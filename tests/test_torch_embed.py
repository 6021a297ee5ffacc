"""gsearch_tpu_torch's embedding (analysis/embed.py, the `ann` subcommand)
against gsearch_tpu's, on the CPU.

Tolerances.  The host parts (edge weights, diffusion-map init, landmark
assignment, coarse graph, quality estimate) are the reference's numpy on
the same inputs: equal.  The layout cannot be bit-exact: the reference
draws its negatives under JAX's threefry and sums its scatter-adds in
XLA's order.  Fed the reference's own draws (made here with JAX), three
full-batch steps from the same start stay within 1.5e-5 of the
reference's coordinates (extent ~10; measured on the CPU), held to 1e-4;
the gap grows with the steps (2.5e-4 after 20, 0.48 after 300, as two
chaotic layouts part).  Over a whole embed() only the outcome is held:
finite coordinates, the quality estimate under the reference's bar of 1.0
and within 0.15 of the reference's on the same k-NN graph (measured 0.0418
against 0.0414, run with -s), and clusters
separated as tests/test_analysis.py requires."""

import jax
import numpy as np
import pytest
import torch

from gsearch_tpu.analysis.embed import Embedder as JaxEmbedder
from gsearch_tpu.analysis.embed import EmbedderParams as JaxParams
from gsearch_tpu.analysis.kgraph import kgraph_from_index as jax_kgraph
from gsearch_tpu.index.flat import FlatIndex as JaxFlat
from gsearch_tpu_torch.analysis.embed import Embedder, EmbedderParams
from gsearch_tpu_torch.analysis.kgraph import KGraph
from gsearch_tpu_torch.cli.main import main as torch_main
from test_torch_analysis import _dump_flat

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def clustered():
    """tests/test_analysis.py's index: 4 clusters of 25 at 10% redrawn
    slots, S = 128; its k-NN graph (k = 8) by gsearch_tpu."""
    rng = np.random.default_rng(3)
    s, n_clusters, per = 128, 4, 25
    centers = rng.integers(0, 1 << 30, size=(n_clusters, s)).astype(np.uint32)
    sigs, labels = [], []
    for c in range(n_clusters):
        for _ in range(per):
            x = centers[c].copy()
            mask = rng.random(s) < 0.1
            x[mask] = rng.integers(0, 1 << 30, size=mask.sum(), dtype=np.uint32)
            sigs.append(x)
            labels.append(c)
    idx = JaxFlat(sketch_size=s, sig_dtype=np.uint32)
    idx.insert(np.stack(sigs))
    kg = jax_kgraph(idx, knbn=8)
    return np.stack(sigs), np.array(labels), kg


def _pair(kg, **kw):
    return (JaxEmbedder(kg, JaxParams(**kw)),
            Embedder(KGraph(kg.neighbors.copy(), kg.distances.copy()), EmbedderParams(**kw), device=CPU))


def _reference_draws(seed: int, total: int, nneg: int, n_edges: int, n: int) -> torch.Tensor:
    """The reference's negatives (gsearch_tpu/analysis/embed.py `_optimize`):
    a key a step, split into one a round, `randint` over the edges."""
    keys = jax.random.split(jax.random.PRNGKey(seed), total)
    return torch.from_numpy(np.stack([
        np.stack([np.asarray(jax.random.randint(kk, (n_edges,), 0, n))
                  for kk in jax.random.split(keys[t], nneg)]) for t in range(total)]).astype(np.int64))


def _separated(y, labels, factor):
    d = np.linalg.norm(y[:, None, :] - y[None, :, :], axis=-1)
    same = labels[:, None] == labels[None, :]
    return d[same & (d > 0)].mean() < factor * d[~same].mean()


def test_host_parts_equal_reference(clustered):
    _, _, kg = clustered
    ref, got = _pair(kg)
    nbrs = kg.neighbors.astype(np.int32)
    w = ref._edge_weights()
    np.testing.assert_array_equal(got._edge_weights(), w)
    np.testing.assert_array_equal(got._dmap_init(w, nbrs), ref._dmap_init(w, nbrs))
    marks = np.random.default_rng(5).choice(100, size=10, replace=False)
    lab = ref._assign_landmarks(nbrs, kg.distances, marks)
    np.testing.assert_array_equal(got._assign_landmarks(nbrs, kg.distances, marks), lab)
    for a, b in zip(got._coarse_graph(nbrs, w, lab, 10), ref._coarse_graph(nbrs, w, lab, 10)):
        np.testing.assert_array_equal(a, b)
    y = np.random.default_rng(6).normal(size=(100, 2)).astype(np.float32)
    ref._embedded, got._embedded = y, y.copy()
    assert got.get_quality_estimate_from_edge_length(50) == ref.get_quality_estimate_from_edge_length(50)


@pytest.mark.parametrize("beta,grad_step", [(1.0, 3.0), (0.5, 2.0)])
def test_trajectory_with_reference_negatives(clustered, beta, grad_step):
    """Three full-batch steps fed the reference's draws stay within 1e-4."""
    _, _, kg = clustered
    kw = dict(nb_grad_batch=1, epochs_per_batch=3, beta=beta, grad_step=grad_step)
    ref, got = _pair(kg, **kw)
    nbrs = kg.neighbors.astype(np.int32)
    w = ref._edge_weights()
    y0 = ref._dmap_init(w, nbrs)
    want = ref._optimize(nbrs, w, y0, rng_seed=7)
    negs = _reference_draws(7, 3, 10, nbrs.size, nbrs.shape[0])
    have = got._optimize(nbrs, w, y0, rng_seed=7, negatives=negs)
    assert have.dtype == np.float32 and have.shape == want.shape
    assert np.abs(have - y0).max() > 1e-3  # the steps moved the layout
    np.testing.assert_allclose(have, want, rtol=0, atol=1e-4)


def test_full_embed_meets_the_reference_bars(clustered):
    """tests/test_analysis.py's bars, and quality within 0.15 of the
    reference's on the same graph; the draws come from the seed."""
    _, labels, kg = clustered
    ref, got = _pair(kg, nb_grad_batch=30, grad_step=2.0)
    y = got.embed()
    assert y.shape == (100, 2) and np.isfinite(y).all()
    assert _separated(y, labels, 1.0)
    q = got.get_quality_estimate_from_edge_length(100)
    ref.embed()
    q_ref = ref.get_quality_estimate_from_edge_length(100)
    print(f"quality: port {q:.4f}, reference {q_ref:.4f}")
    assert 0 <= q < 1.0 and abs(q - q_ref) < 0.15, (q, q_ref)
    np.testing.assert_array_equal(Embedder(got.kgraph, got.params, device=CPU).embed(), y)
    assert set(got.times) == {"init_s", "optimize_s"}


def test_hierarchical_init_path(clustered, monkeypatch):
    """Above hier_threshold the layout starts from landmarks: the coarse
    graph is laid out first (seeded rng_seed + 1), fine points start at
    their landmark; the result meets the bars."""
    _, labels, kg = clustered
    _, got = _pair(kg, hier_threshold=50, n_landmarks=12, nb_grad_batch=30, grad_step=2.0)
    seen = []
    real = Embedder._optimize

    def spy(self, nbrs, w, y0, rng_seed, negatives=None):
        seen.append((nbrs.shape, rng_seed))
        return real(self, nbrs, w, y0, rng_seed, negatives)

    monkeypatch.setattr(Embedder, "_optimize", spy)
    y = got.embed()
    assert seen == [((12, 16), 1), ((100, 8), 0)]
    assert np.isfinite(y).all() and _separated(y, labels, 1.0)
    assert 0 <= got.get_quality_estimate_from_edge_length(100) < 1.0


def test_ann_stats_embed_cli(clustered, tmp_path, capsys):
    sigs, _, _ = clustered
    _dump_flat(tmp_path / "db", sigs)
    assert torch_main(["ann", "-b", str(tmp_path / "db"), "--stats", "--embed", "--nb_grad_batch", "30",
                       "--grad_step", "2.0", "-o", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "hubness" in out and "quality" in out
    rows = (tmp_path / "database_embedded.csv").read_text().strip().splitlines()
    assert len(rows) == 100 and all(len(r.split(",")) == 2 for r in rows)
