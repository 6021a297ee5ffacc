"""gsearch_tpu_torch's k-NN graph (kgraph, hnsw2knn) and coreset (coreset,
hnswcore) against gsearch_tpu's, on the CPU.

Tolerances.  Distances are `1 - eq / S`; where S is a power of two the
reference's reciprocal division (XLA on the CPU) is exact, so k-NN graphs,
Hamming blocks, draws, weights and assignments are equal and costs within
1e-6 relative.  At S = 500 a distance can sit one ulp from the
reference's, and the D^2 draws read the distances: measured on these
inputs, ids, weights and assignments still equal and costs differ by
< 1e-6 relative.  l1 / l2 / cosine are f32 products whose summation order
differs from XLA's: held to 1e-5 relative, cosine also to 2e-5 absolute,
and l2 (whose norm expansion |q|^2 + |d|^2 - 2 q.d cancels near 0: 0.0096
against the reference's 0.0 for a row with itself, f32 rows of S = 512)
also to sqrt(8 ulp) of the largest squared norm absolute.  The l2 coreset
draws the reference's ids, weights and assignment on these inputs; its
cost (which sums the coreset members' own cancellation residues) differs
by 3.5e-5 relative: held to 1e-4."""

import os

import numpy as np
import pytest
import torch

import gsearch_tpu.analysis.coreset as jcore
import gsearch_tpu.analysis.kgraph as jkg
import gsearch_tpu.index.hnsw as jhnsw
import gsearch_tpu_torch.analysis.coreset as tcore
import gsearch_tpu_torch.analysis.kgraph as tkg
from gsearch_tpu.cli.hnsw2knn import run_hnsw2knn as jax_hnsw2knn
from gsearch_tpu.cli.hnswcore import run_hnswcore as jax_hnswcore
from gsearch_tpu.core import HnswParams, ProcessingParams, SeqDict, SeqSketcherParams
from gsearch_tpu.core.seqdict import Id, ItemDict
from gsearch_tpu.index.flat import FlatIndex as JaxFlat
from gsearch_tpu.index.serialize import dumpall as jax_dumpall
from gsearch_tpu.index.sharded import ShardedHnswIndex as JaxSharded
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.index.flat import FlatIndex
from gsearch_tpu_torch.index.hnsw import HnswIndex
from gsearch_tpu_torch.index.sharded import ShardedHnswIndex
from test_torch_hnsw import sig_cloud

CPU = torch.device("cpu")


def _labelled(rng, n, s, n_clusters, dtype=np.uint32):
    """Cluster members with 10% of their slots redrawn, and their labels."""
    lab = np.arange(n) % n_clusters
    centers = rng.integers(0, 1 << 30, size=(n_clusters, s))
    sigs = np.where(rng.random((n, s)) < 0.1, rng.integers(0, 1 << 30, size=(n, s)), centers[lab])
    return sigs.astype(dtype), lab


def _seqdict(n):
    return SeqDict([ItemDict(id=Id(path=f"g{i}.fna", fasta_id=f"g{i}"), len=1000) for i in range(n)])


def _dump_flat(path, sigs):
    idx = JaxFlat(sketch_size=sigs.shape[1], sig_dtype=sigs.dtype)
    idx.insert(sigs)
    params = ProcessingParams(hnsw=HnswParams(), block_flag=True,
                              sketch=SeqSketcherParams(kmer_size=16, sketch_size=sigs.shape[1],
                                                       algo="OPTDENS", data_t="DNA"))
    jax_dumpall(str(path), idx, _seqdict(len(sigs)), params)


# ---- k-NN graph ------------------------------------------------------------


@pytest.fixture(scope="module")
def graph_rows():
    """2,100 rows, S = 128: the graph index above 2,048 rows searches by
    the beam (the reference's graph carried across), the sharded one (two
    shards of 300) and the flat one by the exact sweep."""
    rng = np.random.default_rng(21)
    sigs = sig_cloud(rng, 2100, 128, n_clusters=40)
    ref_h = jhnsw.HnswIndex(sketch_size=128, sig_dtype=np.uint32, max_nb_conn=16, ef_construction=64)
    ref_h.insert(sigs, batch_size=512, bulk=False)
    return sigs, ref_h


def _indexes(kind, sigs, ref_h):
    if kind == "flat":
        ref = JaxFlat(sketch_size=128, sig_dtype=np.uint32)
        got = FlatIndex(128, np.uint32, CPU)
        ref.insert(sigs)
        got.insert(sigs)
    elif kind == "hnsw":
        ref, got = ref_h, HnswIndex.from_jax(ref_h, device=CPU)
    else:
        kw = dict(sketch_size=128, sig_dtype=np.uint32, n_shards=2, max_nb_conn=16, ef_construction=64)
        ref = JaxSharded(**kw)
        ref.insert(sigs[:600], batch_size=512)
        got = ShardedHnswIndex.from_jax(ref, device=CPU)
    return ref, got


@pytest.mark.parametrize("kind", ["flat", "hnsw", "sharded"])
def test_kgraph_matches_reference(graph_rows, kind):
    sigs, ref_h = graph_rows
    ref, got = _indexes(kind, sigs, ref_h)
    want, have = jkg.kgraph_from_index(ref, knbn=8), tkg.kgraph_from_index(got, knbn=8)
    np.testing.assert_array_equal(have.neighbors, want.neighbors)
    np.testing.assert_allclose(have.distances, want.distances, rtol=0, atol=1e-6)
    assert have.neighbors.dtype == np.int32 and have.distances.dtype == np.float32
    assert (have.neighbors != np.arange(have.nb_nodes)[:, None]).all()
    assert have.stats() == want.stats()
    h_ref, h_got = jkg.Hubness(want), tkg.Hubness(have)
    assert h_got.get_standard3m() == h_ref.get_standard3m()
    np.testing.assert_array_equal(h_got.get_hubness_histogram(), h_ref.get_hubness_histogram())
    if kind == "hnsw":
        assert got.stats["search"]["route"] == "beam"


def test_kgraph_batches_and_searcher_route():
    """Batches of the self-search do not change the graph; on the CPU no
    searcher is built (the reference's CPU path)."""
    rng = np.random.default_rng(4)
    sigs, _ = _labelled(rng, 300, 64, 6)
    idx = FlatIndex(64, np.uint32, CPU)
    idx.insert(sigs)
    assert tkg._exact_searcher(sigs, CPU) is None
    a, b = tkg.kgraph_from_index(idx, knbn=5), tkg.kgraph_from_index(idx, knbn=5, batch=64)
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    np.testing.assert_array_equal(a.distances, b.distances)


def test_hnsw2knn_output_identical(tmp_path):
    rng = np.random.default_rng(8)
    sigs, _ = _labelled(rng, 200, 256, 5)
    _dump_flat(tmp_path / "db", sigs)
    jax_hnsw2knn(str(tmp_path / "db"), 6, str(tmp_path / "jax.txt"))
    assert torch_main(["hnsw2knn", "-b", str(tmp_path / "db"), "-n", "6", "-o",
                       str(tmp_path / "torch.txt"), "--device", "cpu"]) == 0
    want = (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "torch.txt").read_bytes() == want
    assert want.count(b"\n") == 200 and want.startswith(b"g0.fna:\tg")


# ---- coreset ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.uint32, np.uint16])
@pytest.mark.parametrize("metric", ["hamming", "l1", "l2", "cosine"])
def test_pairwise_distance_matches_reference(metric, dtype):
    rng = np.random.default_rng(10)
    if dtype == np.float32:
        sigs = rng.random((90, 512), dtype=np.float32)
        sigs[1::2, :300] = sigs[::2, :300]
    else:
        hi = 1 << (16 if dtype == np.uint16 else 32)
        sigs = rng.integers(0, hi, size=(90, 512), dtype=np.uint64).astype(dtype)
        sigs[1::2, :300] = sigs[::2, :300]
    q, db = sigs[:20], sigs
    want = np.asarray(jcore.pairwise_distance(q, db, metric))
    rows = tcore.metric_rows(sigs, metric, CPU)
    got = tcore.pairwise_distance(rows[:20], rows, metric).numpy()
    assert got.shape == want.shape == (20, 90) and got.dtype == np.float32
    if metric == "hamming":
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    elif metric == "cosine":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    elif metric == "l2":
        # |q|^2 + |d|^2 - 2 q.d cancels near 0: a few ulps of the squared norms
        sq = float((sigs.astype(np.float64) ** 2).sum(1).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=np.sqrt(8 * 2.0**-23 * sq))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("metric,s", [("hamming", 512), ("hamming", 500), ("l2", 512)])
def test_coreset_and_clustering_match_reference(metric, s):
    rng = np.random.default_rng(12)
    sigs, _ = _labelled(rng, 700, s, 12)
    q_ref = jcore.distance_quantiles(sigs, nb_rows=64, metric=metric)
    q_got = tcore.distance_quantiles(sigs, nb_rows=64, metric=metric, device=CPU)
    assert q_got.keys() == q_ref.keys()
    np.testing.assert_allclose(list(q_got.values()), list(q_ref.values()), rtol=1e-5)
    ref = jcore.build_coreset(sigs, 64, metric=metric)
    got = tcore.build_coreset(sigs, 64, metric=metric, device=CPU)
    for res_ref, res_got in ((ref, got), (jcore.cluster_coreset(sigs, ref, 6, metric=metric),
                                          tcore.cluster_coreset(sigs, got, 6, metric=metric, device=CPU))):
        np.testing.assert_array_equal(res_got.ids, res_ref.ids)
        np.testing.assert_array_equal(res_got.weights, res_ref.weights)
        np.testing.assert_array_equal(res_got.assignment, res_ref.assignment)
        assert res_got.cost == pytest.approx(res_ref.cost, rel=1e-6 if metric == "hamming" else 1e-4)
        if metric == "hamming" and s == 512:
            assert res_got.cost == res_ref.cost


def test_coreset_shares_one_upload():
    """Passing the device rows instead of the host matrix changes nothing."""
    rng = np.random.default_rng(13)
    sigs, _ = _labelled(rng, 300, 128, 5)
    rows = tcore.metric_rows(sigs, "hamming", CPU)
    a = tcore.build_coreset(sigs, 32, device=CPU)
    b = tcore.build_coreset(rows, 32, device=CPU)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.assignment, b.assignment)
    with pytest.raises(ValueError, match="metric"):
        tcore.metric_rows(sigs, "l3", CPU)


@pytest.mark.parametrize("metric", ["hamming", "cosine"])
def test_hnswcore_csvs_identical(tmp_path, metric, capsys):
    rng = np.random.default_rng(14)
    sigs, _ = _labelled(rng, 400, 256, 8)
    _dump_flat(tmp_path / "db", sigs)
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
    want = jax_hnswcore(str(tmp_path / "db"), 48, 5, str(tmp_path / "jax"), metric=metric)
    capsys.readouterr()
    assert torch_main(["hnswcore", "-b", str(tmp_path / "db"), "--coreset", "48", "--cluster", "5",
                       "--metric", metric, "-o", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    import json

    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("coreset.csv", "clustercoreset.csv"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert got["coreset_size"] == want["coreset_size"] == 48 and got["nb_cluster"] == 5
    assert got["cluster_cost"] == pytest.approx(want["cluster_cost"], rel=1e-6)
    assert os.path.getsize(tmp_path / "torch" / "clustercoreset.csv") > 400 * 20
