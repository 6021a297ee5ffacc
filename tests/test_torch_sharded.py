"""gsearch_tpu_torch's sharded graph index (`hnsw_sharded`) against
gsearch_tpu's, on the CPU.

Tolerances: the shards are the port's HnswIndex, which builds the
reference's graph arrays exactly (test_torch_hnsw.py), so every shard's
arrays and the global signatures are equal; S = 128 is a power of two, so
the reference's reciprocal division is exact and distances are equal
(held within 1e-6).  The merge follows the reference, not the port's
(distance, id) order: a tie between shards goes to the lower shard, and
the test plants such ties.  The database written by gsearch_tpu with
`mesh_devices=2` is requested and grown by the port through its CLI; the
neighbours file is byte-identical to gsearch_tpu's sequential request and
the grown database equals the one gsearch_tpu's `add` writes."""

import os
import shutil

import numpy as np
import pytest
import torch

import gsearch_tpu.pipeline as jax_pipeline
from gsearch_tpu.core import ComputingParams as JaxComputing
from gsearch_tpu.core import HnswParams as JaxHnsw
from gsearch_tpu.core import ProcessingParams as JaxProcessing
from gsearch_tpu.core import SeqSketcherParams as JaxSketch
from gsearch_tpu.index.serialize import load_index as jax_load
from gsearch_tpu.index.sharded import ShardedHnswIndex as JaxSharded
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.index.serialize import load_index as torch_load
from gsearch_tpu_torch.index.sharded import ShardedHnswIndex
from gsearch_tpu_torch.pipeline import empty_index_like
from test_torch_hnsw import sig_cloud

CPU = torch.device("cpu")
ARRAYS = ("_nbrs", "_nbr_d", "_entry_ids", "_pinned")
KW = dict(sketch_size=128, sig_dtype=np.uint32, n_shards=2, max_nb_conn=16, ef_construction=64)


def _plant_ties(sigs: np.ndarray, n_pairs: int) -> list:
    """Make row g+1 a copy of row g for odd g: g lies in shard 1, g+1 in
    shard 0, so the reference's merge lists g+1 first."""
    pairs = [(g, g + 1) for g in range(101, 101 + 40 * n_pairs, 40)]
    for g, h in pairs:
        sigs[h] = sigs[g]
    return pairs


@pytest.fixture(scope="module")
def sharded_pair():
    """2 shards of 2,048 rows (the beam-insert build) by both packages."""
    rng = np.random.default_rng(5)
    sigs = sig_cloud(rng, 4096, 128, n_clusters=32)
    pairs = _plant_ties(sigs, 8)
    ref = JaxSharded(**KW)
    ref.insert(sigs, batch_size=512)
    got = ShardedHnswIndex(**KW, device=CPU)
    got.insert(sigs, batch_size=512)
    return ref, got, sigs, pairs


def test_sharded_build_equals_reference(sharded_pair):
    ref, got, sigs, _ = sharded_pair
    assert [s.nb_points for s in got.shards] == [s.nb_points for s in ref.shards] == [2048, 2048]
    np.testing.assert_array_equal(got.get_sigs(), sigs)
    np.testing.assert_array_equal(got.get_sigs(), ref.get_sigs())
    for i, (a, b) in enumerate(zip(ref.shards, got.shards)):
        for name in ARRAYS:
            want, have = getattr(a, name), getattr(b, name)
            assert have.dtype == want.dtype, (i, name)
            np.testing.assert_array_equal(have, want, err_msg=f"shard {i} {name}")


@pytest.mark.parametrize("carried", [False, True], ids=["built", "from_jax"])
def test_sharded_search_merge_matches_reference(sharded_pair, carried):
    """ids equal, distances within 1e-6, ties between shards in shard order
    (the higher id of a planted pair first)."""
    ref, got, sigs, pairs = sharded_pair
    if carried:
        got = ShardedHnswIndex.from_jax(ref, device=CPU)
    rng = np.random.default_rng(9)
    q = np.concatenate([sigs[[g for g, _ in pairs]], sigs[rng.integers(0, 4096, 24)]])
    d_ref, i_ref = ref.search(q, knbn=6, ef_search=64)
    d, i = got.search(q, knbn=6, ef_search=64)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=1e-6)
    assert i.dtype == np.int32
    for row, (g, h) in enumerate(pairs):
        assert list(i[row, :2]) == [h, g] and d[row, 0] == d[row, 1] == 0.0


def test_incremental_insert_stays_balanced():
    rng = np.random.default_rng(2)
    sigs = sig_cloud(rng, 40, 32, n_clusters=4)
    kw = dict(KW, sketch_size=32, n_shards=3)
    ref, got = JaxSharded(**kw), ShardedHnswIndex(**kw, device=CPU)
    for lo, hi in ((0, 5), (5, 12), (12, 13), (13, 40)):
        ref.insert(sigs[lo:hi])
        got.insert(sigs[lo:hi])
        sizes = [s.nb_points for s in got.shards]
        assert max(sizes) - min(sizes) <= 1 and sum(sizes) == hi
        assert sizes == [s.nb_points for s in ref.shards]
        np.testing.assert_array_equal(got.get_sigs(), sigs[:hi])
    d, i = got.search(sigs[:6], knbn=3)
    d_ref, i_ref = ref.search(sigs[:6], knbn=3)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(d, d_ref)


def _write(path, name, codes):
    path.write_bytes(b">" + name.encode() + b"\n" + np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()
                     + b"\n")


@pytest.fixture(scope="module")
def mesh_db(tmp_path_factory):
    """A database built by gsearch_tpu with mesh_devices=2 (the sharded
    kind) on the tests' CPU mesh: 11 genomes, g3b a copy of g3 (ids 3 and 4
    in shards 1 and 0), 3 queries at 1% mutation, 2 genomes to add."""
    root = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(17)
    for d in ("db_genomes", "queries", "new"):
        (root / d).mkdir()
    gen = {f"g{i}": rng.integers(0, 4, 15_000) for i in range(10)}
    gen["g3b"] = gen["g3"]
    for name, codes in gen.items():
        _write(root / "db_genomes" / f"{name}.fna", name, codes)
    for i in (3, 6, 8):
        q = gen[f"g{i}"].copy()
        hit = rng.random(q.size) < 0.01
        q[hit] = (q[hit] + 1) % 4
        _write(root / "queries" / f"q{i}.fna", f"q{i}", q)
    for i in range(2):
        _write(root / "new" / f"n{i}.fna", f"n{i}", rng.integers(0, 4, 15_000))
    params = JaxProcessing(
        hnsw=JaxHnsw(capacity=1000, ef=64, max_nb_conn=16, scale_modification=1.0),
        sketch=JaxSketch(kmer_size=16, sketch_size=512, algo="OPTDENS", data_t="DNA"),
        block_flag=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        jax_pipeline.build_database("db_genomes", "db", params, JaxComputing(mesh_devices=2),
                                    index_kind="hnsw")
    finally:
        os.chdir(cwd)
    return root


def _in(root, fn):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def test_port_requests_a_mesh_built_database(mesh_db):
    idx = torch_load(str(mesh_db / "db"), CPU)
    assert idx.KIND == "hnsw_sharded" and idx.n_shards == 2 and idx.nb_points == 11
    _in(mesh_db, lambda: jax_pipeline.request_database("db", "queries", 5, JaxComputing(mesh_devices=0),
                                                       out_dir="req_jax"))
    assert _in(mesh_db, lambda: torch_main(["request", "-b", "db", "-n", "5", "-r", "queries",
                                            "-o", "req_torch", "--device", "cpu"])) == 0
    want = (mesh_db / "req_jax" / "gsearch.neighbors.txt").read_text()
    assert (mesh_db / "req_torch" / "gsearch.neighbors.txt").read_text() == want
    # the planted tie: g3b (id 4, shard 0) is listed before g3 (id 3, shard 1)
    hits = [l.split("\t")[5] for l in want.splitlines() if l.startswith("query_id:") and "q3" in l]
    assert hits[:2] == ["db_genomes/g3b.fna", "db_genomes/g3.fna"]


def test_port_add_to_mesh_built_database_read_by_reference(mesh_db, tmp_path):
    """The port's `add` inserts round-robin; gsearch_tpu reads the grown
    database, whose shards equal those of gsearch_tpu's own `add`."""
    for pkg in ("jax", "torch"):
        shutil.copytree(mesh_db / "db", tmp_path / pkg)
    _in(mesh_db, lambda: jax_pipeline.add_to_database(str(tmp_path / "jax"), "new"))
    assert _in(mesh_db, lambda: torch_main(["add", "-b", str(tmp_path / "torch"), "-n", "new",
                                            "--device", "cpu"])) == 0
    ref, back = jax_load(str(tmp_path / "jax")), jax_load(str(tmp_path / "torch"))
    assert back.KIND == "hnsw_sharded" and back.nb_points == 13
    assert [s.nb_points for s in back.shards] == [7, 6]
    np.testing.assert_array_equal(back.get_sigs(), ref.get_sigs())
    for a, b in zip(ref.shards, back.shards):
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    for name in ("seqdict.json", "index.meta.json"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    d, i = back.search(ref.get_sigs()[11:], knbn=1)
    assert list(i[:, 0]) == [11, 12] and (d[:, 0] == 0).all()


def test_empty_index_like_sharded(mesh_db):
    idx = empty_index_like(str(mesh_db / "db"), "hnsw", device=CPU, n_shards=4)
    assert isinstance(idx, ShardedHnswIndex) and idx.n_shards == 4 and idx.nb_points == 0
    assert idx.max_nb_conn == 16 and idx.sketch_size == 512 and idx.sig_dtype == np.float32
    assert empty_index_like(str(mesh_db / "db"), "hnsw", device=CPU).KIND == "hnsw"


def test_build_database_checks_the_insert(monkeypatch, tmp_path):
    """The port's build raises when the index does not hold one point a
    seqdict entry after the insert (gsearch_tpu asserts the same)."""
    from gsearch_tpu_torch.core import HnswParams, ProcessingParams, SeqSketcherParams
    from gsearch_tpu_torch.index.flat import FlatIndex
    from gsearch_tpu_torch.pipeline import build_database

    (tmp_path / "g").mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        _write(tmp_path / "g" / f"g{i}.fna", f"g{i}", rng.integers(0, 4, 2000))
    params = ProcessingParams(hnsw=HnswParams(), block_flag=True,
                              sketch=SeqSketcherParams(kmer_size=16, sketch_size=64, algo="OPTDENS",
                                                       data_t="DNA"))
    real = FlatIndex.insert
    monkeypatch.setattr(FlatIndex, "insert", lambda self, sigs: real(self, sigs[:-1]))
    with pytest.raises(ValueError, match="seqdict"):
        build_database(str(tmp_path / "g"), str(tmp_path / "db"), params, device=CPU)
