"""gsearch_tpu_torch's mesh (parallel/mesh.py) against gsearch_tpu's, on the
CPU: the reference on tests/conftest.py's 8 virtual CPU devices, the port
with 8 members on the one CPU device, inputs made from numpy seeds.

Tolerances: ids equal everywhere.  Distances within 2^-23: the reference's
mesh computes (S - eq) / S, which XLA on the CPU turns into a product with
1/S, and the port's kernels 1 - eq/S (exact at a power-of-two S, one ulp
apart otherwise; the S = 96 and S = 1000 cases show the ulp does not reach
a neighbours file, which prints {:.5E}).  Signatures bit-exact.  The
2-D mesh recovers each member's equal counts from K1's distances
(`equal_counts`), held exact here for every count up to S = 2^22 - 1."""

import os

import numpy as np
import pytest
import torch

from gsearch_tpu.cli.main import main as jax_main
from gsearch_tpu.core.params import SeqSketcherParams as JaxParams
from gsearch_tpu.index.sharded import ShardedHnswIndex as JaxSharded
from gsearch_tpu.models import make_sketcher as jax_sketcher
from gsearch_tpu.parallel import mesh as jmesh
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.core.params import SeqSketcherParams
from gsearch_tpu_torch.index.flat import FlatIndex
from gsearch_tpu_torch.index.sharded import ShardedHnswIndex
from gsearch_tpu_torch.models import make_sketcher
from gsearch_tpu_torch.ops.distance import _distance, hamming_frac
from gsearch_tpu_torch.parallel.mesh import (MeshGraphSearcher, MeshMxuSearcher, MeshSearcher,
                                             dryrun_multichip, equal_counts, make_device_mesh,
                                             shard_database, sharded_knn, sharded_sketch_and_knn_step)
from test_parallel import _clustered
from test_torch_sketch import _packed, _ref

CPU = torch.device("cpu")
ULP = 2.0 ** -23


def mesh8(two_d=False):
    return make_device_mesh(8, two_d, device=CPU)


def _jax(fn, *args):
    return tuple(np.asarray(x) for x in fn(*args))


@pytest.mark.parametrize("n,two_d", [(8, False), (8, True), (6, True), (4, True), (2, True),
                                     (5, True), (1, False)])
def test_make_device_mesh_shapes(n, two_d):
    ref = jmesh.make_device_mesh(n, two_d=two_d)
    got = make_device_mesh(n, two_d, device=CPU)
    assert got.shape == ref.devices.shape and got.axis_names == ref.axis_names
    assert got.size == n and got.devices == (CPU,) * n
    assert [g for g, _ in got.members()] == list(range(n))


def test_make_device_mesh_members():
    cuda = torch.device("cuda")
    reps = make_device_mesh(device=cuda, devices=[cuda, cuda, cuda])
    assert reps.size == 3 and reps.devices == (torch.device("cuda"),) * 3  # nothing placed yet
    assert make_device_mesh(2, device=CPU, devices=[CPU] * 3).size == 2
    assert make_device_mesh(-1, device=CPU).size == 1  # the CPU is one device
    with pytest.raises(ValueError, match="more than the 3 devices"):
        make_device_mesh(4, device=CPU, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="at least one member"):
        make_device_mesh(0, device=CPU)
    if torch.cuda.device_count() < 9:
        with pytest.raises(ValueError, match=f"needs 9 CUDA cards, but {torch.cuda.device_count()}"):
            make_device_mesh(9, device=cuda)


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_sharded_knn_matches_reference(two_d):
    rng = np.random.default_rng(4)
    n, s, nq, k = 1024, 96, 16, 10
    db = rng.integers(0, 64, size=(n, s)).astype(np.uint32)
    q = db[rng.choice(n, nq, replace=False)].copy()
    q[::2, :20] = rng.integers(0, 64, size=(nq // 2, 20))
    jm = jmesh.make_device_mesh(8, two_d=two_d)
    d_ref, i_ref = _jax(jmesh.sharded_knn(jm, s, k), jmesh.shard_database(db, jm), q, np.int32(n))
    m = mesh8(two_d)
    shards = shard_database(db, m)
    assert len(shards) == 8 and shards[0].shape == ((n // 4, s // 2) if two_d else (n // 8, s))
    d, ids = sharded_knn(m, s, k)(shards, q, n)
    np.testing.assert_array_equal(ids.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=0, atol=ULP)
    assert (d[:, 0][1::2] == 0).all()


@pytest.mark.parametrize("s", [1, 7, 96, 12000, (1 << 22) - 1])
def test_equal_counts_recover_every_count(s):
    """Every count 0..S through K1's formula (`_distance`) and back."""
    eq = torch.arange(s + 1, dtype=torch.int32)
    assert torch.equal(equal_counts(_distance(eq, s), s), eq)


def test_equal_counts_of_k1_equal_plain_counts():
    rng = np.random.default_rng(6)
    db = rng.integers(0, 3, size=(300, 6001)).astype(np.int32)
    q = db[:20].copy()
    q[:, ::3] = rng.integers(0, 3, size=q[:, ::3].shape)
    want = (q[:, None, :] == db[None, :, :]).sum(-1)
    got = equal_counts(hamming_frac(torch.from_numpy(q), torch.from_numpy(db)), 6001)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_mesh_searcher_matches_reference_and_flat(rng, two_d):
    n, s, k = 1001, 96, 7  # 1001 % 8 != 0: pad rows on the last shard
    sigs = rng.integers(0, 1 << 24, size=(n, s)).astype(np.float32)
    sigs[500:520] = sigs[480:500]  # distance ties across rows
    queries = sigs[np.r_[rng.choice(n, 9, replace=False), 485]].copy()
    d_ref, i_ref = jmesh.MeshSearcher(sigs, mesh=jmesh.make_device_mesh(8, two_d=two_d)).search(queries, k)
    d, ids = MeshSearcher(sigs, mesh8(two_d)).search(queries, k)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)
    flat = FlatIndex(s, np.float32, CPU)
    flat.insert(sigs)
    d_flat, i_flat = flat.search(queries, k)
    np.testing.assert_array_equal(ids, i_flat)
    np.testing.assert_array_equal(d.view(np.uint32), d_flat.view(np.uint32))
    assert ids.dtype == np.int32 and list(ids[-1, :2]) == [485, 505]


def test_mesh_mxu_searcher_matches_reference(rng):
    """tests/test_parallel.py's data: 11 clusters whose members lie at
    distinct distances; n = 1100 leaves pad rows (each shard 1,024 rows,
    six of the eight all pad), which both packages score and mask."""
    n, s, k = 1100, 256, 7
    centers = rng.integers(0, 1 << 20, size=(11, s)).astype(np.uint32)
    sigs = np.empty((n, s), np.uint32)
    for i in range(n):
        c = centers[i % 11].copy()
        pos = rng.choice(s, min(5 + 2 * (i // 11), s), replace=False)
        c[pos] = rng.integers(1 << 20, 1 << 21, size=len(pos), dtype=np.uint32)
        sigs[i] = c
    d_ref, i_ref = jmesh.MeshMxuSearcher(sigs, n_devices=8).search(centers, k)
    mx = MeshMxuSearcher(sigs, mesh8())
    assert mx.nl == 1024 and 8 * mx.nl > n
    d, ids = mx.search(centers, k)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)
    d0, i0 = MeshSearcher(sigs, mesh8()).search(centers, k)
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, i0)])
    assert recall >= 0.95 and np.abs(d[:, 0] - d0[:, 0]).max() <= 3.0 / s
    with pytest.raises(ValueError, match="rows only"):
        MeshMxuSearcher(sigs, mesh8(two_d=True))


@pytest.fixture(scope="module")
def sharded_ref():
    """8 shards of 256 rows built by gsearch_tpu, carried across."""
    rng = np.random.default_rng(7)
    sigs = _clustered(rng, 2048, 128)
    ref = JaxSharded(sketch_size=128, sig_dtype=np.float32, n_shards=8, max_nb_conn=8, ef_construction=64)
    ref.insert(sigs)
    return ref, ShardedHnswIndex.from_jax(ref, device=CPU), sigs


def test_mesh_graph_searcher_matches_reference(sharded_ref):
    ref, got, sigs = sharded_ref
    rng = np.random.default_rng(8)
    q = sigs[rng.choice(len(sigs), 12, replace=False)].copy()
    q[:6, :16] = rng.random((6, 16)).astype(np.float32)
    d_ref, i_ref = jmesh.MeshGraphSearcher(ref, n_devices=8).search(q, knbn=10, ef_search=64)
    d, ids = MeshGraphSearcher(got, mesh8()).search(q, knbn=10, ef_search=64)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)
    assert (d[6:, 0] == 0).all() and ids.dtype == np.int32
    with pytest.raises(ValueError, match="mesh has 4 members but the index has 8 shards"):
        MeshGraphSearcher(got, make_device_mesh(4, device=CPU))


@pytest.mark.parametrize("form", ["raw", "packed"])
def test_mesh_sketch_matches_reference(form):
    """Genomes past the block (MAX_BLOCK_LOG2 = 14), one with an N-run-
    heavy piece: gsearch_tpu with set_mesh equals gsearch_tpu without it,
    and the port with 8 members equals both."""
    rng = np.random.default_rng(3)
    genomes = [rng.integers(0, 4, n).astype(np.uint8) for n in (40_000, 70_001, 5_000, 33_000)]
    genomes[3][2000:4000] = 255
    if form == "packed":
        genomes = [_packed(g) for g in genomes]
    kw = dict(kmer_size=14, sketch_size=128, algo="OPTDENS", data_t="DNA")
    ref_single, ref_mesh = jax_sketcher(JaxParams(**kw)), jax_sketcher(JaxParams(**kw))
    got_single, got_mesh = (make_sketcher(SeqSketcherParams(**kw), device=CPU) for _ in range(2))
    for sk in (ref_single, ref_mesh, got_single, got_mesh):
        sk.MAX_BLOCK_LOG2 = 14
    for sk in (ref_single, ref_mesh):
        sk._upload_raw = False
    ref_mesh.set_mesh(jmesh.make_device_mesh(8))
    got_mesh.set_mesh(mesh8())
    want = ref_single.sketch_many(_ref(genomes))
    np.testing.assert_array_equal(ref_mesh.sketch_many(_ref(genomes)).view(np.uint32), want.view(np.uint32))
    for sk in (got_mesh, got_single):
        np.testing.assert_array_equal(sk.sketch_many(genomes).view(np.uint32), want.view(np.uint32))


def test_sharded_sketch_and_knn_step_matches_reference():
    rng = np.random.default_rng(42)
    s, block_len, batch, n = 256, 4096, 16, 256
    kw = dict(kmer_size=12, sketch_size=s, algo="OPTDENS", data_t="DNA")
    ref_sk, got_sk = jax_sketcher(JaxParams(**kw)), make_sketcher(SeqSketcherParams(**kw), device=CPU)
    codes = rng.integers(0, 4, size=(batch, block_len)).astype(np.uint8)
    db = rng.integers(0, 1 << 30, size=(n, s)).astype(np.uint32)
    db[:batch] = got_sk.sketch_many(list(codes)).view(np.uint32)
    jm = jmesh.make_device_mesh(8)
    sig_ref, d_ref, i_ref = _jax(jmesh.sharded_sketch_and_knn_step(jm, ref_sk, block_len, 3), codes,
                                 jmesh.shard_database(db, jm))
    m = mesh8()
    sigs, d, ids = sharded_sketch_and_knn_step(m, got_sk, block_len, 3)(codes, shard_database(db, m))
    np.testing.assert_array_equal(sigs.view(np.uint32), sig_ref.view(np.uint32))
    np.testing.assert_array_equal(sigs.view(np.uint32), db[:batch])
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=ULP)
    assert (ids[:, 0] == np.arange(batch)).all() and (d[:, 0] == 0).all()


def _db_files_equal(a, b):
    """Equal arrays in every .npz, equal bytes in every other file but
    processing_state.json (which records the build's wall time)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name == "processing_state.json":
            continue
        if name.endswith(".npz"):
            with np.load(os.path.join(a, name)) as x, np.load(os.path.join(b, name)) as y:
                assert sorted(x.files) == sorted(y.files)
                for key in x.files:
                    np.testing.assert_array_equal(x[key], y[key], err_msg=f"{name} {key}")
        else:
            with open(os.path.join(a, name), "rb") as x, open(os.path.join(b, name), "rb") as y:
                assert x.read() == y.read(), name


@pytest.mark.parametrize("index", ["auto", "hnsw"])
def test_cli_mesh_round_trip(tmp_path, index):
    """`--mesh 8 tohnsw` (flat; `--index hnsw`: hnsw_sharded in 8 shards)
    then `--mesh 8 request` through both packages: the databases hold equal
    files and arrays, and each package's request of either database writes
    the same neighbours file.  S = 1000 is no power of two."""
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    (tmp_path / "g").mkdir()
    (tmp_path / "q").mkdir()
    genomes = [rng.choice(acgt, 4000) for _ in range(24)]
    genomes[7] = genomes[6].copy()  # a distance tie
    for i, g in enumerate(genomes):
        (tmp_path / "g" / f"g{i}.fna").write_bytes(b">c\n" + g.tobytes() + b"\n")
    for i in (3, 6, 17):
        mut = genomes[i].copy()
        pos = rng.choice(len(mut), 40, replace=False)
        mut[pos] = rng.choice(acgt, 40)
        (tmp_path / "q" / f"q{i}.fna").write_bytes(b">q\n" + mut.tobytes() + b"\n")
    build = ["-d", "g", "-k", "14", "-s", "1000", "-n", "8", "--ef", "64", "--algo", "optdens", "--block",
             "--index", index]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert jax_main(["--mesh", "8", "tohnsw", *build, "-o", "db_jax"]) == 0
        assert torch_main(["--mesh", "8", "tohnsw", *build, "-o", "db_torch", "--device", "cpu"]) == 0
        outs = []
        for db in ("db_jax", "db_torch"):
            assert jax_main(["--mesh", "8", "request", "-b", db, "-n", "5", "-r", "q", "-o", f"j_{db}"]) == 0
            assert torch_main(["--mesh", "8", "request", "-b", db, "-n", "5", "-r", "q", "-o", f"t_{db}",
                               "--device", "cpu"]) == 0
            outs += [f"j_{db}", f"t_{db}"]
    finally:
        os.chdir(cwd)
    meta = (tmp_path / "db_torch" / "index.meta.json").read_text()
    assert ('"hnsw_sharded"' in meta and '"n_shards": 8' in meta) if index == "hnsw" else '"flat"' in meta
    _db_files_equal(tmp_path / "db_jax", tmp_path / "db_torch")
    want = (tmp_path / outs[0] / "gsearch.neighbors.txt").read_text()
    for out in outs[1:]:
        assert (tmp_path / out / "gsearch.neighbors.txt").read_text() == want, out
    hits = [line.split("\t") for line in want.splitlines() if line.startswith("query_id:")]
    assert {os.path.basename(h[5]) for h in hits if float(h[3]) < 0.5} >= {"g3.fna", "g6.fna", "g17.fna"}


def test_two_processes_over_gloo(tmp_path):
    """Two processes of 4 CPU members each, joined over gloo (chip_smoke's
    two-process runner, 120 s for both; a failure shows both logs): 8
    global members, rank-major; the members' indices sum to 28 over both
    (tests/test_parallel.py's check); MeshSearcher across the processes,
    each reading its rows of a memory-mapped file, equals one process's."""
    import chip_smoke

    sigs = np.random.default_rng(11).integers(0, 1 << 24, size=(1001, 96)).astype(np.float32)
    np.save(tmp_path / "mesh_db.npy", sigs)
    np.save(tmp_path / "mesh_q.npy", sigs[::97])
    procs = chip_smoke.start_mesh_processes(str(tmp_path), 7, CPU, 4)
    ranks = chip_smoke.finish_mesh_processes(procs, str(tmp_path), timeout=120)
    d, ids = MeshSearcher(sigs, mesh8()).search(sigs[::97], 7)
    for rank, got in enumerate(ranks):
        assert int(got["size"]) == 8 and float(got["total"]) == 28.0
        assert list(got["members"]) == list(range(4 * rank, 4 * rank + 4))
        np.testing.assert_array_equal(got["ids"], ids)
        np.testing.assert_array_equal(got["d"].view(np.uint32), d.view(np.uint32))


def test_dryrun_multichip():
    dryrun_multichip(8, device=CPU)
