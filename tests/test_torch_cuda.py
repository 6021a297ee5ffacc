"""gsearch_tpu_torch on a CUDA card: each hand-written kernel against its
plain torch version (bitwise), and the sketch and search paths on the card
against the same code on the CPU, which the other test_torch_* files hold
to gsearch_tpu.  Every test skips without a card; the file imports no JAX,
so on the card it runs alone with
`python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest`."""

import numpy as np
import pytest
import torch

from gsearch_tpu_torch.core.params import SeqSketcherParams
from gsearch_tpu_torch.index.hnsw import HnswIndex
from gsearch_tpu_torch.models import make_sketcher
from gsearch_tpu_torch.ops import cuda_lib
from gsearch_tpu_torch.ops import distance as tdist
from gsearch_tpu_torch.ops import mxu as tmxu
from gsearch_tpu_torch.ops.mxu import MxuSearcher

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("tile", list(tdist.K1_TILES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_k1_kernel_matches_plain(cuda_device, dtype, tile):
    """Each tile, bitwise: one tile, ragged everything (S % 4 != 0 takes
    4-byte copies), split S, unsplit large Q x N."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for nq, n, s in ((1, 1, 1), (37, 130, 77), (70, 4095, 1203), (600, 3000, 333), (9, 300, 1024)):
        db = (torch.rand((n, s), generator=gen, device=cuda_device) * 3).to(dtype)
        q = (torch.rand((nq, s), generator=gen, device=cuda_device) * 3).to(dtype)
        before = cuda_lib.launches["hamming_frac"]
        got = tdist.hamming_frac(q, db, tile=tile)
        assert cuda_lib.launches["hamming_frac"] == before + 1
        assert _same(got, tdist.hamming_frac_plain(q, db))


def test_k1_split_matches_plain_and_leaves_workspace_zero(cuda_device):
    """Shapes whose tiles cannot fill the card split S in one launch; the
    split workspace is zero again afterwards, so a second call agrees."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for nq, n, s in ((8, 48, 12000), (37, 4095, 12000), (5, 40, 3001), (1, 700, 2048)):
        plan = tdist.k1_plan(1, nq, n, s, sms)
        assert plan.splits > 1, plan
        db = (torch.rand((n, s), generator=gen, device=cuda_device) * 3).to(torch.int32)
        q = (torch.rand((nq, s), generator=gen, device=cuda_device) * 3).to(torch.int32)
        want = tdist.hamming_frac_plain(q, db)
        assert _same(tdist.hamming_frac(q, db), want)
        assert _same(tdist.hamming_frac(q, db), want)
    for counts, tickets in tdist._workspace.values():
        assert int(counts.abs().sum()) == 0 and int(tickets.abs().sum()) == 0


def test_k1_batched_kernel_matches_plain(cuda_device):
    """A batch of independent problems [B, Q, S] x [B, N, S]."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for b, c, n, s in ((1, 3, 4, 5), (37, 96, 50, 128), (300, 64, 64, 1024)):
        q = (torch.rand((b, c, s), generator=gen, device=cuda_device) * 3).to(torch.int32)
        db = (torch.rand((b, n, s), generator=gen, device=cuda_device) * 3).to(torch.int32)
        before = cuda_lib.launches["hamming_frac"]
        got = tdist.hamming_frac(q, db)
        assert cuda_lib.launches["hamming_frac"] == before + 1
        assert got.shape == (b, c, n)
        assert _same(got, tdist.hamming_frac_plain(q, db))


def test_k1_self_pairs_match_plain(cuda_device):
    """The self-pair form (tiles on and above the diagonal, mirrored) at
    odd shapes with repeated rows, split and unsplit: bitwise equal to the
    plain version, symmetric, 0.0 on the diagonal."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for b, c, s in ((1, 1, 5), (3, 5, 77), (7, 33, 1024), (2, 130, 1203), (300, 64, 1024),
                    (1, 1024, 256), (64, 128, 1024)):
        x = (torch.rand((b, c, s), generator=gen, device=cuda_device) * 3).to(torch.int32)
        x[:, c // 2:] = x[:, : c - c // 2].clone()  # repeated rows
        before = cuda_lib.launches["hamming_frac_self"]
        got = tdist.hamming_frac_self(x)
        assert cuda_lib.launches["hamming_frac_self"] == before + 1
        assert _same(got, tdist.hamming_frac_self_plain(x))
        assert _same(got, got.transpose(1, 2).contiguous())
        assert bool((torch.diagonal(got, dim1=1, dim2=2) == 0).all())
    x2 = torch.rand((130, 300), generator=gen, device=cuda_device)  # 2-D f32
    assert _same(tdist.hamming_frac_self(x2), tdist.hamming_frac_self_plain(x2))


_PACKERS = {2: tmxu.pack_hash16, 4: tmxu.pack_hash8, 8: tmxu.pack_hash4}


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_k2_packed_kernel_matches_plain(cuda_device, parts):
    """K2 parts=2/4/8 bitwise against its plain version: packed hashes with
    query and database pads, ragged and odd lane counts, repeated and
    out-of-range ids; launches counted under gather_hamming_p{parts}."""
    gen = torch.Generator(device=cuda_device).manual_seed(6 + parts)
    for qc, r, n, s in ((1, 1, 5, 7), (33, 80, 2000, 1201), (64, 160, 3000, 12000)):
        base = torch.rand((n, s), generator=gen, device=cuda_device)
        keep = torch.rand((qc, s), generator=gen, device=cuda_device) < 0.7
        q = torch.where(keep, base[torch.arange(qc, device=cuda_device) % n], 0.5).contiguous()
        spad = -(-s // (32 * parts)) * 32 * parts  # lanes a multiple of 32: 16-byte path
        db_p = _PACKERS[parts](base, spad=spad, pad_val=0)
        q_p = _PACKERS[parts](q, spad=spad, pad_val=1)
        ids = torch.randint(-2, n + 2, (qc, r), generator=gen, device=cuda_device, dtype=torch.int32)
        ids[:, r // 2:] = ids[:, : r - r // 2]
        name = f"gather_hamming_p{parts}"
        before = cuda_lib.launches[name]
        got = tdist.gather_hamming(db_p, q_p, ids, parts=parts, s_true=s)
        assert cuda_lib.launches[name] == before + 1
        want = tdist.gather_hamming_plain(db_p, q_p, ids, parts=parts, s_true=s)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        # an odd lane count: rows not 16-byte aligned take the scalar path
        db_o, q_o = db_p[:, 1:].contiguous(), q_p[:, 1:].contiguous()
        got = tdist.gather_hamming(db_o, q_o, ids, parts=parts)
        want = tdist.gather_hamming_plain(db_o, q_o, ids, parts=parts)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_k2_kernel_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    for qc, r, n, s in ((1, 1, 5, 3), (33, 80, 2000, 1201), (64, 20, 300, 12000)):
        db = torch.rand((n, s), generator=gen, device=cuda_device)
        keep = torch.rand((qc, s), generator=gen, device=cuda_device) < 0.5
        q = torch.where(keep, db[0].expand(qc, s), 0.0).contiguous()
        ids = torch.randint(-2, n + 2, (qc, r), generator=gen, device=cuda_device, dtype=torch.int32)
        got = tdist.gather_hamming(db, q, ids)
        assert torch.equal(got.view(torch.int32), tdist.gather_hamming_plain(db, q, ids).view(torch.int32))


def test_wrappers_reject_cpu_mix_and_non_contiguous(cuda_device):
    db = torch.rand((10, 16), device=cuda_device)
    with pytest.raises(ValueError):
        tdist.hamming_frac(db[:, ::2], db[:, ::2])
    with pytest.raises(ValueError):
        tdist.hamming_frac(db.cpu(), db)
    with pytest.raises(TypeError):
        tdist.gather_hamming(db, db[:2].contiguous(), torch.zeros((2, 3), dtype=torch.int64, device=cuda_device))


@pytest.mark.parametrize("algo,s", [("OPTDENS", 128), ("REVOPTDENS", 1024)])
def test_sketch_on_card_matches_cpu(cuda_device, algo, s):
    rng = np.random.default_rng(9)
    genomes = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (10, 12_000, 40_000, 70_001)]
    heavy = rng.integers(0, 4, size=40_000).astype(np.uint8)
    for st in rng.integers(0, 15_000, 30):
        heavy[st : st + 60] = 255
    genomes.append(heavy)
    p = SeqSketcherParams(kmer_size=16, sketch_size=s, algo=algo, data_t="DNA")
    sigs = []
    for dev in (cuda_device, torch.device("cpu")):
        sk = make_sketcher(p, device=dev)
        sk.MAX_BLOCK_LOG2 = 14
        sigs.append(sk.sketch_many(genomes))
    np.testing.assert_array_equal(sigs[0].view(np.uint32), sigs[1].view(np.uint32))


def test_mxu_searcher_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(10)
    n, s = 4200, 256
    db = rng.random((n, s), dtype=np.float32)
    q = db[rng.integers(0, n, 40)].copy()
    q[:, :60] = rng.random((40, 60), dtype=np.float32)
    before = dict(cuda_lib.launches)
    got = MxuSearcher(db, cuda_device).search(q, 10)
    assert cuda_lib.launches["gather_hamming"] == before["gather_hamming"] + 1
    want = MxuSearcher(db, torch.device("cpu")).search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


def _cloud(rng, n, s, n_clusters):
    centers = rng.integers(0, 1 << 30, size=(n_clusters, s)).astype(np.uint32)
    sigs = centers[np.arange(n) % n_clusters].copy()
    redraw = rng.random((n, s)) < rng.uniform(0.0, 0.5, size=(n, 1))
    sigs[redraw] = rng.integers(0, 1 << 30, size=int(redraw.sum()), dtype=np.uint32)
    return sigs


def test_hnsw_on_card_matches_cpu(cuda_device):
    """The beam-path build and the beam-route search (n=3000 < COARSE_MIN)
    on the card equal the CPU path's: graph arrays, ids and distances."""
    rng = np.random.default_rng(12)
    n, s = 3000, 1024
    sigs = _cloud(rng, n + 24, s, 32)
    kw = dict(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16, ef_construction=64,
              search_prefix=256)
    idx = {}
    for dev in (cuda_device, torch.device("cpu")):
        idx[dev.type] = HnswIndex(**kw, device=dev)
        idx[dev.type].insert(sigs[:n], batch_size=512, bulk=False)
    for name in ("_nbrs", "_nbr_d", "_entry_ids", "_pinned"):
        np.testing.assert_array_equal(getattr(idx["cuda"], name), getattr(idx["cpu"], name))
    before = dict(cuda_lib.launches)
    got = idx["cuda"].search(sigs[n:], 10, ef_search=128)
    assert idx["cuda"].stats["search"]["route"] == "beam"
    assert cuda_lib.launches["gather_hamming"] > before["gather_hamming"]
    assert cuda_lib.launches["hamming_frac"] > before["hamming_frac"]
    want = idx["cpu"].search(sigs[n:], 10, ef_search=128)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


@pytest.mark.parametrize("form", list(tdist.K2_FORMS))
@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_k2_forms_match_plain_and_leave_workspaces_zero(cuda_device, parts, form):
    """Each K2 form at each `parts`, bitwise against the plain version: a
    row every query lists, R = 1 and Qc = 1, lanes % 4 != 0, a misaligned
    database view, ids -1, N and 2^31 - 1, one and several lane segments,
    query-major launches small enough to split their lanes; one launch
    counted a call, and the K2 workspaces zero after every launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(20 + parts)
    name = tdist._PARTS[parts]
    for qc, r, n, lanes in ((1, 1, 5, 7), (1, 300, 50, 1024), (300, 1, 50, 1024), (64, 80, 40, 2053),
                            (33, 40, 2000, 3000), (256, 64, 4000, 1024)):
        db = torch.randint(-2**31, 2**31 - 1, (n, lanes), generator=gen, device=cuda_device,
                           dtype=torch.int32)
        if parts == 1:
            db = db % 4  # many equal lanes
        noise = torch.randint(-2**31, 2**31 - 1, (qc, lanes), generator=gen, device=cuda_device,
                              dtype=torch.int32)
        src = db[torch.randint(0, n, (qc,), generator=gen, device=cuda_device)]
        keep = torch.rand((qc, lanes), generator=gen, device=cuda_device) < 0.6
        q = torch.where(keep, src, src ^ (noise & 0x0F0F00FF)).contiguous()
        ids = torch.randint(-2, n + 2, (qc, r), generator=gen, device=cuda_device, dtype=torch.int32)
        ids[:, 0] = 0  # a row every query lists
        ids[0, -1] = 2**31 - 1
        ids[-1, -1] = n
        big = torch.empty(n * lanes + 1, dtype=torch.int32, device=cuda_device)
        misaligned = big[1:].view(n, lanes)  # 4 bytes past a 16-byte boundary
        misaligned.copy_(db)
        want = tdist.gather_hamming_plain(db, q, ids, parts=parts)
        for view in (db, misaligned):
            before = cuda_lib.launches[name]
            got = tdist.gather_hamming(view, q, ids, parts=parts, form=form)
            assert cuda_lib.launches[name] == before + 1
            assert _same(got, want), (qc, r, n, lanes, form)
            torch.cuda.synchronize()
            for zeroed, _ in tdist._k2_ws.values():
                assert int(zeroed.abs().sum()) == 0


def test_mxu_searcher_one_k2_launch_over_score_chunks(cuda_device, monkeypatch):
    """A batch of several score chunks is reranked by one K2 launch on the
    card, and equals the CPU path."""
    rng = np.random.default_rng(11)
    n, s = 4200, 256
    db = rng.random((n, s), dtype=np.float32)
    q = db[rng.integers(0, n, 100)].copy()
    q[:, :60] = rng.random((100, 60), dtype=np.float32)
    monkeypatch.setattr(tmxu, "_SCORE_ELEMS", 32 * 4200)  # 32-query chunks
    before = dict(cuda_lib.launches)
    got = MxuSearcher(db, cuda_device).search(q, 10)
    assert cuda_lib.launches["gather_hamming"] == before["gather_hamming"] + 1
    assert cuda_lib.launches["int_mm"] == before["int_mm"] + 4
    want = MxuSearcher(db, torch.device("cpu")).search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


@pytest.mark.parametrize("algo,data_t,k", [("SUPER", "DNA", 16), ("SUPER2", "DNA", 16), ("PROB3A", "DNA", 16),
                                           ("HLL", "DNA", 16), ("OPTDENS", "AA", 7), ("PROB3A", "AA", 7)])
def test_every_sketcher_on_card_matches_cpu(cuda_device, algo, data_t, k):
    """The sort race, the exact scatter race and amino-acid windows on the
    card against the CPU path: bitwise for the integer-only sketchers; prob
    and hll take a float64 log rounded to f32 on both, so at most one slot
    of a genome may differ (none expected)."""
    rng = np.random.default_rng(13)
    alpha = 4 if data_t == "DNA" else 20
    genomes = [rng.integers(0, alpha, n).astype(np.uint8) for n in (9, 12_000, 70_001)]
    genomes[2][1000:2500] = 255
    genomes.append(np.concatenate([genomes[1]] * 3))
    params = SeqSketcherParams(kmer_size=k, sketch_size=1024, algo=algo, data_t=data_t)
    sigs = []
    for dev in (cuda_device, torch.device("cpu")):
        sk = make_sketcher(params, device=dev)
        sk.MAX_BLOCK_LOG2 = 14
        sigs.append(sk.sketch_many(genomes))
    assert sigs[0].dtype == sigs[1].dtype
    diff = sigs[0].view(np.uint32) != sigs[1].view(np.uint32) if sigs[0].dtype == np.float32 else sigs[0] != sigs[1]
    assert diff.sum(1).max() <= (1 if algo in ("PROB3A", "HLL") else 0)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint16])
def test_kernels_on_unsigned_signatures(cuda_device, dtype):
    """K1 and K2 on u32 rows holding NaN patterns and -0.0 (viewed) and on
    u16 registers (widened by value): bitwise the plain version, equal
    counts equal to integer equality on the host."""
    rng = np.random.default_rng(17)
    vals = (np.array([0, 1, 0x0100, 0x0101, 0x8000, 0xFFFF], np.uint16) if dtype == np.uint16 else
            np.array([0x7FC00000, 0xFFC00001, 0, 0x80000000, 0x0001FFFF, 0x0002FFFF], np.uint32))
    db = vals[rng.integers(0, len(vals), size=(300, 1203))]
    q = vals[rng.integers(0, len(vals), size=(9, 1203))]
    tq, tdb = tdist.as_int32_rows(q).to(cuda_device), tdist.as_int32_rows(db).to(cuda_device)
    got = tdist.hamming_frac(tq, tdb)
    assert _same(got, tdist.hamming_frac_plain(tq, tdb))
    eq = (q[:, None, :] == db[None, :, :]).sum(-1)
    np.testing.assert_array_equal(np.rint((1.0 - got.cpu().numpy().astype(np.float64)) * 1203), eq)
    ids = torch.from_numpy(rng.integers(0, 300, size=(9, 40)).astype(np.int32)).to(cuda_device)
    for form in tdist.K2_FORMS:
        assert _same(tdist.gather_hamming(tdb, tq, ids, form=form), tdist.gather_hamming_plain(tdb, tq, ids))


@pytest.mark.parametrize("nq", [1, 256])
def test_k1_at_the_coreset_sweep_shapes(cuda_device, nq):
    """The coreset's sweeps: [1, 65,536] (a draw round) and [256, 65,536]
    (the assignment) at S = 12,000, and the medoid block [256, 256]."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    db = (torch.rand((65536, 12000), generator=gen, device=cuda_device) * 4).to(torch.int32)
    q = db[torch.randint(0, 65536, (nq,), generator=gen, device=cuda_device)].contiguous()
    q[:, ::3] = 7
    assert _same(tdist.hamming_frac(q, db), tdist.hamming_frac_plain(q, db))
    if nq == 256:
        assert _same(tdist.hamming_frac(q, q), tdist.hamming_frac_plain(q, q))


def test_coreset_on_card_matches_cpu(cuda_device):
    from gsearch_tpu_torch.analysis.coreset import build_coreset, cluster_coreset

    rng = np.random.default_rng(22)
    sigs = _cloud(rng, 3000, 1024, 24)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        core = build_coreset(sigs, 128, device=dev)
        res[dev.type] = (core, cluster_coreset(sigs, core, 8, device=dev))
    for a, b in zip(res["cuda"], res["cpu"]):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.assignment, b.assignment)
        assert a.cost == b.cost


def test_embed_optimize_on_card_matches_cpu(cuda_device):
    """Three full-batch steps with the same negatives: within 1e-4 of the
    CPU's (the bound the reference is held to, tests/test_torch_embed.py);
    two runs on the card are equal (the per-destination sums are
    segment_reduce, not atomics)."""
    from gsearch_tpu_torch.analysis.embed import Embedder, EmbedderParams
    from gsearch_tpu_torch.analysis.kgraph import KGraph

    rng = np.random.default_rng(23)
    n, k = 2000, 8
    nbrs = np.stack([(np.arange(n) + 1 + rng.integers(0, 20, n)) % n for _ in range(k)], 1).astype(np.int32)
    dist = np.sort(rng.random((n, k)).astype(np.float32), 1)
    kg = KGraph(nbrs, dist)
    params = EmbedderParams(nb_grad_batch=1, epochs_per_batch=3)
    negs = torch.randint(0, n, (3, 10, n * k), generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        emb = Embedder(kg, params, device=dev)
        w = emb._edge_weights()
        y0 = emb._dmap_init(w, nbrs)
        out[dev.type] = emb._optimize(nbrs, w, y0, rng_seed=1, negatives=negs)
        if dev.type == "cuda":
            np.testing.assert_array_equal(emb._optimize(nbrs, w, y0, rng_seed=1, negatives=negs), out["cuda"])
            drawn = emb._optimize(nbrs, w, y0, rng_seed=1)
            np.testing.assert_array_equal(emb._optimize(nbrs, w, y0, rng_seed=1), drawn)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-4)


def test_seed_sketch_and_sharded_search_on_card_match_cpu(cuda_device):
    from gsearch_tpu_torch.index.sharded import ShardedHnswIndex
    from gsearch_tpu_torch.models.seedchain import SeedChainer

    rng = np.random.default_rng(24)
    g = rng.integers(0, 4, (1 << 22) + 70_000).astype(np.uint8)
    g[1000:3000] = 255
    a, b = SeedChainer(device=cuda_device).sketch(g), SeedChainer(device=torch.device("cpu")).sketch(g)
    np.testing.assert_array_equal(a.hashes, b.hashes)
    np.testing.assert_array_equal(a.positions, b.positions)
    sigs = _cloud(rng, 4216, 256, 32)
    kw = dict(sketch_size=256, sig_dtype=np.uint32, n_shards=2, max_nb_conn=16, ef_construction=64,
              search_prefix=128)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        idx = ShardedHnswIndex(**kw, device=dev)
        idx.insert(sigs[:-16], batch_size=512)
        res[dev.type] = idx.search(sigs[-16:], 10)
        assert {sh.stats["search"]["route"] for sh in idx.shards} == {"beam"}
    np.testing.assert_array_equal(res["cuda"][1], res["cpu"][1])
    np.testing.assert_array_equal(res["cuda"][0].view(np.uint32), res["cpu"][0].view(np.uint32))


@pytest.mark.parametrize("w", [0, 5, 8])
def test_bigsi_on_card_matches_cpu(cuda_device, w):
    """BIGSI bits and raw counts on the card equal the CPU's, bitwise
    (plain and minimizer mode, odd and even window, down-sampled reads)."""
    from gsearch_tpu_torch.index.bigsi import BigsiIndex

    rng = np.random.default_rng(40 + w)
    genomes = [rng.integers(0, 4, n).astype(np.uint8) for n in (30_000, 80_000, (1 << 22) + 500)]
    genomes[1][500:900] = 255
    card, cpu = (BigsiIndex(1 << 20, 2, 21, w, device=dev) for dev in (cuda_device, torch.device("cpu")))
    for i, g in enumerate(genomes):
        card.insert_genome(f"g{i}", g)
        cpu.insert_genome(f"g{i}", g)
    np.testing.assert_array_equal(card._bits, cpu._bits)
    reads = np.stack([genomes[i % 3][s : s + 256] for i, s in enumerate(rng.integers(0, 29_000, 300))])
    reads[::7, 100:120] = 255
    for d in (1, 3):
        for a, b in zip(card.raw_counts(reads, d), cpu.raw_counts(reads, d)):
            np.testing.assert_array_equal(a, b)


def test_hmm_scores_on_card_within_bound_of_cpu(cuda_device, tmp_path):
    """Viterbi and Forward bits on the card within the bound that holds the
    CPU path to gsearch_tpu (tests/test_torch_hmmsearch.py)."""
    from gsearch_tpu_torch.models.hmmprofile import HmmSearcher, parse_hmmer3
    from torch_synth import AAS, bits_bound, write_profile

    rng = np.random.default_rng(41)
    for i, length in enumerate((12, 47, 80, 150)):
        write_profile(tmp_path / "p.hmm", f"P{i}", length, rng)
    profiles = parse_hmmer3(str(tmp_path / "p.hmm"))
    seqs = [HmmSearcher.encode("".join(rng.choice(AAS, int(n)))) for n in rng.integers(1, 300, 40)]
    for algo in ("viterbi", "forward"):
        for multihit in (True, False):
            card = HmmSearcher(profiles, device=cuda_device, multihit=multihit).score(seqs, algo)
            cpu = HmmSearcher(profiles, device=torch.device("cpu"), multihit=multihit).score(seqs, algo)
            assert np.isfinite(card).all()
            assert (np.abs(card - cpu) <= bits_bound(cpu)).all(), (algo, np.abs(card - cpu).max())


@pytest.mark.parametrize("kind", ["flat", "hnsw"])
def test_import_on_card_matches_cpu(cuda_device, tmp_path, kind):
    """A 2,048-row reference dump imported on the card and on the CPU: the
    same database files, byte for byte."""
    from gsearch_tpu_torch.core.params import HnswParams, ProcessingParams, SeqSketcherParams
    from gsearch_tpu_torch.index.refimport import import_reference_db
    from torch_synth import write_reference_dump

    rng = np.random.default_rng(42)
    sigs = _cloud(rng, 2048, 256, 32).view(np.float32)
    params = ProcessingParams(
        hnsw=HnswParams(capacity=1_500_000, ef=64, max_nb_conn=16, scale_modification=1.0),
        sketch=SeqSketcherParams(kmer_size=16, sketch_size=256, algo="OPTDENS", data_t="DNA"),
        block_flag=True)
    ref = tmp_path / "ref"
    ref.mkdir()
    write_reference_dump(str(ref), sigs, params)
    for out, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        res = import_reference_db(str(ref), str(tmp_path / out), kind, device=dev)
        assert res["index_kind"] == kind and res["nb_points"] == 2048
    names = sorted(p.name for p in (tmp_path / "cpu").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "card").iterdir())
    for name in names:
        assert (tmp_path / "card" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes(), name


def _viterbi_inputs(b, w, case, seed, device):
    """Seeded decoder inputs on `device`: emissions and bonuses of planted
    genomes (or random ones), 255-padded windows whose states all tie, and
    dp0 forced into NC on row 0; the transition table with or without the
    indel states."""
    from gsearch_tpu_torch.io.codec import encode_dna
    from gsearch_tpu_torch.models.genepred import _precompute_scores, default_codon_logusage
    from gsearch_tpu_torch.ops.viterbi import transition_table
    from torch_synth import synth_genome

    rng = np.random.default_rng(seed)
    if case == "random":
        e = torch.from_numpy(rng.normal(-1.5, 2.0, (b, w, 11)).astype(np.float32))
        bon = [torch.from_numpy(rng.normal(0, 4, (b, w)).astype(np.float32)) for _ in range(4)]
    else:
        seq, _ = synth_genome(rng, max(b * w // 4, 4 * w) + w, n_runs=max(1, b // 8))
        starts = rng.integers(0, len(seq) - w, b)
        codes = encode_dna(np.stack([seq[s : s + w] for s in starts]))
        codes[:, -100:] = 255
        if case == "all_padding":
            codes[:] = 255
        e, *bon = _precompute_scores(torch.from_numpy(codes), default_codon_logusage(), None,
                                     3.0, 6.0 if case == "indels" else 9.0)
    dp0 = torch.zeros((b, 11))
    dp0[0] = -1e9
    dp0[0, 0] = 0.0
    tb = torch.from_numpy(transition_table(1 / 400, np.log(0.01) if case == "indels" else -1e9))
    return [x.contiguous().to(device) for x in (e, *bon, dp0, tb)]


@pytest.mark.parametrize("b,w,case", [(1, 4096, "planted"), (64, 8192, "planted"),
                                      (1000, 8192, "planted"), (16, 4096, "random"),
                                      (8, 8192, "all_padding"), (32, 8192, "indels")])
def test_viterbi_kernel_matches_plain(cuda_device, b, w, case):
    """The decoder kernel's state paths bitwise equal to the plain
    version's, the CPU one (held to gsearch_tpu by test_torch_genepred.py)
    and, where small, the plain loop on the card."""
    from gsearch_tpu_torch.ops import viterbi as tv

    args = _viterbi_inputs(b, w, case, 50 + b, cuda_device)
    before = cuda_lib.launches["viterbi"]
    got = tv.viterbi(*args)
    assert cuda_lib.launches["viterbi"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (b, w)
    want = tv.viterbi_plain(*(x.cpu() for x in args))
    assert torch.equal(got.cpu(), want)
    if b <= 16:
        assert torch.equal(got, tv.viterbi_plain(*args))


def test_viterbi_wrapper_rejects_bad_inputs(cuda_device):
    from gsearch_tpu_torch.ops import viterbi as tv

    e, *bon, dp0, tb = _viterbi_inputs(4, 256, "random", 3, cuda_device)
    with pytest.raises(ValueError):
        tv.viterbi(e.transpose(0, 1).contiguous().transpose(0, 1), *bon, dp0, tb)
    with pytest.raises(TypeError):
        tv.viterbi(e.double(), *bon, dp0, tb)
    with pytest.raises(ValueError):
        tv.viterbi(e, *bon, dp0, tb.cpu())


def _decode_tables(kind: str, rng) -> dict:
    """Keyword tables of the fused decode for one table variant the CLI
    decodes with (numpy, as `_decode_windows` takes them); "ctx" is a
    FragGeneScan model's full set (context, calibration, noncoding, both
    dicodon tables) plus a start prior."""
    from gsearch_tpu_torch.models.genepred import GeneModel, default_codon_logusage
    from torch_synth import write_fgs_train_dir
    import tempfile

    kw = {"codon_lu": default_codon_logusage(), "dicodon_lu": None}
    if kind == "codon":
        return kw
    with tempfile.TemporaryDirectory() as tdir:
        write_fgs_train_dir(tdir, rng)
        model = GeneModel.from_fgs_train_dir(tdir)
    nc, ctx, aff = model.ctx_for(model.cg_bins[0])
    if kind in ("dicodon", "dicodon_rdi"):
        kw["dicodon_lu"] = model.dicodon_logusage[0]
    if kind == "dicodon_rdi":
        kw["rdicodon_lu"] = model.rdicodon_logusage[0]
    if kind == "nc_lm":
        kw["nc_lm"] = nc
    if kind == "start_prior":
        kw["start_prior"] = rng.normal(0, 1, 64).astype(np.float32)
    if kind == "ctx":
        kw.update(codon_lu=model.codon_logusage[0], dicodon_lu=model.dicodon_logusage[0],
                  rdicodon_lu=model.rdicodon_logusage[0], nc_lm=nc, ctx=ctx, ctx_aff=aff,
                  start_prior=rng.normal(0, 1, 64).astype(np.float32))
    return kw


def _decode_windows_inputs(b, w, seed, device):
    """Seeded windows of planted genomes with N runs and a 255 tail (row 1
    ends in a stop codon, row 0 opens with "TA" + N), dp0 with row 0 in NC,
    the transition table."""
    from gsearch_tpu_torch.io.codec import encode_dna
    from gsearch_tpu_torch.ops.viterbi import transition_table
    from torch_synth import synth_genome

    rng = np.random.default_rng(seed)
    seq, _ = synth_genome(rng, max(b * w // 4, 4 * w) + w, n_runs=max(2, b // 8))
    starts = rng.integers(0, len(seq) - w, b)
    codes = encode_dna(np.stack([seq[s : s + w] for s in starts]))
    codes[:, -100:] = 255
    codes[0, :3] = [3, 0, 255]
    if b > 1:
        codes[1, -3:] = encode_dna(b"TAA")
    dp0 = torch.zeros((b, 11))
    dp0[0] = -1e9
    dp0[0, 0] = 0.0
    tb = torch.from_numpy(transition_table(1 / 400, -1e9))
    return rng, torch.from_numpy(codes).to(device), dp0.to(device), tb.to(device)


@pytest.mark.parametrize("kind", ["codon", "dicodon", "dicodon_rdi", "nc_lm", "start_prior", "ctx"])
@pytest.mark.parametrize("b,w", [(1, 4096), (3, 4133), (64, 8192), (896, 8192)])
def test_genepred_decode_kernel_matches_plain(cuda_device, b, w, kind):
    """The fused decode (`gs_genepred_decode`, one launch from codes to
    paths) bitwise equal to the plain composition on the same device,
    `_precompute_scores` then `viterbi_plain` (held to gsearch_tpu's
    `_decode_windows` by test_torch_genepred.py), for every table variant,
    a context model among them."""
    from gsearch_tpu_torch.models import genepred as gp
    from gsearch_tpu_torch.ops import viterbi as tv

    rng, codes, dp0, tb = _decode_windows_inputs(b, w, 70 + b, cuda_device)
    kw = _decode_tables(kind, rng)
    scal = dict(start_codon_bonus=3.0, stop_codon_bonus=9.0, ctx_weight=1.0, ctx_cap=8.0, ctx_neg_cap=6.0)
    before = dict(cuda_lib.launches)
    got = gp._decode_windows(codes, dp0, tb, **kw, **scal)
    assert cuda_lib.launches["genepred_decode"] == before["genepred_decode"] + 1
    assert cuda_lib.launches["viterbi"] == before["viterbi"]
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (b, w)
    want = tv.viterbi_plain(*gp._precompute_scores(codes, **kw, **scal), dp0, tb)
    assert torch.equal(got, want)


def test_genepred_decode_rejects_bad_inputs(cuda_device):
    """The launcher raises on a table on another device, a context table
    without its calibration, non-contiguous or non-u8 codes; given good
    inputs it agrees with the plain composition."""
    from gsearch_tpu_torch.models.genepred import _precompute_scores, default_codon_logusage
    from gsearch_tpu_torch.ops import viterbi as tv

    _, codes, dp0, tb = _decode_windows_inputs(4, 256, 5, cuda_device)
    codon = torch.as_tensor(default_codon_logusage(), device=cuda_device)
    scal = dict(start_codon_bonus=3.0, stop_codon_bonus=9.0, ctx_weight=1.0, ctx_cap=8.0, ctx_neg_cap=6.0)
    with pytest.raises(ValueError, match="codon_lu on cpu"):
        tv.genepred_decode(codes, dp0, tb, codon_lu=codon.cpu(), **scal)
    with pytest.raises(ValueError, match="ctx_aff"):
        tv.genepred_decode(codes, dp0, tb, codon_lu=codon, ctx=torch.zeros((4, 61, 64), device=cuda_device),
                           **scal)
    with pytest.raises(ValueError, match="contiguous"):
        tv.genepred_decode(codes.t().contiguous().t(), dp0, tb, codon_lu=codon, **scal)
    with pytest.raises(ValueError, match="uint8"):
        tv.genepred_decode(codes.to(torch.int32), dp0, tb, codon_lu=codon, **scal)
    want = tv.viterbi_plain(*_precompute_scores(codes, default_codon_logusage(), None, 3.0, 9.0), dp0, tb)
    assert torch.equal(tv.genepred_decode(codes, dp0, tb, codon_lu=codon, **scal), want)


def test_genepred_on_card_matches_cpu(cuda_device, tmp_path):
    """The genepred CLI with self-training (context tables, a 2-round
    decode) and with the standard prior writes the same four files on the
    card as on the CPU: the fused decode gives the CPU composition's
    paths, through `genepred_decode` launches only."""
    from gsearch_tpu_torch.cli.genepred import main
    from torch_synth import synth_genome

    rng = np.random.default_rng(61)
    fa = tmp_path / "g.fna"
    with open(fa, "wb") as f:
        for i, length in enumerate((120_000, 9_000, 3_000)):
            seq, _ = synth_genome(rng, length, n_runs=1)
            f.write(b">c%d\n" % i + seq.tobytes() + b"\n")
    for train in ("standard", "self"):
        outs = {}
        for dev in ("cuda", "cpu"):
            before = dict(cuda_lib.launches)
            assert main(["-s", str(fa), "-o", str(tmp_path / dev), "-t", train, "--device", dev]) == 0
            if dev == "cuda":
                assert cuda_lib.launches["genepred_decode"] > before["genepred_decode"]
                assert cuda_lib.launches["viterbi"] == before["viterbi"]
            outs[dev] = [(tmp_path / (dev + ext)).read_bytes() for ext in (".faa", ".ffn", ".gff", ".out")]
        assert outs["cuda"] == outs["cpu"], train
        assert outs["cuda"][0].count(b">") > 50


def test_mesh_searchers_on_card_match_cpu(cuda_device):
    """MeshSearcher, MeshMxuSearcher and MeshGraphSearcher with 4 members
    on the one card equal the same searchers with 4 CPU members, bitwise;
    each member's K1 / K2 launch is counted; and the mesh sketcher's
    signatures equal the plain sketcher's."""
    from gsearch_tpu_torch.index.sharded import ShardedHnswIndex
    from gsearch_tpu_torch.parallel.mesh import (MeshGraphSearcher, MeshMxuSearcher, MeshSearcher,
                                                 make_device_mesh)

    rng = np.random.default_rng(71)
    sigs = _cloud(rng, 5000, 256, 40)
    q = sigs[rng.choice(5000, 24, replace=False)].copy()
    q[:12, :30] = rng.integers(0, 1 << 30, size=(12, 30), dtype=np.uint32)
    cpu = torch.device("cpu")
    meshes = {d.type: make_device_mesh(4, device=d, devices=[d] * 4) for d in (cuda_device, cpu)}
    index = ShardedHnswIndex(sketch_size=256, sig_dtype=np.uint32, n_shards=4, max_nb_conn=16,
                             ef_construction=64, search_prefix=128, device=cpu)
    index.insert(sigs, batch_size=512)
    res = {}
    for kind, mesh in meshes.items():
        before = dict(cuda_lib.launches)
        res[kind] = [MeshSearcher(sigs, mesh).search(q, 10), MeshMxuSearcher(sigs, mesh).search(q, 10),
                     MeshGraphSearcher(index, mesh).search(q, 10, ef_search=64)]
        if kind == "cuda":
            assert cuda_lib.launches["hamming_frac"] - before["hamming_frac"] >= 4 + 4  # sweeps, entry tiers
            assert cuda_lib.launches["gather_hamming_p2"] - before["gather_hamming_p2"] == 4
            assert cuda_lib.launches["gather_hamming"] - before["gather_hamming"] > 4
    for (d, i), (d_cpu, i_cpu) in zip(res["cuda"], res["cpu"]):
        np.testing.assert_array_equal(i, i_cpu)
        np.testing.assert_array_equal(d.view(np.uint32), d_cpu.view(np.uint32))
    assert (res["cuda"][0][0][12:, 0] == 0).all()
    params = SeqSketcherParams(kmer_size=16, sketch_size=512, algo="OPTDENS", data_t="DNA")
    genomes = [rng.integers(0, 4, n).astype(np.uint8) for n in (30_000, 70_001, 9)]
    plain = make_sketcher(params, device=cuda_device)
    plain.MAX_BLOCK_LOG2 = 14
    meshed = make_sketcher(params, device=cuda_device)
    meshed.MAX_BLOCK_LOG2 = 14
    meshed.set_mesh(meshes["cuda"])
    np.testing.assert_array_equal(meshed.sketch_many(genomes).view(np.uint32),
                                  plain.sketch_many(genomes).view(np.uint32))


def test_mesh_two_processes_on_card_over_gloo(cuda_device, tmp_path):
    """Two processes on cuda:0, each holding 2 of 4 members (chip_smoke's
    two-process runner), merging over gloo: the lists of one process's
    4-member CPU mesh."""
    import chip_smoke
    from gsearch_tpu_torch.parallel.mesh import MeshSearcher, make_device_mesh

    sigs = np.random.default_rng(12).integers(0, 1 << 20, size=(20_001, 384)).astype(np.uint32)
    np.save(tmp_path / "mesh_db.npy", sigs)
    np.save(tmp_path / "mesh_q.npy", sigs[::701])
    procs = chip_smoke.start_mesh_processes(str(tmp_path), 9, cuda_device, 2)
    ranks = chip_smoke.finish_mesh_processes(procs, str(tmp_path), timeout=180)
    d, ids = MeshSearcher(sigs, make_device_mesh(4, device=torch.device("cpu"))).search(sigs[::701], 9)
    for rank, got in enumerate(ranks):
        assert int(got["size"]) == 4 and float(got["total"]) == 6.0
        assert list(got["members"]) == [2 * rank, 2 * rank + 1]
        np.testing.assert_array_equal(got["ids"], ids)
        np.testing.assert_array_equal(got["d"].view(np.uint32), d.view(np.uint32))
