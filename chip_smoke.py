#!/usr/bin/env python3
"""Drive gsearch_tpu_torch's main path once on one CUDA card and check it.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
Every phase raises on failure, so any fault exits non-zero; without a
CUDA card it exits non-zero before printing any result.

  1. the card's name and power limit; build the CUDA kernels and the
     port's native FASTA parser from the sources (timed);
  2. K1 against its plain version, bitwise, f32 and int32: each tile
     (wide, narrow16, narrow8) forced and the plan's own at Q=37, N=4095,
     S=12000 (all split S), 8 x 48 (phase 4's request, split), 512 x 4095;
     the self-pair form `hamming_frac_self` at the bulk build's pair blocks
     [1024, 128, 1024] (symmetric, 0.0 on the diagonal); each timed against
     its plain version, `torch.cdist(p=0)` and its bound;
  3. K2 (`gather_hamming`) against its plain version at Qc=1024, R=80,
     N=65536, S=12000 with synthetic ids (each repeated inside its query,
     some out of range): both forms (query-major, row-grouped) bitwise
     equal, each timed, and the plan's (`k2_plan`);
  4. the CLI slice in-process: a seeded corpus of 48 genomes (1.5-6 Mb,
     8 clusters, some past the 4 Mb block so the piece path runs, some
     with N runs) and 8 queries (1%-mutated members) through
     `tohnsw -k 16 -s 12000 --algo optdens --block`, `request -n 10` and
     `reformat 16 1`: each query's best hit is its source at ANI 99 +- 0.5;
  5. the same request against that database grown to 65,536 genomes with
     seeded uniform decoy signatures: the neighbours file is byte-identical;
     its K2 call is recorded (a K2 site, below);
     then, with that database's sketcher, signatures on the card equal the
     CPU path's on a small input;
  6. timings beside the card's name: sketch Mbases/s, request qps at
     65,536 x 12,000 (1,024 queries, k = 10; its K2 call recorded), each
     kernel against its plain version, its library call (K1) and its
     bound;
  K2-packed. K2 parts=2/4/8 against its plain version, bitwise, at the
     graph index's tier shapes: Qc=1024, R=160, N=262,144, 6,144 / 3,072 /
     2,048 lanes (12,000 slots as 16-, 8- and 4-bit hashes), with repeated
     and out-of-range ids; both forms bitwise equal, each timed;
  hnsw-build. phase 4's 48 genomes plus seeded clustered decoy signatures
     (256 families x 16 species x a random tree of 64 members, drawn on the
     card) up to
     262,144 x 12,000, built by `HnswIndex.insert` (the bulk path) and
     dumped as an hnsw database; the build's passes timed; pass A's first
     K2 call recorded;
  hnsw-request. CLI `request -n 10` of phase 4's queries against it: the
     neighbours file is byte-identical to phase 4's (decoys lie above the
     0.99 output threshold);
  hnsw-add. CLI `add` of the 8 query genomes (the beam-insert path), then
     `request` again: each query's best hit is itself at 0.00000E0;
  tiers. 1,024 queries (decoy members with 5% of slots redrawn), k = 10,
     against the exact oracle (K1 over all 262,144 rows): the coarse route
     with the full tier and the beam route reach tie-aware recall@10 >= 0.99;
     the packed, packed8 and packed4 tiers, forced by lowering
     `_RERANK_DEVICE_BYTES`, overlap the full tier's ids by >= 0.95, 0.9 and
     0.9; each route timed as a request of 1,024 queries; K2's calls of one
     more request by each route recorded: the coarse prefix rerank (one
     launch over the batch), the full, packed, packed8 and packed4 tiers,
     and the first hop of the beam.
  K2 sites.  Each recorded call is re-run with its own arguments: every
     form bitwise against the plain version, timed under each form, the
     plan's and the plain version (CUDA events; device-only time from
     torch.profiler), beside the bound of the unique rows it references and
     the number of such launches on the main path.
The launch counters are zeroed just before each main-path run and read just
after it: phases 4-5 (K1 in phase 4, K2 and the int8 matmul in phase 5);
hnsw-build to hnsw-add (K2 parts=2 and K1's self pairs in the bulk build,
K2 and the int8 matmul in the request, K1 and its self pairs in the add);
tiers (K2 parts=4 and 8).  The line before the last
is the kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import difflib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
FULL = {
    "k1": (37, 4095, 12000),           # Q, N, S
    "k1_batch": (1024, 128, 1024),     # B, C, S' of the bulk build's pair blocks
    "k2": (1024, 80, 65536, 12000),    # Qc, R, N, S
    "lengths": (1_500_000, 6_000_000),  # genome length range of the corpus
    "clusters": 8, "per_cluster": 6,
    "kmer": 16, "sketch": 12000,
    "n_total": 65536, "bench_queries": 1024, "knbn": 10,
    "k2p": (1024, 160, 262144),        # Qc, R, N of the packed tiers
    "hnsw_total": 262144, "families": 256, "species": 16,
    "tier_queries": 1024,
}
# the tiers' lane counts at S = 12000 (hnsw._rerank_tier widths / parts)
K2P_LANES = {2: 12288 // 2, 4: 12288 // 4, 8: 16384 // 8}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str):
    """Mean device time a call of the launches of kernels whose name holds
    `kernel`, from torch.profiler (host overhead excluded); None when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) or 0 for e in prof.key_averages()
                if kernel in e.key)
    return total / reps / 1e3 if total else None


def sm_clock_under(fn, launches: int) -> dict:
    """The SM clock and power nvidia-smi reads every 100 ms while `launches`
    calls of fn run back to back: medians over the samples."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = [line.split(",") for line in out.splitlines() if line.count(",") == 1]
    samples = [(float(a), float(b)) for a, b in rows if a.strip() and b.strip()][3:]
    if not samples:
        return {"sm_clock_mhz": None, "power_w": None}
    return {"sm_clock_mhz": statistics.median(c for c, _ in samples),
            "power_w": statistics.median(w for _, w in samples)}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    diff = torch.where(both_inf, 0.0, (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def perturbed(rows: torch.Tensor, gen: torch.Generator, max_frac: float = 1.0) -> torch.Tensor:
    """Copies of rows with a per-row fraction in [0, max_frac) of slots
    redrawn, so equal counts spread over a range."""
    frac = torch.rand((rows.shape[0], 1), generator=gen, device=rows.device) * max_frac
    redraw = torch.rand(rows.shape, generator=gen, device=rows.device) < frac
    fresh = torch.rand(rows.shape, generator=gen, device=rows.device)
    if rows.dtype == torch.int32:
        fresh = (fresh * 4).to(torch.int32)
    return torch.where(redraw, fresh, rows).contiguous()


# H100 SXM peaks for the bounds: HBM bytes/s, and 32-bit integer ops/s as
# SMs x 64 INT32 lanes x 1.98 GHz boost (one compare-and-count is one op)
HBM_BYTES_S = 3.35e12
INT_LANES_SM, BOOST_HZ = 64, 1.98e9


def bound(nbytes: float, ops: float, sms: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the integer ops over the INT32 lanes' rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / (sms * INT_LANES_SM * BOOST_HZ)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def k1_bound(batch: int, nq: int, n: int, s: int, sms: int, pairs: bool = False) -> dict:
    """K1's work: each input read once, the output written once, and one
    op per slot compare the function needs (self pairs: C(C-1)/2 pairs)."""
    nbytes = 4 * batch * ((n if pairs else nq + n) * s + nq * n)
    pairs_needed = n * (n - 1) // 2 if pairs else nq * n
    return bound(nbytes, batch * pairs_needed * s, sms)


def k2_bound(db: torch.Tensor, ids: torch.Tensor, sms: int) -> dict:
    """K2's work: the rows the ids reference, each read once (the unique
    valid ids), the query rows, the ids and the output; one op per lane
    compare."""
    qc, r = ids.shape
    lanes = db.shape[1]
    valid = ids[(ids >= 0) & (ids < db.shape[0])]
    unique = int(torch.unique(valid).numel())
    return {"unique_rows": unique,
            **bound(4 * (unique * lanes + qc * lanes + 2 * qc * r), qc * r * lanes, sms)}


def phase_k1(dev, cfg, gen) -> dict:
    """K1 at full width, each form bitwise against its plain version: every
    tile forced at the flat index's Q x N (all split S there), the plan's
    own choice there and at phase 4's request shape (8 x 48, split), an
    unsplit large shape, and the self-pair form at the bulk build's pair
    blocks [B, C, S'] (unsplit, wide tiles, mirrored)."""
    from gsearch_tpu_torch.ops.distance import (K1_TILES, hamming_frac, hamming_frac_plain,
                                                hamming_frac_self, hamming_frac_self_plain,
                                                k1_plan)

    nq, n, s = cfg["k1"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    res = {"err": 0.0, "checked": []}

    def hold(got, want, what):
        if not same_bits(got, want):
            raise AssertionError(f"K1 {what} differs from its plain version: max abs err "
                                 f"{max_abs_err(got, want)}")
        res["err"] = max(res["err"], max_abs_err(got, want))
        res["checked"].append(what)

    for dtype in (torch.float32, torch.int32):
        db = torch.rand((n, s), generator=gen, device=dev)
        if dtype == torch.int32:
            db = (db * 4).to(torch.int32)
        src = torch.randint(0, n, (512,), generator=gen, device=dev)
        qs = perturbed(db[src], gen)
        q = qs[:nq].contiguous()
        want = hamming_frac_plain(q, db)
        for tile in (None, *K1_TILES):
            plan = k1_plan(1, nq, n, s, sms, tile=tile)
            hold(hamming_frac(q, db, tile=tile), want,
                 f"{nq}x{n}x{s} {dtype} {plan.tile} x{plan.splits}{'' if tile else ' (plan)'}")
        for rows, cols in ((8, 48), (512, n)):
            qq, d = qs[:rows].contiguous(), db[:cols].contiguous()
            plan = k1_plan(1, rows, cols, s, sms)
            hold(hamming_frac(qq, d), hamming_frac_plain(qq, d),
                 f"{rows}x{cols}x{s} {dtype} {plan.tile} x{plan.splits}")
        if dtype == torch.float32 and dev.type == "cuda":
            small = (qs[:8].contiguous(), db[:48].contiguous())
            qf, dbf = q.float(), db.float()
            res.update(
                ms=event_ms(lambda: hamming_frac(q, db), 20),
                plain_ms=event_ms(lambda: hamming_frac_plain(q, db), 3),
                library_ms=event_ms(lambda: torch.cdist(qf, dbf, p=0), 3),
                ms_8x48=event_ms(lambda: hamming_frac(*small), 50),
                plain_ms_8x48=event_ms(lambda: hamming_frac_plain(*small), 50),
                library_ms_8x48=event_ms(lambda: torch.cdist(small[0], small[1], p=0), 50),
                plan=k1_plan(1, nq, n, s, sms)._asdict(), plan_8x48=k1_plan(1, 8, 48, s, sms)._asdict(),
                **k1_bound(1, nq, n, s, sms))
            res["bound_ms_8x48"] = k1_bound(1, 8, 48, s, sms)["bound_ms"]
            res["device_ms_8x48"] = device_ms(lambda: hamming_frac(*small), 50, "eqcount_kernel")
            res["device_ms"] = device_ms(lambda: hamming_frac(q, db), 20, "eqcount_kernel")
            for tile in K1_TILES:
                res[f"ms_{tile}"] = event_ms(lambda: hamming_frac(q, db, tile=tile), 20)
            q512 = qs[:512].contiguous()
            res["ms_512"] = event_ms(lambda: hamming_frac(q512, db), 10)
            res["bound_ms_512"] = k1_bound(1, 512, n, s, sms)["bound_ms"]
            res["load_512"] = sm_clock_under(lambda: hamming_frac(q512, db), 400)
        del db, qs, q, want
    # the self-pair form at the bulk build's candidate pair blocks, with
    # repeated candidates (a row may be every candidate list's member)
    b, c, sp = cfg["k1_batch"]
    rows = torch.randint(0, 3, (b, c, sp), generator=gen, device=dev, dtype=torch.int32)
    rows[:, c // 2:] = rows[:, : c - c // 2].clone()
    want = hamming_frac_self_plain(rows)
    got = hamming_frac_self(rows)
    hold(got, want, f"self pairs {cfg['k1_batch']} {k1_plan(b, c, c, sp, sms, pairs=True).tile}")
    if not same_bits(got, got.transpose(1, 2).contiguous()) or bool(
            (torch.diagonal(got, dim1=1, dim2=2) != 0).any()):
        raise AssertionError("K1 self pairs: not symmetric, or the diagonal is not 0.0")
    hold(hamming_frac(rows, rows), want, f"batched {cfg['k1_batch']} (both triangles)")
    selfp = {"err": max_abs_err(got, want)}
    if dev.type == "cuda":
        rf = rows.float()
        selfp.update(ms=event_ms(lambda: hamming_frac_self(rows), 10),
                     plain_ms=event_ms(lambda: hamming_frac_self_plain(rows), 2),
                     library_ms=event_ms(lambda: torch.cdist(rf, rf, p=0), 3),
                     ms_both_triangles=event_ms(lambda: hamming_frac(rows, rows), 10),
                     **k1_bound(b, c, c, sp, sms, pairs=True))
    res["self"] = selfp
    print(f"phase 2 K1 bitwise equal to the plain version: {'; '.join(res['checked'])}")
    return res


def phase_k2(dev, cfg, gen) -> dict:
    """K2 parts=1 at the flat index's width, each form bitwise against the
    plain version, with synthetic ids: every id repeated inside its query,
    out-of-range ids."""
    from gsearch_tpu_torch.ops.distance import K2_FORMS, gather_hamming, gather_hamming_plain, k2_plan

    qc, r, n, s = cfg["k2"]
    db = torch.rand((n, s), generator=gen, device=dev)
    src = torch.randint(0, n, (qc,), generator=gen, device=dev)
    q = perturbed(db[src], gen)
    ids = torch.randint(0, n, (qc, r), generator=gen, device=dev, dtype=torch.int32)
    ids[:, 1] = src.to(torch.int32)          # each query's source row
    ids[:, r // 2:] = ids[:, : r - r // 2]   # every id repeated
    ids[0, 0], ids[1, 0], ids[2, 0] = -1, n, 2**31 - 1  # out of range -> +inf
    want = gather_hamming_plain(db, q, ids)
    res = {"err": 0.0}
    for form in K2_FORMS:
        got = gather_hamming(db, q, ids, form=form)
        if not same_bits(got, want):
            raise AssertionError(f"K2 {form} differs from its plain version: max abs err "
                                 f"{max_abs_err(got, want)}")
        if not bool(torch.isinf(got[:3, 0]).all()):
            raise AssertionError("K2: out-of-range ids must give +inf")
    if dev.type == "cuda":
        for form in K2_FORMS:
            res[f"ms_{form}"] = event_ms(lambda: gather_hamming(db, q, ids, form=form), 10)
        res["ms"] = event_ms(lambda: gather_hamming(db, q, ids), 10)
        res["plain_ms"] = event_ms(lambda: gather_hamming_plain(db, q, ids), 2)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        res.update(k2_bound(db, ids, sms), form=k2_plan(qc, r, n, s, sms).form)
    print(f"phase 3 K2 Qc={qc} R={r} N={n} S={s}: both forms bitwise equal to the plain version")
    return res


def phase_k2_packed(dev, cfg, gen) -> dict:
    """K2 parts=2/4/8 at the tier shapes.  Lanes of random bits; each query
    is a database row with a fraction of its lanes XORed with random bits,
    so equal-field counts spread over the whole range.  Each form bitwise
    against the plain version."""
    from gsearch_tpu_torch.ops.distance import K2_FORMS, gather_hamming, gather_hamming_plain, k2_plan

    qc, r, n = cfg["k2p"]
    res = {}
    for parts, lanes in K2P_LANES.items():
        s_true = min(cfg["sketch"], lanes * parts)
        db = torch.randint(-2**31, 2**31 - 1, (n, lanes), generator=gen, device=dev, dtype=torch.int32)
        src = torch.randint(0, n, (qc,), generator=gen, device=dev)
        noise = torch.randint(-2**31, 2**31 - 1, (qc, lanes), generator=gen, device=dev, dtype=torch.int32)
        frac = torch.rand((qc, 1), generator=gen, device=dev)
        hit = torch.rand((qc, lanes), generator=gen, device=dev) < frac
        q = torch.where(hit, db[src] ^ noise, db[src]).contiguous()
        ids = torch.randint(0, n, (qc, r), generator=gen, device=dev, dtype=torch.int32)
        ids[:, 1] = src.to(torch.int32)
        ids[:, r // 2:] = ids[:, : r - r // 2]
        ids[0, 0], ids[1, 0], ids[2, 0] = -1, n, 2**31 - 1
        want = gather_hamming_plain(db, q, ids, parts=parts, s_true=s_true)
        for form in K2_FORMS:
            got = gather_hamming(db, q, ids, parts=parts, s_true=s_true, form=form)
            if not same_bits(got, want):
                raise AssertionError(f"K2 parts={parts} {form} differs from its plain version: "
                                     f"max abs err {max_abs_err(got, want)}")
            if not bool(torch.isinf(got[:3, 0]).all()) or not bool((got[:, 1] < 1).all()):
                raise AssertionError(f"K2 parts={parts}: out-of-range ids must give +inf, sources < 1")
        ent = {"err": 0.0, "lanes": lanes}
        if dev.type == "cuda":
            for form in K2_FORMS:
                ent[f"ms_{form}"] = event_ms(
                    lambda: gather_hamming(db, q, ids, parts=parts, s_true=s_true, form=form), 10)
            ent["ms"] = event_ms(lambda: gather_hamming(db, q, ids, parts=parts, s_true=s_true), 10)
            ent["plain_ms"] = event_ms(
                lambda: gather_hamming_plain(db, q, ids, parts=parts, s_true=s_true), 2)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            ent.update(k2_bound(db, ids, sms), form=k2_plan(qc, r, n, lanes, sms).form)
        res[parts] = ent
        del db, q, ids, got, want
        torch.cuda.empty_cache()
    print(f"phase K2-packed parts=2/4/8 Qc={qc} R={r} N={n} lanes "
          f"{'/'.join(str(v) for v in K2P_LANES.values())}: bitwise equal to the plain version")
    return res


_LUT = np.full(256, ord("N"), dtype=np.uint8)
_LUT[:4] = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutate(codes: np.ndarray, rate: float, rng) -> np.ndarray:
    """Substitute a different base at a `rate` fraction of valid positions."""
    out = codes.copy()
    hit = (rng.random(out.size) < rate) & (out < 4)
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) % 4
    return out


def _write_fasta(path: str, name: str, codes: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b" synthetic\n")
        f.write(_LUT[codes].tobytes())
        f.write(b"\n")


def write_corpus(root: str, cfg) -> dict:
    """Seeded corpus: clusters of 2%-mutated copies of a random root
    genome, the last member of each cluster carrying N runs, and one
    1%-mutated query per cluster.  Returns {query file: source file}."""
    rng = np.random.default_rng(SEED)
    db_dir, q_dir = os.path.join(root, "db_genomes"), os.path.join(root, "queries")
    os.makedirs(db_dir)
    os.makedirs(q_dir)
    lengths = np.linspace(*cfg["lengths"], cfg["clusters"]).astype(int)
    source = {}
    for c, length in enumerate(lengths):
        base = rng.integers(0, 4, int(length), dtype=np.uint8)
        for m in range(cfg["per_cluster"]):
            member = _mutate(base, 0.02, rng)
            if m == cfg["per_cluster"] - 1:
                for start in rng.integers(0, len(member) - 200, 30):
                    member[start : start + 100] = 255
            name = f"c{c}_m{m}"
            _write_fasta(os.path.join(db_dir, name + ".fna"), name, member)
            if m == c % cfg["per_cluster"]:
                _write_fasta(os.path.join(q_dir, f"q{c}.fna"), f"q{c}", _mutate(member, 0.01, rng))
                source[f"q{c}.fna"] = name + ".fna"
    return {"db_dir": db_dir, "q_dir": q_dir, "source": source,
            "bases": int(lengths.sum()) * cfg["per_cluster"]}


def check_sketch_against_cpu(dev, cfg, db) -> None:
    """The card's signatures equal the CPU path's (which the tier-1 tests
    hold bit-exact to gsearch_tpu) on a small input crossing the piece path,
    with the sketcher of phase 4's database."""
    from gsearch_tpu_torch.pipeline import database_sketcher

    rng = np.random.default_rng(SEED)
    genomes = [rng.integers(0, 4, n, dtype=np.uint8) for n in (10, 12_000, 70_001)]
    genomes[2][1000:2500] = 255  # an N run heavy enough for per-piece buckets
    sigs = []
    for d in (dev, torch.device("cpu")):
        sk = database_sketcher(db, device=d)
        sk.MAX_BLOCK_LOG2 = 14
        sigs.append(sk.sketch_many(genomes))
    if sigs[0].shape != (3, cfg["sketch"]) or not np.isfinite(sigs[0]).all():
        raise AssertionError("card signatures have the wrong shape or non-finite values")
    if not np.array_equal(sigs[0].view(np.uint32), sigs[1].view(np.uint32)):
        raise AssertionError("signatures on the card differ from the CPU path")
    print("phase 5 signatures on the card bitwise equal to the CPU path (3 genomes, piece path)")


def phase_cli(dev, cfg, root) -> dict:
    from gsearch_tpu_torch.cli.main import main

    t0 = time.perf_counter()
    corpus = write_corpus(root, cfg)
    t_write = time.perf_counter() - t0
    db, out = os.path.join(root, "db"), os.path.join(root, "req48")
    k, s = str(cfg["kmer"]), str(cfg["sketch"])
    t0 = time.perf_counter()
    rc = main(["tohnsw", "-d", corpus["db_dir"], "-k", k, "-s", s, "-n", "32", "--ef", "200",
               "--algo", "optdens", "--block", "-o", db, "--device", dev.type])
    t_build = time.perf_counter() - t0
    assert rc == 0, "tohnsw failed"
    t0 = time.perf_counter()
    rc = main(["request", "-b", db, "-n", str(cfg["knbn"]), "-r", corpus["q_dir"], "-o", out,
               "--device", dev.type])
    t_request = time.perf_counter() - t0
    assert rc == 0, "request failed"
    neighbours = os.path.join(out, "gsearch.neighbors.txt")
    tsv = os.path.join(out, "ani.tsv")
    assert main(["reformat", k, "1", neighbours, tsv]) == 0, "reformat failed"
    best = {}
    with open(tsv) as f:
        next(f)
        for line in f:
            query, _, hit, _, ani = line.rstrip("\n").split("\t")
            best.setdefault(query, (hit, float(ani)))  # rows sorted by distance
    for query, src in corpus["source"].items():
        hit, ani = best.get(query, (None, float("nan")))
        if hit != src or not abs(ani - 99.0) < 0.5:
            raise AssertionError(f"{query}: best hit {hit} ANI {ani}, expected {src} at 99 +- 0.5")
    print(f"phase 4 CLI: {len(best)} queries, every best hit is its source, "
          f"ANI {min(a for _, a in best.values()):.3f}..{max(a for _, a in best.values()):.3f}")
    return {"db": db, "neighbours": neighbours, "q_dir": corpus["q_dir"], "source": corpus["source"],
            "db_dir": corpus["db_dir"], "bases": corpus["bases"], "write_s": t_write,
            "build_s": t_build, "request_s": t_request}


def phase_grown(dev, cfg, root, p4) -> dict:
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.index.serialize import load_index
    from gsearch_tpu_torch.pipeline import dump_with_placeholders

    index = load_index(p4["db"], dev)
    n_decoy = cfg["n_total"] - index.nb_points
    gen = torch.Generator().manual_seed(SEED)
    index.insert(torch.rand((n_decoy, index.sketch_size), generator=gen).numpy())
    db = os.path.join(root, "db65k")
    dump_with_placeholders(p4["db"], db, index)
    out = os.path.join(root, "req65k")
    t0 = time.perf_counter()
    with K2Recorder(keep=1) as rec:
        rc = main(["request", "-b", db, "-n", str(cfg["knbn"]), "-r", p4["q_dir"], "-o", out,
                   "--device", dev.type])
    t_request = time.perf_counter() - t0
    assert rc == 0, "request at 65k failed"
    if not rec.calls:
        raise AssertionError("the request at 65k made no K2 call")
    site = k2_site(dev, "flat-65k request", rec.calls[0], rec.count)
    del rec
    with open(p4["neighbours"]) as a, open(os.path.join(out, "gsearch.neighbors.txt")) as b:
        want, got = a.read(), b.read()
    if got != want:
        diff = "".join(list(difflib.unified_diff(
            want.splitlines(True), got.splitlines(True), "48 genomes", f"{cfg['n_total']} genomes"))[:60])
        raise AssertionError(f"neighbours file at {cfg['n_total']} genomes differs from phase 4's:\n{diff}")
    print(f"phase 5 request at {cfg['n_total']} genomes: neighbours file byte-identical")
    return {"db": db, "request_s": t_request, "k2_site": site}


def phase_timings(dev, cfg, p4, p5) -> dict:
    """Sketch throughput on the parsed corpus and request qps at full N."""
    from gsearch_tpu_torch.index.serialize import load_index
    from gsearch_tpu_torch.pipeline import database_sketcher, read_genomes

    genomes = read_genomes(p4["db_dir"])
    sketcher = database_sketcher(p4["db"], device=dev)
    sketcher.sketch_many(genomes[:2])
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        sketcher.sketch_many(genomes)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mbases = sum(len(g) for g in genomes) / 1e6

    index = load_index(p5["db"], dev)
    sigs = index.get_sigs()
    nq = cfg["bench_queries"]
    gen = torch.Generator().manual_seed(SEED + 1)
    q = perturbed(torch.from_numpy(sigs[:nq].copy()), gen, max_frac=0.2).numpy()
    _, ids = index.search(q, cfg["knbn"])  # builds the searcher
    if not (ids[:, 0] == np.arange(nq)).all():
        raise AssertionError("request bench: a query's best hit is not its source row")
    qtimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        index.search(q, cfg["knbn"])
        qtimes.append(time.perf_counter() - t0)
    with K2Recorder(keep=1) as rec:
        index.search(q, cfg["knbn"])
    site = k2_site(dev, f"flat-65k, {nq}-query batch", rec.calls[0], rec.count)
    del rec
    return {"sketch_mbases_s": mbases / min(times), "sketch_s": min(times), "mbases": mbases,
            "request_s": statistics.median(qtimes), "qps": nq / statistics.median(qtimes),
            "k2_site": site}


def make_decoys(dev, cfg, out: np.ndarray, gen) -> None:
    """Fill out [n, S] with clustered decoy signatures drawn on the card, in
    the shape of a phylogeny: family roots; species roots with half their
    slots redrawn from their family's; within a species a random tree of
    members, each a copy of an earlier member (the first: of the species
    root) with 3% of its slots redrawn.  Consecutive ids share a species.
    Tree neighbours lie at ~0.03-0.1, species-mates within ~0.3, family-mates
    near 0.75 and everything else at ~1.0, so a graph search has a gradient
    to follow, as in a real collection of genomes."""
    n, s = out.shape
    n_species = cfg["families"] * cfg["species"]
    per = -(-n // n_species)
    fam_root = torch.rand((cfg["families"], s), generator=gen, device=dev)
    step = 256  # species at a time
    for sp0 in range(0, n_species, step):
        sp = torch.arange(sp0, min(sp0 + step, n_species), device=dev)
        fresh = torch.rand((len(sp), s), generator=gen, device=dev)
        root = torch.where(torch.rand((len(sp), s), generator=gen, device=dev) < 0.5, fresh,
                           fam_root[sp // cfg["species"]])
        members = torch.empty((len(sp), per, s), device=dev)
        for i in range(per):
            parent = root if i == 0 else members[
                torch.arange(len(sp), device=dev),
                torch.randint(0, i, (len(sp),), generator=gen, device=dev)]
            redraw = torch.rand((len(sp), s), generator=gen, device=dev) < 0.03
            members[:, i] = torch.where(redraw, torch.rand((len(sp), s), generator=gen, device=dev),
                                        parent)
        start = sp0 * per
        m = min(len(sp) * per, n - start)
        if m <= 0:
            break
        out[start : start + m] = members.reshape(-1, s)[:m].cpu().numpy()


def phase_hnsw_build(dev, cfg, root, p4) -> dict:
    from gsearch_tpu_torch.index.serialize import load_index
    from gsearch_tpu_torch.pipeline import dump_with_placeholders, empty_index_like

    flat = load_index(p4["db"], dev)
    n_real, s = flat.nb_points, flat.sketch_size
    sigs = np.empty((cfg["hnsw_total"], s), np.float32)
    sigs[:n_real] = flat.get_sigs()
    t0 = time.perf_counter()
    make_decoys(dev, cfg, sigs[n_real:], torch.Generator(device=dev).manual_seed(SEED + 2))
    t_gen = time.perf_counter() - t0
    index = empty_index_like(p4["db"], "hnsw", device=dev)
    t0 = time.perf_counter()
    with K2Recorder(keep=1) as rec:  # pass A's launches, the first kept
        index.insert(sigs)  # the bulk build ends in a host sync
    t_build = time.perf_counter() - t0
    if "build_s" not in index.stats or index.nb_points != cfg["hnsw_total"]:
        raise AssertionError("the graph build did not take the bulk path")
    db = os.path.join(root, "db_hnsw")
    t0 = time.perf_counter()
    dump_with_placeholders(p4["db"], db, index)
    t_dump = time.perf_counter() - t0
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in index.stats["build_s"].items())
    print(f"phase hnsw-build {cfg['hnsw_total']} x {s} (max_nb_conn {index.max_nb_conn}): decoys "
          f"{t_gen:.1f} s, bulk build {t_build:.1f} s ({stages}), dump {t_dump:.1f} s; "
          f"{len(index._pinned)} pinned, {len(index._entry_ids)} entries")
    if not rec.calls or rec.calls[0][3].get("parts") != 2:
        raise AssertionError("the bulk build's pass A made no K2 parts=2 call")
    site = k2_site(dev, "pass A of the bulk build (the first)", rec.calls[0], rec.count)
    del rec
    return {"index": index, "db": db, "gen_s": t_gen, "build_s": t_build, "dump_s": t_dump,
            "stages": dict(index.stats["build_s"]), "k2_site": site}


def _cli_request(dev, cfg, db, q_dir, out) -> float:
    from gsearch_tpu_torch.cli.main import main

    t0 = time.perf_counter()
    rc = main(["request", "-b", db, "-n", str(cfg["knbn"]), "-r", q_dir, "-o", out,
               "--device", dev.type])
    if rc != 0:
        raise AssertionError(f"request against {db} failed")
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def phase_hnsw_request(dev, cfg, root, p4, pb) -> dict:
    out = os.path.join(root, "req_hnsw")
    t = _cli_request(dev, cfg, pb["db"], p4["q_dir"], out)
    with open(p4["neighbours"]) as a, open(os.path.join(out, "gsearch.neighbors.txt")) as b:
        want, got = a.read(), b.read()
    if got != want:
        diff = "".join(list(difflib.unified_diff(
            want.splitlines(True), got.splitlines(True), "48 genomes", "graph"))[:60])
        raise AssertionError(f"neighbours file of the graph database differs from phase 4's:\n{diff}")
    print(f"phase hnsw-request at {cfg['hnsw_total']} genomes: neighbours file byte-identical "
          f"({t:.1f} s CLI wall)")
    return {"request_s": t}


def phase_hnsw_add(dev, cfg, root, p4, pb) -> dict:
    from gsearch_tpu_torch.cli.main import main

    t0 = time.perf_counter()
    if main(["add", "-b", pb["db"], "-n", p4["q_dir"], "--device", dev.type]) != 0:
        raise AssertionError("add failed")
    t_add = time.perf_counter() - t0
    torch.cuda.empty_cache()
    out = os.path.join(root, "req_hnsw_add")
    t_req = _cli_request(dev, cfg, pb["db"], p4["q_dir"], out)
    best = {}
    with open(os.path.join(out, "gsearch.neighbors.txt")) as f:
        for line in f:
            if line.startswith("query_id:"):
                field = line.rstrip("\n").split("\t")
                best.setdefault(field[1], (field[3], field[5]))
    if len(best) != len(p4["source"]):
        raise AssertionError(f"after add: {len(best)} queries answered, expected {len(p4['source'])}")
    for query, (dist, hit) in best.items():
        if hit != query or dist != "0.00000E0":
            raise AssertionError(f"after add: best hit of {query} is {hit} at {dist}")
    print(f"phase hnsw-add: 8 genomes added by beam insert ({t_add:.1f} s CLI wall); each query's "
          f"best hit is itself at 0.00000E0 ({t_req:.1f} s request)")
    return {"add_s": t_add, "request_s": t_req}


def _tie_aware(got_d: np.ndarray, true_d: np.ndarray) -> float:
    """Recall that counts a miss only where a returned distance is strictly
    worse than the oracle's (tests/test_index.py's measure)."""
    worse = np.sort(got_d, 1) > np.sort(true_d, 1) + 1e-6
    return float(1.0 - worse.mean())


class K2Recorder:
    """While active, K2's calls made by the graph index and the searcher
    (the flat index goes through the searcher) are recorded: the
    arguments of the first `keep`, and the count of all of them."""

    def __init__(self, keep: int):
        self.keep, self.calls, self.count = keep, [], 0

    def __enter__(self):
        import gsearch_tpu_torch.index.hnsw as hnsw_mod
        import gsearch_tpu_torch.ops.mxu as mxu_mod
        from gsearch_tpu_torch.ops.distance import gather_hamming

        self.mods, self.real = (hnsw_mod, mxu_mod), gather_hamming

        def recorder(db, q, ids, **kw):
            if len(self.calls) < self.keep:
                self.calls.append((db, q, ids, kw))
            self.count += 1
            return gather_hamming(db, q, ids, **kw)

        for mod in self.mods:
            mod.gather_hamming = recorder
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.gather_hamming = self.real
        return False


def k2_site(dev, site: str, call, launches: int) -> dict:
    """A K2 call the main path made, re-run with its own arguments: every
    form bitwise against the plain version; timed under each forced form,
    the plan's form and the plain version, beside its unique-row bound.
    `launches` is how many launches of this kind the main path made.
    These launches are not main-path launches: the counts are restored."""
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import K2_FORMS, gather_hamming, gather_hamming_plain, k2_plan

    db, q, ids, kw = call
    saved = dict(cuda_lib.launches)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    want = gather_hamming_plain(db, q, ids, **kw)
    for form in K2_FORMS:
        got = gather_hamming(db, q, ids, form=form, **kw)
        if not same_bits(got, want):
            raise AssertionError(f"K2 {site}, form {form}: differs from the plain version, max abs "
                                 f"err {max_abs_err(got, want)}")
    del got
    qc, r = ids.shape
    n, lanes = db.shape
    ent = {"site": site, "launches": launches, "qc": qc, "r": r, "n": n, "lanes": lanes,
           "parts": kw.get("parts", 1), "err": 0.0, "form": k2_plan(qc, r, n, lanes, sms).form}
    if dev.type != "cuda":
        return ent
    reps = 20 if qc * r * lanes < 1 << 28 else 10
    for form in K2_FORMS:
        ent[f"ms_{form}"] = event_ms(lambda: gather_hamming(db, q, ids, form=form, **kw), reps)
    ent["ms"] = event_ms(lambda: gather_hamming(db, q, ids, **kw), reps)
    # every kernel of the launch (the row-grouped form's grouping included),
    # without the host time that event timing of a small launch reads
    ent["device_ms"] = device_ms(lambda: gather_hamming(db, q, ids, **kw), reps, "")
    ent["plain_ms"] = event_ms(lambda: gather_hamming_plain(db, q, ids, **kw), 2)
    ent.update(k2_bound(db, ids, sms))
    ent["of_bound"] = ent["bound_ms"] / min(ent["ms"], ent["device_ms"] or ent["ms"])
    cuda_lib.launches.update(saved)
    return ent


def print_k2_site(ent: dict) -> None:
    print(f"  K2 {ent['site']}: Qc={ent['qc']} R={ent['r']} N={ent['n']} lanes={ent['lanes']} "
          f"parts={ent['parts']}, {ent['launches']} launch(es) on the main path: query-major "
          f"{ent['ms_query']:.4f} ms, row-grouped {ent['ms_row']:.4f} ms, plan ({ent['form']}) "
          f"{ent['ms']:.4f} ms (device only {ent['device_ms']} ms), plain {ent['plain_ms']:.3f} ms, "
          f"bound {ent['bound_ms']:.4f} ms ({ent['bound_by']}, {ent['unique_rows']} unique rows): "
          f"{100 * ent['of_bound']:.0f}% of it")


def phase_tiers(dev, cfg, pb, counts: dict) -> dict:
    """The graph index's routes and tiers against the exact oracle; the
    launches of the routes (not of the oracle) go into counts."""
    import gsearch_tpu_torch.index.hnsw as hnsw_mod
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import bucketed_knn

    index = pb["index"]
    n, k, nq = index.nb_points, cfg["knbn"], cfg["tier_queries"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    src = torch.randint(48, n, (nq,), generator=gen, device=dev).cpu().numpy()
    rows = torch.from_numpy(index.get_sigs()[src]).to(dev)
    q = torch.where(torch.rand(rows.shape, generator=gen, device=dev) < 0.05,
                    torch.rand(rows.shape, generator=gen, device=dev), rows)
    qn = q.cpu().numpy()
    t0 = time.perf_counter()
    true_d, _ = bucketed_knn(q.view(torch.int32), index._device_full_sigs(), k)
    t_oracle = time.perf_counter() - t0

    def request(route: str):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            d, ids = index.search(qn, k)
            times.append(time.perf_counter() - t0)
        got = index.stats["search"]
        if got["route"] != route:
            raise AssertionError(f"expected the {route} route, got {got}")
        return d, ids, times, dict(got)

    res = {"oracle_s": t_oracle}
    cuda_lib.reset_launches()
    d, full_ids, times, st = request("coarse")
    recall = _tie_aware(d, true_d)
    if st["tier"] != "full" or recall < 0.99:
        raise AssertionError(f"coarse route + full tier: recall@10 {recall} ({st})")
    res["coarse"] = {"recall": recall, "cold_s": times[0], "s": statistics.median(times[1:])}
    # one more coarse request with K2's calls recorded: the prefix rerank
    # (one launch over the batch) and the full tier's
    with K2Recorder(keep=2) as rec:
        index.search(qn, k)
    if index.stats["search"]["route"] != "coarse" or rec.count != 2:
        raise AssertionError(f"expected the coarse route's two K2 calls, got {rec.count}")
    res["k2_sites"] = [k2_site(dev, "coarse prefix rerank", rec.calls[0], 1),
                       k2_site(dev, "full tier", rec.calls[1], 1)]
    del rec

    # per-row budgets (x next_pow2(n) + 1) in the middle of each packed
    # tier's range under the reference's rule (hnsw._rerank_tier): at
    # S = 12000 the full tier needs 49,152 bytes a row, packed 16-bit 24,576
    # of 0.7 of the budget, packed8 12,288, packed4 8,192
    nbp1 = (1 << (n - 1).bit_length()) + 1
    s = index.sketch_size
    full_row = 4 * -(-s // 1024) * 1024
    p16, p8, p4 = (b / 0.7 for b in (4 * -(-s // 2048) * 1024, -(-s // 4096) * 4096,
                                     -(-s // 8192) * 4096))
    saved = hnsw_mod._RERANK_DEVICE_BYTES
    index._device_full = None
    torch.cuda.empty_cache()
    for kind, lo, hi, need in (("packed", p16, full_row, 0.95), ("packed8", p8, p16, 0.9),
                               ("packed4", p4, p8, 0.9)):
        per_row = int((lo + hi) / 2)
        hnsw_mod._RERANK_DEVICE_BYTES = per_row * nbp1
        if index._rerank_tier()[0] != kind:
            raise AssertionError(f"budget {per_row} x {nbp1} chose {index._rerank_tier()}, not {kind}")
        d, ids, times, st = request("coarse")
        overlap = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, full_ids)]))
        if st["tier"] != kind or overlap < need:
            raise AssertionError(f"{kind} tier: id overlap with the full tier {overlap} < {need}")
        res[kind] = {"overlap": overlap, "recall": _tie_aware(d, true_d), "cold_s": times[0],
                     "s": statistics.median(times[1:])}
        with K2Recorder(keep=2) as rec:  # the prefix rerank's call, then the tier's
            index.search(qn, k)
        if rec.count != 2:
            raise AssertionError(f"{kind} tier: {rec.count} K2 calls, expected 2")
        res["k2_sites"].append(k2_site(dev, f"{kind} tier", rec.calls[1], 1))
        del rec
    hnsw_mod._RERANK_DEVICE_BYTES = saved
    index._device_packed = None
    torch.cuda.empty_cache()

    index.COARSE_MIN = 1 << 62  # force the beam route on this index
    d, ids, times, st = request("beam")
    with K2Recorder(keep=1) as rec:  # the hops' K2 calls, then the full tier's
        index.search(qn, k)
    hops = index.stats["search"]["hops"]
    if rec.count != hops + 1:
        raise AssertionError(f"beam route: {rec.count} K2 calls for {hops} hops")
    res["k2_sites"].append(k2_site(dev, "beam hop (the first)", rec.calls[0], hops))
    del rec, index.COARSE_MIN
    recall = _tie_aware(d, true_d)
    if recall < 0.99:
        raise AssertionError(f"beam route: recall@10 {recall} ({st})")
    res["beam"] = {"recall": recall, "cold_s": times[0], "s": statistics.median(times[1:]),
                   "hops": st["hops"]}
    counts.update(cuda_lib.launches)
    for name in ("gather_hamming", "gather_hamming_p2", "gather_hamming_p4", "gather_hamming_p8",
                 "int_mm", "hamming_frac"):
        if counts[name] == 0:
            raise AssertionError(f"the tier phase never launched {name}: {counts}")
    print(f"phase tiers {nq} queries x {n} x {index.sketch_size}, k={k}: coarse+full recall@10 "
          f"{res['coarse']['recall']:.4f}; id overlap with full: packed {res['packed']['overlap']:.4f}, "
          f"packed8 {res['packed8']['overlap']:.4f}, packed4 {res['packed4']['overlap']:.4f}; "
          f"beam recall@10 {res['beam']['recall']:.4f} in {st['hops']} hops")
    return res


def run(dev: torch.device, cfg: dict, root: str, card: str) -> dict:
    from gsearch_tpu_torch.ops import cuda_lib

    clock = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        clock[name] = time.perf_counter() - t0
        print(f"  [{name}: {clock[name]:.1f} s]")
        return out

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = timed("phase 2", phase_k1, dev, cfg, gen)
    k2 = timed("phase 3", phase_k2, dev, cfg, gen)
    k2p = timed("phase K2-packed", phase_k2_packed, dev, cfg, gen)
    torch.cuda.empty_cache()

    cuda_lib.reset_launches()
    p4 = timed("phase 4", phase_cli, dev, cfg, root)
    k1_phase4 = cuda_lib.launches["hamming_frac"]
    p5 = timed("phase 5", phase_grown, dev, cfg, root, p4)
    flat_counts = dict(cuda_lib.launches)
    if k1_phase4 == 0:
        raise AssertionError("phase 4 never launched K1")
    if flat_counts["gather_hamming"] == 0 or flat_counts["int_mm"] == 0:
        raise AssertionError(f"phase 5 did not go through K2 and the int8 matmul: {flat_counts}")
    print(f"main-path launches, flat index (phases 4-5): {flat_counts}")
    timed("phase 5 sketch check", check_sketch_against_cpu, dev, cfg, p4["db"])

    cuda_lib.reset_launches()
    pb = timed("phase hnsw-build", phase_hnsw_build, dev, cfg, root, p4)
    build_counts = dict(cuda_lib.launches)
    pr = timed("phase hnsw-request", phase_hnsw_request, dev, cfg, root, p4, pb)
    request_counts = {k: v - build_counts[k] for k, v in cuda_lib.launches.items()}
    pa = timed("phase hnsw-add", phase_hnsw_add, dev, cfg, root, p4, pb)
    graph_counts = dict(cuda_lib.launches)
    if build_counts["gather_hamming_p2"] == 0 or build_counts["hamming_frac_self"] == 0:
        raise AssertionError(f"the bulk build did not go through K2 parts=2 and K1's self pairs: "
                             f"{build_counts}")
    if request_counts["gather_hamming"] == 0 or request_counts["int_mm"] == 0:
        raise AssertionError(f"the graph request did not go through K2 and the int8 matmul: "
                             f"{request_counts}")
    add_counts = {k: v - build_counts[k] - request_counts[k] for k, v in graph_counts.items()}
    if add_counts["hamming_frac_self"] == 0 or add_counts["hamming_frac"] == 0:
        raise AssertionError(f"the beam-insert add did not go through K1 and its self pairs: "
                             f"{add_counts}")
    print(f"main-path launches, graph index (hnsw-build to hnsw-add): {graph_counts}")
    tier_counts = {}
    tiers = timed("phase tiers", phase_tiers, dev, cfg, pb, tier_counts)
    print(f"main-path launches, tiers: {tier_counts}")
    graph = {"build_s": pb["build_s"], "dump_s": pb["dump_s"], "stages": pb["stages"],
             "request_s": pr["request_s"]}
    k2_sites = [p5["k2_site"], pb["k2_site"], *tiers["k2_sites"]]
    del pb
    launches = {k: flat_counts[k] + graph_counts[k] + tier_counts[k] for k in flat_counts}

    t = timed("phase 6", phase_timings, dev, cfg, p4, p5)
    k2_sites.insert(1, t["k2_site"])
    print(f"phase 6 timings on {card}:")
    print(f"  tohnsw {p4['bases'] / 1e6:.1f} Mbases end to end {p4['build_s']:.2f} s; "
          f"request 8 queries: {p4['request_s']:.2f} s at 48 genomes, "
          f"{p5['request_s']:.2f} s at {cfg['n_total']} (CLI wall, parse and load included)")
    print(f"  sketch {t['mbases']:.1f} Mbases in {t['sketch_s']:.3f} s: {t['sketch_mbases_s']:.1f} Mbases/s")
    print(f"  request {cfg['bench_queries']} queries x {cfg['n_total']} x {cfg['sketch']}, "
          f"k={cfg['knbn']}: {t['request_s'] * 1e3:.1f} ms, {t['qps']:.0f} qps")
    if dev.type == "cuda":
        print(f"  K1 {cfg['k1']} ({k1['plan']['tile']}, {k1['plan']['splits']} splits): kernel "
              f"{k1['ms']:.4f} ms (wide {k1['ms_wide']:.4f}, narrow16 {k1['ms_narrow16']:.4f}, "
              f"narrow8 {k1['ms_narrow8']:.4f}), plain {k1['plain_ms']:.3f} ms, cdist(p=0) "
              f"{k1['library_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}); "
              f"device only (profiler) {k1['device_ms']} ms")
        print(f"  K1 8x48 (phase 4's request; {k1['plan_8x48']['tile']}, {k1['plan_8x48']['splits']} "
              f"splits): kernel {k1['ms_8x48']:.4f} ms (device only {k1['device_ms_8x48']} ms), "
              f"plain {k1['plain_ms_8x48']:.4f} ms, cdist {k1['library_ms_8x48']:.4f} ms, bound "
              f"{k1['bound_ms_8x48']:.5f} ms")
        print(f"  K1 512 x {cfg['k1'][1]}: kernel {k1['ms_512']:.4f} ms, bound {k1['bound_ms_512']:.4f} ms; "
              f"under 400 back-to-back launches the SM clock read {k1['load_512']['sm_clock_mhz']} MHz "
              f"at {k1['load_512']['power_w']} W")
        sp = k1["self"]
        print(f"  K1 self pairs {cfg['k1_batch']}: kernel {sp['ms']:.4f} ms (both triangles "
              f"{sp['ms_both_triangles']:.4f}), plain {sp['plain_ms']:.3f} ms, cdist "
              f"{sp['library_ms']:.3f} ms, bound {sp['bound_ms']:.4f} ms ({sp['bound_by']})")
        print(f"  K2 {cfg['k2']} (synthetic ids): query-major {k2['ms_query']:.4f} ms, row-grouped "
              f"{k2['ms_row']:.4f} ms, plan ({k2['form']}) {k2['ms']:.4f} ms, plain {k2['plain_ms']:.3f} "
              f"ms, bound {k2['bound_ms']:.4f} ms ({k2['unique_rows']} unique rows)")
        for parts, ent in k2p.items():
            print(f"  K2 parts={parts} {cfg['k2p']} x {ent['lanes']} lanes (synthetic ids): query-major "
                  f"{ent['ms_query']:.4f} ms, row-grouped {ent['ms_row']:.4f} ms, plan ({ent['form']}) "
                  f"{ent['ms']:.4f} ms, plain {ent['plain_ms']:.3f} ms, bound {ent['bound_ms']:.4f} ms "
                  f"({ent['unique_rows']} unique rows)")
        for ent in k2_sites:
            print_k2_site(ent)
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in graph["stages"].items())
    print(f"  graph {cfg['hnsw_total']} x {cfg['sketch']}: bulk build {graph['build_s']:.1f} s "
          f"({stages}); dump {graph['dump_s']:.1f} s; CLI request of 8 genomes "
          f"{graph['request_s']:.1f} s")
    for name in ("coarse", "packed", "packed8", "packed4", "beam"):
        ent = tiers[name]
        extra = f", {ent['hops']} hops, {ent['s'] / ent['hops'] * 1e3:.2f} ms a hop" if "hops" in ent else ""
        print(f"  request {cfg['tier_queries']} queries, route {name}: {ent['s'] * 1e3:.1f} ms warm "
              f"({ent['cold_s']:.2f} s cold){extra}")
    print(f"  graph CLI: add of 8 genomes {pa['add_s']:.1f} s, request {pa['request_s']:.1f} s")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()))
    src = "gsearch_tpu_torch/csrc/hamming.cu"

    def entry(name, replaces, err, ent, library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err, "ms": ent.get("ms"),
                "plain_ms": ent.get("plain_ms"), "bound_ms": ent.get("bound_ms"),
                "bound_by": ent.get("bound_by"), "library_ms": library_ms, **extra}

    k1_extra = {k: k1.get(k) for k in ("ms_wide", "ms_narrow16", "ms_narrow8", "ms_8x48",
                                       "plain_ms_8x48", "library_ms_8x48", "bound_ms_8x48",
                                       "device_ms", "device_ms_8x48", "ms_512", "bound_ms_512",
                                       "load_512", "plan")}
    kernels = [
        entry("hamming_frac", "gsearch_tpu/ops/distance.py:69", k1["err"], k1, k1.get("library_ms"),
              shape=list(cfg["k1"]), **k1_extra),
        entry("hamming_frac_self", "gsearch_tpu/ops/distance.py:69", k1["self"]["err"], k1["self"],
              k1["self"].get("library_ms"), shape=list(cfg["k1_batch"]),
              ms_both_triangles=k1["self"].get("ms_both_triangles")),
        entry("gather_hamming", "gsearch_tpu/ops/distance.py:154", k2["err"], k2,
              shape=list(cfg["k2"]), form=k2.get("form"), ms_query=k2.get("ms_query"),
              ms_row=k2.get("ms_row"), main_path=[e for e in k2_sites if e["parts"] == 1]),
    ]
    for parts, line in ((2, 201), (4, 207), (8, 217)):
        ent = k2p[parts]
        kernels.append(entry(f"gather_hamming_p{parts}", f"gsearch_tpu/ops/distance.py:{line}",
                             ent["err"], ent, shape=[*cfg["k2p"], ent["lanes"]], form=ent.get("form"),
                             ms_query=ent.get("ms_query"), ms_row=ent.get("ms_row"),
                             main_path=[e for e in k2_sites if e["parts"] == parts]))
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from gsearch_tpu_torch.ops import cuda_lib

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    from gsearch_tpu_torch.io import native

    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"phase 1 kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({cuda_lib.library_path()})")
    t0 = time.perf_counter()
    native.build()  # raises when the FASTA parser does not build
    print(f"phase 1 FASTA parser built in {time.perf_counter() - t0:.1f} s "
          f"({native.library_path()}); parser in use: {native.parser()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        record = run(dev, FULL, root, card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
