#!/usr/bin/env python3
"""Drive gsearch_tpu_torch's main path once on one CUDA card and check it.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
Every phase raises on failure, so any fault exits non-zero; without a
CUDA card it exits non-zero before printing any result.

  1. the card's name and power limit; build the CUDA kernels (timed);
  2. K1 (`hamming_frac`) against its plain version at Q=37, N=4095,
     S=12000, f32 and int32 inputs: bitwise equal;
  3. K2 (`gather_hamming`) against its plain version at Qc=1024, R=80,
     N=65536, S=12000 with repeated and out-of-range ids: bitwise equal;
  4. signatures on the card equal the CPU path's on a small input; then
     the CLI slice in-process: a seeded corpus of 48 genomes (1.5-6 Mb,
     8 clusters, some past the 4 Mb block so the piece path runs, some
     with N runs) and 8 queries (1%-mutated members) through
     `tohnsw -k 16 -s 12000 --algo optdens --block`, `request -n 10` and
     `reformat 16 1`: each query's best hit is its source at ANI 99 +- 0.5;
  5. the same request against that database grown to 65,536 genomes with
     seeded uniform decoy signatures: the neighbours file is byte-identical;
  6. timings beside the card's name: sketch Mbases/s, request qps at
     65,536 x 12,000 (1,024 queries, k = 10), K1 and K2 against their
     plain versions.
The launch counters are zeroed just before phase 4 and read after phase 5:
K1 must have run in phase 4, K2 and the int8 matmul in phase 5.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
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
    "k2": (1024, 80, 65536, 12000),    # Qc, R, N, S
    "lengths": (1_500_000, 6_000_000),  # genome length range of the corpus
    "clusters": 8, "per_cluster": 6,
    "kmer": 16, "sketch": 12000,
    "n_total": 65536, "bench_queries": 1024, "knbn": 10,
}


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


def phase_k1(dev, cfg, gen) -> dict:
    """K1 at the issue's ragged shape, at phase 4's request shape (both split
    S over blocks) and at a shape whose tiles fill the card unsplit."""
    from gsearch_tpu_torch.ops.distance import hamming_frac, hamming_frac_plain

    nq, n, s = cfg["k1"]
    res = {}
    for dtype in (torch.float32, torch.int32):
        db = torch.rand((n, s), generator=gen, device=dev)
        if dtype == torch.int32:
            db = (db * 4).to(torch.int32)
        src = torch.randint(0, n, (512,), generator=gen, device=dev)
        qs = perturbed(db[src], gen)
        errs = []
        for rows, cols in ((nq, n), (8, 48), (512, n)):
            q, d = qs[:rows].contiguous(), db[:cols].contiguous()
            got, want = hamming_frac(q, d), hamming_frac_plain(q, d)
            if not same_bits(got, want):
                raise AssertionError(f"K1 {dtype} at Q={rows} N={cols} differs from its plain "
                                     f"version: max abs err {max_abs_err(got, want)}")
            errs.append(max_abs_err(got, want))
        res[str(dtype)] = max(errs)
        if dtype == torch.float32 and dev.type == "cuda":
            q = qs[:nq].contiguous()
            res["ms"] = event_ms(lambda: hamming_frac(q, db), 20)
            res["plain_ms"] = event_ms(lambda: hamming_frac_plain(q, db), 3)
            small = (qs[:8].contiguous(), db[:48].contiguous())
            res["ms_8x48"] = event_ms(lambda: hamming_frac(*small), 50)
            res["plain_ms_8x48"] = event_ms(lambda: hamming_frac_plain(*small), 50)
    print(f"phase 2 K1 S={s} at Q x N = {nq} x {n}, 8 x 48 and 512 x {n}: f32 and int32 "
          "bitwise equal to the plain version")
    return res


def phase_k2(dev, cfg, gen) -> dict:
    from gsearch_tpu_torch.ops.distance import gather_hamming, gather_hamming_plain

    qc, r, n, s = cfg["k2"]
    db = torch.rand((n, s), generator=gen, device=dev)
    src = torch.randint(0, n, (qc,), generator=gen, device=dev)
    q = perturbed(db[src], gen)
    ids = torch.randint(0, n, (qc, r), generator=gen, device=dev, dtype=torch.int32)
    ids[:, 1] = src.to(torch.int32)          # each query's source row
    ids[:, r // 2:] = ids[:, : r - r // 2]   # every id repeated
    ids[0, 0], ids[1, 0], ids[2, 0] = -1, n, 2**31 - 1  # out of range -> +inf
    got, want = gather_hamming(db, q, ids), gather_hamming_plain(db, q, ids)
    if not same_bits(got, want):
        raise AssertionError(f"K2 differs from its plain version: max abs err {max_abs_err(got, want)}")
    if not bool(torch.isinf(got[:3, 0]).all()):
        raise AssertionError("K2: out-of-range ids must give +inf")
    res = {"err": max_abs_err(got, want)}
    if dev.type == "cuda":
        res["ms"] = event_ms(lambda: gather_hamming(db, q, ids), 10)
        res["plain_ms"] = event_ms(lambda: gather_hamming_plain(db, q, ids), 2)
    print(f"phase 3 K2 Qc={qc} R={r} N={n} S={s}: bitwise equal to the plain version")
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


def check_sketch_against_cpu(dev, cfg) -> None:
    """The card's signatures equal the CPU path's (which the tier-1 tests
    hold bit-exact to gsearch_tpu) on a small input crossing the piece path."""
    from gsearch_tpu.core.params import SeqSketcherParams
    from gsearch_tpu_torch.models import make_sketcher

    rng = np.random.default_rng(SEED)
    genomes = [rng.integers(0, 4, n, dtype=np.uint8) for n in (10, 12_000, 70_001)]
    genomes[2][1000:2500] = 255  # an N run heavy enough for per-piece buckets
    params = SeqSketcherParams(kmer_size=cfg["kmer"], sketch_size=cfg["sketch"],
                               algo="OPTDENS", data_t="DNA")
    sigs = []
    for d in (dev, torch.device("cpu")):
        sk = make_sketcher(params, device=d)
        sk.MAX_BLOCK_LOG2 = 14
        sigs.append(sk.sketch_many(genomes))
    if sigs[0].shape != (3, cfg["sketch"]) or not np.isfinite(sigs[0]).all():
        raise AssertionError("card signatures have the wrong shape or non-finite values")
    if not np.array_equal(sigs[0].view(np.uint32), sigs[1].view(np.uint32)):
        raise AssertionError("signatures on the card differ from the CPU path")
    print("phase 4 signatures on the card bitwise equal to the CPU path (3 genomes, piece path)")


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
    return {"db": db, "neighbours": neighbours, "q_dir": corpus["q_dir"],
            "db_dir": corpus["db_dir"], "bases": corpus["bases"], "write_s": t_write,
            "build_s": t_build, "request_s": t_request}


def phase_grown(dev, cfg, root, p4) -> dict:
    from gsearch_tpu.core import ProcessingParams, ProcessingState, SeqDict
    from gsearch_tpu.core.seqdict import Id, ItemDict
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.index.serialize import dumpall, load_index

    index = load_index(p4["db"], dev)
    seqdict = SeqDict.reload_json(p4["db"])
    params = ProcessingParams.reload_json(p4["db"])
    state = ProcessingState.reload_json(p4["db"])
    n_decoy = cfg["n_total"] - index.nb_points
    gen = torch.Generator().manual_seed(SEED)
    index.insert(torch.rand((n_decoy, index.sketch_size), generator=gen).numpy())
    for i in range(n_decoy):
        seqdict.push(ItemDict(id=Id(path=f"decoys/d{i}.fna", fasta_id=f"d{i}"), len=0))
    state.nb_seq = len(seqdict)
    db = os.path.join(root, "db65k")
    dumpall(db, index, seqdict, params, state)
    out = os.path.join(root, "req65k")
    t0 = time.perf_counter()
    rc = main(["request", "-b", db, "-n", str(cfg["knbn"]), "-r", p4["q_dir"], "-o", out,
               "--device", dev.type])
    t_request = time.perf_counter() - t0
    assert rc == 0, "request at 65k failed"
    with open(p4["neighbours"]) as a, open(os.path.join(out, "gsearch.neighbors.txt")) as b:
        want, got = a.read(), b.read()
    if got != want:
        diff = "".join(list(difflib.unified_diff(
            want.splitlines(True), got.splitlines(True), "48 genomes", f"{cfg['n_total']} genomes"))[:60])
        raise AssertionError(f"neighbours file at {cfg['n_total']} genomes differs from phase 4's:\n{diff}")
    print(f"phase 5 request at {cfg['n_total']} genomes: neighbours file byte-identical")
    return {"db": db, "request_s": t_request}


def phase_timings(dev, cfg, p4, p5) -> dict:
    """Sketch throughput on the parsed corpus and request qps at full N."""
    from gsearch_tpu.core import ProcessingParams
    from gsearch_tpu.io.fasta import concat_file_codes_packed
    from gsearch_tpu.io.walk import walk_fasta_dir
    from gsearch_tpu_torch.index.serialize import load_index
    from gsearch_tpu_torch.models import make_sketcher

    params = ProcessingParams.reload_json(p4["db"])
    genomes = [concat_file_codes_packed(p)[0] for p in walk_fasta_dir(p4["db_dir"])]
    sketcher = make_sketcher(params.sketch, device=dev)
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
    return {"sketch_mbases_s": mbases / min(times), "sketch_s": min(times), "mbases": mbases,
            "request_s": statistics.median(qtimes), "qps": nq / statistics.median(qtimes)}


def run(dev: torch.device, cfg: dict, root: str, card: str) -> dict:
    from gsearch_tpu_torch.ops import cuda_lib

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = phase_k1(dev, cfg, gen)
    k2 = phase_k2(dev, cfg, gen)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    check_sketch_against_cpu(dev, cfg)
    cuda_lib.reset_launches()
    p4 = phase_cli(dev, cfg, root)
    k1_phase4 = cuda_lib.launches["hamming_frac"]
    p5 = phase_grown(dev, cfg, root, p4)
    counts = dict(cuda_lib.launches)
    if k1_phase4 == 0:
        raise AssertionError("phase 4 never launched K1")
    if counts["gather_hamming"] == 0 or counts["int_mm"] == 0:
        raise AssertionError(f"phase 5 did not go through K2 and the int8 matmul: {counts}")
    print(f"main-path launches: {counts}")

    t = phase_timings(dev, cfg, p4, p5)
    print(f"phase 6 timings on {card}:")
    print(f"  tohnsw {p4['bases'] / 1e6:.1f} Mbases end to end {p4['build_s']:.2f} s; "
          f"request 8 queries: {p4['request_s']:.2f} s at 48 genomes, "
          f"{p5['request_s']:.2f} s at {cfg['n_total']} (CLI wall, parse and load included)")
    print(f"  sketch {t['mbases']:.1f} Mbases in {t['sketch_s']:.3f} s: {t['sketch_mbases_s']:.1f} Mbases/s")
    print(f"  request {cfg['bench_queries']} queries x {cfg['n_total']} x {cfg['sketch']}, "
          f"k={cfg['knbn']}: {t['request_s'] * 1e3:.1f} ms, {t['qps']:.0f} qps")
    if dev.type == "cuda":
        print(f"  K1 {cfg['k1']}: kernel {k1['ms']:.3f} ms, plain {k1['plain_ms']:.3f} ms; "
              f"8x48 (phase 4): kernel {k1['ms_8x48']:.4f} ms, plain {k1['plain_ms_8x48']:.4f} ms")
        print(f"  K2 {cfg['k2']}: kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms")
    return {"kernels": [
        {"name": "hamming_frac", "route": "cuda", "source": "gsearch_tpu_torch/csrc/hamming.cu",
         "replaces": "gsearch_tpu/ops/distance.py:69", "launches": counts["hamming_frac"],
         "max_abs_err": max(k1[str(torch.float32)], k1[str(torch.int32)]),
         "ms": k1.get("ms"), "plain_ms": k1.get("plain_ms")},
        {"name": "gather_hamming", "route": "cuda", "source": "gsearch_tpu_torch/csrc/hamming.cu",
         "replaces": "gsearch_tpu/ops/distance.py:154", "launches": counts["gather_hamming"],
         "max_abs_err": k2["err"], "ms": k2.get("ms"), "plain_ms": k2.get("plain_ms")},
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from gsearch_tpu_torch.ops import cuda_lib

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"phase 1 kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({cuda_lib.library_path()})")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        record = run(dev, FULL, root, card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
