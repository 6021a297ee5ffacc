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
  sharded. phase 4's 48 genomes plus clustered decoys (make_decoys) to
     65,536 x 12,000 in a 4-shard `hnsw_sharded` database (what a
     four-chip `--mesh 4` build writes; each shard takes the beam-insert
     build), dumped beside phase 4's seqdict: CLI `request` equal to phase
     4's file in the shards' merge order (ties between shards go to the
     lower shard); CLI `add` of the 8 queries to a copy, then each best hit
     is itself; 1,024 decoy members (5% of slots redrawn) by
     `index.search`, tie-aware recall@10 >= 0.99 against K1 over all
     rows; the first beam hop of shard 0 recorded (a K2 site).
  analysis. the same 65,536 rows as a flat database too: CLI `hnsw2knn -n
     10` of both byte-identical, recall@10 >= 0.99 of the graph on 1,024
     nodes against K1; `ann --stats --embed` (hierarchical init) with
     quality < 1.0 and species separated (intra < 0.5 x inter); `hnswcore
     --coreset 256 --cluster 16`, hamming and l2, both CSVs; the k-NN
     self-search's first rerank (a K2 site) and the coreset's [256, N]
     assignment, [1, N] draw and [256, 256] medoid block (K1 sites); at
     48 genomes, hnsw2knn and hnswcore files on the card equal the CPU's.
  mesh. parallel/mesh.py with 4 members on the one card: (a) phase 4's 48
     genomes sketched data-parallel equal phase 4's signatures bitwise;
     (b) MeshSearcher over 262,144 x 12,000 clustered rows drawn on the
     card (1,024 queries, k = 10) bitwise equal to one K1 sweep with a
     stable top-k; a member's K1 sweep [1,024, 65,536] x 12,000 held
     bitwise against its plain version (a K1 site); (c) MeshMxuSearcher on
     the same rows: recall@10 >= 0.95 against (b), nearest distances within
     3/S, its K2 parts=2 call recorded (a K2 site); (d) MeshGraphSearcher
     over the sharded phase's database (4 shards, one a member): tie-aware
     recall@10 no less than the sequential search's minus 0.05, its rerank
     and first beam hop recorded (K2 sites); phase 4's 8 queries through
     `request_database` with the mesh find their sources at ANI 99 +- 0.5;
     (e) two processes on the card, 2 members each, over gloo (started
     after (b), collected after (f)): their lists over the first 65,536
     rows equal K1's over those rows; (f) CLI `tohnsw --mesh -1` and
     `request --mesh -1` of phase 4's corpus write phase 4's neighbours
     file byte for byte, and `--mesh 2` on a one-card machine raises the
     count error.
  superani. CLI `superani --model none` of phase 4's 8 queries x 48
     genomes: each best hit among the pairs aligned over half the query
     is its source at ANI 99 +- 0.5 (a chain of a few chance seed matches
     reads 100 over a sliver of a genome); the seed sketch
     of a genome past the 4 Mb block on the card equals the CPU's; sketch
     Mbases/s and compare pairs/s.
  algos. the other four sketching algorithms and amino-acid mode, at
     s = 12,000 through the CLI: for each of prob, super, super2 and hll,
     `tohnsw --block` of phase 4's corpus and `request` of its 8 queries
     (every best hit is the planted genome); then a seeded corpus of 48
     proteomes (.faa, 1-2 M residues, 8 clusters, 8 queries at 2%
     substitutions) through `tohnsw --aa -k 7` with optdens and prob.  For
     each build, the card's signatures of a genome above the 4 M block, one
     with N runs and a slice through the piece path are held against the
     port's CPU sketcher: bitwise (super, super2, optdens) or at most 1e-4
     of the slots (prob, hll: a float64 log rounded to f32 on both sides),
     the fraction printed; one timing line an algorithm.  K1 on the u32
     rows of prob's database (NaN patterns, -0.0 and equal low halves
     planted) and the u16 rows of hll's, widened, at 8 x 48 x 12,000,
     bitwise against the plain version and equal to integer equality on the
     host (K1 sites); prob's and hll's databases grown with seeded decoys
     to 8,192 rows, so the CLI request goes through the sign-expansion
     searcher and K2 on u32 and widened-u16 bits: the neighbours file is
     byte-identical, ids and distances equal `brute_force_knn`'s, K2's call
     recorded (K2 sites); `bindash` on 48 x 48 genomes at s = 12,000, its K1
     call held against the plain version; 64 sparse genomes of 600 bases
     through prob's sketcher on the card and the CPU: found slots equal,
     the share of genomes whose empty slots differ under 0.35.
  bigsig. `bigsig construct` over phase 4's 48 genomes at the defaults
     (bloom 25,000,000, 2 hashes, k = 21); `identify` of 262,144 seeded
     256-base reads (7/8 exact N-free substrings of the genomes, 1/8
     random): every exact read's source holds its largest hit count, at
     most 1% of random reads classified; 65,536 FASTQ pairs (600-base
     fragments, second mate reverse-complemented, 1% substitutions, 0.5%
     of qualities under -Q 15): at least half classified, 99% of those to
     their source; one batch's counts on the card equal the CPU path's;
     the counts pass over every read timed at 48 genome columns and with
     the device matrix widened to 1,024 columns (seeded random bits at the
     real genomes' mean fill), the real columns' counts unchanged.
  import. phase 4's 48 signatures plus the sharded phase's clustered
     decoys to 65,536 x 12,000 f32 (GTDB r207 scale), written as a
     reference-format (hnsw_rs) dump; CLI `import --index auto` (flat) and
     `--index hnsw` (the bulk build), each then CLI `request -n 10` of
     phase 4's queries: both neighbours files byte-identical to phase 4's;
     each import's read / build / dump and the build's passes timed.
  hmmsearch. 120 seeded HMMER3 profiles of 100-1,000 nodes (`*` at the
     last node, GA and STATS lines) and a proteome of 512 proteins of
     50-1,500 residues (an eighth of a bacterial proteome: at 1,024 the
     phase took 64 s on an H100), 120 of them carrying a profile's sampled
     sequence at 20% mutation: CLI `hmmsearch --cut_ga` puts each planted protein at
     the top of its profile; Viterbi and Forward of the 8 shortest profiles
     x 64 proteins (their planted ones among them) on the card within
     HMM_BITS_RTOL of the CPU path; DP cells a second an algorithm.
  genepred. 8 seeded prokaryote-like genomes of 2-5.5 Mb (30 Mbases;
     tests/torch_synth.synth_genome: planted genes on both strands,
     codon-biased bodies, real start and stop codons, ~0.87 coding;
     genome 0 with N runs, genome 1 in four contigs, one under 8,192
     bases) through CLI `genepred -t standard` on the card: gene recall
     and precision against the planted truth (a call is right when it
     shares its 3' end and strand) at or above the floors set from the
     CPU rehearsal; `-t self` on genome 0, timed; genome 0 again with
     `--device cpu`, `-t standard` and `-t self`: every contig's decoded
     path equal to the card's and the four files byte-identical; the
     proteomes of the eight genomes through `tohnsw --aa -k 7` and those
     of 1%-substituted copies of two of them through `request` (K1 on the
     card): each query's best hit is its source; the fused decode
     (`gs_genepred_decode`, codes to path in one launch) against the plain
     composition (`_precompute_scores` then `viterbi_plain`) on the card,
     bitwise, at one 64-window dispatch and at the largest genome's
     windows, with the standard tables and with genome 0's self-trained
     ones, and the memory-fed `gs_viterbi` against `viterbi_plain`; each
     timed (CUDA events over launches, and around the bare ctypes call as
     the device-only time) beside its bound and serial chain; the
     genome's `_decode_path` wall with both table sets.
  K2 sites.  Each recorded call is re-run with its own arguments: every
     form bitwise against the plain version, timed under each form, the
     plan's and the plain version (CUDA events; device-only time from
     torch.profiler), beside the bound of the unique rows it references and
     the number of such launches on the main path.
The launch counters are zeroed just before each main-path run and read just
after it: phases 4-5 (K1 in phase 4, K2 and the int8 matmul in phase 5);
hnsw-build to hnsw-add (K2 parts=2 and K1's self pairs in the bulk build,
K2 and the int8 matmul in the request, K1 and its self pairs in the add);
tiers (K2 parts=4 and 8); sharded (K2 in the shards' beam hops, K1's
self pairs in the add); analysis (K1 in the coreset, K2 and the int8
matmul in the k-NN self-search); mesh (K1 in the members' sweeps and
entry tiers, K2 parts=2 and the int8 matmul in the compact members, K2
in the graph members' hops and reranks; the two processes' launches are
their own); superani (none: plain torch); bigsig
(none: plain torch); import (K2 parts=2 and K1's self pairs in the bulk
build, K2 and the int8 matmul in the requests); hmmsearch (none: plain
torch); genepred (the fused decode kernel in every CLI run, K1 in the
AA request; `gs_viterbi`, the memory-fed form, is off the main path);
algos (K1 by every build's request and by bindash, K2 and the int8 matmul
by the grown databases).  The line before the last
is the kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import difflib
import json
import os
import shutil
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
    "algos": ("prob", "super", "super2", "hll"), "aa_algos": ("optdens", "prob"),
    "aa_kmer": 7, "aa_lengths": (1_000_000, 2_000_000), "aa_record": 500,
    "grown_total": 8192, "piece_log2": 16, "piece_len": 300_000,
    "shard_total": 65536, "n_shards": 4, "shard_queries": 1024, "knn_batch": 4096,
    "coreset": 256, "cluster": 16, "sparse_genomes": 64, "sparse_len": 600,
    "bigsig": {"bloom": 25_000_000, "reads": 262_144, "read_len": 256, "pairs": 65_536,
               "batch": 4096, "columns": 1024},
    "import_total": 65536,
    # the mesh: members on the one card, the row-sharded database, its
    # queries, and the rows the two processes share
    "mesh_members": 4, "mesh_total": 262144, "mesh_queries": 1024, "mesh_process_rows": 65536,
    "hmm_profiles": 120, "hmm_lengths": (100, 1001), "proteome": 512, "prot_lengths": (50, 1501),
    "hmm_check": (8, 64),
    # planted prokaryote genomes (~30 Mbases); genome 0 has N runs and takes
    # -t self and the card-vs-CPU check, genome 1 is in four contigs; the AA
    # chain's queries are 1%-substituted copies of genomes 2 and 5
    "genepred": {"genomes": 8, "lengths": (2_000_000, 5_500_000), "n_runs": 30,
                 "query_sources": (2, 5), "query_rate": 0.01, "dispatch": 64,
                 "recall_floor": 0.9, "precision_floor": 0.85},
}
# profile-HMM bits on the card against the CPU path: |diff| <= this x
# max(|bits|, 1), the bound tests/test_torch_hmmsearch.py holds the CPU path
# to gsearch_tpu by (4x the largest difference measured there)
HMM_BITS_RTOL = 1.4e-5
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
    from gsearch_tpu_torch.pipeline import read_genomes

    genomes = read_genomes(p4["db_dir"])
    sketch_s = sketch_seconds(dev, p4["db"], genomes, runs=2)
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
    return {"sketch_mbases_s": mbases / sketch_s, "sketch_s": sketch_s, "mbases": mbases,
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
    """While active, K2's calls made by the graph index, the searcher (the
    flat index goes through the searcher) and the mesh searchers are
    recorded: the arguments of the first `keep` that `where(i, db, q, ids,
    kw)` accepts (i the call's number; default: every call), and the count
    of all of them."""

    def __init__(self, keep: int, where=None):
        self.keep, self.where, self.calls, self.count = keep, where, [], 0

    def __enter__(self):
        import gsearch_tpu_torch.index.hnsw as hnsw_mod
        import gsearch_tpu_torch.ops.mxu as mxu_mod
        import gsearch_tpu_torch.parallel.mesh as mesh_mod
        from gsearch_tpu_torch.ops.distance import gather_hamming

        self.mods, self.real = (hnsw_mod, mxu_mod, mesh_mod), gather_hamming

        def recorder(db, q, ids, **kw):
            if len(self.calls) < self.keep and (self.where is None
                                                or self.where(self.count, db, q, ids, kw)):
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


def decoy_labels(cfg, n_real: int, n: int) -> dict:
    """The planted groups of make_decoys' rows past the n_real genomes
    (their clusters: c{c}_m{m} in walk order, per_cluster apiece): species
    of `per` consecutive rows, families of `species` species."""
    n_species = cfg["families"] * cfg["species"]
    per = -(-(n - n_real) // n_species)
    j = np.arange(n) - n_real
    species = np.where(j < 0, np.arange(n) // cfg["per_cluster"], n_species + j // per)
    family = np.where(j < 0, species, n_species + j // (per * cfg["species"]))
    return {"species": species, "family": family}


def shard_merge_order(neighbours: str, db: str, n_shards: int) -> str:
    """A neighbours file of the flat database at db (answers ordered by
    distance, then id) in the order the sharded merge gives: a distance tie
    between shards goes to the lower shard (id % n_shards), then the lower
    local row (id // n_shards)."""
    from gsearch_tpu_torch.core import SeqDict

    rank = {item.id.path: i for i, item in enumerate(SeqDict.reload_json(db))}
    lines, out, run = neighbours.split("\n"), [], []

    def key(line):
        field = line.split("\t")
        i = rank[field[5]]
        return float(field[3]), i % n_shards, i // n_shards

    for line in lines + [""]:
        if line.startswith("query_id:"):
            run.append(line)
            continue
        out += sorted(run, key=key)
        run = []
        out.append(line)
    return "\n".join(out[:-1])


def phase_sharded(dev, cfg, root, p4) -> dict:
    """The sharded graph database at GTDB scale on the one card: phase 4's
    genomes plus clustered decoys in 4 shards, requested, grown and
    searched through the port's entry points."""
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.index.serialize import load_index
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import bucketed_knn
    from gsearch_tpu_torch.pipeline import dump_with_placeholders, empty_index_like

    flat = load_index(p4["db"], dev)
    n_real, s, n = flat.nb_points, flat.sketch_size, cfg["shard_total"]
    sigs = np.empty((n, s), np.float32)
    sigs[:n_real] = flat.get_sigs()
    del flat
    make_decoys(dev, cfg, sigs[n_real:], torch.Generator(device=dev).manual_seed(SEED + 4))
    index = empty_index_like(p4["db"], "hnsw", device=dev, n_shards=cfg["n_shards"])
    t0 = time.perf_counter()
    index.insert(sigs)
    t_build = time.perf_counter() - t0
    sizes = [sh.nb_points for sh in index.shards]
    if index.KIND != "hnsw_sharded" or sum(sizes) != n or max(sizes) - min(sizes) > 1:
        raise AssertionError(f"sharded build: {index.KIND}, shard sizes {sizes}")
    db = os.path.join(root, "db_sharded")
    dump_with_placeholders(p4["db"], db, index)
    del index

    out = os.path.join(root, "req_sharded")
    t_req = _cli_request(dev, cfg, db, p4["q_dir"], out)
    with open(p4["neighbours"]) as a, open(os.path.join(out, "gsearch.neighbors.txt")) as b:
        want, got = shard_merge_order(a.read(), p4["db"], cfg["n_shards"]), b.read()
    if got != want:
        diff = "".join(list(difflib.unified_diff(
            want.splitlines(True), got.splitlines(True), "48 genomes", "sharded"))[:60])
        raise AssertionError(f"neighbours file of the sharded database differs from phase 4's:\n{diff}")
    grown = db + "_add"  # the add grows a copy: the analysis reads the 65,536 rows
    shutil.copytree(db, grown)
    t0 = time.perf_counter()
    if main(["add", "-b", grown, "-n", p4["q_dir"], "--device", dev.type]) != 0:
        raise AssertionError("add to the sharded database failed")
    t_add = time.perf_counter() - t0
    out = os.path.join(root, "req_sharded_add")
    t_req_add = _cli_request(dev, cfg, grown, p4["q_dir"], out)
    for query, (dist, hit) in best_hits(os.path.join(out, "gsearch.neighbors.txt")).items():
        if hit != query or dist != 0.0:
            raise AssertionError(f"after add to the sharded database: best hit of {query} is {hit} at {dist}")
    index = load_index(grown, dev)
    if index.nb_points != n + len(p4["source"]) or [sh.nb_points for sh in index.shards] != [
            n // cfg["n_shards"] + 2] * cfg["n_shards"]:
        raise AssertionError(f"after add: {[sh.nb_points for sh in index.shards]} rows a shard")
    del index
    shutil.rmtree(grown)

    # 1,024 decoy members with 5% of slots redrawn, against K1 over all rows
    index = load_index(db, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    nq, k = cfg["shard_queries"], cfg["knbn"]
    src = torch.randint(n_real, n, (nq,), generator=gen, device=dev).cpu().numpy()
    rows = torch.from_numpy(sigs[src]).to(dev)
    q = torch.where(torch.rand(rows.shape, generator=gen, device=dev) < 0.05,
                    torch.rand(rows.shape, generator=gen, device=dev), rows)
    qn = q.cpu().numpy()
    saved = dict(cuda_lib.launches)
    all_rows = torch.from_numpy(index.get_sigs()).to(dev).view(torch.int32)
    true_d, _ = bucketed_knn(q.view(torch.int32), all_rows, k)
    del all_rows
    cuda_lib.launches.update(saved)  # the oracle is not the main path
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        d, ids = index.search(qn, k)
        times.append(time.perf_counter() - t0)
    recall = _tie_aware(d, true_d)
    routes = {sh.stats["search"]["route"] for sh in index.shards}
    if recall < 0.99 or routes != {"beam"}:
        raise AssertionError(f"sharded search: recall@10 {recall}, shard routes {routes}")
    with K2Recorder(keep=1) as rec:  # shard 0's first hop is the first call
        index.search(qn, k)
    hops = sum(sh.stats["search"]["hops"] for sh in index.shards)
    if rec.count != hops + len(index.shards):
        raise AssertionError(f"sharded search: {rec.count} K2 calls for {hops} hops")
    site = k2_site(dev, f"shard beam hop (the first of shard 0), {cfg['n_shards']} shards of "
                   f"{n // cfg['n_shards']}", rec.calls[0], hops)
    del rec, index
    torch.cuda.empty_cache()
    print(f"phase sharded {n} x {s} in {cfg['n_shards']} shards of {sizes[0]} (beam-insert build "
          f"{t_build:.1f} s): CLI request byte-identical to phase 4's in the shards' merge order "
          f"({t_req:.1f} s); CLI add of 8 "
          f"({t_add:.1f} s), then each query's best hit is itself ({t_req_add:.1f} s); {nq} queries "
          f"recall@10 {recall:.4f} in {hops} hops")
    return {"db": db, "n_real": n_real, "build_s": t_build, "request_s": t_req, "add_s": t_add,
            "search_s": statistics.median(times[1:]), "search_cold_s": times[0], "recall": recall,
            "hops": hops, "k2_site": site}


class K1Recorder:
    """While active, the coreset's K1 calls are recorded: (q, db) of each."""

    def __enter__(self):
        import gsearch_tpu_torch.analysis.coreset as core_mod

        self.mod, self.real, self.calls = core_mod, core_mod.hamming_frac, []

        def recorder(q, db, **kw):
            self.calls.append((q, db))
            return self.real(q, db, **kw)

        core_mod.hamming_frac = recorder
        return self

    def __exit__(self, *exc):
        self.mod.hamming_frac = self.real
        return False


def _same_files(what: str, a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what}: {a} and {b} differ")


def phase_analysis(dev, cfg, root, p4, ps) -> dict:
    """The database-analysis tools through the CLI on the sharded database
    and on a flat one of the same 65,536 rows: hnsw2knn, ann --stats
    --embed, hnswcore; at flat-48 size, card output equal to the CPU's."""
    import gsearch_tpu_torch.analysis.embed as embed_mod
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.core import ProcessingParams, ProcessingState, SeqDict
    from gsearch_tpu_torch.index.flat import FlatIndex
    from gsearch_tpu_torch.index.serialize import dumpall, load_index
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import hamming_frac

    sigs = load_index(ps["db"], dev).get_sigs()
    n, s, k = sigs.shape[0], sigs.shape[1], cfg["knbn"]
    flat_db = os.path.join(root, "db_flat_shard_rows")
    flat = FlatIndex(s, np.float32, dev)
    flat.insert(sigs)
    dumpall(flat_db, flat, SeqDict.reload_json(ps["db"]), ProcessingParams.reload_json(ps["db"]),
            ProcessingState.reload_json(ps["db"]))
    del flat
    res = {}

    # k-NN graph of both databases (the self-search reads global order)
    knn = {}
    for tag, db in (("flat", flat_db), ("sharded", ps["db"])):
        knn[tag] = os.path.join(root, f"knn_{tag}.txt")
        t0 = time.perf_counter()
        with K2Recorder(keep=1) as rec:
            rc = main(["hnsw2knn", "-b", db, "-n", str(k), "-o", knn[tag], "--device", dev.type])
        res[f"knn_{tag}_s"] = time.perf_counter() - t0
        if rc != 0 or not rec.calls:
            raise AssertionError(f"hnsw2knn of the {tag} database failed or made no K2 call")
        if tag == "flat":
            res["k2_site"] = k2_site(dev, f"k-NN self-search rerank (the first {cfg['knn_batch']}-query "
                                     f"batch) over {n}", rec.calls[0], rec.count)
        del rec
        torch.cuda.empty_cache()
    _same_files("hnsw2knn of the flat and the sharded database", knn["flat"], knn["sharded"])
    # tie-aware recall@10 of the graph on 1,024 sampled nodes against K1
    rng = np.random.default_rng(SEED + 6)
    pick = np.sort(rng.choice(n, cfg["shard_queries"], replace=False))
    got_d = np.empty((len(pick), k), np.float32)
    with open(knn["flat"]) as f:
        row = 0
        for i, line in enumerate(f):
            if row < len(pick) and i == pick[row]:
                got_d[row] = [float(x.rsplit(":", 1)[1]) for x in line.rstrip("\n").split("\t")[1:]]
                row += 1
    saved = dict(cuda_lib.launches)
    all_rows = torch.from_numpy(sigs).to(dev).view(torch.int32)
    d = hamming_frac(all_rows[torch.from_numpy(pick).to(dev)], all_rows)
    d[torch.arange(len(pick), device=dev), torch.from_numpy(pick).to(dev)] = torch.inf  # not itself
    true_d = torch.sort(d, dim=1).values[:, :k].cpu().numpy()
    del all_rows, d
    cuda_lib.launches.update(saved)
    # the file's distances are rounded to 5 decimals
    res["knn_recall"] = float(1.0 - (np.sort(got_d, 1) > np.round(true_d, 5) + 1e-5).mean())
    if res["knn_recall"] < 0.99:
        raise AssertionError(f"k-NN graph: tie-aware recall@10 {res['knn_recall']} on {len(pick)} nodes")

    # ann --stats --embed on the flat database (hierarchical init above 30,000)
    seen = []
    real_embed = embed_mod.Embedder.embed

    def spy(self):
        seen.append(self)
        return real_embed(self)

    embed_mod.Embedder.embed = spy
    try:
        t0 = time.perf_counter()
        rc = main(["ann", "-b", flat_db, "--stats", "--embed", "-o", root, "--device", dev.type])
        res["ann_s"] = time.perf_counter() - t0
    finally:
        embed_mod.Embedder.embed = real_embed
    if rc != 0 or len(seen) != 1:
        raise AssertionError("ann --stats --embed failed")
    emb = seen[0]
    y = np.loadtxt(os.path.join(root, "database_embedded.csv"), delimiter=",")
    quality = emb.get_quality_estimate_from_edge_length(200)
    labels = decoy_labels(cfg, ps["n_real"], n)
    pairs = rng.integers(0, n, (2, 20_000))
    dist = np.linalg.norm(y[pairs[0]] - y[pairs[1]], axis=1)
    ratio = {}
    for level, lab in labels.items():
        same = lab[pairs[0]] == lab[pairs[1]]
        ratio[level] = float(dist[same].mean() / dist[~same].mean())
    if y.shape != (n, 2) or not np.isfinite(y).all() or not 0 <= quality < 1.0 or ratio["species"] >= 0.5:
        raise AssertionError(f"embedding: shape {y.shape}, quality {quality}, intra/inter {ratio}")
    res.update(embed_init_s=emb.times["init_s"], embed_opt_s=emb.times["optimize_s"], quality=quality,
               intra_inter=ratio, hier=n > emb.params.hier_threshold)
    del y, emb, seen

    # hnswcore: hamming (its K1 calls recorded), then l2
    core_out = {}
    for metric in ("hamming", "l2"):
        out = os.path.join(root, f"core_{metric}")
        os.makedirs(out)
        t0 = time.perf_counter()
        with K1Recorder() as rec:
            rc = main(["hnswcore", "-b", flat_db, "--coreset", str(cfg["coreset"]), "--cluster",
                       str(cfg["cluster"]), "--metric", metric, "-o", out, "--device", dev.type])
        res[f"core_{metric}_s"] = time.perf_counter() - t0
        for name in ("coreset.csv", "clustercoreset.csv"):
            with open(os.path.join(out, name)) as f:
                rows = sum(1 for _ in f) - 1
            if rows != (cfg["coreset"] if name == "coreset.csv" else n):
                raise AssertionError(f"hnswcore --metric {metric}: {name} has {rows} rows")
        if rc != 0:
            raise AssertionError(f"hnswcore --metric {metric} failed")
        core_out[metric] = rec.calls
        del rec
    calls = core_out.pop("hamming")
    shapes = [tuple(q.shape[:1]) + tuple(db.shape[:1]) for q, db in calls]
    c = cfg["coreset"]
    assign = [i for i, sh in enumerate(shapes) if sh == (c, n)][-1]  # after the quantiles' block
    sites = [k1_device_site(dev, f"coreset assignment sweep [{c}, {n}]", *calls[assign],
                            shapes.count((c, n))),
             k1_device_site(dev, f"coreset draw sweep [1, {n}]", *calls[shapes.index((1, n))],
                            shapes.count((1, n))),
             k1_device_site(dev, f"cluster_coreset medoid block [{c}, {c}]",
                            *calls[shapes.index((c, c))], shapes.count((c, c)))]
    for ent in sites:
        ent.pop("out")
    res["k1_sites"] = sites
    res["k1_calls"] = len(calls)
    del calls, core_out
    torch.cuda.empty_cache()

    # flat-48: the card's hnsw2knn and hnswcore output equals the CPU's
    for d in (dev.type, "cpu"):
        out = os.path.join(root, f"small_{d}")
        os.makedirs(out, exist_ok=True)
        if main(["hnsw2knn", "-b", p4["db"], "-n", str(k), "-o", os.path.join(out, "knn.txt"),
                 "--device", d]) != 0 or main(["hnswcore", "-b", p4["db"], "--coreset", "32", "--cluster",
                                               "4", "-o", out, "--device", d]) != 0:
            raise AssertionError(f"hnsw2knn / hnswcore of phase 4's database on {d} failed")
    for name in ("knn.txt", "coreset.csv", "clustercoreset.csv"):
        _same_files(f"{name} at 48 genomes, card and CPU", os.path.join(root, f"small_{dev.type}", name),
                    os.path.join(root, "small_cpu", name))
    print(f"phase analysis {n} x {s}: hnsw2knn -n {k} of the flat and the sharded database "
          f"byte-identical ({res['knn_flat_s']:.1f} s, {res['knn_sharded_s']:.1f} s CLI wall), recall@10 "
          f"{res['knn_recall']:.4f} on {len(pick)} nodes; ann --stats --embed quality {quality:.3f}, "
          f"intra/inter species {ratio['species']:.3f}, families {ratio['family']:.3f}; hnswcore "
          f"--coreset {c} --cluster {cfg['cluster']} (hamming, l2): both CSVs; at 48 genomes the card's "
          f"hnsw2knn and hnswcore files equal the CPU's")
    return res


def mesh_rows(dev, n: int, s: int, gen) -> torch.Tensor:
    """[n, S] f32 signatures drawn on the card: clusters of 64 consecutive
    rows, each row a copy of its cluster's root with a per-row fraction in
    [0.02, 0.3) of its slots redrawn, so a query's nearest rows lie at a
    spread of distances inside its cluster and the rest near 1.0."""
    out = torch.empty((n, s), dtype=torch.float32, device=dev)
    per, block = 64, 16384
    for start in range(0, n, block):
        m = min(block, n - start)
        roots = torch.rand((-(-m // per), s), generator=gen, device=dev).repeat_interleave(per, 0)[:m]
        frac = 0.02 + 0.28 * torch.rand((m, 1), generator=gen, device=dev)
        redraw = torch.rand((m, s), generator=gen, device=dev) < frac
        out[start : start + m] = torch.where(redraw, torch.rand((m, s), generator=gen, device=dev), roots)
    return out


def once_ms(fn) -> tuple:
    """(fn's result, its device time in ms from CUDA events) for one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def k1_member_site(dev, site: str, q: torch.Tensor, db: torch.Tensor, launches: int) -> dict:
    """A mesh member's K1 sweep re-run with its own rows: its plain version
    run once (held bitwise, and timed), the kernel timed by CUDA events,
    torch.cdist(p=0) timed once, beside the bound.  No device-only time:
    the profiler caught one of two launches this long.  These launches
    are not main-path launches: the counts are restored."""
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import hamming_frac, hamming_frac_plain, k1_plan

    saved = dict(cuda_lib.launches)
    if dev.type == "cuda":
        want, plain_ms = once_ms(lambda: hamming_frac_plain(q, db))
    else:
        want, plain_ms = hamming_frac_plain(q, db), None
    got = hamming_frac(q, db)
    if not same_bits(got, want):
        raise AssertionError(f"K1 {site}: differs from its plain version, max abs err {max_abs_err(got, want)}")
    del got, want
    (nq, s), n = q.shape, db.shape[0]
    if dev.type != "cuda":
        cuda_lib.launches.update(saved)
        return {"site": site, "launches": launches, "shape": [nq, n, s], "err": 0.0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qf, dbf = q.float(), db.float()
    torch.cdist(qf[:8], dbf[:64], p=0)
    library_ms = once_ms(lambda: torch.cdist(qf, dbf, p=0))[1]
    del qf, dbf
    ent = {"site": site, "launches": launches, "shape": [nq, n, s], "dtype": "float32", "err": 0.0,
           "plan": k1_plan(1, nq, n, s, sms)._asdict(), "ms": event_ms(lambda: hamming_frac(q, db), 3),
           "device_ms": None, "plain_ms": plain_ms, "library_ms": library_ms, **k1_bound(1, nq, n, s, sms)}
    cuda_lib.launches.update(saved)
    return ent


def mesh_worker(argv) -> int:
    """One of two processes of a mesh run (the mesh phase's, and the mesh
    tests'): joins the other over gloo, holds `members` members on
    `device` (its own rows of the database file, read through a memory
    map), searches the queries and saves the merged lists, its global
    member indices, the mesh's size and the sum of every member's index
    gathered over both processes.  argv: rank, port, database .npy,
    queries .npy, k, output .npz, device, members."""
    import torch.distributed as dist

    from gsearch_tpu_torch.parallel.mesh import MeshSearcher, initialize_multihost, make_device_mesh

    rank, port, db, queries, k, out, device, members = argv
    initialize_multihost(f"localhost:{port}", 2, int(rank))
    try:
        dev = torch.device(device)
        mesh = make_device_mesh(device=dev, devices=[dev] * int(members))
        total = float(sum(mesh.gather([torch.tensor([float(g)]) for g, _ in mesh.members()])))
        d, ids = MeshSearcher(np.load(db, mmap_mode="r"), mesh).search(np.load(queries), int(k))
        np.savez(out, d=d, ids=ids, members=np.array([g for g, _ in mesh.members()]), size=mesh.size,
                 total=total)
    finally:
        dist.destroy_process_group()
    return 0


def start_mesh_processes(root: str, k: int, dev: torch.device, members: int) -> list:
    """Start `mesh_worker` twice (ranks 0 and 1) on root/mesh_db.npy and
    root/mesh_q.npy, each writing root/mesh_rank{r}.npz and .log."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    code = "import sys, chip_smoke; sys.exit(chip_smoke.mesh_worker(sys.argv[1:]))"
    procs = []
    for rank in range(2):
        with open(os.path.join(root, f"mesh_rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(rank), str(port), os.path.join(root, "mesh_db.npy"),
                 os.path.join(root, "mesh_q.npy"), str(k), os.path.join(root, f"mesh_rank{rank}.npz"),
                 str(dev), str(members)],
                cwd=here, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_mesh_processes(procs: list, root: str, timeout: float) -> list:
    """Wait for the two processes (killing both past `timeout` s); raise
    with both logs if either failed; else each rank's saved arrays."""
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        logs = []
        for rank, p in enumerate(procs):
            with open(os.path.join(root, f"mesh_rank{rank}.log")) as f:
                logs.append(f"--- process {rank} (rc {p.returncode}):\n{f.read()[-3000:]}")
        raise AssertionError("a mesh process failed:\n" + "\n".join(logs))
    out = []
    for rank in range(2):
        with np.load(os.path.join(root, f"mesh_rank{rank}.npz")) as f:
            out.append({key: f[key] for key in f.files})
    return out


def phase_mesh(dev, cfg, root, p4, ps) -> dict:
    """The mesh on the one card, cfg["mesh_members"] members on cuda:0:
    (a) phase 4's genomes sketched data-parallel equal phase 4's signatures;
    (b) MeshSearcher over cfg["mesh_total"] x S equals one K1 sweep with a
    stable top-k, bitwise; (c) MeshMxuSearcher on the same rows; (d)
    MeshGraphSearcher over the sharded phase's database, and a request
    through the pipeline with the mesh; (e) two processes of 2 members
    each, merging over gloo, equal the sweep over their rows; (f) the CLI
    with --mesh -1 writes phase 4's neighbours file, --mesh 2 on one card
    raises the count error."""
    import gsearch_tpu_torch.parallel.mesh as mesh_mod
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.core import ComputingParams
    from gsearch_tpu_torch.index.serialize import load_index
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import bucketed_knn
    from gsearch_tpu_torch.parallel.mesh import (MeshGraphSearcher, MeshMxuSearcher, MeshSearcher,
                                                 make_device_mesh)
    from gsearch_tpu_torch.pipeline import database_sketcher, read_genomes, request_database

    members, k, s = cfg["mesh_members"], cfg["knbn"], cfg["sketch"]
    mesh = make_device_mesh(device=dev, devices=[dev] * members)
    res = {"members": members}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def oracle(fn):  # not the main path: the counts are restored
        saved = dict(cuda_lib.launches)
        out = fn()
        cuda_lib.launches.update(saved)
        return out

    # (a) data-parallel sketching
    genomes = read_genomes(p4["db_dir"])
    sketcher = database_sketcher(p4["db"], device=dev)
    sketcher.set_mesh(mesh)
    sync()
    t0 = time.perf_counter()
    sigs = sketcher.sketch_many(genomes)
    sync()
    res["sketch_s"] = time.perf_counter() - t0
    res["mbases"] = sum(len(g) for g in genomes) / 1e6
    if not np.array_equal(sigs.view(np.uint32), load_index(p4["db"], dev).get_sigs().view(np.uint32)):
        raise AssertionError(f"mesh sketch of phase 4's {len(genomes)} genomes differs from phase 4's signatures")
    del genomes, sketcher

    # (b) the exact row-sharded search
    n, nq = cfg["mesh_total"], cfg["mesh_queries"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    t0 = time.perf_counter()
    db = mesh_rows(dev, n, s, gen)
    src = torch.randint(0, n, (nq,), generator=gen, device=dev)
    q = torch.where(torch.rand((nq, s), generator=gen, device=dev) < 0.05,
                    torch.rand((nq, s), generator=gen, device=dev), db[src])
    qn = q.cpu().numpy()
    sync()
    res["gen_s"] = time.perf_counter() - t0
    exact = MeshSearcher(db, mesh)  # each member's shard is a view of db
    times = []
    for rep in range(3):
        with CallRecorder(mesh_mod, "hamming_frac", keep=lambda args, out: args) as rec:
            t0 = time.perf_counter()
            d, ids = exact.search(qn, k)
            times.append(time.perf_counter() - t0)
        if rep == 0:
            k1_calls = [args for _, _, args in rec.calls]
    res["exact_cold_s"], res["exact_s"] = times[0], statistics.median(times[1:])
    true_d, true_i = oracle(lambda: bucketed_knn(q.view(torch.int32), db.view(torch.int32), k))
    if not (np.array_equal(ids, true_i) and np.array_equal(d.view(np.uint32), true_d.view(np.uint32))):
        raise AssertionError("MeshSearcher differs from one K1 sweep with a stable top-k")
    if len(k1_calls) != members:
        raise AssertionError(f"MeshSearcher made {len(k1_calls)} K1 calls for {members} members")
    res["k1_site"] = k1_member_site(dev, f"mesh member's sweep (member 0 of {members})", *k1_calls[0],
                                    launches=members)
    del k1_calls, rec, exact

    # (e) starts here so the two processes' start-up overlaps (c), (d), (f)
    nr = cfg["mesh_process_rows"]
    np.save(os.path.join(root, "mesh_db.npy"), db[:nr].cpu().numpy())
    np.save(os.path.join(root, "mesh_q.npy"), qn)
    e_d, e_i = oracle(lambda: bucketed_knn(q.view(torch.int32), db[:nr].view(torch.int32), k))
    procs = start_mesh_processes(root, k, dev, members // 2)
    try:
        # (c) the compact row-sharded search
        sync()
        t0 = time.perf_counter()
        compact = MeshMxuSearcher(db, mesh)
        sync()
        res["mxu_build_s"] = time.perf_counter() - t0
        times = []
        for rep in range(3):
            with K2Recorder(keep=1) as rec:
                t0 = time.perf_counter()
                dm, im = compact.search(qn, k)
                times.append(time.perf_counter() - t0)
            if rep == 0:
                if rec.count != members or rec.calls[0][3].get("parts") != 2:
                    raise AssertionError(f"MeshMxuSearcher: {rec.count} K2 calls, expected {members} parts=2")
                call = rec.calls[0]
        res["mxu_cold_s"], res["mxu_s"] = times[0], statistics.median(times[1:])
        res["mxu_recall"] = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(im, ids)]))
        res["mxu_nearest_err"] = float(np.abs(dm[:, 0] - d[:, 0]).max())
        if res["mxu_recall"] < 0.95 or res["mxu_nearest_err"] > 3.0 / s:
            raise AssertionError(f"MeshMxuSearcher: recall@10 {res['mxu_recall']}, nearest distance off by "
                                 f"{res['mxu_nearest_err']} (bound {3.0 / s})")
        res["k2_sites"] = [k2_site(dev, f"mesh compact rerank (member 0 of {members}, {compact.nl} rows)",
                                   call, members)]
        del call, rec, compact, db, q
        torch.cuda.empty_cache()

        # (d) the graph over the sharded phase's database
        index = load_index(ps["db"], dev)
        n_g, g_sigs = index.nb_points, index.get_sigs()
        sync()
        t0 = time.perf_counter()
        graph = MeshGraphSearcher(index, mesh)
        sync()
        res["graph_build_s"] = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)  # the sharded phase's queries
        src = torch.randint(ps["n_real"], n_g, (cfg["shard_queries"],), generator=gen, device=dev).cpu().numpy()
        rows = torch.from_numpy(g_sigs[src]).to(dev)
        gq = torch.where(torch.rand(rows.shape, generator=gen, device=dev) < 0.05,
                         torch.rand(rows.shape, generator=gen, device=dev), rows)
        gqn = gq.cpu().numpy()
        all_rows = torch.from_numpy(g_sigs).to(dev).view(torch.int32)
        g_true, _ = oracle(lambda: bucketed_knn(gq.view(torch.int32), all_rows, k))
        del all_rows, rows, g_sigs
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            gd, _ = graph.search(gqn, k)
            times.append(time.perf_counter() - t0)
        res["graph_cold_s"], res["graph_s"] = times
        res["graph_hops"] = sum(graph.stats["hops"])
        res["graph_recall"] = _tie_aware(gd, g_true)
        if res["graph_recall"] < ps["recall"] - 0.05:
            raise AssertionError(f"MeshGraphSearcher recall@10 {res['graph_recall']} < the sequential "
                                 f"search's {ps['recall']} - 0.05")
        full = index.sketch_size
        with K2Recorder(keep=2, where=lambda i, db_, *_: i == 0 or db_.shape[1] == full) as rec:
            graph.search(gqn, k)
        if rec.count != sum(graph.stats["hops"]) + members or rec.calls[1][0].shape[1] != full:
            raise AssertionError(f"MeshGraphSearcher: {rec.count} K2 calls for {graph.stats['hops']} hops")
        res["k2_sites"] += [
            k2_site(dev, f"mesh graph rerank (member 0 of {members})", rec.calls[1], members),
            k2_site(dev, f"mesh member's beam hop (the first of member 0)", rec.calls[0],
                    sum(graph.stats["hops"]))]
        del rec, graph, index, gq
        torch.cuda.empty_cache()
        out = os.path.join(root, "req_mesh_graph")
        t0 = time.perf_counter()
        request_database(ps["db"], p4["q_dir"], k, ComputingParams(mesh_devices=members), out_dir=out,
                         device=dev, mesh=mesh)
        res["graph_request_s"] = time.perf_counter() - t0
        tsv = os.path.join(out, "ani.tsv")
        if main(["reformat", str(cfg["kmer"]), "1", os.path.join(out, "gsearch.neighbors.txt"), tsv]) != 0:
            raise AssertionError("reformat of the mesh graph request failed")
        best = {}
        with open(tsv) as f:
            next(f)
            for line in f:
                query, _, hit, _, ani = line.rstrip("\n").split("\t")
                best.setdefault(query, (hit, float(ani)))
        for query, want in p4["source"].items():
            hit, ani = best.get(query, (None, float("nan")))
            if hit != want or not abs(ani - 99.0) < 0.5:
                raise AssertionError(f"mesh graph request: {query}'s best hit {hit} ANI {ani}, expected "
                                     f"{want} at 99 +- 0.5")
        res["ani"] = (min(a for _, a in best.values()), max(a for _, a in best.values()))

        # (f) the CLI with --mesh
        db_dir, out = os.path.join(root, "db_mesh"), os.path.join(root, "req_mesh")
        build = ["tohnsw", "-d", p4["db_dir"], "-k", str(cfg["kmer"]), "-s", str(s), "-n", "32", "--ef", "200",
                 "--algo", "optdens", "--block", "--device", dev.type]
        t0 = time.perf_counter()
        if main(["--mesh", "-1", *build, "-o", db_dir]) != 0:
            raise AssertionError("tohnsw --mesh -1 failed")
        res["cli_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if main(["--mesh", "-1", "request", "-b", db_dir, "-n", str(k), "-r", p4["q_dir"], "-o", out,
                 "--device", dev.type]) != 0:
            raise AssertionError("request --mesh -1 failed")
        res["cli_request_s"] = time.perf_counter() - t0
        _same_files("neighbours file of --mesh -1 and phase 4's", p4["neighbours"],
                    os.path.join(out, "gsearch.neighbors.txt"))
        cards = torch.cuda.device_count()
        if dev.type == "cuda" and cards < 2:
            try:
                main(["--mesh", "2", *build, "-o", db_dir + "2"])
            except ValueError as e:
                if f"needs 2 CUDA cards, but {cards}" not in str(e):
                    raise
                res["count_error"] = str(e)
            else:
                raise AssertionError(f"--mesh 2 on a machine with {cards} card did not raise")
        shutil.rmtree(db_dir)

        # (e) the two processes' lists
        t0 = time.perf_counter()
        ranks = finish_mesh_processes(procs, root, timeout=300)
        res["process_wait_s"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    half = members // 2
    for rank, got in enumerate(ranks):
        if (int(got["size"]) != members or list(got["members"]) != list(range(rank * half, (rank + 1) * half))
                or float(got["total"]) != members * (members - 1) / 2
                or not np.array_equal(got["ids"], e_i)
                or not np.array_equal(got["d"].view(np.uint32), e_d.view(np.uint32))):
            raise AssertionError(f"mesh process {rank}: lists differ from the K1 sweep over the first "
                                 f"{nr} rows (members {list(got['members'])}, total {got['total']})")
    for name in ("mesh_db.npy", "mesh_q.npy", "mesh_rank0.npz", "mesh_rank1.npz", "mesh_rank0.log",
                 "mesh_rank1.log"):
        os.remove(os.path.join(root, name))
    print(f"phase mesh, {members} members on {dev}: {res['mbases']:.1f} Mbases sketched data-parallel equal "
          f"phase 4's signatures; MeshSearcher {nq} queries x {n} x {s} bitwise equal to one K1 sweep; "
          f"MeshMxuSearcher recall@10 {res['mxu_recall']:.4f}, nearest distance within "
          f"{res['mxu_nearest_err']:.2e} (bound {3.0 / s:.2e}); MeshGraphSearcher over {n_g} rows in "
          f"{members} shards recall@10 {res['graph_recall']:.4f} (sequential {ps['recall']:.4f}), phase 4's "
          f"queries at ANI {res['ani'][0]:.3f}..{res['ani'][1]:.3f}; two processes of 2 members over gloo "
          f"equal the sweep over {nr} rows; --mesh -1 CLI file byte-identical to phase 4's; "
          f"--mesh 2: {res.get('count_error', 'not checked (more than one card)')}")
    return res


def phase_superani(dev, cfg, root, p4) -> dict:
    """superani through the CLI on phase 4's queries against its genomes
    (raw ANI); the seed sketch of a genome past the 4 Mb block on the card
    against the CPU's; sketch and compare rates."""
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.io.fasta import concat_file_codes
    from gsearch_tpu_torch.models import seedchain
    from gsearch_tpu_torch.models.seedchain import SeedChainer

    refs = sorted(os.path.join(p4["db_dir"], f) for f in os.listdir(p4["db_dir"]))
    queries = sorted(os.path.join(p4["q_dir"], f) for f in os.listdir(p4["q_dir"]))
    ql, rl, out = (os.path.join(root, name) for name in ("sa_q.txt", "sa_r.txt", "superani.tsv"))
    for path, lst in ((ql, queries), (rl, refs)):
        with open(path, "w") as f:
            f.write("\n".join(lst) + "\n")
    t0 = time.perf_counter()
    if main(["superani", "-q", ql, "-r", rl, "-o", out, "--model", "none", "--device", dev.type]) != 0:
        raise AssertionError("superani failed")
    t_cli = time.perf_counter() - t0
    # a chain of a few chance seed matches reads ANI 100 over a sliver of
    # the query, so the best hit is taken among pairs aligned over half of it
    best, stray = {}, 0
    with open(out) as f:
        next(f)
        for line in f:
            q, r, ani, af_q = line.split("\t")[:4]
            q, r = os.path.basename(q), os.path.basename(r)
            if float(af_q) < 0.5:
                stray += float(ani) > 0.0
            elif float(ani) > best.get(q, ("", -1.0))[1]:
                best[q] = (r, float(ani))
    for query, src in p4["source"].items():
        hit, ani = best.get(query, (None, float("nan")))
        if hit != src or not abs(ani - 99.0) < 0.5:
            raise AssertionError(f"superani: best hit of {query} is {hit} at {ani}, expected {src} at 99 +- 0.5")
    codes = [concat_file_codes(p)[0] for p in refs + queries]
    chainer = SeedChainer(device=dev)
    chainer.sketch(codes[0][:100_000])  # warm-up
    t0 = time.perf_counter()
    sk = [chainer.sketch(c) for c in codes]  # each sketch ends in a copy to the host
    t_sketch = time.perf_counter() - t0
    t0 = time.perf_counter()
    for qs in sk[len(refs):]:
        for rs in sk[: len(refs)]:
            chainer.compare(qs, rs)
    t_compare = time.perf_counter() - t0
    longest = max(codes, key=len)
    if len(longest) <= 1 << seedchain._MAX_PIECE_LOG2:
        raise AssertionError("no genome past the 4 Mb block")
    card, cpu = chainer.sketch(longest), SeedChainer(device=torch.device("cpu")).sketch(longest)
    if not (np.array_equal(card.hashes, cpu.hashes) and np.array_equal(card.positions, cpu.positions)):
        raise AssertionError("superani: the card's seed sketch differs from the CPU's")
    mbases = sum(len(c) for c in codes) / 1e6
    pairs = len(queries) * len(refs)
    print(f"phase superani {len(queries)} x {len(refs)} (--model none): every query's best hit is its "
          f"source at ANI {min(a for _, a in best.values()):.3f}..{max(a for _, a in best.values()):.3f} "
          f"({t_cli:.1f} s CLI wall; {stray} of {len(queries) * len(refs)} pairs chained under half of "
          f"the query); the seed sketch of a {len(longest) / 1e6:.1f} Mb genome on the card "
          f"equals the CPU's")
    return {"cli_s": t_cli, "sketch_s": t_sketch, "mbases": mbases, "compare_s": t_compare,
            "pairs": pairs}


def _fasta_reads(path: str, names, reads: np.ndarray) -> None:
    """Write reads (uint8 codes [R, L]) as FASTA, one record a read."""
    text = _LUT[reads]
    with open(path, "wb") as f:
        for name, row in zip(names, text):
            f.write(b">" + name.encode() + b"\n" + row.tobytes() + b"\n")


def _fastq_reads(path: str, names, reads: np.ndarray, quals: np.ndarray) -> None:
    text = _LUT[reads]
    with open(path, "wb") as f:
        for name, row, q in zip(names, text, quals):
            f.write(b"@" + name.encode() + b"\n" + row.tobytes() + b"\n+\n" + q.tobytes() + b"\n")


def draw_reads(genomes: list, n: int, length: int, rng) -> tuple:
    """n windows of `length` bases free of invalid codes: (reads [n, length],
    source genome index [n]); genomes drawn uniformly."""
    src = rng.integers(0, len(genomes), n)
    out = np.empty((n, length), np.uint8)
    for g, codes in enumerate(genomes):
        rows = np.nonzero(src == g)[0]
        bad = np.concatenate([[0], np.cumsum(codes >= 4)])
        starts = np.empty(0, np.int64)
        while len(starts) < len(rows):
            s = rng.integers(0, len(codes) - length, 2 * len(rows) + 16)
            starts = np.concatenate([starts, s[bad[s + length] == bad[s]]])
        out[rows] = codes[starts[: len(rows), None] + np.arange(length)]
    return out, src


def _revcomp(reads: np.ndarray) -> np.ndarray:
    return (3 - reads[:, ::-1]).astype(np.uint8)


def _counts_by_read(path: str) -> dict:
    """{read id: [(genome, hits, corrected fraction), ...]} of _reads.txt."""
    rows = {}
    with open(path) as f:
        next(f)
        for line in f:
            rid, genome, hits, _, frac = line.rstrip("\n").split("\t")
            rows.setdefault(rid, []).append((genome, int(hits), float(frac)))
    return rows


def widen_bigsi(idx, columns: int, gen) -> None:
    """Grow the index's device matrix to `columns` genomes: the real words
    kept, every further genome's bits set at random with the real genomes'
    mean fill (drawn on the device, a block of rows at a time)."""
    real = idx.device_bits()
    rows, nw_real = real.shape
    nw = -(-columns // 32)
    fill = float(np.mean(idx._ones_per_genome)) / idx.bloom_len
    wide = torch.empty((rows, nw), dtype=torch.int32, device=real.device)
    shifts = torch.arange(32, dtype=torch.int64, device=real.device)
    first_free = idx.nb_genomes
    keep = torch.zeros(nw, dtype=torch.int64, device=real.device)  # bits of the real genomes
    for j in range(first_free):
        keep[j // 32] |= 1 << (j % 32)
    step = 1 << 18
    for r0 in range(0, rows, step):
        bits = torch.rand((min(step, rows - r0), nw, 32), generator=gen, device=real.device) < fill
        words = (bits.to(torch.int64) << shifts).sum(-1) & ~keep
        words[:, :nw_real] |= real[r0 : r0 + step].to(torch.int64) & 0xFFFFFFFF
        wide[r0 : r0 + step] = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    idx._device_bits = wide
    idx.names += [f"random{j}" for j in range(first_free, columns)]
    idx._ones_per_genome += [int(fill * idx.bloom_len)] * (columns - first_free)


class CallRecorder:
    """While active, every call of the named methods (or module functions)
    of `owner` is recorded as (name, seconds, keep(args, result)), keep
    returning the result unless given; `seconds(name)` sums one method's
    wall time (a method called by another counts in both)."""

    def __init__(self, owner, *names, keep=lambda args, out: out):
        self.owner, self.names, self.keep, self.calls = owner, names, keep, []

    def __enter__(self):
        self.real = {name: getattr(self.owner, name) for name in self.names}

        def wrap(name, fn):
            def wrapper(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.calls.append((name, time.perf_counter() - t0, self.keep(args, out)))
                return out
            return wrapper

        for name, fn in self.real.items():
            setattr(self.owner, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.owner, name, fn)
        return False

    def seconds(self, name: str) -> float:
        return sum(sec for n, sec, _ in self.calls if n == name)


def phase_bigsig(dev, cfg, root, p4) -> dict:
    """BIGSI read classification at the CLI defaults over phase 4's genomes:
    construct; identify single-end reads (7/8 exact substrings, 1/8
    random) and FASTQ read pairs at 1% substitutions; a batch's counts on
    the card against the CPU path; the device pass timed at the real
    genome count and with the matrix widened to 1,024 genome columns."""
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.index.bigsi import BigsiIndex
    from gsearch_tpu_torch.io.fasta import concat_file_codes
    from gsearch_tpu_torch.io.walk import walk_fasta_dir

    bc = cfg["bigsig"]
    prefix = os.path.join(root, "bigsi")
    t0 = time.perf_counter()
    # positions: the device pass a genome and its copy to the host; the
    # rest of insert_genome is the host matrix's bit update
    with CallRecorder(BigsiIndex, "_genome_positions", "insert_genome", "save",
                      keep=lambda args, out: None) as parts:
        if main(["bigsig", "construct", "-r", p4["db_dir"], "-b", prefix, "--bloom", str(bc["bloom"]),
                 "--device", dev.type]) != 0:
            raise AssertionError("bigsig construct failed")
    t_construct = time.perf_counter() - t0
    paths = walk_fasta_dir(p4["db_dir"])
    genomes = [concat_file_codes(p)[0] for p in paths]
    mbases = sum(len(g) for g in genomes) / 1e6

    rng = np.random.default_rng(SEED + 5)
    n, length = bc["reads"], bc["read_len"]
    n_exact = n - n // 8
    reads = np.empty((n, length), np.uint8)
    reads[:n_exact], src = draw_reads(genomes, n_exact, length, rng)
    reads[n_exact:] = rng.integers(0, 4, (n - n_exact, length), dtype=np.uint8)
    order = rng.permutation(n)  # exact and random reads interleaved
    reads, is_exact = reads[order], order < n_exact
    source = np.full(n, -1)
    source[is_exact] = src[order[is_exact]]
    names = [f"r{i}" for i in range(n)]
    _fasta_reads(os.path.join(root, "reads.fa"), names, reads)
    t0 = time.perf_counter()
    if main(["bigsig", "identify", "-b", prefix, "-q", os.path.join(root, "reads.fa"), "-o",
             os.path.join(root, "se"), "--device", dev.type]) != 0:
        raise AssertionError("bigsig identify (single-end) failed")
    t_identify = time.perf_counter() - t0
    rows = _counts_by_read(os.path.join(root, "se_reads.txt"))
    for i in np.nonzero(is_exact)[0]:
        hits = rows.get(names[i], [])
        want = paths[source[i]]
        top = max((h for _, h, _ in hits), default=-1)
        if not any(g == want and h == top for g, h, _ in hits):
            raise AssertionError(f"bigsig: exact read {names[i]} of {want}: the source does not hold "
                                 f"the largest hit count ({hits})")
    random_hit = sum(names[i] in rows for i in np.nonzero(~is_exact)[0]) / max(int((~is_exact).sum()), 1)
    if random_hit > 0.01:
        raise AssertionError(f"bigsig: {random_hit:.4f} of random reads classified (at most 0.01)")

    # read pairs: mates at the two ends of a 600-base fragment, the second
    # reverse-complemented, 1% substitutions, 0.5% of qualities under -Q 15
    n_pairs = bc["pairs"]
    frags, psrc = draw_reads(genomes, n_pairs, 600, rng)
    mates = [_mutate(m.ravel(), 0.01, rng).reshape(m.shape)
             for m in (frags[:, :length], _revcomp(frags[:, -length:]))]
    pnames = [f"p{i}" for i in range(n_pairs)]
    files = []
    for m, codes in enumerate(mates):
        quals = np.full(codes.shape, ord("I"), np.uint8)
        quals[rng.random(codes.shape) < 0.005] = ord("#")
        files.append(os.path.join(root, f"pairs_{m + 1}.fq"))
        _fastq_reads(files[-1], pnames, codes, quals)
    t0 = time.perf_counter()
    if main(["bigsig", "identify", "-b", prefix, "-q", *files, "-o", os.path.join(root, "pe"),
             "--device", dev.type]) != 0:
        raise AssertionError("bigsig identify (paired-end) failed")
    t_paired = time.perf_counter() - t0
    prow = _counts_by_read(os.path.join(root, "pe_reads.txt"))
    classified = [i for i in range(n_pairs) if pnames[i] in prow]
    right = sum(prow[pnames[i]][0][0] == paths[psrc[i]] for i in classified)
    if len(classified) < 0.5 * n_pairs or right < 0.99 * len(classified):
        raise AssertionError(f"bigsig paired-end: {len(classified)} of {n_pairs} pairs classified, "
                             f"{right} of them to their source")

    idx = BigsiIndex.load(prefix, device=dev)
    batch = bc["batch"]
    card = idx.raw_counts(reads[:batch])
    cpu = BigsiIndex.load(prefix, device=torch.device("cpu")).raw_counts(reads[:batch])
    if not all(np.array_equal(a, b) for a, b in zip(card, cpu)):
        raise AssertionError("bigsig: raw counts on the card differ from the CPU path's")

    def counts_pass():
        out = [idx.raw_counts(reads[b : b + batch])[0] for b in range(0, n, batch)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    counts_pass()  # warm-up
    t0 = time.perf_counter()
    base = counts_pass()
    t_real = time.perf_counter() - t0
    nb_real = idx.nb_genomes
    widen_bigsi(idx, bc["columns"], torch.Generator(device=dev).manual_seed(SEED + 6))
    counts_pass()
    t0 = time.perf_counter()
    wide = counts_pass()
    t_wide = time.perf_counter() - t0
    for a, b in zip(base, wide):
        if b.shape[1] != bc["columns"] or not np.array_equal(a, b[:, :nb_real]):
            raise AssertionError("bigsig: the real genomes' counts changed when the matrix was widened")
    matrix_gb = idx.device_bits().numel() * 4 / 1e9
    del idx, wide, base
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"phase bigsig {len(paths)} genomes ({mbases:.1f} Mbases), bloom {bc['bloom']}: every exact "
          f"read's source holds its largest hit count; {random_hit:.5f} of random reads classified; "
          f"{len(classified)} of {n_pairs} pairs classified, {right} to their source; a batch's counts "
          f"on the card equal the CPU's; widened to {bc['columns']} columns ({matrix_gb:.2f} GB on the "
          f"device), the {nb_real} real columns' counts unchanged")
    inserts, save = parts.seconds("insert_genome"), parts.seconds("save")
    return {"construct_s": t_construct, "construct_parts": {
                "positions": parts.seconds("_genome_positions"),
                "host bit update": inserts - parts.seconds("_genome_positions"), "save": save,
                "walk and parse": t_construct - inserts - save},
            "mbases": mbases, "identify_s": t_identify, "reads": n,
            "paired_s": t_paired, "pairs": n_pairs, "pass_real_s": t_real, "pass_wide_s": t_wide,
            "nb_real": nb_real, "columns": bc["columns"], "matrix_gb": matrix_gb}


def write_reference_dump(out: str, sigs: np.ndarray, src_db: str) -> None:
    """A reference-format (hnsw_rs) database dump of sigs [n, S] f32: the
    data file as [u32 magic][u64 DataId][u64 length][payload] records, a
    graph description naming DistHamming and f32, the streamed seqdict
    (the database at src_db's genomes first, then placeholder decoys), its
    parameters.json and a processing_state.json."""
    import struct

    from gsearch_tpu_torch.core import ProcessingParams, ProcessingState, SeqDict

    os.makedirs(out)
    n, s = sigs.shape
    with open(os.path.join(out, "hnswdump.hnsw.data"), "wb") as f:
        for i in range(n):
            f.write(struct.pack("<IQQ", 0xA67F0CAF, i, s))
            f.write(sigs[i].tobytes())
    with open(os.path.join(out, "hnswdump.hnsw.graph"), "wb") as f:
        f.write(struct.pack("<IBBBQQQ", 0x2A3B4C5D, 1, 32, 16, 200, n, s)
                + struct.pack("<Q", 11) + b"DistHamming" + struct.pack("<Q", 3) + b"f32" + b"\0" * 64)
    real = SeqDict.reload_json(src_db)
    with open(os.path.join(out, "seqdict.json"), "w") as f:
        for i in range(n):
            if i < len(real):
                item = real[i]
                entry = {"id": {"path": item.id.path, "fasta_id": item.id.fasta_id}, "len": item.len}
            else:
                entry = {"id": {"path": f"decoys/d{i}.fna", "fasta_id": f"d{i}"}, "len": 0}
            f.write(json.dumps(entry))
    ProcessingParams.reload_json(src_db).dump_json(out)
    ProcessingState(nb_seq=n, nb_file=n, elapsed_t=0.0).dump_json(out)


def phase_import(dev, cfg, root, p4) -> dict:
    """A reference-format dump at GTDB r207 scale (phase 4's genomes plus
    the sharded phase's clustered decoys) imported by the CLI as a flat and
    as a graph database, each requested by phase 4's queries."""
    import gsearch_tpu_torch.index.refimport as refimport
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.index.serialize import load_index

    flat = load_index(p4["db"], dev)
    n_real, s, n = flat.nb_points, flat.sketch_size, cfg["import_total"]
    sigs = np.empty((n, s), np.float32)
    sigs[:n_real] = flat.get_sigs()
    del flat
    make_decoys(dev, cfg, sigs[n_real:], torch.Generator(device=dev).manual_seed(SEED + 4))
    ref = os.path.join(root, "refdb")
    t0 = time.perf_counter()
    write_reference_dump(ref, sigs, p4["db"])
    t_write = time.perf_counter() - t0
    del sigs
    res = {"write_s": t_write, "gb": os.path.getsize(os.path.join(ref, "hnswdump.hnsw.data")) / 1e9}
    for kind in ("auto", "hnsw"):
        db = os.path.join(root, f"db_import_{kind}")
        t0 = time.perf_counter()
        with CallRecorder(refimport, "import_reference_db") as rec:
            if main(["import", "-b", ref, "-o", db, "--index", kind, "--device", dev.type]) != 0:
                raise AssertionError(f"import --index {kind} failed")
        wall = time.perf_counter() - t0
        summary = rec.calls[0][2]
        if summary["nb_points"] != n or summary["index_kind"] != ("flat" if kind == "auto" else "hnsw"):
            raise AssertionError(f"import --index {kind}: {summary}")
        out = os.path.join(root, f"req_import_{kind}")
        t_req = _cli_request(dev, cfg, db, p4["q_dir"], out)
        with open(p4["neighbours"]) as a, open(os.path.join(out, "gsearch.neighbors.txt")) as b:
            want, got = a.read(), b.read()
        if got != want:
            diff = "".join(list(difflib.unified_diff(
                want.splitlines(True), got.splitlines(True), "48 genomes", f"import {kind}"))[:60])
            raise AssertionError(f"neighbours file of the imported {kind} database differs from phase 4's:\n{diff}")
        shutil.rmtree(db)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res[summary["index_kind"]] = {"wall_s": wall, "stages": summary["stages"],
                                      "passes": summary["build_passes"], "request_s": t_req}
    shutil.rmtree(ref)
    print(f"phase import {n} x {s} f32 ({res['gb']:.2f} GB dump): CLI import as flat and as hnsw, "
          f"request of phase 4's queries against each byte-identical to phase 4's file")
    return res


def _nl(p: np.ndarray) -> list:
    """-ln p as HMMER writes it, `*` for zero."""
    with np.errstate(divide="ignore"):
        v = -np.log(p)
    return ["*" if not np.isfinite(x) else f"{x:.5f}" for x in v]


def write_hmm_profiles(out: str, cfg, rng) -> list:
    """cfg's HMMER3/f profiles, one .HMM file each: match emissions put
    0.35-0.85 on a consensus residue drawn from the background and the rest
    on the background; per-node transitions around HMMER's typical values,
    `*` for the last node's m->d and d->d; GA (a quarter bit a node, at
    least 25) and STATS lines.  Returns each profile's match emission
    probabilities [L, 20]."""
    from gsearch_tpu_torch.models.hmmprofile import BG_FREQ, HMM_ALPHABET

    os.makedirs(out)
    bg = " ".join(_nl(BG_FREQ))
    emissions = []
    for h, length in enumerate(rng.integers(*cfg["hmm_lengths"], cfg["hmm_profiles"])):
        length = int(length)
        cons = rng.choice(20, length, p=BG_FREQ / BG_FREQ.sum())
        top = rng.uniform(0.35, 0.85, length)[:, None]
        em = (1 - top) * BG_FREQ[None, :] / (1 - BG_FREQ[cons])[:, None]
        em[np.arange(length), cons] = top[:, 0]
        emissions.append(em)
        mi, md = rng.uniform(0.005, 0.05, (2, length))
        ii, dd = rng.uniform(0.2, 0.6, length), rng.uniform(0.1, 0.5, length)
        tr = np.stack([1 - mi - md, mi, md, 1 - ii, ii, 1 - dd, dd], 1)
        tr[-1] = (0.99, 0.01, 0.0, 0.6, 0.4, 1.0, 0.0)
        name = f"TIGR{h:05d}"
        lines = ["HMMER3/f [3.3 | Nov 2019]", f"NAME  {name}", f"ACC   {name}.1",
                 f"DESC  synthetic marker {h}", f"LENG  {length}", "ALPH  amino",
                 f"GA    {max(25.0, 0.25 * length):.2f} {max(25.0, 0.25 * length):.2f};",
                 "STATS LOCAL MSV      -10.1000  0.70000",
                 "STATS LOCAL VITERBI  -10.9000  0.70000",
                 "STATS LOCAL FORWARD   -4.5000  0.70000",
                 "HMM          " + "        ".join(HMM_ALPHABET),
                 "            m->m     m->i     m->d     i->m     i->i     d->m     d->d",
                 "  COMPO   " + bg, "          " + bg,
                 "          " + " ".join(_nl(np.array([0.98, 0.01, 0.01, 0.6, 0.4, 1.0, 0.0])))]
        for k in range(length):
            lines.append(f"  {k + 1:5d}   " + " ".join(_nl(em[k])) + f"  {k + 1} {HMM_ALPHABET[cons[k]].lower()} - - -")
            lines.append("          " + bg)
            lines.append("          " + " ".join(_nl(tr[k])))
        lines.append("//")
        with open(os.path.join(out, f"{name}.HMM"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return emissions


def phase_hmmsearch(dev, cfg, root) -> dict:
    """hmmsearch --cut_ga of a seeded proteome against cfg's profiles (each
    planted protein the top row of its profile); Viterbi and Forward scores
    of 8 profiles x 64 proteins on the card within the CPU test's bound of
    the CPU path; cells a second an algorithm."""
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.models.hmmprofile import HmmSearcher, parse_hmmer3

    rng = np.random.default_rng(SEED + 7)
    hmm_dir = os.path.join(root, "markers")
    emissions = write_hmm_profiles(hmm_dir, cfg, rng)
    n_prot, (lo, hi) = cfg["proteome"], cfg["prot_lengths"]
    prots = [AA_LETTERS[rng.integers(0, 20, int(n))] for n in rng.integers(lo, hi, n_prot)]
    planted = rng.choice(n_prot, len(emissions), replace=False)
    for h, (i, em) in enumerate(zip(planted, emissions)):
        sample = np.minimum((em.cumsum(1) < rng.random(len(em))[:, None]).sum(1), 19)
        hit = rng.random(len(sample)) < 0.2
        sample[hit] = rng.integers(0, 20, int(hit.sum()))
        flank = int(rng.integers(0, max(hi - len(sample), 0) + 1)) // 2
        left = int(rng.integers(0, flank + 1))
        prots[i] = np.concatenate([AA_LETTERS[rng.integers(0, 20, left)], AA_LETTERS[sample],
                                   AA_LETTERS[rng.integers(0, 20, flank - left)]])
    faa = os.path.join(root, "proteome.faa")
    with open(faa, "wb") as f:
        for i, p in enumerate(prots):
            f.write(b">prot%d\n" % i + p.tobytes() + b"\n")
    tsv = os.path.join(root, "hmmsearch.tsv")
    t0 = time.perf_counter()
    with CallRecorder(HmmSearcher, "score", keep=lambda args, out: args[0].stats) as rec:
        if main(["hmmsearch", "-f", faa, "-m", hmm_dir, "-o", tsv, "--cut_ga", "--device", dev.type]) != 0:
            raise AssertionError("hmmsearch failed")
    t_cli = time.perf_counter() - t0
    names = sorted(f for f in os.listdir(hmm_dir))
    top = {}
    with open(tsv) as f:
        next(f)
        for line in f:
            seq, prof = line.split("\t")[:2]
            top.setdefault(prof, seq)
    for h, i in enumerate(planted):
        if top.get(f"TIGR{h:05d}") != f"prot{i}":
            raise AssertionError(f"hmmsearch: the top row of TIGR{h:05d} is {top.get(f'TIGR{h:05d}')}, "
                                 f"expected its planted prot{i}")

    # card against CPU: the 8 shortest profiles, their planted proteins and
    # the shortest others, to 64
    profiles = [p for name in names for p in parse_hmmer3(os.path.join(hmm_dir, name))]
    short = sorted(range(len(profiles)), key=lambda h: profiles[h].length)[: cfg["hmm_check"][0]]
    pick = [int(planted[h]) for h in short]
    pick += [i for i in np.argsort([len(p) for p in prots], kind="stable") if i not in pick]
    pick = pick[: cfg["hmm_check"][1]]
    seqs = [HmmSearcher.encode(prots[i].tobytes().decode()) for i in pick]
    chosen = [profiles[h] for h in short]
    worst = 0.0
    for algo in ("viterbi", "forward"):
        card = HmmSearcher(chosen, device=dev).score(seqs, algo)
        cpu = HmmSearcher(chosen, device=torch.device("cpu")).score(seqs, algo)
        bound_ = HMM_BITS_RTOL * np.maximum(np.abs(cpu.astype(np.float64)), 1.0)
        if not np.isfinite(card).all() or (np.abs(card - cpu) > bound_).any():
            raise AssertionError(f"hmmsearch {algo}: the card's bits differ from the CPU's beyond the bound "
                                 f"(max |diff| {np.abs(card - cpu).max()})")
        worst = max(worst, float((np.abs(card - cpu) / np.maximum(np.abs(cpu), 1.0)).max()))
    # the CLI scores Forward, then Viterbi
    timing = {algo: (sec, st["cells"], st["blocks"])
              for algo, (_, sec, st) in zip(("forward", "viterbi"), rec.calls)}
    print(f"phase hmmsearch {len(profiles)} profiles ({cfg['hmm_lengths'][0]}-{cfg['hmm_lengths'][1]} "
          f"nodes) x {n_prot} proteins: hmmsearch --cut_ga puts each planted protein at the top of its "
          f"profile; card vs CPU on {len(chosen)} x {len(seqs)}: |diff| / max(|bits|, 1) at most "
          f"{worst:.3g} (bound {HMM_BITS_RTOL})")
    return {"cli_s": t_cli, "timing": timing, "profiles": len(profiles), "proteins": n_prot,
            "residues": int(sum(len(p) for p in prots)), "worst_rel": worst}


# f32 peak outside the tensor cores (the decoder's adds and compares), the
# least latency of one dependent f32 operation (4 cycles at the boost clock)
# and the dependent operations of one exact decoder step: three adds in the
# reference's order, a 4-level max over 11 states, the emission add
F32_OPS_S, F32_OP_S, VITERBI_CHAIN_OPS = 67e12, 4 / 1.98e9, 8


def viterbi_bound(nwin: int, w: int, in_bytes: int | None = None, extra_ops: int = 0) -> dict:
    """The decoder's work.  `gs_viterbi`: e [B, W, 11], four bonus vectors,
    dp0 and the transition table read once, the int8 path written once.
    The fused `gs_genepred_decode` (in_bytes given): its inputs, the u8
    codes and the tables, `in_bytes` of them, read once and the path
    written once; `extra_ops`, the precompute's f32 operations this run's
    data needs (context sums at its hits).  Per base and window 121
    candidates of three adds, 110 compares and 11 emission adds (f32, 67
    TFLOP/s).  `chain_ms` is the serial floor: W dependent steps, each at
    least VITERBI_CHAIN_OPS dependent f32 operations."""
    if in_bytes is None:
        in_bytes = nwin * w * (11 * 4 + 4 * 4) + nwin * 11 * 4 + 121 * 4
    nbytes = in_bytes + nwin * w
    ops = nwin * w * (121 * 3 + 110 + 11) + extra_ops
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "chain_ms": w * VITERBI_CHAIN_OPS * F32_OP_S * 1e3}


def launch_ms(fn, reps: int) -> float:
    """The least device time of one call of fn, CUDA events recorded just
    around it (fn should be a launch bound once, ops/viterbi's
    `*_launch`), after one warm-up."""
    fn()
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        t = start.elapsed_time(end)
        best = t if best is None else min(best, t)
    return best


def _synth():
    """tests/torch_synth.py (no JAX): the planted-genome generator the CPU
    and card tests share."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_synth

    return torch_synth


def write_genepred_corpus(root: str, cfg) -> dict:
    """cfg's planted genomes as FASTA (80-column lines): genome 0 with N
    runs, genome 1 in several contigs (one under 8,192 bases), and
    substituted copies of two genomes as the AA chain's queries.  Returns
    the genome and query files, the truth ({file: [(start, end, strand,
    contig)]}) and the base count."""
    synth = _synth()
    g = cfg["genepred"]
    rng = np.random.default_rng(SEED + 8)
    gdir, qdir = os.path.join(root, "gp_genomes"), os.path.join(root, "gp_queries")
    os.makedirs(gdir)
    os.makedirs(qdir)

    def write(path, contigs):
        with open(path, "wb") as f:
            for name, seq in contigs:
                body = seq.tobytes()
                f.write(b">" + name.encode() + b" planted\n")
                f.write(b"\n".join(body[i : i + 80] for i in range(0, len(body), 80)) + b"\n")

    files, truth, contigs_of, bases = [], {}, {}, 0
    for i, length in enumerate(np.linspace(*g["lengths"], g["genomes"]).astype(int)):
        sizes = [int(length)]
        if i == 1:
            sizes = [5_000, int(length) // 40, int(length) // 6]
            sizes.append(int(length) - sum(sizes))
        contigs, genes = [], []
        for j, n in enumerate(sizes):
            seq, planted = synth.synth_genome(rng, n, n_runs=g["n_runs"] if i == 0 else 0)
            contigs.append((f"g{i}_c{j}", seq))
            genes += [(*x, f"g{i}_c{j}") for x in planted]
        path = os.path.join(gdir, f"g{i}.fna")
        write(path, contigs)
        files.append(path)
        truth[path], contigs_of[path] = genes, contigs
        bases += sum(len(seq) for _, seq in contigs)
    queries = {}
    for i in g["query_sources"]:
        mutated = []
        for name, seq in contigs_of[files[i]]:
            seq = seq.copy()
            hit = (rng.random(len(seq)) < g["query_rate"]) & (seq != ord("N"))
            seq[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(hit.sum()))]
            mutated.append((name + "_q", seq))
        path = os.path.join(qdir, f"q{i}.fna")
        write(path, mutated)
        queries[path] = files[i]
    return {"files": files, "queries": queries, "truth": truth, "bases": bases}


def gff_genes(path: str) -> list:
    """[(start, end, strand, contig)] (0-based, half-open) of a genepred
    .gff file."""
    with open(path) as f:
        return [(int(x[3]) - 1, int(x[4]), x[6], x[0])
                for x in (line.split("\t") for line in f if not line.startswith("#"))]


def phase_genepred(dev, cfg, root) -> dict:
    """Gene prediction on planted genomes through the CLI on the card, with
    the launch counts of that main path; the card's files and paths against
    the CPU's; the decoder kernel against its plain version, timed at one
    64-window dispatch and at a whole genome."""
    import gsearch_tpu_torch.models.genepred as gp
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops import viterbi as tv

    from gsearch_tpu_torch.io.fasta import parse_fasta

    synth = _synth()
    g = cfg["genepred"]
    t0 = time.perf_counter()
    corpus = write_genepred_corpus(root, cfg)
    res = {"write_s": time.perf_counter() - t0, "bases": corpus["bases"], "walls": {}}
    out_dir, faa_dir, q_faa = (os.path.join(root, d) for d in ("gp_out", "gp_faa", "gp_qfaa"))
    for d in (out_dir, faa_dir, q_faa):
        os.makedirs(d)

    def genepred(fasta, prefix, device, *extra):
        t0 = time.perf_counter()
        if main(["genepred", "-s", fasta, "-o", prefix, *extra, "--device", device]) != 0:
            raise AssertionError(f"genepred failed on {fasta}")
        return time.perf_counter() - t0

    # ---- the main path: genepred over every genome, -t self on genome 0,
    # the queries' proteomes, tohnsw --aa and request
    check = corpus["files"][0]
    cuda_lib.reset_launches()
    with CallRecorder(gp, "_decode_path") as rec:
        for path in corpus["files"]:
            name = os.path.basename(path)[:-4]
            res["walls"][name] = genepred(path, os.path.join(out_dir, name), dev.type)
            shutil.copy(os.path.join(out_dir, name + ".faa"), faa_dir)
            if path == check:
                paths_card = [out for _, _, out in rec.calls]
            rec.calls.clear()
    res["standard_s"] = sum(res["walls"].values())
    with CallRecorder(gp, "self_trained_params") as srec, CallRecorder(gp, "_decode_path") as rec:
        res["self_s"] = genepred(check, os.path.join(out_dir, "self"), dev.type, "-t", "self")
    self_params = srec.calls[-1][2]
    paths_self_card = [out for _, _, out in rec.calls]
    for q in corpus["queries"]:
        name = os.path.basename(q)[:-4]
        genepred(q, os.path.join(out_dir, name), dev.type)
        shutil.copy(os.path.join(out_dir, name + ".faa"), q_faa)
    db, req = os.path.join(root, "gp_db"), os.path.join(root, "gp_req")
    t0 = time.perf_counter()
    if main(["tohnsw", "-d", faa_dir, "-k", str(cfg["aa_kmer"]), "-s", str(cfg["sketch"]), "-n", "32",
             "--ef", "200", "--algo", "optdens", "--block", "--aa", "-o", db, "--device", dev.type]) != 0:
        raise AssertionError("tohnsw --aa over the predicted proteomes failed")
    res["aa_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if main(["request", "-b", db, "-n", str(cfg["knbn"]), "-r", q_faa, "-o", req,
             "--device", dev.type]) != 0:
        raise AssertionError("request of the queries' proteomes failed")
    res["aa_request_s"] = time.perf_counter() - t0
    res["counts"] = dict(cuda_lib.launches)
    if dev.type == "cuda" and (res["counts"]["genepred_decode"] == 0 or res["counts"]["hamming_frac"] == 0):
        raise AssertionError(f"genepred and its AA request did not go through the fused decode kernel and "
                             f"K1: {res['counts']}")
    source = {os.path.basename(q)[:-4] + ".faa": os.path.basename(s)[:-4] + ".faa"
              for q, s in corpus["queries"].items()}
    lo, hi = check_planted("genepred AA chain", os.path.join(req, "gsearch.neighbors.txt"), source)

    # ---- gene calls against the planted truth
    per_file, n_genes = {}, 0
    for path in corpus["files"]:
        name = os.path.basename(path)[:-4]
        got = gff_genes(os.path.join(out_dir, name + ".gff"))
        n_genes += len(got)
        per_file[name] = synth.gene_recall_precision(got, corpus["truth"][path])
    worst = (min(r for r, _ in per_file.values()), min(q for _, q in per_file.values()))
    if worst[0] < g["recall_floor"] or worst[1] < g["precision_floor"]:
        raise AssertionError(f"genepred: recall / precision {per_file} under the floors "
                             f"{g['recall_floor']} / {g['precision_floor']}")
    self_rp = synth.gene_recall_precision(gff_genes(os.path.join(out_dir, "self.gff")),
                                          corpus["truth"][check])
    res.update(genes=n_genes, recall=worst[0], precision=worst[1], per_file=per_file,
               self_rp=self_rp, aa_best_d=(lo, hi))

    # ---- the card against the CPU: decoded paths and the four files
    with CallRecorder(gp, "_decode_path") as rec:
        res["cpu_s"] = genepred(check, os.path.join(out_dir, "cpu"), "cpu")
    paths_cpu = [out for _, _, out in rec.calls]
    if len(paths_cpu) != len(paths_card) or not all(
            np.array_equal(a, b) for a, b in zip(paths_card, paths_cpu)):
        raise AssertionError("genepred: the decoded paths on the card differ from the CPU's")
    name = os.path.basename(check)[:-4]
    for ext in (".faa", ".ffn", ".gff", ".out"):
        _same_files(f"genepred {ext}", os.path.join(out_dir, name + ext), os.path.join(out_dir, "cpu" + ext))
    with CallRecorder(gp, "_decode_path") as rec:
        res["self_cpu_s"] = genepred(check, os.path.join(out_dir, "self_cpu"), "cpu", "-t", "self")
    paths_self_cpu = [out for _, _, out in rec.calls]
    if len(paths_self_cpu) != len(paths_self_card) or not all(
            np.array_equal(a, b) for a, b in zip(paths_self_card, paths_self_cpu)):
        raise AssertionError("genepred -t self: the decoded paths on the card differ from the CPU's")
    for ext in (".faa", ".ffn", ".gff", ".out"):
        _same_files(f"genepred -t self {ext}", os.path.join(out_dir, "self" + ext),
                    os.path.join(out_dir, "self_cpu" + ext))

    # ---- both decoder forms against their plain versions, timed: the fused
    # decode (codes -> path) with the standard tables and with genome 0's
    # self-trained ones (context, noncoding, dicodon tables, start prior),
    # gs_viterbi on the standard tables' emissions
    p = gp.GenePredParams()
    tb = torch.as_tensor(tv.transition_table(p.p_gene_start, tv.NEG_BIG), device=dev)
    genome = gp.encode_dna(next(parse_fasta(max(corpus["files"], key=os.path.getsize))).seq)
    wins = gp._windows(genome)[0]
    sp = self_params
    models = {"standard": dict(codon_lu=p.codon_logusage, dicodon_lu=None),
              "self": dict(codon_lu=sp.codon_logusage, dicodon_lu=sp.dicodon_logusage,
                           rdicodon_lu=sp.rdicodon_logusage if sp.dicodon_logusage is not None else None,
                           nc_lm=sp.noncoding_lm, ctx=sp.ctx,
                           ctx_aff=sp.ctx_aff if sp.ctx_aff is not None else np.tile(np.float32([1, 0]), (4, 1)),
                           start_prior=sp.start_prior)}
    scals = {model: dict(start_codon_bonus=q.start_codon_bonus, stop_codon_bonus=q.stop_bonus,
                         ctx_weight=q.ctx_weight, ctx_cap=q.ctx_cap, ctx_neg_cap=q.ctx_neg_cap)
             for model, q in (("standard", p), ("self", sp))}
    fused, vit = {}, {}
    for tag, rows in (("dispatch", wins[: g["dispatch"]]), ("genome", wins)):
        codes = torch.from_numpy(rows).to(dev)
        dp0 = torch.zeros((len(rows), 11), dtype=torch.float32, device=dev)
        dp0[0] = tv.NEG_BIG
        dp0[0, tv.NC] = 0.0
        std = gp._precompute_scores(codes, p.codon_logusage, None, p.start_codon_bonus, p.stop_bonus)
        # boundary-codon hits (the four tables'), where a context model sums
        # its 61 taps: positive bonuses without context or prior tables
        hits = sum(int((x > 0).sum()) for x in std[1:])
        for model, tabs in models.items():
            scal = scals[model]
            kw = {**tabs, **scal}
            got = gp._decode_windows(codes, dp0, tb, **kw)
            scores = gp._precompute_scores(codes, **kw)
            want = tv.viterbi_plain(*scores, dp0, tb)
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            if err:
                raise AssertionError(f"genepred_decode {tag} {model}: the kernel's path differs from the plain "
                                     f"composition's")
            ent = {"windows": len(rows), "err": err, "model": model}
            if dev.type == "cuda":
                on = {k: None if v is None else torch.as_tensor(np.asarray(v, np.float32), device=dev)
                      for k, v in tabs.items()}
                ent["ms"] = event_ms(lambda: tv.genepred_decode(codes, dp0, tb, **on, **scal), 3)
                ent["device_ms"] = launch_ms(tv.genepred_decode_launch(codes, dp0, tb, **on, **scal), 3)
                ent["profiler_ms"] = device_ms(lambda: tv.genepred_decode(codes, dp0, tb, **on, **scal), 3,
                                               "decode_kernel")
                ent["plain_ms"] = event_ms(
                    lambda: tv.viterbi_plain(*gp._precompute_scores(codes, **kw), dp0, tb), 1)
                # inputs read once: the codes, dp0, tb and the tables; the
                # precompute's f32 operations: 4 bonus adds a base and, with
                # a context model, 61 adds and 4 calibration operations a hit
                table_bytes = sum(4 * np.asarray(v).size for v in tabs.values() if v is not None)
                ctx_hits = hits if tabs.get("ctx") is not None else 0
                ent.update(viterbi_bound(len(rows), rows.shape[1],
                                         in_bytes=codes.numel() + 4 * dp0.numel() + 4 * 121 + table_bytes,
                                         extra_ops=ctx_hits * (61 + 4) + 4 * codes.numel()))
                ent["ctx_hits"] = ctx_hits
            fused[tag if model == "standard" else f"{tag}_{model}"] = ent
            del scores, want
        scores = std
        args = (*scores, dp0, tb)
        got = tv.viterbi(*args)
        want = tv.viterbi_plain(*args)
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if err:
            raise AssertionError(f"viterbi {tag}: the kernel's path differs from the plain version's")
        ent = {"windows": len(rows), "err": err}
        if dev.type == "cuda":
            ent["ms"] = event_ms(lambda: tv.viterbi(*args), 3)
            ent["device_ms"] = launch_ms(tv.viterbi_launch(*args), 3)
            ent["plain_ms"] = event_ms(lambda: tv.viterbi_plain(*args), 1)
            ent.update(viterbi_bound(len(rows), rows.shape[1]))
        vit[tag] = ent
        del scores, args, std
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for model, params in (("standard", p), ("self", sp)):
        t0 = time.perf_counter()
        gp._decode_path(genome, params, params.codon_logusage, params.dicodon_logusage, params.noncoding_lm,
                        params.ctx, params.ctx_aff, rdicodon_lu=params.rdicodon_logusage, device=dev)
        res["decode_s" if model == "standard" else "decode_self_s"] = time.perf_counter() - t0
    res["decode_bases"] = len(genome)
    res["fused"], res["kernel"] = fused, vit
    print(f"phase genepred {len(corpus['files'])} planted genomes ({res['bases'] / 1e6:.1f} Mbases, "
          f"{n_genes} genes called): recall >= {worst[0]:.3f}, precision >= {worst[1]:.3f} "
          f"(floors {g['recall_floor']} / {g['precision_floor']}); -t self on {name}: recall "
          f"{self_rp[0]:.3f}, precision {self_rp[1]:.3f}; card vs CPU on {name} "
          f"({os.path.getsize(check) / 1e6:.1f} MB): decoded paths and the four files identical; "
          f"AA chain: each query's best hit is its source (distances {lo:.4f}..{hi:.4f}); -t self on "
          f"{name}: card vs CPU paths and the four files identical; the fused decode bitwise equal to "
          f"the plain composition at {fused['dispatch']['windows']} and {fused['genome']['windows']} "
          f"windows, standard and self-trained tables; gs_viterbi bitwise equal to the plain decoder")
    return res


AA_LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
# sketchers whose card and CPU signatures must agree bit for bit; the others
# take a log (float64 rounded to f32 on both sides) and may differ in
LOG_ALGOS, LOG_SLOT_FRACTION = ("prob", "hll"), 1e-4


def write_aa_corpus(root: str, cfg) -> dict:
    """Seeded proteomes: clusters of copies of a random root proteome at 3%
    substitutions, written as records of `aa_record` residues, and one query
    per cluster at 2% substitutions of a member.  Returns the directories
    and {query file: source file}."""
    rng = np.random.default_rng(SEED + 7)
    db_dir, q_dir = os.path.join(root, "aa_db"), os.path.join(root, "aa_queries")
    os.makedirs(db_dir)
    os.makedirs(q_dir)

    def substitute(codes, rate):
        out = codes.copy()
        hit = rng.random(out.size) < rate
        out[hit] = (out[hit] + rng.integers(1, 20, int(hit.sum()), dtype=np.uint8)) % 20
        return out

    def write(path, name, codes):
        rec = cfg["aa_record"]
        with open(path, "wb") as f:
            for i in range(0, len(codes), rec):
                f.write(b">%s_p%d synthetic\n" % (name.encode(), i // rec))
                f.write(AA_LETTERS[codes[i : i + rec]].tobytes())
                f.write(b"\n")

    lengths = np.linspace(*cfg["aa_lengths"], cfg["clusters"]).astype(int)
    source = {}
    for c, length in enumerate(lengths):
        base = rng.integers(0, 20, int(length), dtype=np.uint8)
        for m in range(cfg["per_cluster"]):
            member = substitute(base, 0.03)
            name = f"a{c}_m{m}"
            write(os.path.join(db_dir, name + ".faa"), name, member)
            if m == c % cfg["per_cluster"]:
                write(os.path.join(q_dir, f"aq{c}.faa"), f"aq{c}", substitute(member, 0.02))
                source[f"aq{c}.faa"] = name + ".faa"
    return {"db_dir": db_dir, "q_dir": q_dir, "source": source,
            "residues": int(lengths.sum()) * cfg["per_cluster"]}


def best_hits(neighbours: str) -> dict:
    """{query file: (distance, answer file)} of each query's first line."""
    best = {}
    with open(neighbours) as f:
        for line in f:
            if line.startswith("query_id:"):
                field = line.rstrip("\n").split("\t")
                best.setdefault(os.path.basename(field[1]),
                                (float(field[3]), os.path.basename(field[5])))
    return best


def check_planted(what: str, neighbours: str, source: dict) -> tuple:
    best = best_hits(neighbours)
    for query, src in source.items():
        if best.get(query, (None, None))[1] != src:
            raise AssertionError(f"{what}: best hit of {query} is {best.get(query)}, expected {src}")
    dists = [d for d, _ in best.values()]
    return min(dists), max(dists)


def card_vs_cpu(dev, algo: str, db: str, genomes: list, cfg) -> float:
    """The card's signatures of `genomes` (whole, then the first one's start
    through the piece path at a lowered block) against the port's CPU
    sketcher: the largest fraction of a genome's slots that differ, held to
    0 or LOG_SLOT_FRACTION."""
    from gsearch_tpu_torch.pipeline import database_sketcher

    def codes(g):
        return g.to_codes() if hasattr(g, "to_codes") else g

    piece = [codes(genomes[0])[: cfg["piece_len"]]]
    sigs = {}
    for d in (dev, torch.device("cpu")):
        sk = database_sketcher(db, device=d)
        whole = sk.sketch_many(genomes)
        sk.MAX_BLOCK_LOG2 = cfg["piece_log2"]
        sigs[d.type] = np.concatenate([whole, sk.sketch_many(piece)])
    a, b = sigs[dev.type], sigs["cpu"]
    if a.shape != (len(genomes) + 1, cfg["sketch"]) or a.dtype != b.dtype:
        raise AssertionError(f"{algo}: card signatures {a.shape} {a.dtype}, CPU {b.shape} {b.dtype}")
    if a.dtype == np.float32 and not np.isfinite(a).all():
        raise AssertionError(f"{algo}: non-finite card signatures")
    diff = a.view(np.uint32) != b.view(np.uint32) if a.dtype == np.float32 else a != b
    frac = float(diff.mean(1).max())
    if frac > (LOG_SLOT_FRACTION if algo in LOG_ALGOS else 0.0):
        raise AssertionError(f"{algo}: card and CPU signatures differ in {frac} of a genome's slots")
    if algo == "hll" and diff.any() and int(np.abs(a.astype(np.int64) - b.astype(np.int64))[diff].max()) != 1:
        raise AssertionError("hll: a register differs from the CPU's by more than 1")
    return frac


# share of sparse genomes whose empty ProbMinHash slots may differ between
# two back ends (tests/test_torch_sketchers.py::test_prob_sparse_genomes_empty_slots)
PROB_SPARSE_GENOMES = 0.35


def sparse_prob_card_vs_cpu(dev, db: str, cfg) -> float:
    """ProbMinHash of sparse genomes (fewer darts than slots) on the card
    against the port's CPU sketcher: the found slots agree exactly; the
    empty slots, filled from the genome's least key, may differ as a whole
    where that key's log rounds apart.  Returns the share of such genomes."""
    from gsearch_tpu_torch.pipeline import database_sketcher

    rng = np.random.default_rng(SEED + 17)
    genomes = [rng.integers(0, 4, cfg["sparse_len"], dtype=np.uint8) for _ in range(cfg["sparse_genomes"])]
    sigs, found = {}, {}
    for d in (dev, torch.device("cpu")):
        sk = database_sketcher(db, device=d)
        seen = []
        finalize = sk._finalize_race
        sk._finalize_race = lambda race, seen=seen, finalize=finalize: (
            seen.append(race.found.cpu().numpy()), finalize(race))[1]
        sigs[d.type], found[d.type] = sk.sketch_many(genomes), seen[0]
    f = found["cpu"]
    if not np.array_equal(found[dev.type], f) or not (~f).any(1).all():
        raise AssertionError(f"sparse prob: found slots differ between card and CPU, or a genome has "
                             f"no empty slot ({f.mean()} found)")
    if not np.array_equal(sigs[dev.type][f], sigs["cpu"][f]):
        raise AssertionError("sparse prob: a found slot differs between card and CPU")
    share = float((sigs[dev.type] != sigs["cpu"]).any(1).mean())
    if share >= PROB_SPARSE_GENOMES:
        raise AssertionError(f"sparse prob: {share} of genomes differ in their empty slots")
    return share


def sketch_seconds(dev, db: str, genomes: list, runs: int = 1) -> float:
    """The least wall time of `runs` calls of sketch_many over the parsed
    genomes with the database's sketcher, after a warm-up on two of them."""
    from gsearch_tpu_torch.pipeline import database_sketcher

    sketcher = database_sketcher(db, device=dev)
    sketcher.sketch_many(genomes[:2])
    times = []
    for _ in range(runs):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sketcher.sketch_many(genomes)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def k1_device_site(dev, site: str, q: torch.Tensor, db: torch.Tensor, launches: int,
                   dtype: str = "float32") -> dict:
    """A K1 call of the main path re-run with its own device rows: bitwise
    against the plain version; timed on the card beside its bound and
    torch.cdist(p=0).  These launches are not main-path launches: the
    counts are restored."""
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import hamming_frac, hamming_frac_plain, k1_plan

    saved = dict(cuda_lib.launches)
    got, want = hamming_frac(q, db), hamming_frac_plain(q, db)
    if not same_bits(got, want):
        raise AssertionError(f"K1 {site}: differs from its plain version, max abs err "
                             f"{max_abs_err(got, want)}")
    del want
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    (nq, s), n = q.shape, db.shape[0]
    ent = {"site": site, "launches": launches, "shape": [nq, n, s], "dtype": dtype,
           "err": 0.0, "plan": k1_plan(1, nq, n, s, sms)._asdict(), "out": got}
    if dev.type == "cuda":
        big = nq * n * s > 1 << 32
        qf, dbf = q.float(), db.float()
        ent.update(ms=event_ms(lambda: hamming_frac(q, db), 5 if big else 50),
                   device_ms=device_ms(lambda: hamming_frac(q, db), 5 if big else 50, "eqcount_kernel"),
                   plain_ms=event_ms(lambda: hamming_frac_plain(q, db), 2 if big else 20),
                   library_ms=event_ms(lambda: torch.cdist(qf, dbf, p=0), 2 if big else 20),
                   **k1_bound(1, nq, n, s, sms))
        del qf, dbf
    cuda_lib.launches.update(saved)
    return ent


def k1_site(dev, site: str, q_rows: np.ndarray, db_rows: np.ndarray, launches: int) -> dict:
    """K1 on host signature rows of an unsigned type (u32 viewed, u16
    widened): `k1_device_site`, and its equal counts against integer
    equality on the host."""
    from gsearch_tpu_torch.ops.distance import as_int32_rows

    q, db = as_int32_rows(q_rows).to(dev), as_int32_rows(db_rows).to(dev)
    ent = k1_device_site(dev, site, q, db, launches, dtype=str(db_rows.dtype))
    eq = (q_rows[:, None, :] == db_rows[None, :, :]).sum(-1)
    got = ent.pop("out").cpu().numpy().astype(np.float64)
    if not np.array_equal(np.rint((1.0 - got) * q.shape[1]), eq):
        raise AssertionError(f"K1 {site}: equal counts differ from integer equality on the host")
    return ent


def print_k1_site(ent: dict) -> None:
    print(f"  K1 {ent['site']}: {ent['shape']} ({ent['plan']['tile']}, {ent['plan']['splits']} "
          f"splits), {ent['launches']} launch(es) on the main path: kernel {ent['ms']:.4f} ms "
          f"(device only {ent['device_ms']} ms), plain {ent['plain_ms']:.4f} ms, cdist "
          f"{ent['library_ms']:.4f} ms, bound {ent['bound_ms']:.5f} ms ({ent['bound_by']})")


def plant_patterns(rows: np.ndarray, rng) -> np.ndarray:
    """A copy of u32 rows with the patterns a float compare gets wrong
    planted at shared columns: NaN payloads (equal bits), +0 against -0
    (unequal bits), and values with equal low halves."""
    out = rows.copy()
    cols = rng.choice(rows.shape[1], 64, replace=False)
    pats = np.array([0x7FC00000, 0xFFC00001, 0x7F800001, 0x00000000, 0x80000000, 0x0001FFFF,
                     0x0002FFFF, 0xFFFFFFFF], np.uint32)
    out[:, cols] = pats[rng.integers(0, len(pats), size=(rows.shape[0], 64))]
    return out


def grown_request(dev, cfg, root, algo: str, db: str, q_dir: str, neighbours: str) -> dict:
    """The database of `algo` grown to `grown_total` rows with seeded decoy
    signatures of its own type (every bit pattern), requested through the
    CLI: the sign-expansion searcher and K2 on u32 or widened-u16 bits.
    The neighbours file equals the 48-genome one; ids and distances of the
    searcher equal brute_force_knn's."""
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.index.serialize import load_index
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.ops.distance import as_int32_rows, brute_force_knn
    from gsearch_tpu_torch.pipeline import dump_with_placeholders

    index = load_index(db, dev)
    dtype = index.sig_dtype
    rng = np.random.default_rng(SEED + 11)
    n_decoy = cfg["grown_total"] - index.nb_points
    decoys = rng.integers(0, 1 << (8 * dtype.itemsize), size=(n_decoy, index.sketch_size),
                          dtype=np.uint64).astype(dtype)
    index.insert(decoys)
    grown = os.path.join(root, f"db_{algo}_grown")
    dump_with_placeholders(db, grown, index)
    out = os.path.join(root, f"req_{algo}_grown")
    cuda_lib.reset_launches()
    with K2Recorder(keep=1) as rec:
        rc = main(["request", "-b", grown, "-n", str(cfg["knbn"]), "-r", q_dir, "-o", out,
                   "--device", dev.type])
    counts = dict(cuda_lib.launches)
    assert rc == 0, f"request of the grown {algo} database failed"
    with open(neighbours) as a, open(os.path.join(out, "gsearch.neighbors.txt")) as b:
        if a.read() != b.read():
            raise AssertionError(f"{algo}: neighbours file at {cfg['grown_total']} rows differs "
                                 "from the 48-genome one")
    res = {"counts": counts, "dtype": str(dtype)}
    if dev.type == "cuda":
        if counts["gather_hamming"] == 0 or counts["int_mm"] == 0 or not rec.calls:
            raise AssertionError(f"{algo}: the grown request did not go through K2 and the int8 "
                                 f"matmul: {counts}")
        res["k2_site"] = k2_site(dev, f"{algo} ({dtype}) database grown to {cfg['grown_total']}, "
                                 "CLI request", rec.calls[0], rec.count)
    del rec
    # the searcher against the exact sweep, on the real genomes' rows with a
    # seventh of their slots redrawn: the true neighbours are the cluster
    # mates, far below the decoys (whose distances tie and are not compared)
    sigs = index.get_sigs()
    n_real, k = index.nb_points - n_decoy, cfg["per_cluster"]
    q = sigs[:n_real].copy()
    q[:, ::7] = decoys[:n_real, ::7]
    d, ids = index.search(q, k)
    want_d, want_i = brute_force_knn(as_int32_rows(q).to(dev), as_int32_rows(sigs).to(dev), k)
    if not np.array_equal(d.view(np.uint32), want_d.cpu().numpy().view(np.uint32)) or not np.array_equal(
            ids, want_i.cpu().numpy()):
        raise AssertionError(f"{algo}: searcher ids or distances differ from brute_force_knn's")
    if not (ids[:, 0] == np.arange(n_real)).all() or not (d[:, k - 1] < 0.99).all():
        raise AssertionError(f"{algo}: a genome's neighbours are not itself and its cluster mates")
    return res


def phase_bindash(dev, cfg, root, p4) -> dict:
    """`bindash` through the CLI on the corpus against itself: its K1 call
    recorded and held against the plain version."""
    import gsearch_tpu_torch.ops.distance as dist_mod
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.ops import cuda_lib

    paths = sorted(os.path.join(p4["db_dir"], f) for f in os.listdir(p4["db_dir"]))
    lst, out = os.path.join(root, "bindash_list.txt"), os.path.join(root, "bindash.tsv")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    calls, real = [], dist_mod.hamming_frac

    def recorder(q, db, **kw):
        calls.append((q, db))
        return real(q, db, **kw)

    cuda_lib.reset_launches()
    dist_mod.hamming_frac = recorder
    try:
        t0 = time.perf_counter()
        rc = main(["bindash", "-q", lst, "-r", lst, "-k", str(cfg["kmer"]), "-s", str(cfg["sketch"]),
                   "-o", out, "--device", dev.type])
        t_run = time.perf_counter() - t0
    finally:
        dist_mod.hamming_frac = real
    counts = dict(cuda_lib.launches)
    assert rc == 0, "bindash failed"
    if len(calls) != 1 or (dev.type == "cuda" and counts["hamming_frac"] != 1):
        raise AssertionError(f"bindash: expected one K1 call, got {len(calls)} ({counts})")
    dist = {}
    with open(out) as f:
        next(f)
        for line in f:
            a, b, d = line.rstrip("\n").split("\t")
            dist[(os.path.basename(a), os.path.basename(b))] = float(d)
    n = len(paths)
    if len(dist) != n * n:
        raise AssertionError(f"bindash wrote {len(dist)} pairs, expected {n * n}")
    for (a, b), d in dist.items():
        mates = a.split("_")[0] == b.split("_")[0]
        if (a == b and d != 0.0) or (mates and not d < 0.06) or (not mates and not d > 0.2):
            raise AssertionError(f"bindash: {a} x {b} at {d}")
    q, db = calls[0]
    site = k1_site(dev, f"bindash {n} x {n}", q.cpu().numpy().view(np.uint32),
                   db.cpu().numpy().view(np.uint32), 1)
    print(f"phase algos bindash {n} x {n} at s={cfg['sketch']}: {t_run:.1f} s CLI wall, cluster "
          f"mates < 0.06, others > 0.2; its K1 call bitwise equal to the plain version")
    return {"counts": counts, "k1_site": site, "run_s": t_run}


def phase_algos(dev, cfg, root, p4, card: str) -> dict:
    """The other sketching algorithms and amino-acid mode at full width,
    through the CLI; K1 and K2 on their u32 and u16 signatures."""
    from gsearch_tpu_torch.cli.main import main
    from gsearch_tpu_torch.ops import cuda_lib
    from gsearch_tpu_torch.pipeline import read_genomes

    counts = {name: 0 for name in cuda_lib.launches}
    res = {"builds": {}, "k1_sites": [], "k2_sites": []}

    def build_and_request(tag, algo, db_dir, q_dir, source, kmer, aa):
        """CLI tohnsw + request of one algorithm; counts read around it."""
        db, out = os.path.join(root, f"db_{tag}"), os.path.join(root, f"req_{tag}")
        extra = ["--aa"] if aa else []
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        rc = main(["tohnsw", "-d", db_dir, "-k", str(kmer), "-s", str(cfg["sketch"]), "-n", "32",
                   "--ef", "200", "--algo", algo, "--block", *extra, "-o", db, "--device", dev.type])
        t_build = time.perf_counter() - t0
        assert rc == 0, f"tohnsw --algo {algo} failed"
        t0 = time.perf_counter()
        rc = main(["request", "-b", db, "-n", str(cfg["knbn"]), "-r", q_dir, "-o", out,
                   "--device", dev.type])
        t_request = time.perf_counter() - t0
        assert rc == 0, f"request against the {tag} database failed"
        got = dict(cuda_lib.launches)
        if dev.type == "cuda" and got["hamming_frac"] == 0:
            raise AssertionError(f"{tag}: the request never launched K1: {got}")
        for name in counts:
            counts[name] += got[name]
        neighbours = os.path.join(out, "gsearch.neighbors.txt")
        lo, hi = check_planted(tag, neighbours, source)
        return {"db": db, "neighbours": neighbours, "build_s": t_build, "request_s": t_request,
                "best_d": (lo, hi), "k1_launches": got["hamming_frac"]}

    def report(tag, algo, ent, genomes, picks, unit):
        ent["cpu_frac"] = card_vs_cpu(dev, algo, ent["db"], [genomes[i] for i in picks], cfg)
        ent["rate"] = sum(len(g) for g in genomes) / sketch_seconds(dev, ent["db"], genomes)
        held = (f"at most {ent['cpu_frac']:.2e} of a genome's slots differ from the CPU sketcher "
                f"(bound {LOG_SLOT_FRACTION:.0e})" if algo in LOG_ALGOS
                else "signatures bitwise equal to the CPU sketcher")
        print(f"phase algos {tag}: every best hit is the planted genome (distances "
              f"{ent['best_d'][0]:.4f}..{ent['best_d'][1]:.4f}); {held}")
        print(f"  timing {tag} on {card}: sketch {ent['rate'] / 1e6:.1f} M{unit}/s, tohnsw "
              f"{ent['build_s']:.2f} s, request of 8 {ent['request_s'] * 1e3:.0f} ms (CLI wall)")
        res["builds"][tag] = ent

    genomes = read_genomes(p4["db_dir"])
    # the longest genome (past the 4 M block) and the shortest one with N runs
    longest = int(np.argmax([len(g) for g in genomes]))
    picks = [longest, cfg["per_cluster"] - 1]
    for algo in cfg["algos"]:
        ent = build_and_request(algo, algo, p4["db_dir"], p4["q_dir"], p4["source"], cfg["kmer"], False)
        report(algo, algo, ent, genomes, picks, "bases")
        if algo == "prob":
            ent["sparse_share"] = sparse_prob_card_vs_cpu(dev, ent["db"], cfg)
            print(f"phase algos prob, {cfg['sparse_genomes']} sparse genomes of {cfg['sparse_len']} bases: "
                  f"found slots equal on card and CPU; {ent['sparse_share']:.3f} of the genomes differ in "
                  f"their empty slots (bound {PROB_SPARSE_GENOMES})")
    del genomes

    t0 = time.perf_counter()
    aa = write_aa_corpus(root, cfg)
    res["aa_write_s"] = time.perf_counter() - t0
    proteomes = read_genomes(aa["db_dir"], is_aa=True)
    for algo in cfg["aa_algos"]:
        tag = f"aa-{algo}"
        ent = build_and_request(tag, algo, aa["db_dir"], aa["q_dir"], aa["source"], cfg["aa_kmer"], True)
        report(tag, algo, ent, proteomes, [len(proteomes) - 1, 0], "residues")
    del proteomes

    # K1 on u32 and widened u16 signatures at the request's shape
    rng = np.random.default_rng(SEED + 13)
    for algo in ("prob", "hll"):
        sigs = np.load(os.path.join(res["builds"][algo]["db"], "index.sigs.npy"))
        db_rows = plant_patterns(sigs, rng) if sigs.dtype == np.uint32 else sigs.copy()
        q_rows = db_rows[rng.integers(0, len(db_rows), 8)].copy()
        redraw = rng.random(q_rows.shape) < rng.random((8, 1))
        q_rows[redraw] = db_rows[rng.integers(0, len(db_rows), 8)][redraw]
        res["k1_sites"].append(k1_site(
            dev, f"{algo} request, {sigs.dtype} rows" + (" widened" if sigs.dtype == np.uint16 else
                                                         " with NaN patterns"),
            q_rows, db_rows, res["builds"][algo]["k1_launches"]))
    print("phase algos K1 on u32 rows (NaN patterns, -0.0, equal low halves) and widened u16 rows at "
          f"8 x 48 x {cfg['sketch']}: bitwise equal to the plain version and to integer equality")

    # K2 on u32 and widened u16 bits: the grown databases through the CLI
    for algo in ("prob", "hll"):
        ent = res["builds"][algo]
        g = grown_request(dev, cfg, root, algo, ent["db"], p4["q_dir"], ent["neighbours"])
        for name in counts:
            counts[name] += g["counts"][name]
        if "k2_site" in g:
            res["k2_sites"].append(g["k2_site"])
        print(f"phase algos {algo} database ({g['dtype']}) grown to {cfg['grown_total']} rows: "
              "neighbours file byte-identical; searcher ids and distances equal brute_force_knn's")

    b = phase_bindash(dev, cfg, root, p4)
    for name in counts:
        counts[name] += b["counts"][name]
    res["k1_sites"].append(b["k1_site"])
    res["bindash_s"] = b["run_s"]
    res["counts"] = counts
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
    shutil.rmtree(pb["db"])
    del pb
    torch.cuda.empty_cache()

    cuda_lib.reset_launches()
    ps = timed("phase sharded", phase_sharded, dev, cfg, root, p4)
    sharded_counts = dict(cuda_lib.launches)
    if dev.type == "cuda" and (sharded_counts["gather_hamming"] == 0
                               or sharded_counts["hamming_frac_self"] == 0):
        raise AssertionError(f"the sharded database's requests and add did not go through K2 "
                             f"(beam hops) and K1's self pairs (add): {sharded_counts}")
    print(f"main-path launches, sharded: {sharded_counts}")
    cuda_lib.reset_launches()
    pa_ = timed("phase analysis", phase_analysis, dev, cfg, root, p4, ps)
    analysis_counts = dict(cuda_lib.launches)
    if dev.type == "cuda" and (analysis_counts["hamming_frac"] == 0 or analysis_counts["gather_hamming"] == 0
                               or analysis_counts["int_mm"] == 0):
        raise AssertionError(f"the analysis tools did not go through K1 (coreset), K2 and the int8 "
                             f"matmul (k-NN self-search): {analysis_counts}")
    print(f"main-path launches, analysis: {analysis_counts}")
    cuda_lib.reset_launches()
    pm = timed("phase mesh", phase_mesh, dev, cfg, root, p4, ps)
    mesh_counts = dict(cuda_lib.launches)
    if dev.type == "cuda" and any(mesh_counts[k] == 0 for k in (
            "hamming_frac", "gather_hamming", "gather_hamming_p2", "int_mm")):
        raise AssertionError(f"the mesh searchers did not go through K1 (member sweeps, entry tiers), K2 "
                             f"(graph hops and rerank), K2 parts=2 and the int8 matmul (compact members): "
                             f"{mesh_counts}")
    print(f"main-path launches, mesh: {mesh_counts}")
    shutil.rmtree(ps.pop("db"))
    torch.cuda.empty_cache()
    cuda_lib.reset_launches()
    sa = timed("phase superani", phase_superani, dev, cfg, root, p4)
    superani_counts = dict(cuda_lib.launches)
    print(f"main-path launches, superani: {superani_counts} (seed hashing is plain torch)")
    k2_sites += [ps["k2_site"], pa_["k2_site"], *pm["k2_sites"]]

    cuda_lib.reset_launches()
    bg = timed("phase bigsig", phase_bigsig, dev, cfg, root, p4)
    bigsig_counts = dict(cuda_lib.launches)
    print(f"main-path launches, bigsig: {bigsig_counts} (gather / AND / popcount is plain torch)")
    cuda_lib.reset_launches()
    im = timed("phase import", phase_import, dev, cfg, root, p4)
    import_counts = dict(cuda_lib.launches)
    if dev.type == "cuda" and any(import_counts[k] == 0 for k in (
            "gather_hamming", "int_mm", "gather_hamming_p2", "hamming_frac_self")):
        raise AssertionError(f"the imports and their requests did not go through the bulk build (K2 "
                             f"parts=2, K1's self pairs) and the searchers (K2, the int8 matmul): "
                             f"{import_counts}")
    print(f"main-path launches, import: {import_counts}")
    cuda_lib.reset_launches()
    hm = timed("phase hmmsearch", phase_hmmsearch, dev, cfg, root)
    hmm_counts = dict(cuda_lib.launches)
    print(f"main-path launches, hmmsearch: {hmm_counts} (the Plan7 recurrences are plain torch)")
    gpd = timed("phase genepred", phase_genepred, dev, cfg, root)
    print(f"main-path launches, genepred: {gpd['counts']}")

    algos = timed("phase algos", phase_algos, dev, cfg, root, p4, card)
    print(f"main-path launches, algos: {algos['counts']}")
    k2_sites += algos["k2_sites"]
    k1_sites = algos["k1_sites"] + pa_["k1_sites"] + [pm["k1_site"]]
    launches = {k: flat_counts[k] + graph_counts[k] + tier_counts[k] + sharded_counts[k]
                + analysis_counts[k] + mesh_counts[k] + superani_counts[k] + bigsig_counts[k] + import_counts[k]
                + hmm_counts[k] + gpd["counts"][k] + algos["counts"][k] for k in flat_counts}

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
        for ent in k1_sites:
            print_k1_site(ent)
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
    print(f"  timing sharded on {card}: {cfg['shard_queries']} queries x {cfg['shard_total']} x "
          f"{cfg['sketch']} in {cfg['n_shards']} shards, k={cfg['knbn']}: {ps['search_s'] * 1e3:.1f} ms "
          f"warm ({ps['search_cold_s']:.2f} s cold, {ps['hops']} hops in all); CLI request of 8 "
          f"{ps['request_s']:.1f} s, add of 8 {ps['add_s']:.1f} s; beam-insert build {ps['build_s']:.1f} s")
    print(f"  timing k-NN graph on {card}: {cfg['shard_total']} nodes, k={cfg['knbn']}: "
          f"{cfg['shard_total'] / pa_['knn_flat_s']:.0f} nodes/s (hnsw2knn CLI wall {pa_['knn_flat_s']:.1f} s, "
          f"load and searcher build included; sharded database {pa_['knn_sharded_s']:.1f} s)")
    print(f"  timing embed on {card}: {cfg['shard_total']} nodes ({'hierarchical' if pa_['hier'] else 'dmap'} "
          f"init): init {pa_['embed_init_s']:.1f} s, optimisation {pa_['embed_opt_s']:.1f} s; ann CLI "
          f"{pa_['ann_s']:.1f} s")
    print(f"  timing coreset on {card}: hnswcore --coreset {cfg['coreset']} --cluster {cfg['cluster']} "
          f"over {cfg['shard_total']}: hamming {pa_['core_hamming_s']:.1f} s ({pa_['k1_calls']} K1 calls), "
          f"l2 {pa_['core_l2_s']:.1f} s (CLI wall)")
    print(f"  timing mesh on {card}, {pm['members']} members on the one card (they run one after another): "
          f"sketch {pm['mbases'] / pm['sketch_s']:.1f} Mbases/s ({pm['mbases']:.1f} Mbases); "
          f"{cfg['mesh_queries']} queries x {cfg['mesh_total']} x {cfg['sketch']}, k={cfg['knbn']}: MeshSearcher "
          f"{pm['exact_s'] * 1e3:.1f} ms warm ({pm['exact_cold_s'] * 1e3:.1f} cold), MeshMxuSearcher "
          f"{pm['mxu_s'] * 1e3:.1f} ms warm ({pm['mxu_cold_s'] * 1e3:.1f} cold, build {pm['mxu_build_s']:.2f} s); "
          f"MeshGraphSearcher {cfg['shard_queries']} queries x {cfg['shard_total']} in {pm['members']} shards "
          f"{pm['graph_s'] * 1e3:.1f} ms warm ({pm['graph_cold_s'] * 1e3:.1f} cold, {pm['graph_hops']} hops, "
          f"build {pm['graph_build_s']:.2f} s), request of 8 with the mesh {pm['graph_request_s']:.1f} s; "
          f"CLI --mesh -1 tohnsw {pm['cli_build_s']:.1f} s, request {pm['cli_request_s']:.1f} s; rows drawn "
          f"in {pm['gen_s']:.1f} s; waited {pm['process_wait_s']:.1f} s for the two processes")
    print(f"  timing superani on {card}: sketch {sa['mbases'] / sa['sketch_s']:.1f} Mbases/s "
          f"({sa['mbases']:.1f} Mbases, parsed), compare {sa['pairs'] / sa['compare_s']:.0f} pairs/s; "
          f"CLI {sa['cli_s']:.1f} s for {sa['pairs']} pairs")
    parts = ", ".join(f"{k} {v:.2f} s" for k, v in bg["construct_parts"].items())
    print(f"  timing bigsig on {card}: construct {bg['mbases']:.1f} Mbases in {bg['construct_s']:.1f} s "
          f"CLI wall ({bg['mbases'] / bg['construct_s']:.1f} Mbases/s; {parts}); "
          f"identify {bg['reads']} single-end reads {bg['identify_s']:.1f} s CLI wall "
          f"({bg['reads'] / bg['identify_s']:.0f} reads/s), {bg['pairs']} pairs {bg['paired_s']:.1f} s; "
          f"counts pass over the {bg['reads']} reads (batches of 4,096, 256 bases): {bg['nb_real']} "
          f"columns {bg['reads'] / bg['pass_real_s']:.0f} reads/s, {bg['columns']} columns "
          f"({bg['matrix_gb']:.2f} GB) {bg['reads'] / bg['pass_wide_s']:.0f} reads/s")
    for kind in ("flat", "hnsw"):
        ent = im[kind]
        stages = ", ".join(f"{k} {v:.2f} s" for k, v in ent["stages"].items())
        passes = ", ".join(f"{k} {v:.2f} s" for k, v in ent["passes"].items()) or "none"
        print(f"  timing import on {card}: {kind} {cfg['import_total']} x {cfg['sketch']} "
              f"({im['gb']:.2f} GB dump, written in {im['write_s']:.1f} s): CLI wall {ent['wall_s']:.1f} s "
              f"({stages}); build passes: {passes}; CLI request of 8 {ent['request_s']:.1f} s")
    for algo in ("forward", "viterbi"):
        sec, cells, blocks = hm["timing"][algo]
        print(f"  timing hmmsearch on {card}: {algo} {hm['profiles']} profiles x {hm['proteins']} proteins "
              f"({hm['residues']} residues): {sec:.2f} s, {cells / sec:.4g} cells/s ({cells} cells, "
              f"{blocks} blocks)")
    print(f"  timing hmmsearch CLI on {card}: {hm['cli_s']:.1f} s (parse, both algorithms, TSV)")
    walls = ", ".join(f"{k} {v:.2f}" for k, v in gpd["walls"].items())
    print(f"  timing genepred on {card}: -t standard over {len(gpd['walls'])} genomes "
          f"({gpd['bases'] / 1e6:.1f} Mbases) {gpd['standard_s']:.1f} s CLI wall "
          f"({gpd['bases'] / 1e6 / gpd['standard_s']:.2f} Mbases/s; s a genome: {walls}); -t self on "
          f"genome 0 {gpd['self_s']:.1f} s; the same genome with --device cpu {gpd['cpu_s']:.1f} s; "
          f"AA chain tohnsw --aa {gpd['aa_build_s']:.2f} s, request {gpd['aa_request_s']:.2f} s")
    ent = gpd["fused"]["genome"]
    print(f"  timing genepred decode on {card}: {gpd['decode_bases'] / 1e6:.2f} Mbases "
          f"({ent['windows']} windows) in {gpd['decode_s'] * 1e3:.2f} ms with the standard tables, "
          f"{gpd['decode_self_s'] * 1e3:.2f} ms with genome 0's self-trained ones "
          f"({gpd['decode_bases'] / 1e6 / gpd['decode_s']:.1f} Mbases/s; windows, upload, one fused "
          f"launch, download); -t self with --device cpu {gpd['self_cpu_s']:.1f} s")
    if dev.type == "cuda":
        for tag, ent in gpd["fused"].items():
            print(f"  genepred_decode {tag} ({ent['windows']} windows x 8192, {ent['model']} tables): kernel "
                  f"{ent['ms']:.4f} ms (device only {ent['device_ms']:.4f} ms; profiler {ent['profiler_ms']}), "
                  f"plain composition {ent['plain_ms']:.1f} ms, bound {ent['bound_ms']:.4f} ms "
                  f"({ent['bound_by']}; {ent['bytes']} bytes, {ent['ops']} ops, {ent['ctx_hits']} context "
                  f"hits), serial chain {ent['chain_ms']:.4f} ms")
        for tag, ent in gpd["kernel"].items():
            print(f"  viterbi {tag} ({ent['windows']} windows x 8192): kernel {ent['ms']:.4f} ms "
                  f"(device only {ent['device_ms']:.4f} ms), plain {ent['plain_ms']:.1f} ms, bound "
                  f"{ent['bound_ms']:.4f} ms ({ent['bound_by']}), serial chain {ent['chain_ms']:.4f} ms")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items()))
    src = "gsearch_tpu_torch/csrc/hamming.cu"

    def entry(name, replaces, err, ent, library_ms=None, source=src, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err, "ms": ent.get("ms"),
                "plain_ms": ent.get("plain_ms"), "bound_ms": ent.get("bound_ms"),
                "bound_by": ent.get("bound_by"), "library_ms": library_ms, **extra}

    k1_extra = {k: k1.get(k) for k in ("ms_wide", "ms_narrow16", "ms_narrow8", "ms_8x48",
                                       "plain_ms_8x48", "library_ms_8x48", "bound_ms_8x48",
                                       "device_ms", "device_ms_8x48", "ms_512", "bound_ms_512",
                                       "load_512", "plan")}
    kernels = [
        entry("hamming_frac", "gsearch_tpu/ops/distance.py:69", k1["err"], k1, k1.get("library_ms"),
              shape=list(cfg["k1"]), main_path=k1_sites, **k1_extra),
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
    keys = ("windows", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "chain_ms")
    fz = gpd["fused"]
    kernels.append(entry("genepred_decode", "gsearch_tpu/models/genepred.py:838", max(e["err"] for e in fz.values()),
                         fz["genome"], source="gsearch_tpu_torch/csrc/viterbi.cu",
                         shape=[fz["genome"]["windows"], 8192], device_ms=fz["genome"].get("device_ms"),
                         chain_ms=fz["genome"].get("chain_ms"),
                         **{tag: {k: fz[tag].get(k) for k in keys + ("ctx_hits",)}
                            for tag in ("dispatch", "genome_self", "dispatch_self")}))
    vit = gpd["kernel"]
    # the memory-fed form: no longer on the main path (the fused one
    # replaced it there); the tests' planted emissions go through it
    kernels.append(entry("viterbi", "gsearch_tpu/models/genepred.py:790", vit["genome"]["err"],
                         vit["genome"], source="gsearch_tpu_torch/csrc/viterbi.cu",
                         shape=[vit["genome"]["windows"], 8192, 11], on_main_path=False,
                         device_ms=vit["genome"].get("device_ms"), chain_ms=vit["genome"].get("chain_ms"),
                         dispatch={k: vit["dispatch"].get(k) for k in keys}))
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
