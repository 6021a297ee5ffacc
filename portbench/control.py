"""The controls of a cell, and the faults its numbers are held against:
each judged by the cell's own numbers and limits beside a sound run of
the same set-up.  The benchmark's runs never run them.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 [--seconds 5]

Search cells: one set-up a seed (inputs, index, warm-up, as the cell's
run makes them), then each variant's short window at the cell's load, its
answers sampled and judged as a run judges them:
- `program`: the cell as it runs (the lower reading);
- `lower` (a control): the program's own path one precision step down:
  the flat index's estimator-only searcher (the sign expansion's top-k
  with its estimated distances); the graph index's device answers
  (`search_device`: packed8's 8-bit hashed distances, without the exact
  host re-score);
- `reference8` (a control): the plain exact k-NN over 8-bit slot hashes in
  the program's place, for the same sampled queries;
- `packed4` (graph index only; reported, not a control): the 4-bit rerank
  tier forced by a smaller device budget, which over-fetches 32 and
  re-scores exactly, so its answers keep the guarantee;
- `drop_half` (a fault, run last): the candidate stage loses every odd
  row (its sign expansion zeroed), so the rerank sees a wrong candidate
  list and still reports exact distances for it.
Ingest cells: the plain reference sketcher's signatures through its
`control` (the OptDens reference's: carried in bfloat16).

Prints one JSON line a seed and variant: the numbers, and which limits
they break.  Exits 0 where every sound run is correct and every control
and fault is not.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile

import numpy as np
import torch

from . import drivers, judge, run
from .reference import knn

# a device budget under which the graph index's rule picks packed4 at
# 318,000 x 12,000 (packed8 needs 0.7 x budget >= 524,289 x 12,288 bytes)
PACKED4_BUDGET = 8_000_000_000


@contextlib.contextmanager
def _lower(cell):
    idx = cell.index
    if hasattr(idx, "_mxu"):
        from gsearch_tpu_torch.ops.mxu import MxuSearcher

        kept = idx._mxu
        idx._mxu = MxuSearcher(idx._sigs, cell.device, estimator_only=True)
        try:
            yield
        finally:
            idx._mxu = kept
        return

    def device_answers(queries, knbn, ef_search=0):
        nq = queries.shape[0]
        qbuf = np.full((max(8, 1 << (nq - 1).bit_length()), idx.sketch_size), -1, np.int32)
        qbuf[:nq] = queries.view(np.int32)
        d, ids = idx.search_device(idx._to_dev(qbuf), knbn, ef_search)
        return d.cpu().numpy()[:nq], ids.cpu().numpy()[:nq]

    idx.search = device_answers
    try:
        yield
    finally:
        del idx.search


@contextlib.contextmanager
def _packed4(cell):
    from gsearch_tpu_torch.index import hnsw

    kept = hnsw._RERANK_DEVICE_BYTES
    hnsw._RERANK_DEVICE_BYTES = PACKED4_BUDGET
    try:
        assert cell.index._rerank_tier()[0] == "packed4", cell.index._rerank_tier()
        yield
    finally:
        hnsw._RERANK_DEVICE_BYTES = kept


@contextlib.contextmanager
def _drop_half(cell):
    idx = cell.index
    searcher = idx._mxu if hasattr(idx, "_mxu") else idx._coarse
    searcher._db_exp[1::2] = 0
    yield


# name -> (how the index is switched, None for the reference; expected correct)
SEARCH_VARIANTS = {
    "program": (contextlib.nullcontext, True),
    "lower": (_lower, False),
    "reference8": (None, False),
    "packed4": (_packed4, None),
    "drop_half": (_drop_half, False),
}


def search_variants(files, seed: int, device, seconds: float, names) -> list:
    """[(variant, numbers)] of one set-up of the cell, the variants named
    in SEARCH_VARIANTS' order (program before reference8, drop_half last)."""
    cell = drivers.SearchCell(files.cfg, files.traffic, seed, device)
    cell.setup()
    ref = knn.ExactKnn(cell.db, device)
    out, program_sample = [], None
    flat = hasattr(cell.index, "_mxu")
    for name in names:
        if name == "packed4" and flat:
            continue
        switch, _ = SEARCH_VARIANTS[name]
        if switch is None:  # the reference in the program's place, on the sound run's queries
            q = program_sample[0]
            d, ids = knn.ExactKnn(cell.db, device, hashed=8).search(q, files.traffic["knbn"])
            out.append((name, cell.judge(ref, (q, d, ids))))
            continue
        with switch(cell):
            cell.index.search(cell.batches[0], files.traffic["knbn"], files.traffic["ef_search"])
            cell.window(seconds)
            sample = cell.sample()
        if name == "program":
            program_sample = sample
        out.append((name, cell.judge(ref, sample)))
    return out


def ingest_control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The cell's corpus, sketched by its plain reference, against the
    reference's own control of those signatures."""
    corpus, ref = drivers.ingest_parts(cfg, traffic)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        files = sorted(corpus.write(tmp, drivers.corpus_spec(cfg, traffic), seed)["files"])
        files = files[: traffic["check_genomes"]]
        sigs = np.stack([ref.sketch(ref.read_genome(f), k=cfg["kmer_size"], s=cfg["sketch_size"],
                                    device=device) for f in files])
    return judge.sketch_numbers(sigs, [(ref.control(sigs), len(files))], len(files))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the controls and faults of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0, help="each search variant's window")
    args = ap.parse_args(argv)
    files = run.cell_files(run.spec(), args.workload)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    as_expected = True
    for seed in (int(s) for s in args.seeds.split(",")):
        if files.traffic["kind"] == "ingest":
            results = [("control", ingest_control(files.cfg, files.traffic, seed, device), False)]
        else:
            results = [(n, nums, SEARCH_VARIANTS[n][1]) for n, nums in
                       search_variants(files, seed, device, args.seconds, list(SEARCH_VARIANTS))]
        for name, numbers, want in results:
            ok, rows = judge.verdict(numbers, files.limits)
            as_expected &= want is None or ok == want
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": name, "correct": ok,
                              "numbers": numbers,
                              "broken": [n for n, v, lim in rows if v is None or not v <= lim]}), flush=True)
    return 0 if as_expected else 1


if __name__ == "__main__":
    sys.exit(main())
