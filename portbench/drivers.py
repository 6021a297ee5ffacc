"""The two kinds of traffic: `search` (query batches through an index, a
closed loop) and `ingest` (whole database builds from FASTA).  A traffic
file names its kind; the configuration says what the database is.

An ingest cell's corpus writer and plain reference sketcher are found by
name (`ingest_parts`), so a configuration with other symbols or another
sketcher comes as new files.

A driver's life: `setup()` draws the inputs from the seed, builds what the
program needs and warms up every shape the window uses; `window()` runs
the timed loop and keeps every answer; `check()` frees the program's state
and judges the answers against the plain reference.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from . import gen, judge, run
from .reference import knn

# the request's answer filter (gsearch's dnarequest.rs:83): answers at or
# beyond this distance are not written, so they are not judged as misses
OUT_THRESHOLD = 0.99


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _report_failure(what: str, first: bool) -> None:
    if first:
        print(f"{what} failed:\n{traceback.format_exc()}", file=sys.stderr)


class SearchCell:
    kind = "search"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.lines: list = []

    def _index(self):
        from gsearch_tpu_torch.index.flat import FlatIndex
        from gsearch_tpu_torch.index.hnsw import HnswIndex
        from gsearch_tpu_torch.pipeline import flat_auto_limit

        cfg, s = self.cfg, self.cfg["sketch_size"]
        kind = cfg["index"]
        if kind == "auto":  # tohnsw's rule
            kind = "flat" if cfg["genomes"] <= flat_auto_limit(s) else "hnsw"
        if kind == "flat":
            return FlatIndex(s, np.float32, self.device)
        return HnswIndex(s, np.float32, max_nb_conn=min(cfg["max_nb_conn"], 255),
                         ef_construction=cfg["ef_construction"], device=self.device)

    def setup(self) -> None:
        t = self.traffic
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        t0 = time.perf_counter()
        self.db = gen.database(self.cfg, g, self.device)
        self.pool = gen.query_pool(self.db, t["pool"], tuple(t["redraw"]), g, self.device)
        self.batches = self.pool.reshape(-1, t["batch"], self.pool.shape[1])
        t1 = time.perf_counter()
        self.index = self._index()
        self.index.insert(self.db)
        t2 = time.perf_counter()
        for i in range(t["warmup_calls"]):
            self.index.search(self.batches[i % len(self.batches)], t["knbn"], t["ef_search"])
        t3 = time.perf_counter()
        self.lines.append(f"set-up: inputs drawn {t1 - t0:.3f} s, index built {t2 - t1:.3f} s, "
                          f"{t['warmup_calls']} warm-up calls {t3 - t2:.3f} s")
        self.lines.append(self._route())

    def _route(self) -> str:
        idx = self.index
        if hasattr(idx, "_mxu"):
            m = idx._mxu
            if m is None:
                return f"index flat, {idx.nb_points} genomes, exact sweep (K1)"
            tier = "compact" if m.compact else "full"
            return (f"index flat, {idx.nb_points} genomes: MxuSearcher {tier} tier, m {m.m}, "
                    f"expansion {tuple(m._db_exp.shape)} int8, rerank "
                    f"{None if m._rr is None else tuple(m._rr.shape)} int32")
        st = idx.stats.get("search", {})
        build = idx.stats.get("build_s", {})
        return (f"index hnsw, {idx.nb_points} genomes, max_nb_conn {idx.max_nb_conn}, "
                f"ef_construction {idx.ef_construction}: route {st.get('route')}, tier "
                f"{st.get('tier')} {idx._rerank_tier()}; build stages "
                + ", ".join(f"{k} {v:.3f} s" for k, v in build.items()))

    def window(self, seconds: float, tracer=None) -> SimpleNamespace:
        t, nb = self.traffic, len(self.batches)
        span = tracer.span if tracer is not None else None
        calls, walls, failed = [], [], 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            b = i % nb
            t0 = time.perf_counter()
            try:
                if span is None:
                    d, ids = self.index.search(self.batches[b], t["knbn"], t["ef_search"])
                else:
                    with span("search"):
                        d, ids = self.index.search(self.batches[b], t["knbn"], t["ef_search"])
            except Exception:  # a failed request is counted, and the window goes on
                _report_failure("a search", failed == 0)
                failed += 1
                d = ids = None
            t1 = time.perf_counter()
            calls.append((b, d, ids))
            walls.append(t1 - t0)
            i += 1
            if t1 >= deadline:
                break
        self.calls = calls
        return SimpleNamespace(kind=self.kind, window_s=t1 - t_start, attempted=len(calls),
                               failed=failed, answered=(len(calls) - failed) * t["batch"],
                               walls=walls, batches=len(calls))

    def sample(self) -> tuple:
        """(queries [R, S], distances [R, k], ids [R, k]): a sample of the
        window's answers drawn from the seed; a failed call's rows come
        back as no valid answer."""
        t, k = self.traffic, self.traffic["knbn"]
        rows = len(self.calls) * t["batch"]
        rng = np.random.default_rng([self.seed, 0x5A3B1E])
        pick = np.sort(rng.choice(rows, size=min(t["check_queries"], rows), replace=False))
        qs, ds, idss = [], [], []
        for p in pick:
            b, d, ids = self.calls[p // t["batch"]]
            r = p % t["batch"]
            qs.append(self.batches[b][r])
            if d is None or d.shape[0] != t["batch"] or ids.shape[0] != t["batch"]:
                d = np.full((t["batch"], k), np.nan, np.float32)
                ids = np.full((t["batch"], k), -1, np.int32)
            ds.append(d[r])
            idss.append(ids[r])
        return np.stack(qs), np.stack(ds), np.stack(idss)

    def judge(self, ref, sample: tuple) -> dict:
        """The numbers of a sample against ref (reference.knn.ExactKnn)."""
        return judge.search_numbers(ref, *sample, k=self.traffic["knbn"], threshold=OUT_THRESHOLD,
                                    near=judge.species_distance(self.cfg["kmer_size"]))

    def check(self) -> dict:
        """Judge a sample of the window's answers once the program's state
        is freed."""
        self.lines.append(self._route())
        sample = self.sample()
        del self.index
        _free(self.device)
        return self.judge(knn.ExactKnn(self.db, self.device), sample)


def corpus_spec(cfg: dict, traffic: dict) -> dict:
    """The genome corpus a pass ingests: the traffic's shapes, the
    configuration's genome count."""
    return dict(traffic, genomes=cfg["genomes"])


def ingest_parts(cfg: dict, traffic: dict) -> tuple:
    """(corpus, reference): the corpus writer the traffic names (`corpus`,
    default `genomes`; `corpora/<name>.py`) and the plain reference
    sketcher the configuration names (`reference`, default `sketch`;
    `reference/<name>.py`).  Raises ValueError where the reference does
    not sketch the configuration's `algo` or `data`, or the corpus does
    not write its `data`: such a cell could only fail every slot."""
    c_name, r_name = traffic.get("corpus", "genomes"), cfg.get("reference", "sketch")
    corpus, ref = run.part("corpora", c_name), run.part("reference", r_name)
    where = f"configuration {cfg.get('name')!r}"
    if cfg["algo"] != ref.ALGO:
        raise ValueError(f"{where} asks for algo {cfg['algo']!r}; its reference {r_name!r} sketches "
                         f"algo {ref.ALGO!r}")
    if cfg["data"] not in ref.DATA:
        raise ValueError(f"{where} asks for data {cfg['data']!r}; its reference {r_name!r} takes data "
                         f"{', '.join(map(repr, ref.DATA))}")
    if corpus.DATA != cfg["data"]:
        raise ValueError(f"{where} asks for data {cfg['data']!r}; its corpus {c_name!r} writes data "
                         f"{corpus.DATA!r}")
    return corpus, ref


class IngestCell:
    kind = "ingest"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.lines: list = []

    def _params(self):
        from gsearch_tpu_torch.core import ProcessingParams
        from gsearch_tpu_torch.core.params import HnswParams, SeqSketcherParams

        cfg = self.cfg
        return ProcessingParams(
            hnsw=HnswParams(capacity=1_500_000, ef=cfg["ef_construction"],
                            max_nb_conn=min(cfg["max_nb_conn"], 255), scale_modification=1.0),
            sketch=SeqSketcherParams(kmer_size=cfg["kmer_size"], sketch_size=cfg["sketch_size"],
                                     algo=cfg["algo"].upper(), data_t=cfg["data"]),
            block_flag=cfg["block"])

    def _build(self, out: str) -> dict:
        from gsearch_tpu_torch.core import ComputingParams
        from gsearch_tpu_torch.pipeline import build_database

        computing = ComputingParams(nb_threads=self.traffic.get("nb_threads", 0))
        return build_database(self.genomes, out, self.params, computing, self.cfg["index"],
                              device=self.device)

    def setup(self) -> None:
        from gsearch_tpu_torch.io import native

        corpus, self.ref = ingest_parts(self.cfg, self.traffic)
        self.tmp = tempfile.mkdtemp(prefix="portbench-ingest-")
        self.genomes = os.path.join(self.tmp, "genomes")
        t0 = time.perf_counter()
        self.corpus = corpus.write(self.genomes, corpus_spec(self.cfg, self.traffic), self.seed)
        t1 = time.perf_counter()
        self.params = self._params()
        warm = os.path.join(self.tmp, "warm")
        self._build(warm)
        shutil.rmtree(warm)
        t2 = time.perf_counter()
        self.lines.append(f"set-up: corpus of {len(self.corpus['files'])} genomes, "
                          f"{self.corpus['bases']} bases written {t1 - t0:.3f} s, warm-up pass "
                          f"{t2 - t1:.3f} s; FASTA parser: {native.parser()}")

    def window(self, seconds: float, tracer=None) -> SimpleNamespace:
        passes, stages, failed, ends = [], {}, 0, []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            out = os.path.join(self.tmp, f"pass{len(passes)}")
            try:
                if tracer is None:
                    rep = self._build(out)
                else:
                    with tracer.span("pass"):
                        rep = self._build(out)
                for name, st in rep["stages"].items():
                    stages[name] = stages.get(name, 0.0) + st["wall_s"]
            except Exception:  # a failed pass is counted, and the window goes on
                _report_failure("a pass", failed == 0)
                failed += 1
            t1 = time.perf_counter()
            passes.append(out)
            ends.append(t1 - t_start)
            if t1 >= deadline:
                break
        self.passes, self.walls = passes, np.diff([0.0] + ends)
        done = len(passes) - failed
        return SimpleNamespace(kind=self.kind, window_s=t1 - t_start, attempted=len(passes),
                               failed=failed, bases=done * self.corpus["bases"], stages=stages,
                               batches=len(passes))

    def check(self) -> dict:
        """Every pass's signatures of a seeded sample of genomes against the
        plain reference sketcher's."""
        t, cfg, ref = self.traffic, self.cfg, self.ref
        self.lines.append("window: pass walls s " + " ".join(f"{w:.3f}" for w in self.walls))
        files = sorted(self.corpus["files"])
        rng = np.random.default_rng([self.seed, 0x1D6E57])
        pick = np.sort(rng.choice(len(files), size=min(t["check_genomes"], len(files)), replace=False))
        want = np.stack([ref.sketch(ref.read_genome(files[i]), k=cfg["kmer_size"],
                                    s=cfg["sketch_size"], device=self.device) for i in pick])
        got = []
        for out in self.passes:
            try:
                sigs = np.load(os.path.join(out, "index.sigs.npy"))
                with open(os.path.join(out, "seqdict.json")) as f:
                    row = {os.path.abspath(it["path"]): r for r, it in enumerate(json.load(f))}
                got.append((sigs[[row[os.path.abspath(files[i])] for i in pick]], sigs.shape[0]))
            except (OSError, KeyError, ValueError):
                got.append(None)
        shutil.rmtree(self.tmp, ignore_errors=True)
        return judge.sketch_numbers(want, got, len(files))


DRIVERS = {"search": SearchCell, "ingest": IngestCell}
