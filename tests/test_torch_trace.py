"""gsearch_tpu_torch's spans and counters (utils/trace.py) on the CPU: off,
nothing is built or recorded; under torch.profiler, the searchers' stages,
the graph's host re-score and the ingest pipeline's stages record where
they run, with counters that follow the shapes; StageTimer's CPU time is
its own thread's; the CLI's --trace writes the record as JSON."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gsearch_tpu_torch.index.hnsw as thnsw
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.core import ComputingParams, ProcessingParams
from gsearch_tpu_torch.core.params import HnswParams, SeqSketcherParams
from gsearch_tpu_torch.ops import host_rescore
from gsearch_tpu_torch.ops import mxu as tmxu
from gsearch_tpu_torch.pipeline import build_database
from gsearch_tpu_torch.utils import StageTimer, trace

CPU = torch.device("cpu")
SEARCH_STAGES = ("search.stage", "search.upload", "search.device", "search.expand", "search.int_mm",
                 "search.select", "search.rerank", "search.final", "search.download")


@pytest.fixture(autouse=True)
def fresh_record():
    trace.disable()
    trace.snapshot(reset=True)
    yield
    trace.disable()
    trace.snapshot(reset=True)


def _corpus(root, n=6, length=30_000, seed=5):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    root.mkdir()
    for i in range(n):
        contigs = b"".join(b">c%d\n" % j + bytes(rng.choice(acgt, length // 2)) + b"\n" for j in range(2))
        (root / f"g{i}.fna").write_bytes(contigs)
    return n * length


def _clustered(rng, n, s, clusters=16):
    """Signatures in clusters whose members share at least half their slots."""
    rows = rng.integers(0, 1 << 30, size=(clusters, s)).astype(np.uint32)[np.arange(n) % clusters]
    redraw = rng.random((n, s)) < rng.uniform(0.0, 0.5, size=(n, 1))
    rows[redraw] = rng.integers(0, 1 << 30, size=int(redraw.sum()), dtype=np.uint32)
    return rows


def _params():
    return ProcessingParams(
        hnsw=HnswParams(capacity=1000, ef=64, max_nb_conn=16, scale_modification=1.0),
        sketch=SeqSketcherParams(kmer_size=16, sketch_size=256, algo="OPTDENS", data_t="DNA"),
        block_flag=True)


def test_off_builds_and_records_nothing(rng, monkeypatch, tmp_path):
    def boom(*a, **k):
        raise AssertionError("built while tracing is off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert not trace.on()
    assert trace.span("search", CPU) is trace.span("sketch.race")
    with pytest.raises(ValueError):
        with trace.span("search"):
            raise ValueError("passes through")
    sigs = rng.integers(0, 1 << 20, size=(300, 64)).astype(np.uint32)
    tmxu.MxuSearcher(sigs, CPU).search(sigs[:9], 5)
    timer = StageTimer()
    with timer.stage("parse"):
        trace.count("ingest.bases", 10)
    _corpus(tmp_path / "g", n=2)
    build_database(str(tmp_path / "g"), str(tmp_path / "db"), _params(), ComputingParams(nb_threads=2),
                   "flat", device=CPU)
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert timer.report()["parse"]["calls"] == 1


def test_mxu_search_spans_under_the_profiler(rng):
    sigs = rng.integers(0, 1 << 20, size=(300, 64)).astype(np.uint32)
    searcher = tmxu.MxuSearcher(sigs, CPU)
    q, k, calls = sigs[:9], 5, 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        for _ in range(calls):
            searcher.search(q, k)
    snap = trace.snapshot()
    spans = snap["spans"]
    for name in SEARCH_STAGES:
        # select: the top-k of the one score chunk, then the candidates' sort
        assert spans[name]["calls"] == calls * (2 if name == "search.select" else 1), name
        assert spans[name]["device_s"] is None and spans[name]["wall_s"] > 0
    assert snap["counters"]["search.candidates"] == calls * q.shape[0] * searcher._nb_cand(k)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"gs:" + n for n in SEARCH_STAGES} <= names


@pytest.fixture(scope="module")
def packed4_graph():
    """A graph whose search takes the packed4 tier (once the budget is
    lowered) and its queries."""
    rng = np.random.default_rng(7)
    n, s = 2100, 6144
    sigs = _clustered(rng, n + 6, s)
    idx = thnsw.HnswIndex(s, np.uint32, max_nb_conn=8, ef_construction=64, search_prefix=64,
                          device=CPU)
    idx.insert(sigs[:n], bulk=False)
    return idx, sigs[n:]


def test_graph_rescore_counts_fetched_rows(monkeypatch, packed4_graph):
    """packed4 over-fetches max(32, k) rows a query and re-scores them on
    the host."""
    monkeypatch.setattr(thnsw, "_RERANK_DEVICE_BYTES", 8000 * (4096 + 1))
    idx, q = packed4_graph
    assert idx._rerank_tier()[0] == "packed4"
    k = 5
    with profile(activities=[ProfilerActivity.CPU]):
        d, ids = idx.search(q, k, 64)
    snap = trace.snapshot()
    assert ids.shape == (q.shape[0], k)
    for name in ("search", "search.stage", "search.upload", "search.route.beam", "search.rerank",
                 "search.download", "search.rescore"):
        assert snap["spans"][name]["calls"] == 1, name
    assert snap["counters"]["search.queries"] == q.shape[0]
    assert snap["counters"]["search.rescore_rows"] == q.shape[0] * 32


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_graph_rescore_counts_native_rows(monkeypatch, packed4_graph, native):
    """search.rescore_native_rows counts the rows the native library
    re-scored: all of search.rescore_rows with it loaded, 0 on the numpy
    fallback."""
    monkeypatch.setattr(thnsw, "_RERANK_DEVICE_BYTES", 8000 * (4096 + 1))
    if native:
        assert host_rescore.get_lib() is not None
    else:
        monkeypatch.setattr(host_rescore, "get_lib", lambda: None)
    idx, q = packed4_graph
    trace.enable()
    idx.search(q, 5, 64)
    counters = trace.snapshot()["counters"]
    assert counters["search.rescore_rows"] == q.shape[0] * 32
    assert counters["search.rescore_native_rows"] == (counters["search.rescore_rows"] if native else 0)


def test_build_database_spans_from_threads(tmp_path):
    bases = _corpus(tmp_path / "g")
    with profile(activities=[ProfilerActivity.CPU]):
        build_database(str(tmp_path / "g"), str(tmp_path / "db"), _params(),
                       ComputingParams(nb_threads=2), "flat", device=CPU)
    snap = trace.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    assert spans["ingest.queue_wait"]["calls"] == 6 + 1  # a file each, then the end
    for name in ("sketch.submit", "sketch.pieces", "sketch.fill", "sketch.upload", "sketch.race",
                 "sketch.merge", "sketch.finish", "pipeline.parse", "pipeline.sketch"):
        assert spans[name]["calls"] >= 1, name
    assert spans["pipeline.parse"]["calls"] == 6
    assert counters["ingest.bases"] == bases + 6  # block mode joins two contigs by one separator
    assert counters["sketch.genomes"] == 6 and counters["sketch.rows"] == 6
    assert counters["sketch.groups"] >= 1 and counters["sketch.upload_bytes"] > 0
    main = threading.get_ident()
    parse_threads = {t for t, s in trace._threads if "pipeline.parse" in s.spans}
    assert parse_threads and all(t.ident != main for t in parse_threads)


def test_stage_timer_cpu_is_the_stage_threads():
    """Its report and its pipeline.<stage> span both take the CPU time of
    the thread that ran the stage."""
    timer = StageTimer()
    trace.enable()

    def sleeper():
        with timer.stage("sleep"):
            time.sleep(0.3)

    t = threading.Thread(target=sleeper)
    t.start()
    x, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 0.3:
        x += 1
    t.join(timeout=10)
    assert not t.is_alive()
    rep = timer.report()["sleep"]
    assert rep["wall_s"] >= 0.29 and rep["cpu_s"] < 0.05
    row = trace.snapshot()["spans"]["pipeline.sleep"]
    assert row["calls"] == 1 and row["wall_s"] >= 0.29 and row["cpu_s"] < 0.05


def test_snapshot_reset_empties_the_record():
    trace.enable()
    with trace.span("a"):
        pass
    with trace.span("c"):
        sum(range(10_000))
    trace.cpu("c", 0.25)
    trace.count("b", 3)
    snap = trace.snapshot(reset=True)
    assert snap["spans"]["a"]["calls"] == 1 and snap["counters"] == {"b": 3}
    assert snap["spans"]["a"]["device_s"] is None and snap["spans"]["a"]["cpu_s"] is None
    assert snap["spans"]["c"]["cpu_s"] == 0.25 and snap["spans"]["c"]["calls"] == 1
    empty = trace.snapshot()
    assert empty["spans"] == {} and empty["counters"] == {}
    assert all(v == 0 for v in empty["launches"].values())


def test_cli_trace_writes_sketch_spans(tmp_path, monkeypatch):
    _corpus(tmp_path / "g", n=3)
    out = tmp_path / "trace.json"
    monkeypatch.chdir(tmp_path)
    assert torch_main(["tohnsw", "-d", "g", "-k", "16", "-s", "256", "-n", "16", "--block",
                       "-o", "db", "--device", "cpu", "--trace", str(out)]) == 0
    assert not trace.on()
    rec = json.loads(out.read_text())
    assert {"spans", "counters", "launches"} <= set(rec)
    for name in ("sketch.submit", "sketch.fill", "sketch.race", "sketch.finish", "ingest.queue_wait"):
        assert rec["spans"][name]["calls"] >= 1, name
    assert rec["counters"]["sketch.genomes"] == 3


def test_device_span_under_the_profiler_alone_records_no_event_pair(monkeypatch):
    """A profiler session alone marks a device span in its trace and times
    it on the host; the CUDA event pairs wait for enable()."""
    def boom(*a, **k):
        raise AssertionError("an event pair under the profiler alone")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(trace._Sums, "stream", boom)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("search.upload", torch.device("cuda", 0)):
                pass
    row = trace.snapshot()["spans"]["search.upload"]
    assert row["calls"] == 3 and row["device_s"] is None
    assert sum(e.name() == "gs:search.upload" for e in prof.profiler.kineto_results.events()) == 3


class _Ev:
    """A profiler event as kineto reports it, for the device-time reading."""

    def __init__(self, kind, name, a, b, corr=0, thread=1, linked=0):
        self.kind, self.nm, self.a, self.b, self.corr, self.thread = kind, name, a, b, corr, thread
        self.linked = linked

    def device_type(self):
        return "DeviceType.CUDA" if self.kind in ("kernel", "gpu_memcpy", "gpu_memset") else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.kind == "user_annotation"

    def name(self):
        return self.nm

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.thread


def _window_events():
    """One search on thread 1 with two inner spans, and a parse span on
    thread 2 that launches nothing: the device ops run 10-40 and 50-90 us
    after their launches; one op has no launch, one is placed by its torch
    operator."""
    from portbench.trace import SPAN_PREFIX

    ann = "user_annotation"
    return [
        _Ev(ann, SPAN_PREFIX + "window", 0, 1000),
        _Ev(ann, "gs:search", 100, 900),
        _Ev(ann, "gs:search.upload", 110, 200),
        _Ev(ann, "gs:search.select", 300, 400),
        _Ev(ann, "gs:search.select", 500, 600),
        _Ev(ann, "gs:pipeline.parse", 0, 1000, thread=2),
        _Ev("cuda_runtime", "cudaMemcpyAsync", 150, 160, corr=7),
        _Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 210, 240, corr=7),
        _Ev("cuda_runtime", "cudaLaunchKernel", 310, 315, corr=8),
        _Ev("kernel", "topk", 320, 350, corr=8),
        _Ev("cuda_runtime", "cudaLaunchKernel", 320, 325, corr=9),
        _Ev("kernel", "sort", 360, 380, corr=9),
        _Ev("cuda_driver", "cuLaunchKernel", 550, 555, corr=10),
        _Ev("kernel", "gather", 600, 640, corr=10),
        _Ev("kernel", "orphan", 700, 800, corr=99),
        # placed by its linked torch operator (correlation ids of their own)
        _Ev("cpu_op", "aten::cat", 560, 570, corr=3),
        _Ev("kernel", "cat", 640, 650, corr=11, linked=3),
    ]


def test_device_seconds_from_the_profilers_events():
    from portbench.program_trace import device_seconds

    missed: dict = {}
    dev = device_seconds(_window_events(), thread=1, missed=missed)
    ns = {k: round(v * 1e9) for k, v in dev.items()}
    # upload 210-240; select's two calls 320-380 and 600-650; search spans 210-650
    assert ns == {"search.upload": 30, "search.select": 60 + 50, "search": 440}
    assert missed == {"orphan": 1}


def test_readers_take_device_times_from_the_tracers_profiler():
    """Under a profiler alone the program's spans carry no device time; the
    readers take it from the profiler of the run's tracer."""
    from types import SimpleNamespace

    from portbench import run
    from portbench.trace import Tracer

    trace.enable()
    for _ in range(2):
        with trace.span("search"):
            with trace.span("search.upload", CPU):
                pass
            with trace.span("search.select", CPU):
                pass
    trace.disable()
    tracer = Tracer.__new__(Tracer)
    tracer.readings = {"device_events": 5}
    tracer._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=_window_events)))
    rec = SimpleNamespace(kind="search", trace=tracer.readings)
    upload, select = run.reader("search.upload_ms")(rec), run.reader("search.select_ms")(rec)
    assert upload == pytest.approx(30e-9 / 2 * 1e3) and select == pytest.approx(110e-9 / 2 * 1e3)
    assert rec.program_trace["spans"]["search"]["device_s"] == pytest.approx(440e-9)


def test_device_times_of_a_cpu_window_and_of_an_unreadable_trace(rng):
    """A real traced window on the CPU reads no device time and raises
    nothing; a trace that cannot be read leaves the device times None and
    says why, since a reader must not fail its run."""
    from types import SimpleNamespace

    from portbench import program_trace
    from portbench.trace import Tracer

    sigs = rng.integers(0, 1 << 20, size=(300, 64)).astype(np.uint32)
    searcher = tmxu.MxuSearcher(sigs, CPU)
    with Tracer(CPU, "search") as tracer:
        searcher.search(sigs[:9], 5)
    assert program_trace.tracer_device_seconds(tracer) == {}
    snap = program_trace.with_device_times(trace.snapshot(reset=True), tracer)
    assert snap["spans"]["search.int_mm"]["device_s"] is None and "device_times_error" not in snap

    def broken():
        raise RuntimeError("no events")

    tracer._prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=broken)))
    snap = program_trace.with_device_times({"spans": {"search": {"device_s": None}}}, tracer)
    assert snap["spans"]["search"]["device_s"] is None and "no events" in snap["device_times_error"]


def test_benchmark_readers_take_the_window_once():
    """The benchmark's per-layer readers (portbench/metrics, found by the
    harness's rule) read the program's record of a traced run that saw the
    device, and nothing otherwise; off the card device times are absent."""
    from types import SimpleNamespace

    from portbench import run

    read = {name: run.reader(name) for name in (
        "search.upload_ms.small", "search.select_ms", "search.rescore_ms", "search.rescore_us_per_row",
        "ingest.queue_wait_s", "ingest.submit_host_s", "ingest.upload_s", "ingest.parse_cpu_s")}
    trace.enable()
    for _ in range(4):
        with trace.span("search"):
            with trace.span("search.device", CPU):
                time.sleep(0.002)
            with trace.span("search.rescore"):
                time.sleep(0.001)
    trace.count("search.queries", 32)
    trace.count("search.rescore_rows", 320)
    for name in ("sketch.pieces", "sketch.fill", "ingest.queue_wait", "pipeline.parse"):
        with trace.span(name):
            time.sleep(0.001)
    trace.disable()

    idle = SimpleNamespace(kind="search", trace={"device_events": 0})
    assert all(f(idle) is None for f in read.values())
    search = SimpleNamespace(kind="search", trace={"device_events": 5})
    assert read["search.rescore_ms"](search) >= 1.0
    rescore_s = search.program_trace["spans"]["search.rescore"]["wall_s"]
    assert read["search.rescore_us_per_row"](search) == pytest.approx(rescore_s / 320 * 1e6)
    assert read["search.upload_ms.small"](search) is None  # no device time on the CPU
    assert read["search.select_ms"](search) is None
    assert read["ingest.queue_wait_s"](search) is None     # not an ingest run
    assert trace.snapshot()["spans"] == {}                 # the first reader took the window

    ingest = SimpleNamespace(kind="ingest", trace={"device_events": 5}, bases=10**9,
                             program_trace={"spans": {
                                 "sketch.pieces": {"calls": 1, "wall_s": 0.5, "cpu_s": 0.5, "device_s": None},
                                 "sketch.fill": {"calls": 2, "wall_s": 0.25, "cpu_s": 0.2, "device_s": None},
                                 "sketch.upload": {"calls": 4, "wall_s": 0.3, "cpu_s": 0.1, "device_s": 0.125},
                                 "pipeline.parse": {"calls": 3, "wall_s": 4.0, "cpu_s": 2.5, "device_s": None}},
                                 "counters": {}, "launches": {}})
    assert read["ingest.submit_host_s"](ingest) == 0.75
    assert read["ingest.upload_s"](ingest) == 0.125
    assert read["ingest.parse_cpu_s"](ingest) == 2.5
    assert read["ingest.queue_wait_s"](ingest) is None
