"""The GTDB proteome deployment (`gtdb-aa-ingest`) on the CPU: the README's
`prob` through the port's params; the plain ProbMinHash-on-residues
reference (portbench/reference/probminhash.py) against the port's
`ProbMinHashSketcher` slot for slot, and two planted faults it must catch;
the proteome corpus writer; the cell from its own files through
`run.run_cell`; the prob sketcher's spans and counters; and the import
guard of the new benchmark modules.  No JAX."""

import ast
import gzip
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsearch_tpu_torch.core import ComputingParams, ProcessingParams
from gsearch_tpu_torch.core.params import HnswParams, SeqSketcherParams, SketchAlgo
from gsearch_tpu_torch.io.fasta import concat_file_codes
from gsearch_tpu_torch.models.base import make_sketcher
from gsearch_tpu_torch.models.probminhash import ProbMinHashSketcher
from gsearch_tpu_torch.pipeline import build_database
from gsearch_tpu_torch.utils import trace
from portbench import control, judge, run
from portbench.corpora import proteomes
from portbench.reference import probminhash as ref

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEED = 2**31 + 2020
CELL = "gtdb-aa-ingest"
# the corpus's shapes with more odd letters, so every small proteome holds some
SHAPES = {"protein_mean": 310, "protein_shape": 2.5, "protein_range": [30, 3000], "x_share": 0.05,
          "x_count": [1, 3], "paralog_share": 0.1, "paralog_redraw": [0.1, 0.4]}
NEW_MODULES = ("portbench/reference/probminhash.py", "portbench/corpora/proteomes.py",
               "portbench/metrics/ingest.prob_sort_s.py", "portbench/metrics/ingest.prob_darts_s.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "gsearch_tpu", "gsearch_tpu_torch"}


@pytest.fixture(scope="module")
def proteome_dir(tmp_path_factory):
    """Four proteomes of 20-60 k residues: X, `*`, paralogs, every fifth
    sequence line in lower case, and a capsid record both parsers skip."""
    root = tmp_path_factory.mktemp("faa")
    rng = np.random.default_rng(11)
    for i, n in enumerate((65, 100, 140, 180)):
        seq, lengths = proteomes.proteome(rng, SHAPES, n)
        lines = proteomes._faa(seq, lengths, f"p{i}").split(b"\n")
        lines = [ln.lower() if not ln.startswith(b">") and j % 5 == 0 else ln for j, ln in enumerate(lines)]
        text = b"\n".join(lines) + b">p%d_capsid # 1 # 90 # 1 # major capsid protein\nMKVLAAGIWWY*\n" % i
        (root / f"p{i}.faa.gz").write_bytes(gzip.compress(text, mtime=0))
    return root


def _files(root):
    return sorted(str(p) for p in root.glob("*.faa.gz"))


def _mismatch(files, s):
    """Slots where the port's signature differs from the reference's, a proteome."""
    sketcher = make_sketcher(SeqSketcherParams(7, s, "prob", "AA"), device=CPU)
    codes = [concat_file_codes(f, is_aa=True)[0] for f in files]
    got = sketcher.sketch_many(codes)
    return [int((got[i] != ref.sketch(c, k=7, s=s, device=CPU)).sum()) for i, c in enumerate(codes)]


@pytest.mark.parametrize("name", ["prob", "PROB", "Prob", "prob3a", "PROB3A"])
def test_the_readmes_prob_is_prob3a_wherever_params_are_built(name, tmp_path):
    assert SketchAlgo.from_name(name) is SketchAlgo.PROB3A
    params = ProcessingParams(hnsw=HnswParams(), block_flag=True,
                              sketch=SeqSketcherParams(kmer_size=7, sketch_size=64, algo=name, data_t="AA"))
    assert params.sketch.algo is SketchAlgo.PROB3A
    params.dump_json(str(tmp_path))
    path = tmp_path / "parameters.json"
    saved = json.loads(path.read_text())
    saved["sketch"]["algo"] = name
    path.write_text(json.dumps(saved))
    assert ProcessingParams.reload_json(str(tmp_path)).sketch.algo is SketchAlgo.PROB3A
    with pytest.raises(ValueError, match=f"unknown sketching algorithm '{name.upper()}ABLY'"):
        SketchAlgo.from_name(name + "ably")


@pytest.mark.parametrize("block_log2", [23, 14], ids=["one-row", "pieces"])
@pytest.mark.parametrize("s", [512, 12000])
def test_the_plain_reference_equals_the_port_slot_for_slot(proteome_dir, monkeypatch, s, block_log2):
    monkeypatch.setattr(ProbMinHashSketcher, "MAX_BLOCK_LOG2", block_log2)
    monkeypatch.setattr(ref, "MAX_BLOCK_LOG2", block_log2)
    files = _files(proteome_dir)
    for f in files:
        codes = concat_file_codes(f, is_aa=True)[0]
        assert np.array_equal(ref.read_genome(f), codes)
        assert 20_000 <= len(codes) <= 60_000 and np.any(codes == 255)
        if block_log2 == 14:
            assert len(ref.pieces(codes, 7)) >= 2
        _, m = ref.multiplicities(ref.kmers(torch.from_numpy(codes), 7))
        assert int((m > 1).sum()) > 100  # the paralogs' 7-mers
    assert _mismatch(files, s) == [0] * len(files)


def _ones(multiplicities):
    def forced(x):
        kmers, counts = multiplicities(x)
        return kmers, torch.ones_like(counts)
    return forced


@pytest.mark.parametrize("fault", ["multiplicity-1", "two-arrivals"])
def test_planted_faults_in_the_reference_fail_the_comparison(proteome_dir, monkeypatch, fault):
    if fault == "multiplicity-1":
        monkeypatch.setattr(ref, "multiplicities", _ones(ref.multiplicities))
    else:
        monkeypatch.setattr(ref, "ARRIVALS", 2)
    assert all(n > 0 for n in _mismatch(_files(proteome_dir), 12000))


def _records(path):
    text = gzip.decompress(open(path, "rb").read()).decode()
    out = []
    for rec in text.split(">")[1:]:
        head, *lines = rec.rstrip("\n").split("\n")
        out.append((head, lines))
    return out


def test_the_proteome_corpus_writes_prodigal_shaped_proteomes(tmp_path):
    spec = dict(run.load_json(os.path.join(ROOT, "portbench/traffic/ingest-faa.json")),
                genomes=3, lengths=[30_000, 90_000], x_share=0.2)
    got = proteomes.write(str(tmp_path / "a"), spec, SEED)
    files = got["files"]
    assert [os.path.basename(f) for f in files] == ["p0000.faa.gz", "p0001.faa.gz", "p0002.faa.gz"]
    want_counts = sorted(np.round(np.exp(np.linspace(*np.log(spec["lengths"]), 3)) / 1050).astype(int))
    letters, counts, x_proteins = 0, [], 0
    for f in files:
        recs = _records(f)
        counts.append(len(recs))
        seqs = []
        for i, (head, lines) in enumerate(recs, 1):
            assert head.startswith(f"{os.path.basename(f)[:5]}_1_{i} # ") and f"# ID=1_{i};partial=00;" in head
            assert all(len(ln) == 60 for ln in lines[:-1]) and 1 <= len(lines[-1]) <= 60
            seq = "".join(lines)
            assert seq[0] == "M" and seq[-1] == "*" and "*" not in seq[:-1]
            assert set(seq[:-1]) <= set("ACDEFGHIKLMNPQRSTVWYX")
            assert 30 <= len(seq) - 1 <= 3000
            letters += len(seq) - 1
            x_proteins += "X" in seq
            seqs.append(seq)
        # paralogs: proteins that share most residues with an earlier one of equal length
        same = [any(len(a) == len(b) and np.mean(np.frombuffer(a.encode(), np.uint8)
                                                 == np.frombuffer(b.encode(), np.uint8)) > 0.55
                    for a in seqs[:i]) for i, b in enumerate(seqs)]
        assert 0.04 * len(seqs) <= sum(same) <= 0.2 * len(seqs)
    assert sorted(counts) == want_counts and got["bases"] == letters
    assert 0.1 * sum(counts) <= x_proteins <= 0.3 * sum(counts)
    again = proteomes.write(str(tmp_path / "b"), spec, SEED)
    assert [open(f, "rb").read() for f in again["files"]] == [open(f, "rb").read() for f in files]
    other = proteomes.write(str(tmp_path / "c"), spec, SEED + 1)
    assert open(other["files"][0], "rb").read() != open(files[0], "rb").read()


def _small_cell():
    files = run.cell_files(run.spec(), CELL)
    cfg = dict(files.cfg, sketch_size=512, genomes=4)
    traffic = dict(files.traffic, lengths=[25_000, 60_000], check_genomes=3)
    return SimpleNamespace(cell=files.cell, cfg=cfg, traffic=traffic, limits=files.limits)


def test_the_gtdb_aa_cell_runs_from_its_own_files(monkeypatch):
    """The cell's configuration names the README's `prob`, its corpus and
    its reference by name; proteomes past 2^14 residues take pieces."""
    monkeypatch.setattr(ProbMinHashSketcher, "MAX_BLOCK_LOG2", 14)
    monkeypatch.setattr(ref, "MAX_BLOCK_LOG2", 14)
    files = _small_cell()
    assert files.cfg["algo"] == "prob" and files.cfg["data"] == "AA" and files.cfg["kmer_size"] == 7
    assert files.traffic["corpus"] == "proteomes" and files.cfg["reference"] == "probminhash"
    assert files.limits == {"slot_mismatch": 0, "bad_passes": 0}
    res = run.run_cell(CELL, SEED, 0.3, False, "cpu", files=files, say=lambda *_: None)
    assert res["correct"], res["checks"]
    assert res["_numbers"]["slot_mismatch"] == 0 and res["_numbers"]["passes"] == res["attempted"] >= 1
    assert set(res["metrics"]) == {"ingest_rate", "setup_s"}
    numbers = control.ingest_control(files.cfg, files.traffic, 3, "cpu")
    assert numbers["slot_mismatch"] > 0.99 * 3 * 512 and not judge.verdict(numbers, files.limits)[0]


def test_the_cell_reports_its_metrics_and_their_readers_exist():
    bench = run.spec()
    assert {m["name"] for m in run.metrics_of(bench, CELL, False)} == {"ingest_rate", "setup_s"}
    layer = {m["name"] for m in run.metrics_of(bench, CELL, True)}
    assert layer == {"ingest.prob_sort_s", "ingest.prob_darts_s", "device_idle.aa"}
    assert run.reader_path("device_idle.aa").endswith("metrics/device_idle.py")
    for name in layer:
        assert os.path.exists(run.reader_path(name))


@pytest.fixture()
def fresh_record():
    trace.disable()
    trace.snapshot(reset=True)
    yield
    trace.disable()
    trace.snapshot(reset=True)


def test_the_prob_sketchers_spans_and_counters_in_a_traced_build(proteome_dir, tmp_path, fresh_record):
    params = ProcessingParams(hnsw=HnswParams(capacity=100, ef=16, max_nb_conn=8), block_flag=True,
                              sketch=SeqSketcherParams(kmer_size=7, sketch_size=256, algo="prob", data_t="AA"))
    with profile(activities=[ProfilerActivity.CPU]):
        build_database(str(proteome_dir), str(tmp_path / "db"), params, ComputingParams(nb_threads=2),
                       device=CPU)
    snap = trace.snapshot(reset=True)
    spans, counters = snap["spans"], snap["counters"]
    for name in ("sketch.prob.sort", "sketch.prob.runs", "sketch.prob.arrivals"):
        assert spans[name]["calls"] == spans["sketch.race"]["calls"] >= 1
        assert spans[name]["wall_s"] <= spans["sketch.race"]["wall_s"]
    assert counters["sketch.darts"] == 3 * counters["sketch.kmer_windows"]
    assert counters["sketch.kmer_windows"] >= counters["ingest.bases"] > 0


def test_the_prob_readers_read_device_times_per_gbase():
    read = {name: run.reader(name) for name in ("ingest.prob_sort_s", "ingest.prob_darts_s")}

    def record(**device_s):
        spans = {f"sketch.prob.{k}": {"calls": 3, "wall_s": 1.0, "cpu_s": None, "device_s": v}
                 for k, v in device_s.items()}
        return SimpleNamespace(kind="ingest", trace={"device_events": 9}, bases=2 * 10**9,
                               program_trace={"spans": spans, "counters": {}, "launches": {}})

    full = record(sort=0.5, runs=0.25, arrivals=1.25)
    assert read["ingest.prob_sort_s"](full) == 0.25 and read["ingest.prob_darts_s"](full) == 0.75
    cpu = record(sort=None, runs=None, arrivals=None)
    assert all(f(cpu) is None for f in read.values())
    parent = SimpleNamespace(kind="ingest", trace={"device_events": 9}, bases=10**9,
                             program_trace={"spans": {}, "counters": {}, "launches": {}})
    assert all(f(parent) is None for f in read.values())
    assert read["ingest.prob_darts_s"](record(sort=0.5, runs=0.25)) is None


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from ((a.name.split(".")[0], 0) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", NEW_MODULES)
def test_the_new_benchmark_modules_import_neither_package(path):
    names = {m for m, level in _imports(os.path.join(ROOT, path)) if level == 0}
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    assert all(level <= 1 for _, level in _imports(os.path.join(ROOT, path)))


def test_the_new_reference_and_corpus_load_neither_package():
    code = ("import sys\nimport portbench.reference.probminhash, portbench.corpora.proteomes\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
