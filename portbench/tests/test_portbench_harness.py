"""The harness: the result line's keys, metrics found by name, a new
configuration, traffic mix, limits file and metric found without an edit,
and no run without a card."""

import json
import os
import shutil
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import run  # noqa: E402
from pbcommon import ingest_files, search_files, small_blocks  # noqa: E402

torch.set_num_threads(2)
SEED = 2**31 + 99


def _keys_ok(res, trace):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-2:] == ["checks", "_numbers"]  # checks last once _numbers is popped
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and "breakdown" in res
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.parametrize("trace", [False, True])
def test_search_cell_on_the_cpu(trace):
    res = run.run_cell("gtdb-batch", SEED, 0.5, trace, "cpu", files=search_files(), say=lambda *_: None)
    _keys_ok(res, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    if trace:
        assert "search.host_ms" in names and "query_rate" not in names
    else:
        assert names == {"query_rate", "setup_s"}
    assert res["checks"]["dist_gap"]["value"] < 1e-6  # the exact sweep on the CPU


def test_ingest_cell_on_the_cpu(monkeypatch):
    small_blocks(monkeypatch)
    for trace in (False, True):
        res = run.run_cell("gtdb-ingest", SEED, 0.2, trace, "cpu", files=ingest_files(),
                           say=lambda *_: None)
        _keys_ok(res, trace)
        assert res["correct"], res["checks"]
        assert res["checks"]["slot_mismatch"]["value"] == 0
        want = {"ingest.parse_s", "ingest.drain_s"} if trace else {"ingest_rate", "setup_s"}
        assert set(res["metrics"]) == want


def test_main_refuses_a_host_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", "gtdb-batch", "--seed", "1", "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gsearch_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxish.sub", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    """A copy of the benchmark with one more configuration, traffic mix,
    limits file and per-layer metric, each a new file and entry only."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "portbench")
    bench = run.spec()
    cfg = dict(search_files().cfg, name="tiny-new")
    (root / "portbench/configs/tiny-new.json").write_text(json.dumps(cfg))
    traffic = dict(search_files().traffic)
    (root / "portbench/traffic/tiny-mix.json").write_text(json.dumps(traffic))
    (root / "portbench/limits/tiny-cell.json").write_text(json.dumps({"bad_answers": 0}))
    (root / "portbench/metrics/calls.count.py").write_text("def read(r):\n    return float(r.batches)\n")
    bench["configs"].append({"name": "tiny-new", "source": "test", "file": "portbench/configs/tiny-new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-new", "traffic": "tiny-mix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny-cell")
    bench["per_layer"].append({"name": "calls.count", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "index", "moves": "query_rate",
                               "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", str(root))
    monkeypatch.setattr(run, "HERE", str(root / "portbench"))
    res = run.run_cell("tiny-cell", SEED, 0.3, True, "cpu", say=lambda *_: None)
    assert res["correct"] and res["metrics"]["calls.count"]["value"] >= 1
    assert set(res["checks"]) == {"bad_answers"}
    res = run.run_cell("tiny-cell", SEED, 0.3, False, "cpu", say=lambda *_: None)
    assert set(res["metrics"]) == {"query_rate", "setup_s"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    res = run.run_cell("gtdb-small", SEED, 1.0, True, card)
    _keys_ok(res, True)
    assert res["correct"] and res["device"]["busy_s"] > 0
