"""The import guard and the shape of BENCHMARK.json.

No file of portbench/ imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
no file of portbench/reference/ imports the program.  Every name in
BENCHMARK.json has its file here."""

import ast
import json
import os
import re
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import run  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "gsearch_tpu"}
PROGRAM = "gsearch_tpu_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _sources():
    for dirpath, _, files in os.walk(run.HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], 0


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, run.ROOT))
def test_no_jax_and_a_reference_free_of_the_program(path):
    names = {m for m, level in _imports(path) if level == 0}
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if os.sep + "reference" + os.sep in path:
        assert PROGRAM not in names, f"{path} imports the program"
        assert all(level <= 1 for _, level in _imports(path)), f"{path} reaches out of reference/"


def test_the_guard_compares_whole_names(tmp_path):
    bad = tmp_path / "x.py"
    bad.write_text("import jax.numpy\nfrom gsearch_tpu.ops import mxu\nimport gsearch_tpu_torch\n")
    assert {m for m, _ in _imports(str(bad))} & FORBIDDEN == {"jax", "gsearch_tpu"}


def test_benchmark_json_names_its_files():
    b = run.spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    metrics = b["end_to_end"] + b["per_layer"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(run.ROOT, c["file"]))
        assert json.load(open(os.path.join(run.ROOT, c["file"])))["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        for sub in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(run.HERE, sub)), sub
        mine = run.metrics_of(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert run.metrics_of(b, w["name"], True)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(run.reader_path(m["name"]))
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert next(m for m in b["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["layer"] in {"pipeline", "index", "kernels", "device"}
        if m["unit"] == "%" and m["name"].endswith("roofline"):
            assert "workloads" in m
