"""Run one cell of BENCHMARK.json and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (`configs/<config>.json`, as BENCHMARK.json
gives its file) and a traffic mix (`traffic/<traffic>.json`); its limits
are `limits/<cell>.json` and each metric is read by `metrics/<metric>.py`,
or, where a metric has no file of its own, by that of its name less its
last dotted part (`device_idle.small` by `metrics/device_idle.py`).  An
ingest cell's corpus writer is `corpora/<corpus>.py` (the traffic's
`corpus`) and its plain reference sketcher `reference/<reference>.py`
(the configuration's `reference`).
With --trace 0 the result carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read under the tracer over the first
TRACED_SECONDS of the window at most (reading a longer trace would take
the run past its time limit).  Standard output
ends with one JSON line; standard error ends with each compared number
beside its limit.  Exits 2 without a CUDA card (or fewer than the cell
asks for), and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "gsearch_tpu")
TRACED_SECONDS = 30.0


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(bench: dict, name: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic and limits, found by name."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return SimpleNamespace(
        cell=cell,
        cfg=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", name + ".json")))


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with trace its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((cell in m["workloads"]) if "workloads" in m else (m["moves"] in mine))]


def reader_path(name: str) -> str:
    """metrics/<name>.py, else that of the name less its last dotted part,
    and so on: one reader serves a quantity split by the metric it moves."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        path = os.path.join(HERE, "metrics", ".".join(parts[:i]) + ".py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader in {HERE}/metrics for {name!r}")


def _load(path: str, module: str):
    mod_spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    return _load(reader_path(name), "portbench.metrics." + name.replace(".", "_")).read


def part(folder: str, name: str):
    """The module <HERE>/<folder>/<name>.py (a corpus writer, a plain
    reference), found by the name a configuration or traffic mix gives:
    this package's own module where HERE is this package, else the file
    loaded on its own (a copy of the benchmark)."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder}/{name}.py in {HERE}")
    if os.path.samefile(HERE, os.path.dirname(os.path.abspath(__file__))):
        return importlib.import_module(f"{__package__}.{folder}.{name}")
    return _load(path, f"portbench.{folder}.{name.replace('.', '_')}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "?"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, *, bench: dict | None = None,
             files: SimpleNamespace | None = None, t0: float = T0, say=print) -> dict:
    """Set up, time and judge one cell; returns the result line's object.
    `files` overrides the cell's configuration, traffic and limits (tests)."""
    import torch

    from . import drivers, judge
    from .trace import Tracer

    bench = bench or spec()
    files = files or cell_files(bench, name)
    device = torch.device(device)
    cuda = device.type == "cuda"
    kind = files.traffic["kind"]
    driver = drivers.DRIVERS[kind](files.cfg, files.traffic, seed, device)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    for line in driver.lines:
        say(line)
    if cuda:
        say(f"device bytes after set-up: {torch.cuda.memory_allocated(device)} allocated, "
            f"{torch.cuda.memory_reserved(device)} reserved")
    tracer = Tracer(device, kind) if trace else None
    if tracer is None:
        rec = driver.window(seconds)
    else:
        with tracer:
            rec = driver.window(min(seconds, TRACED_SECONDS), tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_check, told = time.perf_counter(), len(driver.lines)
    numbers = driver.check()
    for line in driver.lines[told:]:
        say(line)
    say(f"check: {time.perf_counter() - t_check:.3f} s; window {rec.window_s:.3f} s, set-up {setup_s:.3f} s")
    ok, rows = judge.verdict(numbers, files.limits)
    rec.setup_s = setup_s
    rec.trace = tracer.readings if tracer else None
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    rec.peaks = load_json(os.path.join(HERE, "peaks.json")).get(card)
    if trace and rec.peaks is None:
        say(f"no peaks for {card!r} in peaks.json: the roofline shares are left out")
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(ok and rec.failed == 0), "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": card, "count": 1,
                         "memory_peak_bytes": peak}}
    if trace:
        t = rec.trace
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
        say(f"traced: {t['device_events']} device events, busy {t['busy_s']} s of {t['window_s']} s; "
            f"spans {json.dumps(t['spans'])} calls {json.dumps(t['span_calls'])}")
        if t["int_mm"]:
            say(f"_int_mm: {len(t['int_mm'])} calls, {sum(c[0] for c in t['int_mm'])} s, "
                f"{sum(c[1] for c in t['int_mm'])} ops, {sum(c[2] for c in t['int_mm'])} bytes")
        if t["k2"]:
            from .readers import k2_bytes
            say(f"K2: {len(t['k2'])} calls, {sum(c[0] for c in t['k2'])} s, "
                f"{sum(k2_bytes(*c[1:]) for c in t['k2'])} bytes, "
                f"{sum(c[1] * c[2] * c[3] for c in t['k2'])} ops (a lane compare each), "
                f"{sum(c[4] for c in t['k2'])} distinct rows")
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    result["_numbers"] = numbers
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = spec()
    files = cell_files(bench, args.workload)
    chips = files.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench needs {chips} CUDA device(s); this host has {n}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"cell {args.workload}: config {files.cell['config']}, traffic {files.cell['traffic']}, "
          f"seed {args.seed}, {args.seconds} s, trace {args.trace}")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      bench=bench, files=files)
    numbers = result.pop("_numbers")
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the benchmark runs without JAX)",
              file=sys.stderr)
        return 3
    print("numbers: " + json.dumps(numbers))
    print(json.dumps(result))
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
