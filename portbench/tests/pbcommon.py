"""Small cells for the benchmark's CPU tests (imported by the test files;
run the tests from the repository root: python -m pytest portbench/tests)."""

import copy
from types import SimpleNamespace

from portbench import run

SEARCH_CFG = {"genomes": 2500, "sketch_size": 2048,
              "structure": {"kind": "species_reps", "families": 32, "genera_per_family": 8,
                            "genus_redraw": 0.9, "species_redraw": 0.7}}
INGEST_TRAFFIC = {"genomes": 4, "lengths": [40000, 120000], "contigs": [1, 30], "n_runs": [15, 20],
                  "n_run_len": [100, 200], "n_run_share": 1.0, "check_genomes": 3}


def search_files(batch: int = 32, **cfg) -> SimpleNamespace:
    base = run.load_json(run.HERE + "/configs/gtdb-r207.json")
    base.update(copy.deepcopy(SEARCH_CFG), **cfg)
    traffic = run.load_json(run.HERE + "/traffic/batch-1024.json")
    traffic.update(batch=batch, pool=4 * batch, check_queries=2 * batch, warmup_calls=1)
    return SimpleNamespace(cell={"chips": 1}, cfg=base, traffic=traffic,
                           limits=run.load_json(run.HERE + "/limits/gtdb-batch.json"))


def ingest_files(sketch_size: int = 512) -> SimpleNamespace:
    base = dict(run.load_json(run.HERE + "/configs/gtdb-r207-slice96.json"), sketch_size=sketch_size,
                genomes=INGEST_TRAFFIC["genomes"])
    traffic = dict(run.load_json(run.HERE + "/traffic/ingest-gz.json"), **INGEST_TRAFFIC)
    return SimpleNamespace(cell={"chips": 1}, cfg=base, traffic=traffic,
                           limits=run.load_json(run.HERE + "/limits/gtdb-ingest.json"))


def small_blocks(monkeypatch, log2: int = 16) -> None:
    """Pieces of 2^log2 bases in the program and the reference, so small
    genomes take the piece path."""
    from gsearch_tpu_torch.models.base import SketcherBase

    from portbench.reference import sketch

    monkeypatch.setattr(SketcherBase, "MAX_BLOCK_LOG2", log2)
    monkeypatch.setattr(sketch, "MAX_BLOCK_LOG2", log2)
