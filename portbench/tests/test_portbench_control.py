"""The controls come out not correct at a test's size, beside a sound run
of the same set-up: the search cells' 8-bit-hash k-NN in the program's
place, the ingest cell's signatures in bfloat16, and on the card the
program's own lower path and a candidate stage that loses half the rows.
On the card at the cells' sizes they run as `python3 -m portbench.control`."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import control, judge, run  # noqa: E402
from pbcommon import ingest_files, search_files, small_blocks  # noqa: E402

torch.set_num_threads(2)
SEARCH_CELLS = ("gtdb-batch", "refseq-batch", "gtdb-small")


def test_reference8_control_fails_each_search_cells_limits():
    files = search_files(sketch_size=12000)
    for seed in (1, 2, 3):
        out = dict(control.search_variants(files, seed, "cpu", 0.2, ["program", "reference8"]))
        for cell in SEARCH_CELLS:
            limits = run.load_json(f"{run.HERE}/limits/{cell}.json")
            assert judge.verdict(out["program"], limits)[0], (cell, out["program"])
            assert not judge.verdict(out["reference8"], limits)[0], (cell, out["reference8"])
        assert out["reference8"]["dist_gap"] > 2e-3


def test_ingest_control_fails(monkeypatch):
    small_blocks(monkeypatch)
    files = ingest_files()
    numbers = control.ingest_control(files.cfg, files.traffic, 7, "cpu")
    assert not judge.verdict(numbers, files.limits)[0]
    assert numbers["slot_mismatch"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_the_programs_lower_path_and_a_lost_half_fail(card):
    files = search_files(batch=64, genomes=8192)  # the sign-expansion searcher from 4,096 rows
    out = dict(control.search_variants(files, 5, card, 0.5, ["program", "lower", "drop_half"]))
    assert judge.verdict(out["program"], files.limits)[0], out["program"]
    assert not judge.verdict(out["lower"], files.limits)[0], out["lower"]
    assert out["drop_half"]["near_miss"] > files.limits["near_miss"], out["drop_half"]
