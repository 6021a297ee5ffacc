"""A run with the timed path broken underneath comes out not correct: the
harness drives the rest of a run on the CPU (no look for a card) with each
fault a cell can have planted in the program's calls.  One chip a cell, so
no exchange between chips exists to leave out."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import run  # noqa: E402
from pbcommon import ingest_files, search_files, small_blocks  # noqa: E402

torch.set_num_threads(2)
SEED = 2**31 + 5


def _altered(index, queries, d, ids, last):
    return d, (ids + 1) % 2500            # every answer names the next genome


def _half(index, queries, d, ids, last):
    h = d.shape[0] // 2                   # the second half answered as the first
    return np.concatenate([d[:h], d[:h]]), np.concatenate([ids[:h], ids[:h]])


def _unchanged(index, queries, d, ids, last):
    return last if last is not None else (d, ids)  # the previous call's answers


def _wrong_candidates(index, queries, d, ids, last):
    """The candidate stage names genomes half the database away (another
    family); the rerank still reports each one's exact distance, in order."""
    ids = (ids + index.nb_points // 2) % index.nb_points
    rows = index.get_sigs()[ids].view(np.int32)
    d = 1.0 - (rows == queries.view(np.int32)[:, None]).mean(-1, dtype=np.float64)
    order = np.argsort(d, axis=1, kind="stable")
    return (np.take_along_axis(d, order, 1).astype(np.float32),
            np.take_along_axis(ids, order, 1).astype(np.int32))


@pytest.mark.parametrize("fault", [_altered, _half, _unchanged, _wrong_candidates],
                         ids=["altered", "half", "unchanged", "wrong_candidates"])
def test_a_broken_search_is_not_correct(monkeypatch, fault):
    from gsearch_tpu_torch.index.flat import FlatIndex

    real, state = FlatIndex.search, {"last": None, "on": False}

    def broken(self, queries, knbn, ef_search=0):
        d, ids = real(self, queries, knbn, ef_search)
        out = fault(self, queries, d, ids, state["last"]) if state["on"] else (d, ids)
        state["last"] = (d, ids)
        return out

    monkeypatch.setattr(FlatIndex, "search", broken)
    files = search_files(batch=16)
    res = run.run_cell("gtdb-batch", SEED, 0.0, False, "cpu", files=files, say=lambda *_: None)
    assert res["correct"], res["checks"]     # the same run unbroken
    state["on"] = True
    res = run.run_cell("gtdb-batch", SEED, 1.0, False, "cpu", files=files, say=lambda *_: None)
    assert not res["correct"], res["checks"]
    if fault is _wrong_candidates:           # only the recall of near genomes sees it
        assert [n for n, c in res["checks"].items() if c["value"] > c["limit"]] == ["near_miss"]


def _zeros(sigs):
    return np.zeros_like(sigs)            # the state left as it was made


def _half_genomes(sigs):
    h = len(sigs) // 2
    return np.concatenate([sigs[:h], sigs[:len(sigs) - h]])


def _one_slot(sigs):
    out = sigs.copy()
    out[0, 0] = np.nextafter(out[0, 0], 1.0)
    return out


@pytest.mark.parametrize("fault", [_zeros, _half_genomes, _one_slot], ids=["unchanged", "half", "altered"])
def test_a_broken_ingest_is_not_correct(monkeypatch, fault):
    from gsearch_tpu_torch.models.base import SketcherBase

    small_blocks(monkeypatch)
    real = SketcherBase.sketch_finish
    monkeypatch.setattr(SketcherBase, "sketch_finish", lambda self, t: fault(real(self, t)))
    res = run.run_cell("gtdb-ingest", SEED, 0.2, False, "cpu", files=ingest_files(), say=lambda *_: None)
    assert not res["correct"] and res["checks"]["slot_mismatch"]["value"] > 0
