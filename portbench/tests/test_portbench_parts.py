"""An ingest cell follows its configuration: its corpus writer and plain
reference sketcher are found by name, a configuration that its reference
or corpus does not serve is refused at set-up, slots are compared by their
bits at the reference's width, and the control is the reference's own."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import control, drivers, judge, run  # noqa: E402
from portbench.reference import sketch  # noqa: E402
from pbcommon import ingest_files, small_blocks  # noqa: E402

torch.set_num_threads(2)
SEED = 2**31 + 77

# a corpus of another form (plain FASTA, 60-wide lines, two records a
# genome) and two references that sketch as the plain OptDens sketcher,
# one with a slot of its first genome flipped: each a new file only
FNA_CORPUS = '''
import os

import numpy as np

DATA = "DNA"


def write(root, spec, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    files, bases = [], 0
    for g in range(spec["genomes"]):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 50000 + 7000 * g)]
        cut = len(seq) // 3
        text = b""
        for r, part in enumerate((seq[:cut], seq[cut:])):
            text += b">g%d_r%d\\n" % (g, r) + b"".join(part[i:i + 60].tobytes() + b"\\n"
                                                      for i in range(0, len(part), 60))
        files.append(os.path.join(root, "g%d.fna" % g))
        with open(files[-1], "wb") as f:
            f.write(text)
        bases += len(seq)
    return {"files": files, "bases": bases}
'''
PLAIN_REFERENCE = '''
import numpy as np

from portbench.reference import sketch as plain

ALGO = "optdens"
DATA = ("DNA",)
read_genome = plain.read_genome
flipped = []


def sketch(codes, *, k, s, device):
    sig = plain.sketch(codes, k=k, s=s, device=device)
    if FLIP and not flipped:
        flipped.append(1)
        sig.view(np.uint32)[0] ^= 1
    return sig


def control(sigs):
    return (sigs.view(np.uint32) ^ 1).view(np.float32)
'''


@pytest.mark.parametrize("key, value, declared", [("algo", "prob", "'optdens'"), ("data", "AA", "'DNA'")])
def test_a_configuration_its_reference_does_not_sketch_is_refused_at_set_up(key, value, declared):
    files = ingest_files()
    cell = drivers.IngestCell(dict(files.cfg, **{key: value}), files.traffic, SEED, "cpu")
    with pytest.raises(ValueError) as err:
        cell.setup()
    assert f"{key} {value!r}" in str(err.value) and declared in str(err.value)
    assert "gtdb-r207-slice96" in str(err.value) and "'sketch'" in str(err.value)
    assert not hasattr(cell, "tmp")  # refused before a corpus is written


def _copied_checkout(tmp_path, monkeypatch):
    """A copy of the benchmark with a new corpus, the two new references
    and a configuration and cell for each, found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "portbench")
    (root / "portbench/corpora/plain_fna.py").write_text(FNA_CORPUS)
    (root / "portbench/corpora/proteins.py").write_text(FNA_CORPUS.replace('"DNA"', '"AA"'))
    (root / "portbench/reference/plain_copy.py").write_text("FLIP = False\n" + PLAIN_REFERENCE)
    (root / "portbench/reference/plain_flip.py").write_text("FLIP = True\n" + PLAIN_REFERENCE)
    files = ingest_files()
    bench = run.spec()
    for cfg_name, ref in (("tiny-plain", "plain_copy"), ("tiny-flip", "plain_flip")):
        cfg = dict(files.cfg, name=cfg_name, reference=ref)
        (root / f"portbench/configs/{cfg_name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg_name, "source": "test", "reduced": [], "why": "test",
                                 "file": f"portbench/configs/{cfg_name}.json"})
    for mix, corpus in (("tiny-fna", "plain_fna"), ("tiny-faa", "proteins")):
        (root / f"portbench/traffic/{mix}.json").write_text(json.dumps(dict(files.traffic, corpus=corpus)))
    for cell, cfg_name, mix in (("tiny-ingest", "tiny-plain", "tiny-fna"), ("tiny-flipped", "tiny-flip", "tiny-fna"),
                                ("tiny-aa", "tiny-plain", "tiny-faa")):
        (root / f"portbench/limits/{cell}.json").write_text(json.dumps(files.limits))
        bench["workloads"].append({"name": cell, "config": cfg_name, "traffic": mix, "chips": 1, "why": "test"})
        next(m for m in bench["end_to_end"] if m["name"] == "ingest_rate")["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", str(root))
    monkeypatch.setattr(run, "HERE", str(root / "portbench"))


def test_an_ingest_cell_of_new_files_is_found_by_name(tmp_path, monkeypatch):
    small_blocks(monkeypatch)
    _copied_checkout(tmp_path, monkeypatch)
    res = run.run_cell("tiny-ingest", SEED, 0.2, False, "cpu", say=lambda *_: None)
    assert res["correct"], res["checks"]
    assert res["_numbers"]["slot_mismatch"] == 0 and res["_numbers"]["passes"] == res["attempted"] >= 1
    assert set(res["metrics"]) == {"ingest_rate", "setup_s"}
    # the planted reference flips one slot of one genome: one slot a pass
    res = run.run_cell("tiny-flipped", SEED, 0.2, False, "cpu", say=lambda *_: None)
    assert not res["correct"]
    assert res["_numbers"]["slot_mismatch"] == res["_numbers"]["passes"] == res["attempted"] >= 1
    # the control is the new reference's own (each slot's lowest bit)
    files = run.cell_files(run.spec(), "tiny-ingest")
    numbers = control.ingest_control(files.cfg, files.traffic, 3, "cpu")
    assert numbers["slot_mismatch"] == files.traffic["check_genomes"] * files.cfg["sketch_size"]
    # an amino-acid corpus under a DNA configuration: refused at set-up
    with pytest.raises(ValueError, match="its corpus 'proteins' writes data 'AA'"):
        run.run_cell("tiny-aa", SEED, 0.2, False, "cpu", say=lambda *_: None)


def test_a_missing_part_is_named():
    with pytest.raises(FileNotFoundError, match="reference/nonesuch.py"):
        drivers.ingest_parts(dict(ingest_files().cfg, reference="nonesuch"), ingest_files().traffic)


@pytest.mark.parametrize("dtype, other", [(np.float32, np.int32), (np.uint32, np.float32), (np.uint16, np.int16)])
def test_slots_are_compared_by_their_bits_at_the_references_width(dtype, other):
    rng = np.random.default_rng(5)
    width = np.dtype(dtype).itemsize
    ref = rng.integers(0, 2 ** (8 * width), (3, 64), dtype=np.uint64).astype(f"u{width}").view(dtype)
    flipped = ref.copy()
    flipped.view(f"u{width}")[0, 1] ^= 1
    flipped.view(f"u{width}")[2, 5] ^= 1 << (8 * width - 1)  # the top bit: f32's sign
    wider = ref.view(f"u{width}").astype(np.uint64)
    passes = [(ref.copy(), 3), (flipped, 3), (ref.view(other), 3), (wider, 3), None, (ref[:2], 3), (ref.copy(), 4)]
    assert judge.sketch_numbers(ref, passes, 3) == {"slot_mismatch": 2, "bad_passes": 5, "passes": 7}


def test_the_ingest_control_is_the_references(monkeypatch):
    small_blocks(monkeypatch)
    seen = []

    def spy(sigs):
        seen.append(sigs.copy())
        out = sigs.copy()
        out.view(np.uint32)[:, :3] ^= 1
        return out

    monkeypatch.setattr(sketch, "control", spy)
    files = ingest_files()
    numbers = control.ingest_control(files.cfg, files.traffic, 7, "cpu")
    assert len(seen) == 1 and seen[0].dtype == np.float32
    assert seen[0].shape == (files.traffic["check_genomes"], files.cfg["sketch_size"])
    assert numbers == {"slot_mismatch": 3 * files.traffic["check_genomes"], "bad_passes": 0, "passes": 1}
