"""The verify recipe (8 genomes, one 1%-mutated query, k=16, s=1024, block
mode) through both CLIs: identical signatures, neighbours files and ANI
tables, each package requesting the other's database; the port's CLI run
as `python -m gsearch_tpu_torch ... --device cpu` imports no JAX."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsearch_tpu.cli.main import main as jax_main
from gsearch_tpu_torch.cli.main import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ["-k", "16", "-s", "1024", "-n", "32", "--ef", "200", "--algo", "optdens", "--block"]


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The corpus of .claude/skills/verify/SKILL.md, built by both CLIs
    (run from the corpus root, so both record the same relative paths)."""
    root = tmp_path_factory.mktemp("verify")
    rng = np.random.default_rng(123)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    (root / "db_genomes").mkdir()
    (root / "queries").mkdir()
    gen = [bytes(rng.choice(acgt, 12000)) for _ in range(8)]
    for i, g in enumerate(gen):
        (root / "db_genomes" / f"g{i}.fna").write_bytes(b">chr1\n" + g + b"\n")
    a = np.frombuffer(gen[0], np.uint8).copy()
    pos = rng.choice(len(a), 120, replace=False)
    a[pos] = rng.choice(acgt, 120)
    (root / "queries" / "q.fna").write_bytes(b">q\n" + a.tobytes() + b"\n")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert jax_main(["tohnsw", "-d", "db_genomes", *BUILD, "-o", "db_jax"]) == 0
        assert torch_main(["tohnsw", "-d", "db_genomes", *BUILD, "-o", "db_torch", "--device", "cpu"]) == 0
        outs = {}
        for db in ("db_jax", "db_torch"):
            for pkg, run in (("jax", jax_main), ("torch", torch_main)):
                out = f"req_{pkg}_{db}"
                extra = ["--device", "cpu"] if pkg == "torch" else []
                assert run(["request", "-b", db, "-n", "5", "-r", "queries", "-o", out, *extra]) == 0
                assert run(["reformat", "16", "1", f"{out}/gsearch.neighbors.txt", f"{out}/ani.tsv"]) == 0
                outs[(pkg, db)] = out
    finally:
        os.chdir(cwd)
    return root, outs


def test_databases_identical(recipe):
    root, _ = recipe
    for name in ("index.sigs.npy", "index.meta.json", "seqdict.json", "parameters.json"):
        assert (root / "db_jax" / name).read_bytes() == (root / "db_torch" / name).read_bytes(), name


def test_neighbours_and_ani_identical_across_packages(recipe):
    root, outs = recipe
    ref = outs[("jax", "db_jax")]
    for key, out in outs.items():
        for name in ("gsearch.neighbors.txt", "ani.tsv"):
            assert (root / out / name).read_bytes() == (root / ref / name).read_bytes(), (key, name)
    rows = (root / ref / "ani.tsv").read_text().splitlines()[1:]
    best = rows[0].split("\t")
    assert best[0] == "q.fna" and best[2] == "g0.fna" and abs(float(best[4]) - 99.0) < 1.0


def test_from_jax_database_searches_like_reference(recipe):
    from gsearch_tpu.index.serialize import load_index as jax_load
    from gsearch_tpu_torch.index import from_jax_database

    root, _ = recipe
    idx = from_jax_database(str(root / "db_jax"))
    ref = jax_load(str(root / "db_jax"))
    sigs = ref.get_sigs()
    d, i = idx.search(sigs[[3, 0, 5]], 4)
    d_ref, i_ref = ref.search(sigs[[3, 0, 5]], 4)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(d.view(np.uint32), d_ref.view(np.uint32))
    assert (i[:, 0] == [3, 0, 5]).all() and (d[:, 0] == 0).all()


def test_add_then_request(recipe, tmp_path):
    root, _ = recipe
    db = tmp_path / "db"
    shutil.copytree(root / "db_torch", db)
    rng = np.random.default_rng(11)
    newg = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 12000))
    for d in ("new", "newq"):
        (tmp_path / d).mkdir()
        (tmp_path / d / f"{d}.fna").write_bytes(b">x\n" + newg + b"\n")
    assert torch_main(["add", "-b", str(db), "-n", str(tmp_path / "new"), "--device", "cpu"]) == 0
    out = tmp_path / "out"
    assert torch_main(["request", "-b", str(db), "-n", "3", "-r", str(tmp_path / "newq"),
                       "-o", str(out), "--device", "cpu"]) == 0
    hits = [l for l in (out / "gsearch.neighbors.txt").read_text().splitlines() if l.startswith("query_id:")]
    assert "new.fna" in hits[0] and "0.00000E0" in hits[0]


def test_unported_paths_raise(recipe, tmp_path):
    root, _ = recipe
    db = str(root / "db_genomes")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_main(["tohnsw", "-d", db, *BUILD, "--index", "hnsw", "-o", str(tmp_path / "h"), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="mesh"):
        torch_main(["--mesh", "2", "tohnsw", "-d", db, *BUILD, "-o", str(tmp_path / "m"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            torch_main(["tohnsw", "-d", db, *BUILD, "-o", str(tmp_path / "c")])


def test_python_m_run_imports_no_jax(recipe, tmp_path):
    """A fresh interpreter running the port's CLI never imports jax, nor the
    JAX-bound parts of gsearch_tpu; its neighbours file equals the reference's."""
    root, outs = recipe
    env = dict(os.environ, PYTHONPATH=REPO)
    cmds = [["tohnsw", "-d", "db_genomes", *BUILD, "-o", str(tmp_path / "db")],
            ["request", "-b", str(tmp_path / "db"), "-n", "5", "-r", "queries", "-o", str(tmp_path / "out")]]
    for cmd in cmds:
        proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "gsearch_tpu_torch", *cmd,
                               "--device", "cpu"], cwd=root, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        modules = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                   if line.startswith("import time:")}
        assert "gsearch_tpu_torch.pipeline" in modules
        banned = [m for m in modules if m == "jax" or m.startswith("jax.") or m in (
            "gsearch_tpu.utils", "gsearch_tpu.index", "gsearch_tpu.models")]
        assert not banned, banned
    ref = root / outs[("jax", "db_jax")] / "gsearch.neighbors.txt"
    assert (tmp_path / "out" / "gsearch.neighbors.txt").read_bytes() == ref.read_bytes()
