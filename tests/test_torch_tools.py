"""gsearch_tpu_torch's pairwise tools (bindash, hypermash, superaai) against
gsearch_tpu's on a seeded list of 6 genomes / proteomes: the same output
file, byte for byte (their sketchers are integer-only).  The tools run on
the CPU here (`--device cpu`); bindash's all-pairs compare is K1, whose
kernel is held to its plain version on the card."""

import numpy as np
import pytest
import torch

from gsearch_tpu.cli import bindash as jbindash
from gsearch_tpu.cli import hypermash as jhypermash
from gsearch_tpu.cli import superaai as jsuperaai
from gsearch_tpu.cli.main import main as jax_main
from gsearch_tpu_torch.cli import bindash as tbindash
from gsearch_tpu_torch.cli import hypermash as thypermash
from gsearch_tpu_torch.cli import superaai as tsuperaai
from gsearch_tpu_torch.cli.main import main as torch_main
from gsearch_tpu_torch.ops import cuda_lib

ALPHABETS = {"fna": b"ACGT", "faa": b"ACDEFGHIKLMNPQRSTVWY"}


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """Six genomes and six proteomes: three roots, each with a copy at 2%
    substitutions; the first four are references, all six queries (so some
    pairs share a basename and are forced to 0 / 100)."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(21)
    out = {"root": root}
    for ext, n in (("fna", 9_000), ("faa", 5_000)):
        alpha = np.frombuffer(ALPHABETS[ext], np.uint8)
        paths = []
        for i in range(3):
            base = rng.choice(alpha, n)
            near = base.copy()
            pos = rng.choice(n, n // 50, replace=False)
            near[pos] = rng.choice(alpha, len(pos))
            for name, g in ((f"g{i}", base), (f"g{i}_near", near)):
                p = root / f"{name}.{ext}"
                # two records a file: the tools sketch the concatenation
                p.write_bytes(b">a\n" + g[: n // 2].tobytes() + b"\n>b\n" + g[n // 2:].tobytes() + b"\n")
                paths.append(str(p))
        (root / f"q_{ext}.txt").write_text("\n".join(paths) + "\n")
        (root / f"r_{ext}.txt").write_text("\n".join(paths[:4]) + "\n\n")
        out[ext] = (str(root / f"q_{ext}.txt"), str(root / f"r_{ext}.txt"))
    return out


def _rows(path):
    return [line.split("\t") for line in open(path).read().strip().splitlines()[1:]]


@pytest.mark.parametrize("dens", [0, 1])
def test_bindash_same_output(lists, tmp_path, dens):
    q, r = lists["fna"]
    args = ["-q", q, "-r", r, "-k", "12", "-s", "1024", "-d", str(dens)]
    before = dict(cuda_lib.launches)
    assert jbindash.main([*args, "-o", str(tmp_path / "j.tsv")]) == 0
    assert tbindash.main([*args, "-o", str(tmp_path / "t.tsv"), "--device", "cpu"]) == 0
    assert cuda_lib.launches == before  # CPU tensors take K1's plain version
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    rows = _rows(tmp_path / "t.tsv")
    assert len(rows) == 24
    d = {(a.rsplit("/", 1)[1], b.rsplit("/", 1)[1]): float(x) for a, b, x in rows}
    assert d[("g0.fna", "g0.fna")] == 0.0 and 0 < d[("g0_near.fna", "g0.fna")] < 0.05
    assert d[("g2.fna", "g0.fna")] > 0.2


def test_hypermash_same_output(lists, tmp_path):
    q, r = lists["fna"]
    args = ["-q", q, "-r", r, "-k", "12", "-b", "1024"]
    assert jhypermash.main([*args, "-o", str(tmp_path / "j.tsv")]) == 0
    assert thypermash.main([*args, "-o", str(tmp_path / "t.tsv"), "--device", "cpu"]) == 0
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    d = {(a.rsplit("/", 1)[1], b.rsplit("/", 1)[1]): float(x) for a, b, x in _rows(tmp_path / "t.tsv")}
    assert len(d) == 24 and d[("g1_near.fna", "g1.fna")] < 0.06 < d[("g2.fna", "g1.fna")]


@pytest.mark.parametrize("num", [None, 30])
def test_superaai_same_output(lists, tmp_path, num):
    q, r = lists["faa"]
    args = ["-q", q, "-r", r, "-k", "7", "-s", "20"] + (["--num", str(num)] if num else [])
    assert jsuperaai.main([*args, "-o", str(tmp_path / "j.tsv")]) == 0
    assert tsuperaai.main([*args, "-o", str(tmp_path / "t.tsv"), "--device", "cpu"]) == 0
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    d = {(a.rsplit("/", 1)[1], b.rsplit("/", 1)[1]): float(x) for a, b, x in _rows(tmp_path / "t.tsv")}
    assert len(d) == 24 and d[("g0.faa", "g0.faa")] == 100.0
    if num is None:
        assert d[("g0_near.faa", "g0.faa")] > 90.0 > d[("g2.faa", "g0.faa")]


def test_tools_forwarded_by_the_main_cli(lists, tmp_path):
    """`python -m gsearch_tpu_torch bindash ...` reaches the tool's own
    parser, as in the reference; without a card the default device raises."""
    q, r = lists["fna"]
    args = ["bindash", "-q", q, "-r", r, "-k", "12", "-s", "256"]
    assert jax_main([*args, "-o", str(tmp_path / "j.tsv")]) == 0
    assert torch_main([*args, "-o", str(tmp_path / "t.tsv"), "--device", "cpu"]) == 0
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    if not torch.cuda.is_available():
        for tool in ("bindash", "hypermash", "superaai"):
            with pytest.raises(RuntimeError, match="--device cpu"):
                torch_main([tool, "-q", q, "-r", r, "-o", str(tmp_path / "x.tsv")])
