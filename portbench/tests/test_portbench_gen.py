"""The generators repeat from --seed, and another seed draws other inputs."""

import gzip
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import gen  # noqa: E402
from portbench.corpora import genomes  # noqa: E402
from pbcommon import INGEST_TRAFFIC, SEARCH_CFG  # noqa: E402

torch.set_num_threads(2)
BIG_SEED = 2**31 + 2**30 + 7  # past 32 signed bits, as the driver's seeds are


def _draw(seed, structure=SEARCH_CFG["structure"], n=600, s=256):
    g = torch.Generator().manual_seed(seed)
    db = gen.database({"genomes": n, "sketch_size": s, "structure": structure}, g, "cpu")
    return db, gen.query_pool(db, 64, (0.02, 0.9), g, "cpu")


def test_database_and_queries_repeat_from_the_seed():
    db1, q1 = _draw(BIG_SEED)
    db2, q2 = _draw(BIG_SEED)
    db3, q3 = _draw(BIG_SEED + 1)
    assert np.array_equal(db1, db2) and np.array_equal(q1, q2)
    assert not np.array_equal(db1, db3) and not np.array_equal(q1, q3)


def test_species_structure_sets_the_distances():
    db, q = _draw(11, n=1024, s=4096)
    eq = lambda a, b: float((a == b).mean())  # noqa: E731
    # 32 families x 8 genera over 1,024 rows: genus 0 is rows 0-3
    assert 0.05 < eq(db[0], db[1]) < 0.15           # genus-mates share ~0.3 x 0.3
    assert eq(db[0], db[4]) < 0.01                  # another genus of the family
    # queries share 10-98% of their slots with some database row
    best = np.array([max(eq(r, d) for d in db) for r in q[:8]])
    assert (best > 0.09).all()


def test_member_trees_repeat_and_cluster():
    structure = {"kind": "member_trees", "families": 4, "species_per_family": 4,
                 "species_redraw": 0.5, "member_redraw": 0.03}
    a, _ = _draw(5, structure, n=320, s=1024)
    b, _ = _draw(5, structure, n=320, s=1024)
    assert np.array_equal(a, b)
    assert (a[0] == a[1]).mean() > 0.8              # species-mates (20 a species)
    assert (a[0] == a[25]).mean() < 0.5             # another species


def test_query_fractions_are_the_same_set_for_every_seed():
    for seed in (1, BIG_SEED):
        db, q = _draw(seed, n=64, s=2048)
        kept = np.sort([max((r == d).mean() for d in db) for r in q])
        want = np.sort(1 - (0.02 + 0.88 * (np.arange(64) + 0.5) / 64))
        assert np.abs(kept - want).max() < 0.05


def test_genome_corpus_repeats_from_the_seed(tmp_path):
    spec = dict(INGEST_TRAFFIC, gzip_level=1, writers=2)
    a = genomes.write(str(tmp_path / "a"), spec, BIG_SEED)
    b = genomes.write(str(tmp_path / "b"), spec, BIG_SEED)
    c = genomes.write(str(tmp_path / "c"), spec, BIG_SEED + 1)
    read = lambda p: open(p, "rb").read()  # noqa: E731
    assert [read(p) for p in a["files"]] == [read(p) for p in b["files"]]
    assert [read(p) for p in a["files"]] != [read(p) for p in c["files"]]
    assert len(a["files"]) == spec["genomes"]
    # the same sizes for every seed, in another order
    assert a["bases"] == c["bases"]
    assert sorted(map(_symbols, a["files"])) == sorted(map(_symbols, c["files"]))
    assert list(map(_symbols, a["files"])) != list(map(_symbols, c["files"]))


@pytest.mark.parametrize("seed, digest", [
    (7, "4f1d758c910f83395ec1acac7190ac521d990e6582a35db63c7246e366bb4943"),
    (BIG_SEED, "bc6842d07358c344328dd8f2918d211395b936cab721ca49853d59cea5b23b9a"),
])
def test_genomes_corpus_writes_the_bytes_it_always_wrote(tmp_path, seed, digest):
    """The sha256 of the files, in order, as the corpus writer wrote them
    before it became `corpora/genomes.py`: the gtdb-ingest cell ingests
    the same bytes."""
    out = genomes.write(str(tmp_path), dict(INGEST_TRAFFIC, gzip_level=1, writers=2), seed)
    h = hashlib.sha256()
    for path in out["files"]:
        with open(path, "rb") as f:
            h.update(f.read())
    assert out["bases"] == 300891 and h.hexdigest() == digest


def _symbols(path):
    with gzip.open(path) as f:
        return sum(len(line) for line in f.read().split(b"\n") if line and not line.startswith(b">"))
