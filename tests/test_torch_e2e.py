"""The verify recipe (8 genomes, one 1%-mutated query, k=16, s=1024, block
mode) through both CLIs, with the flat and the graph (`--index hnsw`)
index: identical signatures, graphs, neighbours files and ANI tables, each
package requesting the other's database; an `add` that migrates a flat
database to the graph; the port's CLI run as `python -m gsearch_tpu_torch
... --device cpu` imports no JAX.  Then every sketching algorithm through both
CLIs (`tohnsw`, `add`, `request`) on one small corpus: byte-identical
databases and neighbours files where the sketcher is bit-exact; for prob and
hll (an f32 log, see test_torch_sketchers.py) equal ids and distances within
0.004; each package requests the other's database."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsearch_tpu.pipeline as jax_pipeline
import gsearch_tpu_torch.pipeline as torch_pipeline
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
    idx = from_jax_database(str(root / "db_jax"), device=torch.device("cpu"))
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
    unknown = tmp_path / "unknown"
    shutil.copytree(root / "db_torch", unknown)
    (unknown / "index.meta.json").write_text('{"kind": "bigsi"}')
    with pytest.raises(ValueError, match="unknown index kind"):
        torch_main(["request", "-b", str(unknown), "-n", "5", "-r", str(root / "queries"),
                    "-o", str(tmp_path / "o"), "--device", "cpu"])
    if torch.cuda.device_count() < 2:  # --mesh 2 on a machine with fewer cards names both counts
        from gsearch_tpu_torch.parallel.mesh import make_device_mesh

        with pytest.raises(ValueError, match=f"needs 2 CUDA cards, but {torch.cuda.device_count()}"):
            make_device_mesh(2, device=torch.device("cuda"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            torch_main(["tohnsw", "-d", db, *BUILD, "-o", str(tmp_path / "c")])


def _graph_arrays(db) -> dict:
    with np.load(db / "index.graph.npz") as g:
        arrays = {k: g[k] for k in g.files}
    arrays["sigs"] = np.load(db / "index.sigs.npy")
    return arrays


def _assert_same_graph(a, b):
    ga, gb = _graph_arrays(a), _graph_arrays(b)
    assert sorted(ga) == sorted(gb) == ["entry_ids", "nbr_d", "nbrs", "pinned", "sigs"]
    for k in ga:
        assert ga[k].dtype == gb[k].dtype, k
        np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
    assert (a / "index.meta.json").read_bytes() == (b / "index.meta.json").read_bytes()


@pytest.fixture(scope="module")
def hnsw_recipe(recipe):
    """The verify recipe built with `--index hnsw` by both CLIs, each
    package requesting both databases."""
    root, _ = recipe
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert jax_main(["tohnsw", "-d", "db_genomes", *BUILD, "--index", "hnsw", "-o", "hdb_jax"]) == 0
        assert torch_main(["tohnsw", "-d", "db_genomes", *BUILD, "--index", "hnsw", "-o", "hdb_torch",
                           "--device", "cpu"]) == 0
        outs = {}
        for db in ("hdb_jax", "hdb_torch"):
            for pkg, run in (("jax", jax_main), ("torch", torch_main)):
                out = f"hreq_{pkg}_{db}"
                extra = ["--device", "cpu"] if pkg == "torch" else []
                assert run(["request", "-b", db, "-n", "5", "-r", "queries", "-o", out, "--ef", "64",
                            *extra]) == 0
                assert run(["reformat", "16", "1", f"{out}/gsearch.neighbors.txt", f"{out}/ani.tsv"]) == 0
                outs[(pkg, db)] = out
    finally:
        os.chdir(cwd)
    return root, outs


def test_hnsw_recipe_graphs_and_answers_identical(hnsw_recipe):
    root, outs = hnsw_recipe
    assert '"kind": "hnsw"' in (root / "hdb_torch" / "index.meta.json").read_text()
    _assert_same_graph(root / "hdb_jax", root / "hdb_torch")
    ref = outs[("jax", "hdb_jax")]
    for key, out in outs.items():
        for name in ("gsearch.neighbors.txt", "ani.tsv"):
            assert (root / out / name).read_bytes() == (root / ref / name).read_bytes(), (key, name)
    best = (root / ref / "ani.tsv").read_text().splitlines()[1].split("\t")
    assert best[0] == "q.fna" and best[2] == "g0.fna" and abs(float(best[4]) - 99.0) < 1.0


def test_add_migrates_flat_to_hnsw_like_reference(recipe, tmp_path, monkeypatch):
    """An `add` that grows a flat database past (a lowered) flat_auto_limit
    converts it to the graph index in both packages: equal graphs, and the
    added genome is found at distance 0."""
    root, _ = recipe
    for mod in (jax_pipeline, torch_pipeline):
        monkeypatch.setattr(mod, "flat_auto_limit", lambda sketch_size: 8)
    rng = np.random.default_rng(11)
    (tmp_path / "new").mkdir()
    newg = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 12000))
    (tmp_path / "new" / "new.fna").write_bytes(b">x\n" + newg + b"\n")
    dbs = {}
    for pkg, run, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        db = tmp_path / f"db_{pkg}"
        shutil.copytree(root / "db_jax", db)
        assert run(["add", "-b", str(db), "-n", str(tmp_path / "new"), *extra]) == 0
        dbs[pkg] = db
    assert '"kind": "hnsw"' in (dbs["torch"] / "index.meta.json").read_text()
    _assert_same_graph(dbs["jax"], dbs["torch"])
    out = tmp_path / "out"
    assert torch_main(["request", "-b", str(dbs["torch"]), "-n", "3", "-r", str(tmp_path / "new"),
                       "-o", str(out), "--device", "cpu"]) == 0
    hits = [l for l in (out / "gsearch.neighbors.txt").read_text().splitlines() if l.startswith("query_id:")]
    assert "new.fna" in hits[0] and "0.00000E0" in hits[0]


def test_grown_database_with_placeholders(recipe, tmp_path, monkeypatch):
    """The port's helpers that grow a database with synthetic signatures:
    the database's sketcher re-sketches its genomes bit for bit; a graph
    index holding them plus uniform decoys, dumped with placeholder names,
    is requested by gsearch_tpu with the flat database's answers (every
    decoy lies above the 0.99 output threshold)."""
    root, outs = recipe
    cpu = torch.device("cpu")
    src = str(root / "db_torch")
    sketcher = torch_pipeline.database_sketcher(src, device=cpu)
    sigs = sketcher.sketch_many(torch_pipeline.read_genomes(str(root / "db_genomes")))
    np.testing.assert_array_equal(sigs.view(np.uint32), np.load(root / "db_torch" / "index.sigs.npy").view(np.uint32))
    idx = torch_pipeline.empty_index_like(src, "hnsw", device=cpu)
    decoys = np.random.default_rng(5).random((40, sigs.shape[1]), dtype=np.float32)
    idx.insert(np.concatenate([sigs, decoys]))
    torch_pipeline.dump_with_placeholders(src, str(tmp_path / "grown"), idx)
    names = (tmp_path / "grown" / "seqdict.json").read_text()
    assert "g7.fna" in names and "decoys/d39.fna" in names and "decoys/d40.fna" not in names
    monkeypatch.chdir(root)
    assert jax_main(["request", "-b", str(tmp_path / "grown"), "-n", "5", "-r", "queries",
                     "-o", str(tmp_path / "out")]) == 0
    ref = root / outs[("jax", "db_jax")] / "gsearch.neighbors.txt"
    assert (tmp_path / "out" / "gsearch.neighbors.txt").read_bytes() == ref.read_bytes()
    with pytest.raises(ValueError, match="fewer"):
        torch_pipeline.dump_with_placeholders(src, str(tmp_path / "bad"),
                                              torch_pipeline.empty_index_like(src, "flat", device=cpu))


def test_python_m_run_imports_no_jax(recipe, tmp_path):
    """A fresh interpreter running the port's CLI, with the flat and the
    graph index, imports neither jax nor any module of gsearch_tpu; its
    neighbours files equal the reference's."""
    root, outs = recipe
    env = dict(os.environ, PYTHONPATH=REPO)
    cmds = []
    for kind in ("flat", "hnsw"):
        db, out = tmp_path / f"db_{kind}", tmp_path / f"out_{kind}"
        cmds += [["tohnsw", "-d", "db_genomes", *BUILD, "--index", kind, "-o", str(db)],
                 ["request", "-b", str(db), "-n", "5", "-r", "queries", "-o", str(out)]]
    for cmd in cmds:
        proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "gsearch_tpu_torch", *cmd,
                               "--device", "cpu"], cwd=root, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        modules = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                   if line.startswith("import time:")}
        assert "gsearch_tpu_torch.pipeline" in modules
        assert "gsearch_tpu_torch.index.hnsw" in modules
        assert "gsearch_tpu_torch.io.native" in modules
        banned = [m for m in modules if m in ("jax", "gsearch_tpu")
                  or m.startswith(("jax.", "gsearch_tpu."))]
        assert not banned, banned
    assert '"kind": "hnsw"' in (tmp_path / "db_hnsw" / "index.meta.json").read_text()
    ref = root / outs[("jax", "db_jax")] / "gsearch.neighbors.txt"
    for kind in ("flat", "hnsw"):
        assert (tmp_path / f"out_{kind}" / "gsearch.neighbors.txt").read_bytes() == ref.read_bytes()


# ---- every sketching algorithm through both CLIs ---------------------------------

LOG_ALGOS = ("prob", "hll")
SIG_DTYPE = {"prob": "uint32", "super": "float32", "super2": "uint32", "hll": "uint16",
             "optdens": "float32", "revoptdens": "float32"}
ALPHABETS = {False: b"ACGT", True: b"ACDEFGHIKLMNPQRSTVWY"}


def write_algo_corpus(root, is_aa: bool, seed: int = 99):
    """Six genomes (or proteomes), a query at 1% (3%) substitutions of
    genome 1, and a genome to `add`, which is also queried."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(ALPHABETS[is_aa], np.uint8)
    ext, n = ("faa", 6_000) if is_aa else ("fna", 10_000)
    for d in ("db", "q", "new"):
        (root / d).mkdir()
    genomes = [rng.choice(alpha, n) for _ in range(6)]
    for i, g in enumerate(genomes):
        (root / "db" / f"g{i}.{ext}").write_bytes(b">g%d\n" % i + g.tobytes() + b"\n")
    q = genomes[1].copy()
    pos = rng.choice(n, n * (3 if is_aa else 1) // 100, replace=False)
    q[pos] = rng.choice(alpha, len(pos))
    (root / "q" / f"qq.{ext}").write_bytes(b">qq\n" + q.tobytes() + b"\n")
    new = rng.choice(alpha, n).tobytes()
    (root / "new" / f"added.{ext}").write_bytes(b">added\n" + new + b"\n")
    (root / "q" / f"added.{ext}").write_bytes(b">added\n" + new + b"\n")
    return ext


def _hits(path) -> list:
    """[(query, distance, answer)] of a neighbours file, in file order."""
    rows = []
    for line in path.read_text().splitlines():
        if line.startswith("query_id:"):
            f = line.split("\t")
            rows.append((f[1], float(f[3]), f[5]))
    return rows


def run_algo_case(root, work, algo: str, is_aa: bool, ext: str):
    """`tohnsw`, `add` and `request` of one algorithm by both CLIs, each
    package requesting both databases; every comparison of the module
    docstring.  `root` holds the corpus (the CLIs run from it, so both
    record the same relative paths), `work` the outputs."""
    k = "7" if is_aa else "12"
    build = ["-k", k, "-s", "512", "-n", "8", "--ef", "64", "--algo", algo, "--block"]
    if is_aa:
        build.append("--aa")
    runs = {"jax": (jax_main, []), "torch": (torch_main, ["--device", "cpu"])}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for pkg, (run, extra) in runs.items():
            db = str(work / f"db_{pkg}")
            assert run(["tohnsw", "-d", "db", *build, "-o", db, *extra]) == 0
            assert run(["add", "-b", db, "-n", "new", *extra]) == 0
        for db in ("db_jax", "db_torch"):
            for pkg, (run, extra) in runs.items():
                assert run(["request", "-b", str(work / db), "-n", "4", "-r", "q",
                            "-o", str(work / f"req_{pkg}_{db}"), *extra]) == 0
    finally:
        os.chdir(cwd)
    for name in ("index.meta.json", "seqdict.json", "parameters.json"):
        assert (work / "db_jax" / name).read_bytes() == (work / "db_torch" / name).read_bytes(), name
    assert '"sig_dtype": "%s"' % SIG_DTYPE[algo] in (work / "db_torch" / "index.meta.json").read_text()
    sj, st = np.load(work / "db_jax" / "index.sigs.npy"), np.load(work / "db_torch" / "index.sigs.npy")
    assert sj.dtype == st.dtype == np.dtype(SIG_DTYPE[algo]) and sj.shape == st.shape == (7, 512)
    outs = [work / f"req_{pkg}_{db}" / "gsearch.neighbors.txt"
            for db in ("db_jax", "db_torch") for pkg in runs]
    if algo in LOG_ALGOS:
        assert (sj != st).sum(1).max() <= 1
        # each database gives both packages the same file; across the two
        # databases ids are equal and distances within the tolerance
        assert outs[0].read_bytes() == outs[1].read_bytes()
        assert outs[2].read_bytes() == outs[3].read_bytes()
        a, b = _hits(outs[0]), _hits(outs[2])
        assert [(q, hit) for q, _, hit in a] == [(q, hit) for q, _, hit in b]
        assert max(abs(x[1] - y[1]) for x, y in zip(a, b)) <= 0.004
    else:
        np.testing.assert_array_equal(sj.view(np.uint8), st.view(np.uint8))
        assert (work / "db_jax" / "index.sigs.npy").read_bytes() == (
            work / "db_torch" / "index.sigs.npy").read_bytes()
        for out in outs[1:]:
            assert out.read_bytes() == outs[0].read_bytes(), out
    best = {}
    for q, d, hit in _hits(outs[3]):
        best.setdefault(q, (d, hit))
    assert best[f"q/qq.{ext}"][1] == f"db/g1.{ext}", best
    assert best[f"q/added.{ext}"] == (0.0, f"new/added.{ext}"), best
    # the reference's database through from_jax_database: the same neighbours
    from gsearch_tpu.index.serialize import load_index as jax_load
    from gsearch_tpu_torch.index import from_jax_database

    idx = from_jax_database(str(work / "db_jax"), device=torch.device("cpu"))
    assert idx.sig_dtype == np.dtype(SIG_DTYPE[algo])
    d, i = idx.search(sj[[3, 6, 0]], 4)
    d_ref, i_ref = jax_load(str(work / "db_jax")).search(sj[[3, 6, 0]], 4)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=2.0**-23)
    assert (i[:, 0] == [3, 6, 0]).all() and (d[:, 0] == 0).all()


@pytest.fixture(scope="module")
def algo_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("algos")
    return root, write_algo_corpus(root, is_aa=False)


@pytest.mark.parametrize("algo", ["prob", "super", "super2", "hll", "optdens", "revoptdens"])
def test_algo_end_to_end_both_packages(algo_corpus, tmp_path, algo):
    root, ext = algo_corpus
    run_algo_case(root, tmp_path, algo, False, ext)


def test_cli_refuses_what_the_reference_refuses(algo_corpus, tmp_path):
    """`--algo nonsense` and AA `-k 13` fail with the reference's messages."""
    root, _ = algo_corpus
    for args, msg in ((["-k", "12", "--algo", "nonsense"], "unknown sketching algorithm 'NONSENSE'"),
                      (["-k", "13", "--algo", "optdens", "--aa"], r"out of range \[1,12\] for AA")):
        for run, extra in ((jax_main, []), (torch_main, ["--device", "cpu"])):
            with pytest.raises(ValueError, match=msg):
                run(["tohnsw", "-d", str(root / "db"), "-s", "64", "-n", "8", *args,
                     "-o", str(tmp_path / "x"), *extra])
    from gsearch_tpu_torch.cli.main import build_parser

    helptext = build_parser().format_help()
    assert "bindash" in helptext and "hypermash" in helptext and "superaai" in helptext
