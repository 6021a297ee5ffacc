"""gsearch_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax or any module of gsearch_tpu (read from the
source, so an import inside a function counts too); and its entry points
take no default device, so a caller who names none is told so instead of
running on the CPU."""

import ast
import glob
import os

import numpy as np
import pytest

from gsearch_tpu_torch.analysis.coreset import build_coreset
from gsearch_tpu_torch.analysis.embed import Embedder
from gsearch_tpu_torch.core.params import SeqSketcherParams
from gsearch_tpu_torch.index.bigsi import BigsiIndex
from gsearch_tpu_torch.index.refimport import import_reference_db
from gsearch_tpu_torch.index.sharded import ShardedHnswIndex
from gsearch_tpu_torch.models.genepred import predict_genes, self_trained_params
from gsearch_tpu_torch.models.hmmprofile import HmmSearcher, ProfileHMM
from gsearch_tpu_torch.models.seedchain import SeedChainer
from gsearch_tpu_torch.index import FlatIndex, HnswIndex, from_jax_database
from gsearch_tpu_torch.models import make_sketcher
from gsearch_tpu_torch.models.optdens import OptDensSketcher
from gsearch_tpu_torch.parallel.mesh import dryrun_multichip, make_device_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(glob.glob(os.path.join(REPO, "gsearch_tpu_torch", "**", "*.py"), recursive=True))
SOURCES.append(os.path.join(REPO, "chip_smoke.py"))


def _banned(name: str) -> bool:
    return name.split(".")[0] in ("jax", "gsearch_tpu")


def test_sources_found():
    assert len(SOURCES) > 30
    rel = {os.path.relpath(p, REPO) for p in SOURCES}
    for mod in ("index/sharded.py", "analysis/kgraph.py", "analysis/coreset.py", "analysis/embed.py",
                "models/seedchain.py", "cli/hnsw2knn.py", "cli/hnswcore.py", "cli/superani.py",
                "index/bigsi.py", "cli/bigsig.py", "index/refimport.py", "models/hmmprofile.py",
                "cli/hmmsearch.py", "models/genepred.py", "cli/genepred.py", "ops/viterbi.py",
                "parallel/__init__.py", "parallel/mesh.py"):
        assert f"gsearch_tpu_torch/{mod}" in rel, mod


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _banned(node.module):
                found.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and _banned(node.args[0].value)):
            found.append(node.args[0].value)
    assert not found, found


def test_entry_points_require_a_device(tmp_path):
    params = SeqSketcherParams(kmer_size=16, sketch_size=64, algo="OPTDENS", data_t="DNA")
    with pytest.raises(TypeError, match="device"):
        make_sketcher(params)
    with pytest.raises(TypeError, match="device"):
        OptDensSketcher(params)
    with pytest.raises(TypeError, match="device"):
        HnswIndex(sketch_size=64, sig_dtype=np.float32)
    with pytest.raises(TypeError, match="device"):
        FlatIndex(64, np.float32)
    with pytest.raises(TypeError, match="device"):
        from_jax_database(str(tmp_path))
    with pytest.raises(TypeError, match="device"):
        HnswIndex.from_jax(object())
    with pytest.raises(TypeError, match="device"):
        ShardedHnswIndex(sketch_size=64, sig_dtype=np.float32, n_shards=2)
    with pytest.raises(TypeError, match="device"):
        SeedChainer()
    with pytest.raises(TypeError, match="device"):
        Embedder(None)
    with pytest.raises(TypeError, match="device"):
        build_coreset(np.zeros((4, 8), np.float32), 2)
    with pytest.raises(TypeError, match="device"):
        BigsiIndex(1 << 10, 2, 21)
    with pytest.raises(TypeError, match="device"):
        BigsiIndex.load(str(tmp_path / "idx"))
    with pytest.raises(TypeError, match="device"):
        BigsiIndex.from_jax(object())
    profile = ProfileHMM("p", "", 1, np.zeros((2, 20), np.float32), np.zeros((2, 7), np.float32))
    with pytest.raises(TypeError, match="device"):
        HmmSearcher([profile])
    with pytest.raises(TypeError, match="device"):
        import_reference_db(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(TypeError, match="device"):
        predict_genes(b"ACGT" * 40)
    with pytest.raises(TypeError, match="device"):
        self_trained_params(b"ACGT" * 40)
    with pytest.raises(TypeError, match="device"):
        make_device_mesh(2)
    with pytest.raises(TypeError, match="device"):
        dryrun_multichip(2)
