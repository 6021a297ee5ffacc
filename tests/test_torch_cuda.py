"""gsearch_tpu_torch on a CUDA card: each hand-written kernel against its
plain torch version (bitwise), and the sketch and search paths on the card
against the same code on the CPU, which the other test_torch_* files hold
to gsearch_tpu.  Every test skips without a card; the file imports no JAX,
so on the card it runs alone with
`python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest`."""

import numpy as np
import pytest
import torch

from gsearch_tpu.core.params import SeqSketcherParams
from gsearch_tpu_torch.models import make_sketcher
from gsearch_tpu_torch.ops import cuda_lib
from gsearch_tpu_torch.ops import distance as tdist
from gsearch_tpu_torch.ops.mxu import MxuSearcher

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_k1_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    # unsplit (large Q x N), split S, one tile, ragged everything
    for nq, n, s in ((1, 1, 1), (37, 130, 77), (70, 4095, 1203), (600, 3000, 333)):
        db = (torch.rand((n, s), generator=gen, device=cuda_device) * 3).to(dtype)
        q = (torch.rand((nq, s), generator=gen, device=cuda_device) * 3).to(dtype)
        before = cuda_lib.launches["hamming_frac"]
        got = tdist.hamming_frac(q, db)
        assert cuda_lib.launches["hamming_frac"] == before + 1
        assert torch.equal(got.view(torch.int32), tdist.hamming_frac_plain(q, db).view(torch.int32))


def test_k2_kernel_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    for qc, r, n, s in ((1, 1, 5, 3), (33, 80, 2000, 1201), (64, 20, 300, 12000)):
        db = torch.rand((n, s), generator=gen, device=cuda_device)
        keep = torch.rand((qc, s), generator=gen, device=cuda_device) < 0.5
        q = torch.where(keep, db[0].expand(qc, s), 0.0).contiguous()
        ids = torch.randint(-2, n + 2, (qc, r), generator=gen, device=cuda_device, dtype=torch.int32)
        got = tdist.gather_hamming(db, q, ids)
        assert torch.equal(got.view(torch.int32), tdist.gather_hamming_plain(db, q, ids).view(torch.int32))


def test_wrappers_reject_cpu_mix_and_non_contiguous(cuda_device):
    db = torch.rand((10, 16), device=cuda_device)
    with pytest.raises(ValueError):
        tdist.hamming_frac(db[:, ::2], db[:, ::2])
    with pytest.raises(ValueError):
        tdist.hamming_frac(db.cpu(), db)
    with pytest.raises(TypeError):
        tdist.gather_hamming(db, db[:2].contiguous(), torch.zeros((2, 3), dtype=torch.int64, device=cuda_device))


@pytest.mark.parametrize("algo,s", [("OPTDENS", 128), ("REVOPTDENS", 1024)])
def test_sketch_on_card_matches_cpu(cuda_device, algo, s):
    rng = np.random.default_rng(9)
    genomes = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (10, 12_000, 40_000, 70_001)]
    heavy = rng.integers(0, 4, size=40_000).astype(np.uint8)
    for st in rng.integers(0, 15_000, 30):
        heavy[st : st + 60] = 255
    genomes.append(heavy)
    p = SeqSketcherParams(kmer_size=16, sketch_size=s, algo=algo, data_t="DNA")
    sigs = []
    for dev in (cuda_device, torch.device("cpu")):
        sk = make_sketcher(p, device=dev)
        sk.MAX_BLOCK_LOG2 = 14
        sigs.append(sk.sketch_many(genomes))
    np.testing.assert_array_equal(sigs[0].view(np.uint32), sigs[1].view(np.uint32))


def test_mxu_searcher_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(10)
    n, s = 4200, 256
    db = rng.random((n, s), dtype=np.float32)
    q = db[rng.integers(0, n, 40)].copy()
    q[:, :60] = rng.random((40, 60), dtype=np.float32)
    before = dict(cuda_lib.launches)
    got = MxuSearcher(db, cuda_device).search(q, 10)
    assert cuda_lib.launches["gather_hamming"] == before["gather_hamming"] + 1
    want = MxuSearcher(db, torch.device("cpu")).search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
