"""The codon-HMM Viterbi decoder of gene prediction (models/genepred.py).

Counterpart of gsearch_tpu/models/genepred.py's `_transition_table` and
`_viterbi`: emissions e [B, W, 11] and four position bonuses [B, W] (start
and rev-begin on the NC -> F1 / R1 edges, stop and rev-end on the F3 / R3 ->
NC edges) decode to the best state path [B, W] int8, one window a row.

`viterbi` is the wrapper: a CPU tensor takes `viterbi_plain`, a torch loop
over positions in the reference's sum order; a CUDA tensor launches the
hand-written kernel of csrc/viterbi.cu (see the notes there) or raises.
Both add as the reference does, ((dp[f] + tb[f, t]) + from-bonus) +
to-bonus, keep the lowest `from` state among equal candidates and start the
backtrace from the lowest best final state, so their paths equal the
reference's bit for bit, ties under N runs and padding included.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib

NSTATE = 11
NC, F1, F2, F3, R1, R2, R3, FI1, FI2, RI1, RI2 = range(NSTATE)
NEG_BIG = -1e9


def transition_table(p_gene_start: float, log_indel: float) -> np.ndarray:
    """The static [from, to] log-transition matrix, f32 (the reference's
    `_transition_table(log1p(-2 p), log(p), log_indel)`).  The logs are
    taken in float64 and rounded to f32, which equals XLA's f32 log at the
    gene-start rates used (tests/test_torch_genepred.py)."""
    p = np.float64(np.float32(p_gene_start))
    log_stay, log_go = np.float32(np.log1p(-2.0 * p)), np.float32(np.log(p))
    tb = np.full((NSTATE, NSTATE), NEG_BIG, np.float32)
    tb[NC, NC] = log_stay
    tb[F3, NC] = tb[R3, NC] = 0.0
    tb[NC, F1] = tb[NC, R1] = log_go
    for a, b in ((F3, F1), (F1, F2), (F2, F3), (R3, R1), (R1, R2), (R2, R3),
                 (FI1, F2), (FI2, F3), (RI1, R2), (RI2, R3)):
        tb[a, b] = 0.0
    # sequencing errors (log_indel = -1e9 prunes them): insertions detour
    # through FI / RI (self-loops for runs), deletions skip a codon position
    for a, b in ((F1, FI1), (FI1, FI1), (F2, FI2), (FI2, FI2), (R1, RI1), (RI1, RI1),
                 (R2, RI2), (RI2, RI2), (F1, F3), (F2, F1), (F3, F2), (R1, R3), (R2, R1),
                 (R3, R2)):
        tb[a, b] = np.float32(log_indel)
    return tb


def _check(e, bonuses, dp0, tb) -> tuple:
    if e.dim() != 3 or e.shape[2] != NSTATE:
        raise ValueError(f"emissions must be [B, W, {NSTATE}], got {tuple(e.shape)}")
    b, w = e.shape[:2]
    if len(bonuses) != 4 or any(x.shape != (b, w) for x in bonuses):
        raise ValueError(f"expected four bonus vectors [{b}, {w}]")
    if dp0.shape != (b, NSTATE) or tb.shape != (NSTATE, NSTATE):
        raise ValueError(f"dp0 must be [{b}, {NSTATE}] and tb [{NSTATE}, {NSTATE}], "
                         f"got {tuple(dp0.shape)} and {tuple(tb.shape)}")
    for x in (e, *bonuses, dp0, tb):
        if x.dtype != torch.float32:
            raise TypeError(f"viterbi takes float32 inputs, got {x.dtype}")
        if x.device != e.device:
            raise ValueError(f"device mismatch {x.device} vs {e.device}")
    return b, w


def viterbi_plain(e: torch.Tensor, start_bonus: torch.Tensor, stop_bonus: torch.Tensor,
                  rev_begin_bonus: torch.Tensor, rev_end_bonus: torch.Tensor,
                  dp0: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """Plain torch decoder: a loop over the W positions on [B, 11, 11]
    candidates, then the backtrace.  The reference's one-hot products add
    a bonus or an exact zero, so adding the bonuses to the NC column and
    the NC row in that order gives its bits."""
    b, w = _check(e, (start_bonus, stop_bonus, rev_begin_bonus, rev_end_bonus), dp0, tb)
    zeros = torch.zeros((b, w), dtype=torch.float32, device=e.device)
    # from-side bonuses (edges * -> NC) and to-side ones (NC -> *)
    from_bon = torch.stack([zeros, zeros, zeros, stop_bonus, zeros, zeros, rev_end_bonus,
                            zeros, zeros, zeros, zeros], dim=2)
    to_bon = torch.stack([zeros, start_bonus, zeros, zeros, rev_begin_bonus, zeros, zeros,
                          zeros, zeros, zeros, zeros], dim=2)
    bps = torch.empty((b, w, NSTATE), dtype=torch.int8, device=e.device)
    dp = dp0
    for i in range(w):
        cand = dp[:, :, None] + tb
        cand[:, :, NC] += from_bon[:, i]
        cand[:, NC, :] += to_bon[:, i]
        best, arg = torch.max(cand, dim=1)  # the first maximal `from` state
        bps[:, i] = arg.to(torch.int8)
        dp = best + e[:, i]
    path = torch.empty((b, w), dtype=torch.int8, device=e.device)
    st = torch.argmax(dp, dim=1, keepdim=True)
    rows = bps.to(torch.int64)
    for i in range(w - 1, -1, -1):
        path[:, i] = st[:, 0]
        st = rows[:, i].gather(1, st)
    return path


def viterbi(e: torch.Tensor, start_bonus: torch.Tensor, stop_bonus: torch.Tensor,
            rev_begin_bonus: torch.Tensor, rev_end_bonus: torch.Tensor, dp0: torch.Tensor,
            tb: torch.Tensor) -> torch.Tensor:
    """Viterbi decode, one window a row: the CUDA kernel for CUDA tensors,
    the plain version for CPU ones.  Returns the state path [B, W] int8."""
    bonuses = (start_bonus, stop_bonus, rev_begin_bonus, rev_end_bonus)
    b, w = _check(e, bonuses, dp0, tb)
    if e.device.type == "cpu":
        return viterbi_plain(e, *bonuses, dp0, tb)
    if e.device.type != "cuda":
        raise ValueError(f"viterbi: expected CPU or CUDA tensors, got {e.device}")
    for x in (e, *bonuses, dp0, tb):
        if not x.is_contiguous():
            raise ValueError("viterbi: tensors must be contiguous")
    if b * w * NSTATE >= 1 << 62 or w >= 1 << 31 or b >= 1 << 31:
        raise ValueError(f"viterbi: shape [{b}, {w}] too large")
    path = torch.empty((b, w), dtype=torch.int8, device=e.device)
    bp = torch.empty((b, w, NSTATE), dtype=torch.int8, device=e.device)
    lib = cuda_lib.load()
    rc = lib.gs_viterbi(e.data_ptr(), *(x.data_ptr() for x in bonuses), dp0.data_ptr(),
                        tb.data_ptr(), bp.data_ptr(), path.data_ptr(), b, w, e.device.index,
                        cuda_lib.current_stream(e.device))
    cuda_lib.check(lib, rc, "gs_viterbi")
    cuda_lib.launches["viterbi"] += 1
    return path
