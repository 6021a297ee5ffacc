"""The codon-HMM Viterbi decoder of gene prediction (models/genepred.py).

Counterpart of gsearch_tpu/models/genepred.py's `_transition_table` and
`_viterbi`: emissions e [B, W, 11] and four position bonuses [B, W] (start
and rev-begin on the NC -> F1 / R1 edges, stop and rev-end on the F3 / R3 ->
NC edges) decode to the best state path [B, W] int8, one window a row.

`viterbi` is the wrapper: a CPU tensor takes `viterbi_plain`, a torch loop
over positions in the reference's sum order; a CUDA tensor launches the
hand-written kernel `gs_viterbi` of csrc/viterbi.cu (see the notes there)
or raises.  Both add as the reference does, ((dp[f] + tb[f, t]) +
from-bonus) + to-bonus, keep the lowest `from` state among equal
candidates and start the backtrace from the lowest best final state, so
their paths equal the reference's bit for bit, ties under N runs and
padding included.

`genepred_decode` launches the fused form, `gs_genepred_decode`: the
window's codes [B, W] u8 to its path in one launch, the emissions and
bonuses computed inside it.  It takes CUDA tensors only; its wrapper with
the plain composition for CPU tensors is models/genepred.py's
`_decode_windows`.  `viterbi_launch` and `genepred_decode_launch` check and
bind a launch once and return it as a function, which the wrappers call
once and a timing loop may call again.
"""

from __future__ import annotations

from typing import Callable

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
    if e.device.type == "cpu":
        return viterbi_plain(e, *bonuses, dp0, tb)
    return viterbi_launch(e, *bonuses, dp0, tb)()


def viterbi_launch(e: torch.Tensor, start_bonus: torch.Tensor, stop_bonus: torch.Tensor,
                   rev_begin_bonus: torch.Tensor, rev_end_bonus: torch.Tensor,
                   dp0: torch.Tensor, tb: torch.Tensor) -> Callable[[], torch.Tensor]:
    """`gs_viterbi` on CUDA tensors, checked and bound once: each call of
    the returned function launches the kernel on the stream current now,
    counts the launch and returns the path [B, W] int8 (one output tensor,
    rewritten by every call).  `viterbi` calls it once."""
    bonuses = (start_bonus, stop_bonus, rev_begin_bonus, rev_end_bonus)
    b, w = _check(e, bonuses, dp0, tb)
    if e.device.type != "cuda":
        raise ValueError(f"viterbi: expected CPU or CUDA tensors, got {e.device}")
    for x in (e, *bonuses, dp0, tb):
        if not x.is_contiguous():
            raise ValueError("viterbi: tensors must be contiguous")
    _check_window_shape("viterbi", b, w)
    path, bp = _outputs(b, w, e.device)
    lib = cuda_lib.load()
    args = (e.data_ptr(), *(x.data_ptr() for x in bonuses), dp0.data_ptr(), tb.data_ptr(),
            bp.data_ptr(), path.data_ptr(), b, w, e.device.index, cuda_lib.current_stream(e.device))

    def launch() -> torch.Tensor:
        cuda_lib.check(lib, lib.gs_viterbi(*args), "gs_viterbi")
        cuda_lib.launches["viterbi"] += 1
        return path

    launch.held = (e, bonuses, dp0, tb, bp)  # what the bound pointers address
    return launch


def _check_window_shape(what: str, b: int, w: int) -> None:
    if w < 8:
        raise ValueError(f"{what}: the kernel takes windows of at least 8 bases, got {w}")
    if b * w * NSTATE >= 1 << 62 or w >= 1 << 31 or b >= 1 << 31:
        raise ValueError(f"{what}: shape [{b}, {w}] too large")


def _outputs(b: int, w: int, device) -> tuple:
    """The path [B, W] int8 and the kernel's backpointer scratch, 4
    bit-planes of 16 bits a base."""
    return (torch.empty((b, w), dtype=torch.int8, device=device),
            torch.empty((b, w, 2), dtype=torch.int32, device=device))


#: the fused decoder's tables (keywords of models/genepred._precompute_scores)
#: and their shapes; codon_lu is required, the others may be None
DECODE_TABLES = {"codon_lu": (64,), "dicodon_lu": (64, 64), "rdicodon_lu": (64, 64),
                 "nc_lm": (4, 4), "ctx": (4, 61, 64), "ctx_aff": (4, 2), "start_prior": (64,)}


def genepred_decode(codes: torch.Tensor, dp0: torch.Tensor, tb: torch.Tensor, *,
                    start_codon_bonus: float, stop_codon_bonus: float, ctx_weight: float,
                    ctx_cap: float, ctx_neg_cap: float, **tables) -> torch.Tensor:
    """One launch of `gs_genepred_decode`: codes [B, W] u8 (>= 4 invalid)
    on a CUDA device, the tables of DECODE_TABLES as f32 tensors on that
    device (codon_lu required, ctx only with ctx_aff; rdicodon_lu is read
    only with dicodon_lu, as the plain precompute does), dp0 [B, 11] and
    tb [11, 11] -> the state path [B, W] int8.  The scalars round to f32.
    Raises on what the kernel does not take."""
    return genepred_decode_launch(codes, dp0, tb, start_codon_bonus=start_codon_bonus,
                                  stop_codon_bonus=stop_codon_bonus, ctx_weight=ctx_weight,
                                  ctx_cap=ctx_cap, ctx_neg_cap=ctx_neg_cap, **tables)()


def genepred_decode_launch(codes: torch.Tensor, dp0: torch.Tensor, tb: torch.Tensor, *,
                           start_codon_bonus: float, stop_codon_bonus: float,
                           ctx_weight: float, ctx_cap: float, ctx_neg_cap: float,
                           **tables) -> Callable[[], torch.Tensor]:
    """`genepred_decode`'s inputs checked and bound once: each call of the
    returned function launches `gs_genepred_decode` on the stream current
    now, counts the launch and returns the path (one output tensor,
    rewritten by every call)."""
    if set(tables) - set(DECODE_TABLES):
        raise TypeError(f"genepred_decode: unknown tables {sorted(set(tables) - set(DECODE_TABLES))}")
    if codes.device.type != "cuda":
        raise ValueError(f"genepred_decode: expected CUDA tensors, got {codes.device} (the "
                         "plain composition is models.genepred._decode_windows)")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"genepred_decode: codes must be [B, W] uint8, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    b, w = codes.shape
    _check_window_shape("genepred_decode", b, w)
    if tables.get("codon_lu") is None:
        raise ValueError("genepred_decode: codon_lu is required")
    if tables.get("ctx") is not None and tables.get("ctx_aff") is None:
        raise ValueError("genepred_decode: ctx needs its calibration ctx_aff (the identity "
                         "is [[1, 0]] * 4)")
    shapes = {**DECODE_TABLES, "dp0": (b, NSTATE), "tb": (NSTATE, NSTATE)}
    given = {**tables, "dp0": dp0, "tb": tb}
    for name, x in given.items():
        if x is None:
            continue
        if tuple(x.shape) != shapes[name] or x.dtype != torch.float32:
            raise ValueError(f"genepred_decode: {name} must be f32 {list(shapes[name])}, got "
                             f"{x.dtype} {list(x.shape)}")
        if x.device != codes.device:
            raise ValueError(f"genepred_decode: {name} on {x.device}, codes on {codes.device}")
    for name, x in {"codes": codes, **given}.items():
        if x is not None and not x.is_contiguous():
            raise ValueError(f"genepred_decode: {name} must be contiguous")
    path, bp = _outputs(b, w, codes.device)
    ptr = {name: (0 if tables.get(name) is None else tables[name].data_ptr())
           for name in DECODE_TABLES}
    scalars = (start_codon_bonus, stop_codon_bonus, ctx_weight, ctx_cap, ctx_neg_cap)
    lib = cuda_lib.load()
    args = (codes.data_ptr(), ptr["codon_lu"], ptr["dicodon_lu"], ptr["rdicodon_lu"], ptr["nc_lm"],
            ptr["ctx"], ptr["ctx_aff"], ptr["start_prior"], *(float(np.float32(x)) for x in scalars),
            dp0.data_ptr(), tb.data_ptr(), bp.data_ptr(), path.data_ptr(), b, w, codes.device.index,
            cuda_lib.current_stream(codes.device))

    def launch() -> torch.Tensor:
        cuda_lib.check(lib, lib.gs_genepred_decode(*args), "gs_genepred_decode")
        cuda_lib.launches["genepred_decode"] += 1
        return path

    launch.held = (codes, given, bp)  # what the bound pointers address
    return launch
