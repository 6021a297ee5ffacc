"""Profile-HMM search over HMMER3 files: the `hmmsearch` engine.

Counterpart of gsearch_tpu/models/hmmprofile.py on one torch device.  The
parser, the profile record and the packing are the port's host copies of
the reference's; `HmmSearcher` scores with the same model: HMMER3's
default multihit local Plan7 configuration with the length-dependent
N/J/C loop model and null1 subtraction (entry t(B->Mk) = 2(L-k+1)/(L(L+1)),
exit t(Mk->E) = 1, insert log-odds 0), by Viterbi (the optimal alignment)
or Forward (the sum over alignments, what hmmsearch reports and applies GA
cutoffs to).  No null2 correction.  E-values come from the profile's
`STATS LOCAL VITERBI` / `FORWARD` tails: E = n_targets exp(-lambda (bits - tau)).

Both decoders are a loop over residue position on [H, B, L+1] state
tensors (profiles padded to one length, a block of sequences of one
length bucket); everything within a step is vectorised over profile
position.  The delete chain D[j] = f(M[j-1] + tMD, D[j-1] + tDD) is the one
dependency along j: Viterbi takes it as a cummax of M + tMD minus the
cumulative tDD; Forward as a Hillis-Steele scan of the first-order
log-linear recurrence (combine (a1, b1), (a2, b2) -> (a1 + a2,
logaddexp(b1 + a2, b2)), ceil(log2(L + 1)) steps), which carries the -inf
entries of `*` transitions and padding as they are.  A sequence shorter
than its block is frozen by `alive`, so the graph is the same whatever the
block holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

#: HMMER3 amino-acid column order
HMM_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
_AA_INDEX = {c: i for i, c in enumerate(HMM_ALPHABET)}

#: HMMER default background frequencies (p7_bg, Swiss-Prot derived)
BG_FREQ = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float64)

_NEG = -1e30  # keeps -inf out of the chains where the reference clamps
_BLOCK_SEQS = 64  # sequences a block at most


@dataclass
class ProfileHMM:
    """One parsed HMMER3/f profile (natural-log space, node 0 = begin)."""

    name: str
    acc: str
    length: int
    match_logodds: np.ndarray  # [L+1, 20] f32, row 0 = -inf
    # transitions from node k (ln p): mm mi md im ii dm dd
    trans: np.ndarray          # [L+1, 7] f32
    ga: float = math.nan       # GA gathering cutoff (bits), nan if absent
    stats_vit: tuple = ()      # (tau, lambda) from STATS LOCAL VITERBI
    stats_fwd: tuple = ()      # (tau, lambda) from STATS LOCAL FORWARD
    desc: str = ""


def parse_hmmer3(path: str) -> List[ProfileHMM]:
    """Parse an HMMER3/f text file (one or more profiles)."""
    out = []
    with open(path, "r", errors="replace") as f:
        lines = iter(f)
        while True:
            prof = _parse_one(lines)
            if prof is None:
                return out
            out.append(prof)


def _floats(tokens):
    return [math.inf if t == "*" else float(t) for t in tokens]


def _parse_one(lines):
    name = acc = desc = ""
    ga = math.nan
    stats_vit = ()
    stats_fwd = ()
    length = 0
    header_seen = False
    for ln in lines:
        t = ln.split()
        if not t:
            continue
        if t[0].startswith("HMMER3"):
            header_seen = True
        elif t[0] == "NAME":
            name = t[1]
        elif t[0] == "ACC":
            acc = t[1]
        elif t[0] == "DESC":
            desc = ln[5:].strip()
        elif t[0] == "LENG":
            length = int(t[1])
        elif t[0] == "GA":
            ga = float(t[1])
        elif t[0] == "STATS" and len(t) >= 5 and t[2] == "VITERBI":
            stats_vit = (float(t[3]), float(t[4]))
        elif t[0] == "STATS" and len(t) >= 5 and t[2] == "FORWARD":
            stats_fwd = (float(t[3]), float(t[4]))
        elif t[0] == "HMM":
            break
    else:
        return None
    if not header_seen or length == 0:
        return None
    next(lines)  # the m->m m->i ... transition header line

    L = length
    mat = np.full((L + 1, 20), np.inf, np.float64)  # -ln p
    trans = np.full((L + 1, 7), np.inf, np.float64)
    k = 0  # node about to be read (0 = begin)
    for ln in lines:
        t = ln.split()
        if not t:
            continue
        if t[0] == "//":
            break
        if t[0] == "COMPO":
            continue
        if k == 0:
            # node 0: its insert-emission line (local scoring gives inserts
            # 0) then its transition line
            if len(t) == 20:
                continue
            trans[0] = _floats(t[:7])
            k = 1
            continue
        # node k: match line (led by the node number), insert line (20
        # floats), transition line (7 floats)
        if t[0] == str(k) and len(t) >= 21:
            mat[k] = _floats(t[1:21])
        elif len(t) == 20:
            continue
        elif len(t) == 7:
            trans[k] = _floats(t)
            k += 1
    # -ln p -> log-odds against the background
    lo = np.where(np.isfinite(mat), -mat - np.log(BG_FREQ)[None, :], -np.inf)
    lo[0] = -np.inf
    return ProfileHMM(
        name=name, acc=acc, length=L,
        match_logodds=lo.astype(np.float32),
        trans=(-trans).astype(np.float32),  # ln p (inf -> -inf)
        ga=ga, stats_vit=stats_vit, stats_fwd=stats_fwd, desc=desc,
    )


def _pack_profiles(profiles: Sequence[ProfileHMM]):
    """H profiles padded to one block: (match log-odds [H, Lmax+1, 20],
    transitions [H, Lmax+1, 7], entry t(B->Mk) [H, Lmax+1]), f32 numpy,
    -inf past each profile's length."""
    lmax = max(p.length for p in profiles)
    H = len(profiles)
    msc = np.full((H, lmax + 1, 20), -np.inf, np.float32)
    tr = np.full((H, lmax + 1, 7), -np.inf, np.float32)
    tbm = np.full((H, lmax + 1), -np.inf, np.float32)
    for h, p in enumerate(profiles):
        L = p.length
        msc[h, : L + 1] = p.match_logodds
        tr[h, : L + 1] = p.trans
        k = np.arange(1, L + 1, dtype=np.float64)
        tbm[h, 1 : L + 1] = np.log(2.0 * (L - k + 1) / (L * (L + 1.0)))
    return msc, tr, tbm


def _shift1(a: torch.Tensor) -> torch.Tensor:
    """a[..., j] -> a[..., j-1], -inf at j = 0."""
    return F.pad(a[..., :-1], (1, 0), value=-math.inf)


def _length_model(lens: torch.Tensor, multihit: bool):
    """Per-sequence N/J/C loop, move and null1 (nats, f32), and the E->J,
    E->C transitions."""
    Lf = torch.clamp(lens.to(torch.float32), min=1.0)
    loop = torch.log(Lf / (Lf + 2.0))
    move = torch.log(2.0 / (Lf + 2.0))
    null1 = Lf * torch.log(Lf / (Lf + 1.0)) + torch.log(1.0 / (Lf + 1.0))
    log_ej = math.log(0.5) if multihit else _NEG
    log_ec = math.log(0.5) if multihit else 0.0
    return loop, move, null1, log_ej, log_ec


def _viterbi_block(msc, tr, tbm, seqs, lens, multihit=True):
    """Local Plan7 Viterbi with HMMER3's length model.  msc [H, L+1, 20],
    tr [H, L+1, 7], tbm [H, L+1], seqs [B, T] int64 (pads any residue,
    masked by lens), lens [B].  Returns viterbi - null1 in nats [H, B]."""
    H, Lp1, _ = msc.shape
    B, T = seqs.shape
    dev = msc.device
    tMM, tMI, tMD, tIM, tII, tDM, tDD = tr.unbind(-1)
    # cumulative delete-chain cost c[j] = sum_{l<=j} tDD[l]
    cdd = torch.cumsum(torch.where(torch.isfinite(tDD), tDD, 0.0), dim=1)
    tMMs, tIMs, tDMs = (_shift1(x)[:, None, :] for x in (tMM, tIM, tDM))
    g_off = (tMD - cdd)[:, None, :]
    cdds = _shift1(cdd)[:, None, :]
    tMI_, tII_, tbm_ = tMI[:, None, :], tII[:, None, :], tbm[:, None, :]
    loop, move, null1, log_ej, log_ec = _length_model(lens, multihit)
    em = msc.transpose(1, 2).contiguous()  # [H, 20, L+1]
    alive = torch.arange(T, device=dev)[None, :] < lens[:, None]

    M = torch.full((H, B, Lp1), _NEG, dtype=torch.float32, device=dev)
    I, D = M.clone(), M.clone()
    J = torch.full((H, B), _NEG, dtype=torch.float32, device=dev)
    C = J.clone()
    for t in range(T):
        a = alive[:, t]
        em_x = em[:, seqs[:, t], :]  # [H, B, L+1]
        xN_prev = float(t) * loop  # N after t self-loops
        b_prev = move[None, :] + torch.maximum(xN_prev[None, :], J)
        cand = torch.maximum(
            torch.maximum(_shift1(M) + tMMs, _shift1(I) + tIMs),
            torch.maximum(_shift1(D) + tDMs, tbm_ + b_prev[:, :, None]))
        Mn = torch.clamp(em_x + cand, min=_NEG)
        # D[j] = max_{k<=j-1}(M[k] + tMD[k] - c[k]) + c[j-1]
        Dn = _shift1(torch.cummax(Mn + g_off, dim=2).values) + cdds
        In = torch.maximum(M + tMI_, I + tII_)
        e_i = Mn.amax(2)  # exit t(Mk->E) = 1 (local)
        J = torch.where(a[None, :], torch.maximum(J + loop[None, :], e_i + log_ej), J)
        C = torch.where(a[None, :], torch.maximum(C + loop[None, :], e_i + log_ec), C)
        keep = a[None, :, None]
        M = torch.where(keep, Mn, M)
        I = torch.where(keep, In, I)
        D = torch.where(keep, Dn, D)
    return C + move[None, :] - null1[None, :]


def _scan_levels(a: torch.Tensor) -> list:
    """The multipliers of each doubling step of `_log_linear_scan` for the
    coefficients a (they do not depend on b, so a decoder computes them
    once): [(s, A_s[..., s:])] for s = 1, 2, 4, ... < n, where A_1 = a and
    A_2s[j] = A_s[j - s] + A_s[j] (the first s kept)."""
    n = a.shape[-1]
    levels = []
    s = 1
    while s < n:
        a_hi = a[..., s:]
        levels.append((s, a_hi))
        a = torch.cat([a[..., :s], a[..., :-s] + a_hi], dim=-1)
        s *= 2
    return levels


def _log_linear_scan(levels: list, b: torch.Tensor) -> torch.Tensor:
    """D[j] = logaddexp(b[j], a[j] + D[j-1]) along the last axis (D[-1] =
    -inf): a Hillis-Steele inclusive scan of the combine (a1, b1), (a2, b2)
    -> (a1 + a2, logaddexp(b1 + a2, b2)) in ceil(log2(n)) doubling steps,
    with a's side precomputed by `_scan_levels`."""
    for s, a_hi in levels:
        b = torch.cat([b[..., :s], torch.logaddexp(b[..., :-s] + a_hi, b[..., s:])], dim=-1)
    return b


def _forward_block(msc, tr, tbm, seqs, lens, multihit=True):
    """Local Plan7 Forward: _viterbi_block with max -> logaddexp throughout.
    Returns forward - null1 in nats [H, B]."""
    H, Lp1, _ = msc.shape
    B, T = seqs.shape
    dev = msc.device
    tMM, tMI, tMD, tIM, tII, tDM, tDD = tr.unbind(-1)
    tMMs, tIMs, tDMs = (_shift1(x)[:, None, :] for x in (tMM, tIM, tDM))
    dd_levels = _scan_levels(_shift1(tDD)[:, None, :])  # [H, 1, .] a level
    tMD_, tMI_, tII_, tbm_ = tMD[:, None, :], tMI[:, None, :], tII[:, None, :], tbm[:, None, :]
    loop, move, null1, log_ej, log_ec = _length_model(lens, multihit)
    em = msc.transpose(1, 2).contiguous()
    alive = torch.arange(T, device=dev)[None, :] < lens[:, None]
    lse = torch.logaddexp

    M = torch.full((H, B, Lp1), _NEG, dtype=torch.float32, device=dev)
    I, D = M.clone(), M.clone()
    J = torch.full((H, B), _NEG, dtype=torch.float32, device=dev)
    C = J.clone()
    for t in range(T):
        a = alive[:, t]
        em_x = em[:, seqs[:, t], :]
        xN_prev = float(t) * loop
        b_prev = move[None, :] + lse(xN_prev[None, :], J)
        cand = lse(lse(_shift1(M) + tMMs, _shift1(I) + tIMs),
                   lse(_shift1(D) + tDMs, tbm_ + b_prev[:, :, None]))
        Mn = torch.clamp(em_x + cand, min=_NEG)
        # D[j] = logaddexp(M[j-1] + tMD[j-1], D[j-1] + tDD[j-1])
        Dn = torch.clamp(_log_linear_scan(dd_levels, _shift1(Mn + tMD_)), min=_NEG)
        In = torch.clamp(lse(M + tMI_, I + tII_), min=_NEG)
        # exit t(Mk->E) = 1: E = logsumexp_k M[k]
        mmax = Mn.amax(2)
        e_i = mmax + torch.log(torch.exp(Mn - mmax[:, :, None]).sum(2))
        J = torch.where(a[None, :], lse(J + loop[None, :], e_i + log_ej), J)
        C = torch.where(a[None, :], lse(C + loop[None, :], e_i + log_ec), C)
        keep = a[None, :, None]
        M = torch.where(keep, Mn, M)
        I = torch.where(keep, In, I)
        D = torch.where(keep, Dn, D)
    return C + move[None, :] - null1[None, :]


class HmmSearcher:
    """Batched search of protein sequences against a set of profiles."""

    def __init__(self, profiles: Sequence[ProfileHMM], *, device: torch.device,
                 multihit: bool = True):
        if not profiles:
            raise ValueError("no profiles given")
        self.profiles = list(profiles)
        self.device = device
        self.multihit = multihit  # HMMER3's default; False = uni-local
        self._msc, self._tr, self._tbm = (torch.from_numpy(x).to(device)
                                          for x in _pack_profiles(self.profiles))
        # the last `score` call's blocks and DP cells (sum of H x (Lmax+1) x B x T)
        self.stats = {"blocks": 0, "cells": 0}

    @staticmethod
    def encode(seq: str) -> np.ndarray:
        """aa string -> int32 indices; unknown residues -> 0, scored as A."""
        return np.array([_AA_INDEX.get(c, 0) for c in seq.upper()], np.int32)

    def score(self, seqs: Sequence[np.ndarray], algo: str = "viterbi") -> np.ndarray:
        """Bit scores [n_profiles, n_seqs] by "viterbi" (the optimal
        alignment) or "forward" (the sum over alignments).  Sequences go in
        blocks of at most 64 of one power-of-two length bucket (at least
        16), sorted by length, the block padded to at least 8 rows."""
        block_fn = {"viterbi": _viterbi_block, "forward": _forward_block}[algo]
        B = len(seqs)
        lens = np.array([len(s) for s in seqs], np.int32)
        out = np.empty((len(self.profiles), B), np.float32)
        order = np.argsort(lens, kind="stable")
        H, Lp1 = self._msc.shape[:2]
        self.stats = {"blocks": 0, "cells": 0}
        pos = 0
        while pos < B:
            t = max(int(lens[order[pos]]), 16)
            tpad = 1 << (t - 1).bit_length()
            take = [i for i in order[pos:] if lens[i] <= tpad][:_BLOCK_SEQS]
            pos += len(take)
            bb = len(take)
            bpad = 1 << max((bb - 1).bit_length(), 3)
            block = np.zeros((bpad, tpad), np.int64)
            for r, i in enumerate(take):
                block[r, : lens[i]] = seqs[i]
            ln = np.zeros(bpad, np.int32)
            ln[:bb] = lens[np.asarray(take)]
            nats = block_fn(self._msc, self._tr, self._tbm,
                            torch.from_numpy(block).to(self.device),
                            torch.from_numpy(ln).to(self.device), multihit=self.multihit)
            out[:, np.asarray(take)] = nats[:, :bb].cpu().numpy()
            self.stats["blocks"] += 1
            self.stats["cells"] += H * Lp1 * bpad * tpad
        return out / np.float32(math.log(2.0))  # nats -> bits

    def evalues(self, bits: np.ndarray, n_targets: int, algo: str = "viterbi") -> np.ndarray:
        """Tail E-values from each profile's calibration: Gumbel for Viterbi,
        exponential (capped at P = 1) for Forward; nan without a STATS line."""
        ev = np.full_like(bits, np.nan, dtype=np.float64)
        for h, p in enumerate(self.profiles):
            stats = p.stats_fwd if algo == "forward" else p.stats_vit
            if stats:
                tau, lam = stats
                pv = np.exp(-lam * (bits[h].astype(np.float64) - tau))
                if algo == "forward":
                    pv = np.minimum(pv, 1.0)
                ev[h] = n_targets * pv
        return ev
