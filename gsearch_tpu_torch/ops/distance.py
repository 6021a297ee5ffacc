"""Sketch distance: the Hamming fraction over signature vectors.

Counterpart of gsearch_tpu/ops/distance.py.  Slots are compared as 32-bit
patterns (f32 and u32 signatures through an int32 view, u16 registers
widened by value; equality needs no unsigned arithmetic) and distance = 1 - eq / S in f32, the formula of the reference's
`hamming_frac_xla` and of its Pallas kernel's finish.

Two kernels, each a wrapper beside its plain torch version:
  - `hamming_frac` (K1): [Q, S] x [N, S] -> [Q, N], or a batch of such
    problems [B, Q, S] x [B, N, S] -> [B, Q, N]; `hamming_frac_self`, its
    self-pair form x [B, C, S] against itself -> [B, C, C], computes only
    the tiles on and above the diagonal.  `k1_plan` picks K1's tile and
    S split from the shape;
  - `gather_hamming` (K2): distances of Qc queries to R database rows
    picked by id, [Qc, R], over rows of raw 32-bit slots (`parts=1`) or of
    packed 16-, 8- or 4-bit slot hashes (`parts=2, 4, 8`: the graph index's
    rerank tiers and the compact searcher, ops/mxu.py).  Two forms:
    query-major (a warp a pair, a row read for every query that lists it;
    small launches cut a pair's lanes over several warps) and row-grouped
    (the pairs grouped by row id on the card, each listed row's segment
    read once and compared with every query that lists it).  `k2_plan`
    picks the form from the shape: row-grouped past one wave of pairs
    where evenly spread ids would repeat rows; the bound of both is the
    bytes of the rows the ids reference, each read once.
A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel of csrc/hamming.cu (see the notes there) or raises.

Top-k follows `jax.lax.top_k`'s order: ascending distance, ties by lower
index, through a stable sort.  The reference's power-of-two Q/N buckets
existed to reuse remote XLA compiles and are not ported; `bucketed_knn`
keeps their semantics (rows past `n_valid` are +inf).
"""

from __future__ import annotations

import functools
import threading
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch

from . import cuda_lib

# bound on the bool compare buffer of the plain versions (elements)
_PLAIN_ELEMS = 1 << 26


def _distance(eq: torch.Tensor, s: int) -> torch.Tensor:
    """1 - eq / S in f32.  The divisor is a 0-dim tensor on eq's device:
    CUDA torch turns division by a Python scalar into multiplication by its
    reciprocal, which can differ from IEEE division by one ulp."""
    return 1.0 - eq.to(torch.float32) / torch.tensor(float(s), dtype=torch.float32, device=eq.device)


def sig_bits(sigs: np.ndarray) -> np.ndarray:
    """Host signature rows (numpy f32, i32, u32 or u16) as int32 bit
    patterns, the form both kernels compare.  32-bit types are viewed (no
    copy, no value conversion: u32 signatures hold arbitrary patterns, NaN
    payloads and -0.0 among them); u16 registers are widened by value
    (zero-extended, a copy), as the reference widens them for its kernel."""
    if sigs.dtype == np.uint16:
        return sigs.astype(np.uint32).view(np.int32)
    if sigs.dtype not in (np.float32, np.uint32, np.int32):
        raise TypeError(f"unsupported signature dtype {sigs.dtype}: "
                        "expected float32, int32, uint32 or uint16")
    return sigs.view(np.int32)


def as_int32_rows(sigs: np.ndarray) -> torch.Tensor:
    """`sig_bits` of host rows (f32, i32, u32 or u16) as a contiguous int32
    tensor."""
    return torch.from_numpy(np.ascontiguousarray(sig_bits(sigs)))


def _as_i32(x: torch.Tensor, what: str) -> torch.Tensor:
    """Signature rows as int32 bit patterns: f32 and u32 viewed, u16
    widened by value."""
    if x.dtype == torch.int32:
        return x
    if x.dtype in (torch.float32, torch.uint32):
        return x.view(torch.int32)
    if x.dtype == torch.uint16:
        return x.to(torch.int32)
    raise TypeError(f"{what}: signatures must be float32, int32, uint32 or uint16, got {x.dtype}")


def _check_rows(q: torch.Tensor, db: torch.Tensor) -> int:
    if q.dim() not in (2, 3) or db.dim() != q.dim():
        raise ValueError(f"expected 2-D or batched 3-D signatures, got {tuple(q.shape)} and {tuple(db.shape)}")
    if q.dtype != db.dtype:
        raise TypeError(f"dtype mismatch {q.dtype} vs {db.dtype}")
    if q.device != db.device:
        raise ValueError(f"device mismatch {q.device} vs {db.device}")
    if q.dim() == 3 and q.shape[0] != db.shape[0]:
        raise ValueError(f"batch sizes differ: {q.shape[0]} vs {db.shape[0]}")
    s = q.shape[-1]
    if db.shape[-1] != s or s == 0:
        raise ValueError(f"sketch sizes differ or are empty: {q.shape[-1]} vs {db.shape[-1]}")
    return s


def _cuda_args(*tensors: torch.Tensor, what: str) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    for dim in (d for t in tensors for d in t.shape):
        if dim >= 1 << 31:
            raise ValueError(f"{what}: a dimension exceeds int32")


# ---- K1: all-pairs equal-count distance -------------------------------------

#: K1's tiles, in the order of csrc/hamming.cu's `tile` argument: (queries,
#: rows, blocks resident on an SM, which the tile's ring of shared memory
#: sets: 64 KB, 102 KB and 99 KB of the SM's 227 KB).  The square wide tile
#: serves large shapes and self pairs, the narrow ones request shapes.
K1_TILES = {"wide": (64, 64, 3), "narrow16": (16, 256, 2), "narrow8": (8, 256, 2)}
#: slots a shared-memory chunk holds; a split covers whole chunks
K1_CHUNK = 32
#: cost of staging one slot of one row, in slot compares
K1_STAGE_COST = 8
_GRID_X, _GRID_YZ = (1 << 31) - 1, 65535


class K1Plan(NamedTuple):
    """One K1 launch: the tile, how many output tiles there are along the
    queries (`qtiles`) and in all (`tiles`, a batch member's), and the S
    split (`span` slots a split, `splits` blocks a tile)."""
    tile: str
    qtiles: int
    tiles: int
    span: int
    splits: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def k1_plan(batch: int, nq: int, n: int, s: int, sms: int, pairs: bool = False,
            tile: str | None = None) -> K1Plan:
    """K1's launch for a shape, a pure function of (batch, Q, N, S, the
    card's SM count, self pairs).  For each tile and S split it estimates
    the time as waves x chunks a block x the cost of a chunk (compares plus
    K1_STAGE_COST x staged slots, times the blocks sharing an SM), where a
    wave is SMs x resident blocks and a split block pays one chunk more
    for its atomic epilogue; it takes the least (ties: the fewer splits).
    Self pairs need the square wide tile.  `tile` forces a tile (tests)."""
    if pairs and nq != n:
        raise ValueError("self pairs need Q == N")
    names = ["wide"] if pairs else list(K1_TILES)
    if tile is not None:
        if tile not in names:
            raise ValueError(f"tile {tile!r} not among {names}")
        names = [tile]
    chunks = _cdiv(s, K1_CHUNK)
    best = None
    for name in names:
        tq, tn, resident = K1_TILES[name]
        qtiles, ntiles = _cdiv(nq, tq), _cdiv(n, tn)
        tiles = ntiles * (ntiles + 1) // 2 if pairs else qtiles * ntiles
        chunk_cost = (tq * tn + K1_STAGE_COST * (tq + tn)) * resident
        wave = sms * resident
        for splits in range(1, min(chunks, _GRID_YZ) + 1):
            span_chunks = _cdiv(chunks, splits)
            splits = _cdiv(chunks, span_chunks)
            est = (_cdiv(batch * tiles * splits, wave) * (span_chunks + (splits > 1))
                   * chunk_cost)
            if best is None or est < best[0]:
                best = (est, K1Plan(name, qtiles, tiles, span_chunks * K1_CHUNK, splits))
    plan = best[1]
    if plan.tiles > _GRID_X or batch > _GRID_YZ:
        raise ValueError(f"hamming_frac: {batch} x {nq} x {n} needs a grid past the "
                         f"card's limits ({plan})")
    return plan


def k1_tiles(plan: K1Plan, pairs: bool = False) -> Iterator[Tuple[int, int, bool]]:
    """(first query, first row, mirrored) of each output tile of a batch
    member, in blockIdx.x order: csrc/hamming.cu's enumeration."""
    tq, tn, _ = K1_TILES[plan.tile]
    for x in range(plan.tiles):
        if pairs:
            nt = int((np.sqrt(8.0 * x + 1.0) - 1.0) * 0.5)
            while nt * (nt + 1) // 2 > x:
                nt -= 1
            while (nt + 1) * (nt + 2) // 2 <= x:
                nt += 1
            qt = x - nt * (nt + 1) // 2
        else:
            qt, nt = x % plan.qtiles, x // plan.qtiles
        yield qt * tq, nt * tn, pairs and qt != nt


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# workspaces by (device, stream), grown, never shrunk: K1's split counts and
# tickets, which the kernel finds zero and leaves zero (csrc/hamming.cu),
# and K2's row-grouped (zeroed, scratch) pair
_workspace: dict = {}
_k2_ws: dict = {}
_workspace_lock = threading.Lock()


def _k1_workspace(device: torch.device, stream: int, counts: int, tickets: int):
    key = (device.index, stream)
    with _workspace_lock:
        have = _workspace.get(key)
        if have is None or have[0].numel() < counts or have[1].numel() < tickets:
            old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
            have = (torch.zeros(max(counts, old[0]), dtype=torch.int32, device=device),
                    torch.zeros(max(tickets, old[1]), dtype=torch.int32, device=device))
            _workspace[key] = have
        return have


def hamming_frac_plain(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain torch K1: [Q, S] x [N, S] -> [Q, N] f32 (batched: [B, Q, N])."""
    s = _check_rows(q, db)
    qi, di = _as_i32(q, "hamming_frac"), _as_i32(db, "hamming_frac")
    if qi.dim() == 2:
        return hamming_frac_plain(qi[None], di[None])[0]
    nb, nq, n = qi.shape[0], qi.shape[1], di.shape[1]
    eq = torch.empty((nb, nq, n), dtype=torch.int32, device=q.device)
    chunk = max(1, _PLAIN_ELEMS // max(1, nb * nq * s))
    for start in range(0, n, chunk):
        part = di[:, start : start + chunk]
        eq[:, :, start : start + chunk] = (qi[:, :, None, :] == part[:, None, :, :]).sum(-1, dtype=torch.int32)
    return _distance(eq, s)


def hamming_frac_self_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch self-pair K1: x [C, S] or [B, C, S] against itself ->
    [C, C] or [B, C, C]; the diagonal is 1 - S/S = 0.0."""
    return hamming_frac_plain(x, x)


def _k1(q: torch.Tensor, db: torch.Tensor, pairs: bool, tile: str | None) -> torch.Tensor:
    _cuda_args(q, db, what="hamming_frac")
    qi, di = _as_i32(q, "hamming_frac"), _as_i32(db, "hamming_frac")
    batch = qi.shape[0] if qi.dim() == 3 else 1
    nq, n, s = qi.shape[-2], di.shape[-2], qi.shape[-1]
    out = torch.empty(qi.shape[:-1] + (n,), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    plan = k1_plan(batch, nq, n, s, _sm_count(q.device.index), pairs=pairs, tile=tile)
    stream = cuda_lib.current_stream(q.device)
    counts = tickets = 0
    if plan.splits > 1:
        ws = _k1_workspace(q.device, stream, batch * nq * n, batch * plan.tiles)
        counts, tickets = ws[0].data_ptr(), ws[1].data_ptr()
    lib = cuda_lib.load()
    rc = lib.gs_hamming_frac(
        qi.data_ptr(), di.data_ptr(), out.data_ptr(), counts, tickets, batch, nq, n, s,
        list(K1_TILES).index(plan.tile), plan.span, int(pairs), q.device.index, stream)
    cuda_lib.check(lib, rc, "gs_hamming_frac")
    cuda_lib.launches["hamming_frac_self" if pairs else "hamming_frac"] += 1
    return out


def hamming_frac(q: torch.Tensor, db: torch.Tensor, *, tile: str | None = None) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU ones.  `tile` forces one of K1_TILES (tests; default: k1_plan's)."""
    _check_rows(q, db)
    if q.device.type == "cpu":
        return hamming_frac_plain(q, db)
    return _k1(q, db, False, tile)


def hamming_frac_self(x: torch.Tensor) -> torch.Tensor:
    """Self-pair K1 wrapper: x [C, S] or [B, C, S] against itself, only the
    tiles on and above the diagonal computed (the kernel mirrors them).
    The CUDA kernel for a CUDA tensor, the plain version for a CPU one;
    launches count under hamming_frac_self."""
    _check_rows(x, x)
    if x.device.type == "cpu":
        return hamming_frac_self_plain(x)
    return _k1(x, x, True, None)


# ---- K2: distances to candidate rows picked by id ----------------------------

_PARTS = {1: "gather_hamming", 2: "gather_hamming_p2", 4: "gather_hamming_p4",
          8: "gather_hamming_p8"}


def _check_gather(db: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, parts: int,
                  s_true: int | None) -> int:
    lanes = _check_rows(q, db)
    if q.dim() != 2:
        raise ValueError(f"gather_hamming takes 2-D rows, got {tuple(q.shape)}")
    if ids.dim() != 2 or ids.shape[0] != q.shape[0]:
        raise ValueError(f"ids must be [Qc, R] with Qc={q.shape[0]}, got {tuple(ids.shape)}")
    if ids.device != q.device:
        raise ValueError(f"device mismatch {ids.device} vs {q.device}")
    if parts not in _PARTS:
        raise ValueError(f"parts must be one of {sorted(_PARTS)}, got {parts}")
    s_true = lanes * parts if s_true is None else int(s_true)
    if not 0 < s_true <= lanes * parts:
        raise ValueError(f"s_true={s_true} outside (0, {lanes * parts}]")
    return s_true


def _eq_fields(x: torch.Tensor, parts: int) -> torch.Tensor:
    """Equal fields of int32 lanes, summed over the last axis: x = a ^ b is
    zero in a field iff the field is equal.  Halves and bytes are read
    through an int16 / int8 view of the lanes; nibbles through a uint8 view
    (no shift of a signed type, whose `>>` is arithmetic)."""
    if parts == 1:
        return (x == 0).sum(-1, dtype=torch.int32)
    if parts == 2:
        return (x.view(torch.int16) == 0).sum(-1, dtype=torch.int32)
    if parts == 4:
        return (x.view(torch.int8) == 0).sum(-1, dtype=torch.int32)
    b = x.view(torch.uint8)
    return ((b & 0xF) == 0).sum(-1, dtype=torch.int32) + ((b >> 4) == 0).sum(-1, dtype=torch.int32)


def gather_hamming_plain(db: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, *,
                         parts: int = 1, s_true: int | None = None) -> torch.Tensor:
    """Plain torch K2: 1 - eq / s_true of q_i against db[ids[i, j]] as
    [Qc, R] f32, eq the equal fields of the lanes (`parts` a lane), +inf
    for ids outside [0, N).  s_true defaults to lanes * parts."""
    s_true = _check_gather(db, q, ids, parts, s_true)
    di, qi = _as_i32(db, "gather_hamming"), _as_i32(q, "gather_hamming")
    ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < di.shape[0])
    safe = torch.where(ok, ids, 0)
    eq = torch.empty(ids.shape, dtype=torch.int32, device=q.device)
    chunk = max(1, _PLAIN_ELEMS // max(1, ids.shape[1] * qi.shape[1]))
    for start in range(0, ids.shape[0], chunk):
        rows = di[safe[start : start + chunk]]  # [c, R, L]
        eq[start : start + chunk] = _eq_fields(rows ^ qi[start : start + chunk, None, :], parts)
    return torch.where(ok, _distance(eq, s_true), torch.inf)


#: K2's forms, in the order of csrc/hamming.cu's `form` argument
K2_FORMS = ("query", "row")
#: the row-grouped form (csrc/hamming.cu): lanes a segment, pairs a warp's
#: run, rows a scan block's tile
K2_SEG, K2_RUN, K2_SCAN_TILE = 1024, 32, 4096
#: the row-grouped form is taken where a launch holds at least one wave of
#: warps' pairs (SMs x K2_WAVE_PAIRS) and its pairs are expected to list
#: each referenced row at least K2_REPEAT times
K2_WAVE_PAIRS, K2_REPEAT = 64, 1.25


class K2Plan(NamedTuple):
    """One K2 launch: the form, the rows its ids are expected to reference
    were they spread evenly over the N rows, and the spans the query-major
    form cuts a pair's lanes into."""
    form: str
    unique: float
    splits: int


@functools.lru_cache(maxsize=4096)
def k2_plan(qc: int, r: int, n: int, lanes: int, sms: int, form: str | None = None) -> K2Plan:
    """K2's form for a shape, a pure function of (Qc, R, N, lanes, the
    card's SM count).  The query-major form reads a row for every pair;
    the row-grouped form reads each referenced row once, N * (1 - (1 -
    1/N)^pairs) of them for ids spread evenly, and pays four grouping
    launches.  A launch with fewer pairs than one wave of warps (SMs x
    K2_WAVE_PAIRS) stays query-major, its time being latency, and cuts each
    pair's lanes into spans of at least K2_SEG lanes, enough to fill the
    wave; so does a launch whose rows would repeat less than K2_REPEAT
    times.  `form` forces one of K2_FORMS (tests, chip_smoke)."""
    if form is not None and form not in K2_FORMS:
        raise ValueError(f"form {form!r} not among {K2_FORMS}")
    pairs = qc * r
    wave = sms * K2_WAVE_PAIRS
    unique = min(float(pairs), float(n * -np.expm1(pairs * np.log1p(-1.0 / n))) if n > 1 else 1.0)
    if form is None:
        form = "row" if pairs >= wave and pairs >= K2_REPEAT * unique else "query"
    splits = 1
    if form == "query" and pairs < wave:
        splits = max(1, min(_cdiv(wave, pairs), _cdiv(lanes, K2_SEG), _GRID_YZ))
    return K2Plan(form, unique, splits)


def _k2_workspace(device: torch.device, stream: int, zeroed: int, scratch: int):
    """K2's int32 workspaces (the row-grouped form's, or a query-major
    launch's with split lanes): `zeroed` entries that the kernels find
    zero and leave zero, and `scratch` of any content."""
    key = (device.index, stream)
    with _workspace_lock:
        have = _k2_ws.get(key)
        if have is None or have[0].numel() < zeroed or have[1].numel() < scratch:
            old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
            have = (torch.zeros(max(zeroed, old[0]), dtype=torch.int32, device=device),
                    torch.empty(max(scratch, old[1]), dtype=torch.int32, device=device))
            _k2_ws[key] = have
        return have


def gather_hamming(db: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, *,
                   parts: int = 1, s_true: int | None = None, form: str | None = None) -> torch.Tensor:
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU ones (whatever the form).  db [N, L] and q [Qc, L] f32 or int32
    lanes, ids [Qc, R] int32.  `form` forces one of K2_FORMS (tests,
    chip_smoke; default: k2_plan's).  Launches count under gather_hamming
    (parts=1) or gather_hamming_p{parts}."""
    s_true = _check_gather(db, q, ids, parts, s_true)
    if form is not None and form not in K2_FORMS:
        raise ValueError(f"form {form!r} not among {K2_FORMS}")
    if q.device.type == "cpu":
        return gather_hamming_plain(db, q, ids, parts=parts, s_true=s_true)
    _cuda_args(db, q, ids, what="gather_hamming")
    if ids.dtype != torch.int32:
        raise TypeError(f"gather_hamming: ids must be int32, got {ids.dtype}")
    di, qi = _as_i32(db, "gather_hamming"), _as_i32(q, "gather_hamming")
    out = torch.empty(ids.shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    n, lanes = di.shape
    (qc, r), pairs = ids.shape, ids.numel()
    if pairs >= 1 << 30:
        raise ValueError(f"gather_hamming: {qc} x {r} pairs pass the kernel's 2^30 limit")
    plan = k2_plan(qc, r, n, lanes, _sm_count(q.device.index), form=form)
    stream = cuda_lib.current_stream(q.device)
    zeroed = scratch = 0
    if plan.form == "row":
        ws = _k2_workspace(q.device, stream, n + pairs + _cdiv(pairs, K2_RUN),
                           2 * pairs + 4 + _cdiv(n, K2_SCAN_TILE))
        zeroed, scratch = ws[0].data_ptr(), ws[1].data_ptr()
    elif plan.splits > 1:
        zeroed = _k2_workspace(q.device, stream, 2 * pairs, 0)[0].data_ptr()
    lib = cuda_lib.load()
    rc = lib.gs_gather_hamming(
        di.data_ptr(), qi.data_ptr(), ids.data_ptr(), out.data_ptr(), n, lanes, s_true, parts, qc, r,
        K2_FORMS.index(plan.form), plan.splits, zeroed, scratch, q.device.index, stream)
    cuda_lib.check(lib, rc, "gs_gather_hamming")
    cuda_lib.launches[_PARTS[parts]] += 1
    return out


# ---- exact k-NN ----------------------------------------------------------------

def topk_smallest(d: torch.Tensor, k: int):
    """The k smallest per row in jax.lax.top_k(-d) order (ties: lower index)."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def brute_force_knn(q: torch.Tensor, db: torch.Tensor, knbn: int):
    """Exact top-k by sketch distance: (distances [Q, k], ids [Q, k])."""
    return topk_smallest(hamming_frac(q, db), min(knbn, db.shape[0]))


def bucketed_knn(q: torch.Tensor, db: torch.Tensor, knbn: int, n_valid: int | None = None):
    """Exact top-k over the first `n_valid` rows of db (rows past it are
    +inf, never returned); numpy (distances [Q, k], int32 ids [Q, k])."""
    n = db.shape[0] if n_valid is None else n_valid
    d = hamming_frac(q, db)
    if n < db.shape[0]:
        d[:, n:] = torch.inf
    dist, ids = topk_smallest(d, min(knbn, n))
    return dist.cpu().numpy(), ids.to(torch.int32).cpu().numpy()
