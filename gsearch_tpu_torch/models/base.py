"""Sketcher base: genome code rows -> dart races -> signatures, on one device
or split over the members of a mesh (`set_mesh`, parallel/mesh.py).

Counterpart of gsearch_tpu/models/base.py.  A genome is cut into rows:
one row padded to its block bucket (`block_length`) when it fits the
largest block, otherwise pieces of the largest block that overlap so no
k-window is lost.  Rows of one block length are raced together in launch
groups of at most BATCH_ELEMS bases, each genome's pieces are merged with
`combine_race`, and the merged races are finalized (densified) on the
device.  `sketch_submit` only enqueues device work; `sketch_finish` copies
the signatures back.

The port cuts genomes into exactly the rows the reference races (the
packed race's windowed pre-reduce and ProbMinHash's per-piece
multiplicities depend on the row partition):
  - a genome of n <= max block symbols is one row of block_length(n);
  - a longer genome is cut at starts 0, step, 2*step, ... with
    step = max_block - (k - 1), rounded down to a multiple of 4 when a DNA
    genome arrives as PackedCodes (the reference slices the 2-bit form at
    byte boundaries) and the sketcher is not MULTIPLICITY_SENSITIVE: such
    a sketcher (ProbMinHash) unpacks first and cuts at exactly k - 1
    overlap, since a duplicated boundary window would count twice;
  - the rows are max_block long, unless some DNA piece holds more than
    _MAX_EXC invalid positions: then the reference takes its per-piece
    fallback and every row is padded to its own block bucket (amino-acid
    rows travel raw in the reference and never take it).
Rows always travel as uint8 codes; the reference's 2-bit exception and
bit-plane forms existed for its host-device relay.

Integer-only sketchers (OptDens, RevOptDens, SuperMinHash, SuperMinHash2,
HyperMinHash, FracMinHash) are bit-exact with gsearch_tpu.  ProbMinHash
and SetSketch take an f32 logarithm, which differs by an ulp between back
ends (ops/hash.py `log_f32`): their signatures agree with gsearch_tpu's
in all but a few slots in ten thousand.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.params import DataType, SeqSketcherParams, SketchAlgo
from ..io.codec import PackedCodes
from ..ops.hash import mix32
from ..ops.kmer import AA_BITS, canonical_dna_windows, kmer_windows
from ..ops.race import (RaceResult, bucket_min, bucket_min_packed, bucket_min_packed_payload,
                        combine_race, sketch_fingerprint)
from ..utils import trace

_MIN_BLOCK_LOG2 = 14
_MAX_BLOCK_LOG2 = 22
_BLOCK_STEP_LOG2 = 1

#: symbols raced in one launch group (rows x block length).  One budget for
#: CUDA: a group's temporaries are a dozen or so int64 arrays of this many
#: elements (times the darts a window: 3 for ProbMinHash, whose group of
#: four 2^23 rows holds ~12 x 3 x 2^25 x 8 = 9.7 GB), a small share of an
#: 80 GB card, and each elementwise launch still covers 32M elements.
BATCH_ELEMS = 1 << 25

#: invalid positions a piece may hold in the reference's exception upload
#: form; beyond it the reference falls back to per-piece rows (see above)
_MAX_EXC = 1024


def block_length(n: int, max_log2: int = _MAX_BLOCK_LOG2) -> int:
    """Smallest block bucket >= n: powers of two plus 1.5x midpoints
    (3*2^(k-1)), capped at 2^max_log2."""
    cap = 1 << max_log2
    nb = 1 << _MIN_BLOCK_LOG2
    while nb < n and nb < cap:
        mid = nb + (nb >> 1)
        if n <= mid and mid <= cap:
            return mid
        nb <<= _BLOCK_STEP_LOG2
    return min(nb, cap)


class SketchTicket:
    """Handle of an asynchronous sketch_submit: the device signatures
    [rows, S] that land in `out` at sketch_finish."""

    __slots__ = ("out", "sigs")

    def __init__(self, out: np.ndarray):
        self.out = out
        self.sigs: torch.Tensor | None = None


def _as_codes(codes) -> np.ndarray:
    if isinstance(codes, PackedCodes):
        return codes.to_codes()
    return np.asarray(codes, dtype=np.uint8)


class SketcherBase:
    """Shared machinery; subclasses define the darts and the finalize."""

    SIG_DTYPE = np.float32
    # payload-free algorithms race on packed (key | slot) words;
    # payload-carrying ones can opt into the quantized packed-payload race
    USE_PACKED_RACE = False
    USE_PACKED_PAYLOAD_RACE = False
    # True when the sketch depends on k-mer multiplicity (ProbMinHash): a
    # long PackedCodes genome is then unpacked and cut with no 4-alignment
    MULTIPLICITY_SENSITIVE = False
    # longest contiguous row before a genome is cut into pieces
    MAX_BLOCK_LOG2 = _MAX_BLOCK_LOG2

    def __init__(self, params: SeqSketcherParams, seed: int = 0x5EED, *,
                 device: torch.device):
        self.params = params
        self.k = params.kmer_size
        self.nb_slots = params.sketch_size
        self.seed = seed
        self.device = torch.device(device)
        self.is_aa = params.data_t == DataType.AA
        if self.is_aa and params.kmer_size > 12:
            raise ValueError("AA kmer_size must be <= 12 (reference: aasketch.rs:464)")
        self.mesh = None  # parallel/mesh.DeviceMesh: rows split over its members

    def set_mesh(self, mesh) -> None:
        """Data-parallel sketching over this process's mesh members: each
        launch group's rows, padded with empty rows to a multiple of the
        member count, are split evenly over the members, raced on each
        member's device and gathered back in row order onto the sketcher's
        device, where pieces merge and signatures finalize.  Rows race
        independently, so the signatures equal those without a mesh."""
        self.mesh = mesh

    # ---- subclass interface -------------------------------------------------

    def _darts(self, hi, lo, valid):
        """(hi, lo, valid) windows -> (slots, keys, payload, dart_valid)."""
        raise NotImplementedError

    def _finalize_race(self, race: RaceResult) -> torch.Tensor:
        """RaceResult [..., S] -> signatures [..., S]."""
        raise NotImplementedError

    def _filler(self, race: RaceResult, seed: int) -> torch.Tensor:
        """u32 values for empty slots that depend on the genome (its least
        key) and the slot, so two sparse genomes never agree on slots both
        left empty; `seed` is the algorithm's."""
        idx = torch.arange(self.nb_slots, dtype=torch.int64, device=race.key.device)
        return mix32(idx ^ sketch_fingerprint(race), self.seed ^ seed)

    # ---- device work ----------------------------------------------------------

    def _windows(self, codes: torch.Tensor):
        if self.is_aa:
            return kmer_windows(codes, self.k, AA_BITS)
        return canonical_dna_windows(codes, self.k)

    def _race(self, slots, keys, payload, dvalid) -> RaceResult:
        if self.USE_PACKED_RACE and payload is None:
            return bucket_min_packed(slots, keys, self.nb_slots, valid=dvalid)
        if self.USE_PACKED_PAYLOAD_RACE and payload is not None:
            return bucket_min_packed_payload(slots, keys, payload, self.nb_slots, valid=dvalid)
        return bucket_min(slots, keys, self.nb_slots, payload=payload, valid=dvalid)

    def _race_rows(self, codes: torch.Tensor) -> RaceResult:
        """uint8 code rows [b, nb] on the device -> one race per row."""
        hi, lo, valid = self._windows(codes)
        return self._race(*self._darts(hi, lo, valid))

    def _race_group(self, arr: np.ndarray) -> RaceResult:
        """One launch group's code rows [b, nb] -> their races on the
        sketcher's device; with a mesh, raced split over its members."""
        if self.mesh is None:
            with trace.span("sketch.upload", self.device):
                codes = torch.from_numpy(arr).to(self.device)
            with trace.span("sketch.race", self.device):
                return self._race_rows(codes)
        devs = self.mesh.devices
        per = -(-arr.shape[0] // len(devs))
        padded = np.full((per * len(devs), arr.shape[1]), 255, dtype=np.uint8)
        padded[: arr.shape[0]] = arr
        # the members' uploads and races, timed on the sketcher's device
        with trace.span("sketch.race", self.device):
            parts = [self._race_rows(torch.from_numpy(padded[j * per : (j + 1) * per]).to(dev))
                     for j, dev in enumerate(devs)]
            return RaceResult(*(torch.cat([p[f].to(self.device) for p in parts])[: arr.shape[0]]
                                for f in range(3)))

    def _pieces(self, codes) -> List[Tuple[np.ndarray, int]]:
        """The reference's row partition of one genome: [(codes, row length)]."""
        max_block = 1 << self.MAX_BLOCK_LOG2
        n = len(codes)
        if n <= max_block:
            return [(_as_codes(codes), block_length(n, self.MAX_BLOCK_LOG2))]
        step = max_block - (self.k - 1)
        if self.is_aa or self.MULTIPLICITY_SENSITIVE:
            codes = _as_codes(codes)
        if self.is_aa:
            return [(codes[st : st + max_block], max_block) for st in range(0, n, step)]
        if isinstance(codes, PackedCodes):
            step -= step % 4
            packed = [codes.piece(st, max_block) for st in range(0, n, step)]
            heavy = any(p.inv.size > _MAX_EXC for p in packed)
            pieces = [p.to_codes() for p in packed]
        else:
            codes = np.asarray(codes, dtype=np.uint8)
            pieces = [codes[st : st + max_block] for st in range(0, n, step)]
            heavy = any(int(np.count_nonzero(p >= 4)) > _MAX_EXC for p in pieces)
        if heavy:
            return [(p, block_length(len(p), self.MAX_BLOCK_LOG2)) for p in pieces]
        return [(p, max_block) for p in pieces]

    # ---- public API ----------------------------------------------------------

    def sketch_codes(self, codes) -> np.ndarray:
        """One genome (uint8 codes or PackedCodes) -> one signature [nb_slots]."""
        return self.sketch_many([codes])[0]

    def sketch_many(self, codes_list: Sequence) -> np.ndarray:
        """Signatures for a list of genomes, stacked [B, nb_slots]."""
        return self.sketch_finish(self.sketch_submit(codes_list))

    def sketch_submit(self, codes_list: Sequence) -> SketchTicket:
        """Enqueue the device work for a list of genomes.  On CUDA the
        kernels run asynchronously on the current stream, but each row
        group is uploaded from pageable host memory, a copy the host waits
        for: the call returns after the last upload, not at once."""
        with trace.span("sketch.submit"):
            return self._submit(codes_list)

    def _submit(self, codes_list: Sequence) -> SketchTicket:
        ticket = SketchTicket(np.empty((len(codes_list), self.nb_slots), dtype=self.SIG_DTYPE))
        if not codes_list:
            return ticket
        rows: List[Tuple[np.ndarray, int]] = []
        first = []  # each genome's pieces are contiguous rows from here
        with trace.span("sketch.pieces"):
            for codes in codes_list:
                first.append(len(rows))
                rows.extend(self._pieces(codes))

        dev, s = self.device, self.nb_slots
        found = torch.empty((len(rows), s), dtype=torch.bool, device=dev)
        key = torch.empty((len(rows), s), dtype=torch.int64, device=dev)
        payload = torch.empty_like(key)
        by_len: dict = {}
        for r, (_, nb) in enumerate(rows):
            by_len.setdefault(nb, []).append(r)
        groups = upload_bytes = 0
        for nb, rids in by_len.items():
            bcap = max(1, BATCH_ELEMS // nb)
            for start in range(0, len(rids), bcap):
                chunk = rids[start : start + bcap]
                with trace.span("sketch.fill"):
                    arr = np.full((len(chunk), nb), 255, dtype=np.uint8)
                    for row, r in enumerate(chunk):
                        piece = rows[r][0]
                        arr[row, : len(piece)] = piece
                race = self._race_group(arr)
                with trace.span("sketch.upload", dev):
                    idx = torch.tensor(chunk, dtype=torch.int64, device=dev)
                found[idx], key[idx], payload[idx] = race
                groups += 1
                upload_bytes += arr.nbytes + 8 * len(chunk)

        with trace.span("sketch.merge", dev):
            # merge each genome's pieces in order (the reference's segment reduce)
            counts = np.diff(np.array(first + [len(rows)]))
            first_t = torch.tensor(first, dtype=torch.int64, device=dev)
            acc = RaceResult(found[first_t], key[first_t], payload[first_t])
            for j in range(1, int(counts.max())):
                g = torch.from_numpy(np.nonzero(counts > j)[0]).to(dev)
                r = first_t[g] + j
                merged = combine_race(RaceResult(acc.found[g], acc.key[g], acc.payload[g]),
                                      RaceResult(found[r], key[r], payload[r]))
                acc.found[g], acc.key[g], acc.payload[g] = merged
            ticket.sigs = _host_form(self._finalize_race(acc), np.dtype(self.SIG_DTYPE))
        trace.count("sketch.genomes", len(codes_list))
        trace.count("sketch.rows", len(rows))
        trace.count("sketch.groups", groups)
        trace.count("sketch.upload_bytes", upload_bytes)
        return ticket

    def sketch_finish(self, ticket: SketchTicket) -> np.ndarray:
        """Copy the ticket's signatures to the host (once)."""
        if ticket.sigs is not None:
            with trace.span("sketch.finish", self.device):
                ticket.out[:] = ticket.sigs.cpu().numpy().view(ticket.out.dtype)
            ticket.sigs = None
        return ticket.out


def _host_form(sigs: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """Finalized signatures in the width they cross to the host in: f32 as
    it is; a u32 / u16 carrier (int64 holding the unsigned value) as the
    int32 / int16 with the same bits, which the host views as unsigned."""
    if dtype == np.float32:
        return sigs
    bits = 8 * dtype.itemsize
    signed = torch.where(sigs >= 1 << (bits - 1), sigs - (1 << bits), sigs)
    return signed.to(torch.int32 if bits == 32 else torch.int16)


def make_sketcher(params: SeqSketcherParams, seed: int = 0x5EED, *,
                  device: torch.device) -> SketcherBase:
    """Algorithm dispatch (the reference's models.make_sketcher).  `device`
    has no default: the caller names the card or the CPU."""
    from .optdens import OptDensSketcher, RevOptDensSketcher
    from .probminhash import ProbMinHashSketcher
    from .setsketch import SetSketchSketcher
    from .superminhash import SuperMinHash2Sketcher, SuperMinHashSketcher

    table = {
        SketchAlgo.OPTDENS: OptDensSketcher,
        SketchAlgo.REVOPTDENS: RevOptDensSketcher,
        SketchAlgo.SUPER: SuperMinHashSketcher,
        SketchAlgo.SUPER2: SuperMinHash2Sketcher,
        SketchAlgo.PROB3A: ProbMinHashSketcher,
        SketchAlgo.HLL: SetSketchSketcher,
    }
    return table[params.algo](params, seed=seed, device=device)
