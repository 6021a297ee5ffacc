"""FASTA parsing with transparent decompression (the port's copy of
gsearch_tpu/io/fasta.py, limited to what the port calls).

  - `concat_file_codes`        one-block mode: every kept record of a file
                               as one code array, records joined by one
                               invalid code (a k-mer break);
  - `concat_file_codes_packed` the same as PackedCodes for DNA;
  - `file_records_codes`       per-record mode: one code array a record;
  - `parse_reads`              reads, FASTA or FASTQ by suffix, FASTQ
                               bases under a phred cut masked to 'N'.
Records whose header contains "capsid" are skipped, and records shorter
than min_seq_size dropped.  Each goes through the native parser
(io/native.py) when it is built, and through the pure-Python parser below
otherwise; both give the same codes.  .gz / .xz / .bz2 / .zst files are
decompressed on the fly.
"""

from __future__ import annotations

import bz2
import dataclasses
import gzip
import io
import lzma
from typing import Callable, Iterator, List, Tuple

import numpy as np

from . import native
from .codec import DNA_INVALID, encode_aa, encode_dna


@dataclasses.dataclass
class FastaRecord:
    fasta_id: str  # first whitespace-delimited token of the header
    seq: bytes
    header: str = ""  # full header line (capsid filtering scans all of it)


def _open_maybe_compressed(path: str) -> io.BufferedReader:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".xz"):
        return lzma.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    if path.endswith((".zst", ".zstd")):
        import zstandard  # not installed everywhere

        return zstandard.open(path, "rb")
    return open(path, "rb")


def read_file_bytes(path: str) -> bytes:
    """A whole file, decompressed."""
    with _open_maybe_compressed(path) as f:
        return f.read()


def parse_fasta(path: str | None = None, data: bytes | None = None) -> Iterator[FastaRecord]:
    """Stream FASTA records from a path or an in-memory buffer."""
    if data is None:
        assert path is not None
        data = read_file_bytes(path)
    # split on line-start '>' only: a header may hold '>' in its description
    pos = data.find(b">")
    if pos < 0:
        return
    for chunk in data[pos + 1 :].split(b"\n>"):
        nl = chunk.find(b"\n")
        if nl < 0:
            continue
        header = chunk[:nl].strip()
        fasta_id = header.split()[0].decode("utf-8", "replace") if header else ""
        seq = chunk[nl + 1 :].replace(b"\n", b"").replace(b"\r", b"")
        yield FastaRecord(
            fasta_id=fasta_id, seq=seq, header=header.decode("utf-8", "replace")
        )


def parse_fastq(
    path: str | None = None,
    data: bytes | None = None,
    quality_min: int = 0,
) -> Iterator[FastaRecord]:
    """Stream FASTQ records (the 4-line form).  Bases whose phred+33 quality
    is below quality_min become 'N' (an invalid code, so a k-mer break)."""
    if data is None:
        assert path is not None
        data = read_file_bytes(path)
    lines = data.split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        head = lines[i].strip()
        if not head.startswith(b"@"):
            continue
        seq = lines[i + 1].strip()
        if quality_min > 0:
            qual = lines[i + 3].strip()
            sa = np.frombuffer(seq, np.uint8).copy()
            qa = np.frombuffer(qual[: len(sa)], np.uint8)
            sa[: len(qa)][qa < 33 + quality_min] = ord("N")
            seq = sa.tobytes()
        fid = head[1:].split()[0].decode("utf-8", "replace") if len(head) > 1 else ""
        yield FastaRecord(fasta_id=fid, seq=seq, header=head[1:].decode("utf-8", "replace"))


def is_fastq_file(name: str) -> bool:
    """`.fq` / `.fastq`, compressed or not."""
    base = name
    for c in (".gz", ".xz", ".bz2", ".zst", ".zstd"):
        if base.endswith(c):
            base = base[: -len(c)]
            break
    return base.endswith((".fq", ".fastq"))


def parse_reads(path: str, quality_min: int = 0) -> Iterator[FastaRecord]:
    """Reads from a FASTQ file (by suffix; quality-masked) or a FASTA file."""
    if is_fastq_file(path):
        return parse_fastq(path, quality_min=quality_min)
    return parse_fasta(path)


def _encoder(is_aa: bool) -> Callable[[bytes], np.ndarray]:
    return encode_aa if is_aa else encode_dna


def _keep(rec: FastaRecord, min_seq_size: int) -> bool:
    if "capsid" in (rec.header or rec.fasta_id):
        return False
    return len(rec.seq) >= min_seq_size


def concat_file_codes(
    path: str, is_aa: bool = False, min_seq_size: int = 0, data: bytes | None = None
) -> Tuple[np.ndarray, str, int]:
    """One-block mode: (codes, first kept record's id, residues encoded,
    separators excluded)."""
    if data is None:
        data = read_file_bytes(path)
    got = native.native_concat_codes(data, is_aa, min_seq_size)
    if got is not None:
        return got
    enc = _encoder(is_aa)
    parts: List[np.ndarray] = []
    first_id = ""
    total = 0
    sep = np.array([DNA_INVALID], dtype=np.uint8)
    for rec in parse_fasta(path, data=data):
        if not _keep(rec, min_seq_size):
            continue
        if not first_id:
            first_id = rec.fasta_id
        if parts:
            parts.append(sep)
        codes = enc(rec.seq)
        total += len(codes)
        parts.append(codes)
    if not parts:
        return np.empty(0, dtype=np.uint8), first_id, 0
    return np.concatenate(parts), first_id, total


def concat_file_codes_packed(
    path: str, is_aa: bool = False, min_seq_size: int = 0, data: bytes | None = None
):
    """One-block mode through the fused native parse and pack: (PackedCodes
    or codes ndarray, first id, residues).  AA files, a parser that could
    not be built, or N-run-heavy files (more invalid positions than the
    packed form holds) take `concat_file_codes`, whose array the sketchers
    take equally."""
    if is_aa:
        return concat_file_codes(path, is_aa=True, min_seq_size=min_seq_size, data=data)
    if data is None:
        data = read_file_bytes(path)
    got = native.native_concat_pack2(data, min_seq_size)
    if got is None:
        return concat_file_codes(path, is_aa=False, min_seq_size=min_seq_size, data=data)
    return got


def file_records_codes(
    path: str, is_aa: bool = False, min_seq_size: int = 0, data: bytes | None = None
) -> List[Tuple[np.ndarray, str]]:
    """Per-record mode: one (codes, fasta_id) per kept record."""
    if data is None:
        data = read_file_bytes(path)
    got = native.native_records_codes(data, is_aa, min_seq_size)
    if got is not None:
        return got
    enc = _encoder(is_aa)
    return [(enc(rec.seq), rec.fasta_id) for rec in parse_fasta(path, data=data)
            if _keep(rec, min_seq_size)]
