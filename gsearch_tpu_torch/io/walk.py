"""Directory traversal selecting FASTA files by suffix, and ordered
parallel reads (the port's copy of gsearch_tpu/io/walk.py)."""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

from .fasta import read_file_bytes

_COMP = ("", ".gz", ".xz", ".bz2", ".zst", ".zstd")
_DNA_SUFFIXES = tuple(b + c for b in (".fna", ".fa", ".fasta") for c in _COMP)
_AA_SUFFIXES = tuple(b + c for b in (".faa",) for c in _COMP)


def is_fasta_dna_file(name: str) -> bool:
    return name.endswith(_DNA_SUFFIXES)


def is_fasta_aa_file(name: str) -> bool:
    return name.endswith(_AA_SUFFIXES)


def walk_fasta_dir(root: str, is_aa: bool = False) -> List[str]:
    """Recursive, deterministic (sorted) list of FASTA paths under root."""
    pred = is_fasta_aa_file if is_aa else is_fasta_dna_file
    found: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if pred(name):
                found.append(os.path.join(dirpath, name))
    return found


def bounded_thread_map(fn, items, workers: int, window: int = 0):
    """Ordered thread map with at most `window` futures in flight (2 x
    workers by default), so items that expand into parsed genomes do not
    pile up in memory."""
    window = window or 2 * workers
    with ThreadPoolExecutor(max_workers=workers) as pool:
        q: deque = deque()
        for x in items:
            q.append(pool.submit(fn, x))
            while len(q) >= window:
                yield q.popleft().result()
        while q:
            yield q.popleft().result()


def iter_file_buffers(
    paths: List[str], group_size: int = 0
) -> Iterator[Tuple[int, str, bytes]]:
    """Yield (filerank, path, raw-or-decompressed bytes) in path order;
    group_size > 1 reads each group of files with a thread pool (`--pio`),
    otherwise files are read one after another."""
    if group_size <= 1:
        for i, p in enumerate(paths):
            yield i, p, read_file_bytes(p)
        return
    with ThreadPoolExecutor(max_workers=min(group_size, 32)) as pool:
        for start in range(0, len(paths), group_size):
            group = paths[start : start + group_size]
            for off, data in enumerate(pool.map(read_file_bytes, group)):
                yield start + off, group[off], data
