"""Request answers in gsearch's `gsearch.neighbors.txt` format (the port's
copy of gsearch_tpu/results/answer.py).

For each request with at least one neighbour under the threshold, a header
line "rank\\tpath\\tfasta_id:\\t<id>\\tlength:\\t<len>", then one line per
neighbour "query_id:\\t<path>\\tdistance:\\t<x.xxxxxE?>\\tanswer_fasta_path\\t
<p>\\t<fasta_id> \\t answer_seq_len:\\t <len>"; `reformat` reads the
"query_id:" lines.
"""

from __future__ import annotations

import dataclasses
from typing import List, TextIO

from ..core.seqdict import ItemDict, SeqDict


def _rust_upper_exp(x: float, precision: int = 5) -> str:
    """Format like Rust's {:.5E}: e.g. 1.23450E-2 (no zero-padded exponent)."""
    s = f"{x:.{precision}E}"
    mant, exp = s.split("E")
    sign = "-" if exp.startswith("-") else ""
    digits = exp.lstrip("+-").lstrip("0") or "0"
    return f"{mant}E{sign}{digits}"


@dataclasses.dataclass
class Neighbour:
    d_id: int
    distance: float


@dataclasses.dataclass
class ReqAnswer:
    rank: int
    req_item: ItemDict
    neighbours: List[Neighbour]

    def dump(self, seqdict: SeqDict, threshold: float, out: TextIO) -> int:
        nb_match = 0
        if not any(n.distance <= threshold for n in self.neighbours):
            return 0
        out.write(
            f"\n{self.rank}\t{self.req_item.id.path}\tfasta_id:\t"
            f"{self.req_item.id.fasta_id}\tlength:\t{self.req_item.len}"
        )
        for n in self.neighbours:
            if n.distance < threshold:
                nb_match += 1
                item = seqdict[n.d_id]
                out.write(
                    f"\nquery_id:\t{self.req_item.id.path}\tdistance:\t"
                    f"{_rust_upper_exp(n.distance)}\tanswer_fasta_path\t{item.id.path}\t"
                    f"{item.id.fasta_id} \t answer_seq_len:\t {item.len}"
                )
        return nb_match
