"""Sequence-mode match aggregation (the port's copy of
gsearch_tpu/results/matcher.py).

Outside block mode each request sequence gives its sub-threshold neighbour
distances to the target genomes (files) they belong to; a target's merit
is the product of those distances (lower is better), and `analyze` writes
the 5 best targets per request genome to `gsearch.matches`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, TextIO

from ..core.seqdict import ItemDict


class Matcher:
    def __init__(self, threshold: float = 0.99):
        self.threshold = threshold
        # request genome path -> target genome path -> list of distances
        self.seq_matches: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
        self.nb_sequence_match = 0

    def insert_sequence_match(
        self, req_item: ItemDict, target_item: ItemDict, distance: float
    ) -> None:
        self.seq_matches[req_item.id.path][target_item.id.path].append(float(distance))
        self.nb_sequence_match += 1

    def _merit(self, distances: list) -> float:
        merit = 1.0
        for d in distances:
            if d < self.threshold:
                merit *= d
        return merit

    def analyze(self, out: TextIO) -> None:
        for genome, targets in self.seq_matches.items():
            ranked = sorted(
                ((t, self._merit(ds)) for t, ds in targets.items()), key=lambda x: x[1]
            )
            out.write(f"\n\n request genome : {genome}")
            for path, merit in ranked[:5]:
                out.write(f"\n\t matched genome {path}  merit : {merit:.3E}")
