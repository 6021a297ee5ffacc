"""Sequence identity dictionary (the port's copy of gsearch_tpu/core/seqdict.py).

The rank of an item in the SeqDict is the data id the index uses; answers
are resolved back to (path, fasta_id, length) through it.  Persisted as
`seqdict.json`, a JSON array of {path, fasta_id, len}, one item a line.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List


@dataclasses.dataclass
class Id:
    path: str
    fasta_id: str


@dataclasses.dataclass
class ItemDict:
    id: Id
    len: int

    def to_json(self) -> dict:
        return {"path": self.id.path, "fasta_id": self.id.fasta_id, "len": self.len}

    @classmethod
    def from_json(cls, d: dict) -> "ItemDict":
        return cls(id=Id(path=d["path"], fasta_id=d["fasta_id"]), len=int(d["len"]))


class SeqDict:
    FILENAME = "seqdict.json"

    def __init__(self, items: List[ItemDict] | None = None):
        self.items: List[ItemDict] = items or []

    def push(self, item: ItemDict) -> int:
        """Append, returning the data id assigned to the item."""
        self.items.append(item)
        return len(self.items) - 1

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, rank: int) -> ItemDict:
        return self.items[rank]

    def __iter__(self) -> Iterator[ItemDict]:
        return iter(self.items)

    def dump(self, dirpath: str) -> str:
        path = os.path.join(dirpath, self.FILENAME)
        # one item a line, so a large dictionary is written as a stream
        with open(path, "w") as f:
            f.write("[\n")
            for i, item in enumerate(self.items):
                sep = "," if i + 1 < len(self.items) else ""
                f.write(json.dumps(item.to_json()) + sep + "\n")
            f.write("]\n")
        return path

    @classmethod
    def reload_json(cls, dirpath: str) -> "SeqDict":
        path = os.path.join(dirpath, cls.FILENAME)
        with open(path) as f:
            data = json.load(f)
        return cls([ItemDict.from_json(d) for d in data])
