"""Processing-state counters persisted with a database as
processing_state.json; `add` reloads them to continue counting (the port's
copy of gsearch_tpu/core/state.py)."""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class ProcessingState:
    nb_seq: int = 0
    nb_file: int = 0
    elapsed_t: float = 0.0

    FILENAME = "processing_state.json"

    def dump_json(self, dirpath: str) -> str:
        path = os.path.join(dirpath, self.FILENAME)
        with open(path, "w") as f:
            json.dump(
                {"nb_seq": self.nb_seq, "nb_file": self.nb_file, "elapsed_t": self.elapsed_t},
                f,
            )
        return path

    @classmethod
    def reload_json(cls, dirpath: str) -> "ProcessingState":
        path = os.path.join(dirpath, cls.FILENAME)
        with open(path) as f:
            d = json.load(f)
        return cls(
            nb_seq=int(d["nb_seq"]), nb_file=int(d["nb_file"]), elapsed_t=float(d["elapsed_t"])
        )
