"""Configuration structures and their JSON persistence.

The port's own copy of gsearch_tpu/core/params.py, limited to what the
port calls.  A database carries a `parameters.json` that `add` and
`request` reload, so the algorithm, k and sketch size always match the
stored index.  The schema is the reference's, so either package reads the
other's databases:
  {"hnsw": {"capacity":..,"ef":..,"max_nb_conn":..,"scale_modification":..},
   "sketch": {"kmer_size":..,"sketch_size":..,"algo":..,"data_t":..},
   "block_flag": bool}
"""

from __future__ import annotations

import dataclasses
import json
import os
from enum import Enum


class SketchAlgo(str, Enum):
    """Sketching algorithms, one per gsearch mode."""

    PROB3A = "PROB3A"       # ProbMinHash: weighted (probability) Jaccard
    SUPER = "SUPER"         # SuperMinHash, f32 signatures
    SUPER2 = "SUPER2"       # SuperMinHash, integer signatures
    HLL = "HLL"             # SetSketch ("HyperLogLog-like"), u16 registers
    OPTDENS = "OPTDENS"     # one-permutation hashing + optimal densification
    REVOPTDENS = "REVOPTDENS"  # + reverse-optimal densification

    @classmethod
    def from_name(cls, name: str) -> "SketchAlgo":
        """An algorithm by name, in any case; the README's `prob` is PROB3A."""
        key = name.upper()
        try:
            return cls({"PROB": "PROB3A"}.get(key, key))
        except ValueError:
            raise ValueError(
                f"unknown sketching algorithm '{key}'; expected one of "
                f"{[a.value.lower() for a in cls]}"
            )


class DataType(str, Enum):
    DNA = "DNA"
    AA = "AA"


@dataclasses.dataclass
class SeqSketcherParams:
    """Sketching parameters: DNA kmer_size <= 32, AA kmer_size <= 12,
    sketch_size <= 65535."""

    kmer_size: int
    sketch_size: int
    algo: SketchAlgo
    data_t: DataType

    def __post_init__(self):
        if isinstance(self.algo, str):
            self.algo = SketchAlgo.from_name(self.algo)
        if isinstance(self.data_t, str):
            self.data_t = DataType(self.data_t.upper())
        kmax = 32 if self.data_t == DataType.DNA else 12
        if not (1 <= self.kmer_size <= kmax):
            raise ValueError(
                f"kmer_size {self.kmer_size} out of range [1,{kmax}] for {self.data_t.value}"
            )
        if not (1 <= self.sketch_size <= 65535):
            raise ValueError("sketch_size must be in [1, 65535]")

    def to_json(self) -> dict:
        return {
            "kmer_size": self.kmer_size,
            "sketch_size": self.sketch_size,
            "algo": self.algo.value,
            "data_t": self.data_t.value,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SeqSketcherParams":
        return cls(
            kmer_size=int(d["kmer_size"]),
            sketch_size=int(d["sketch_size"]),
            algo=SketchAlgo.from_name(d["algo"]),
            data_t=DataType(d["data_t"].upper()),
        )


@dataclasses.dataclass
class HnswParams:
    """Graph parameters: max_nb_conn is clamped to 255; scale_modification
    in [0.2, 1.0]."""

    capacity: int = 1_500_000
    ef: int = 1600
    max_nb_conn: int = 128
    scale_modification: float = 1.0

    def __post_init__(self):
        if self.max_nb_conn > 255:
            self.max_nb_conn = 255
        if not (0.2 <= self.scale_modification <= 1.0):
            raise ValueError("scale_modification (scale_modify_f) must be in [0.2, 1.0]")

    def to_json(self) -> dict:
        return {
            "capacity": self.capacity,
            "ef": self.ef,
            "max_nb_conn": self.max_nb_conn,
            "scale_modification": self.scale_modification,
        }

    @classmethod
    def from_json(cls, d: dict) -> "HnswParams":
        return cls(
            capacity=int(d["capacity"]),
            ef=int(d["ef"]),
            max_nb_conn=int(d["max_nb_conn"]),
            scale_modification=float(d["scale_modification"]),
        )


@dataclasses.dataclass
class ProcessingParams:
    """The bundle persisted as parameters.json."""

    hnsw: HnswParams
    sketch: SeqSketcherParams
    block_flag: bool = True  # True: whole genome sketched as one block

    FILENAME = "parameters.json"

    def dump_json(self, dirpath: str) -> str:
        path = os.path.join(dirpath, self.FILENAME)
        with open(path, "w") as f:
            json.dump(
                {
                    "hnsw": self.hnsw.to_json(),
                    "sketch": self.sketch.to_json(),
                    "block_flag": self.block_flag,
                },
                f,
            )
        return path

    @classmethod
    def reload_json(cls, dirpath: str) -> "ProcessingParams":
        path = os.path.join(dirpath, cls.FILENAME)
        with open(path) as f:
            d = json.load(f)
        return cls(
            hnsw=HnswParams.from_json(d["hnsw"]),
            sketch=SeqSketcherParams.from_json(d["sketch"]),
            block_flag=bool(d["block_flag"]),
        )


@dataclasses.dataclass
class ComputingParams:
    """Runtime-only settings, never persisted: nb_files_par is `--pio`
    (files read into memory per IO group), nb_threads `--nbthreads` (host
    parse workers), mesh_devices `--mesh` (members of the device mesh the
    pipeline shards over, parallel/mesh.py: 0 off, -1 every device, N the
    first N)."""

    nb_files_par: int = 0
    nb_threads: int = 0
    mesh_devices: int = 0
