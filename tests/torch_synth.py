"""Seeded inputs shared by the port's tests, importing no JAX (so
tests/test_torch_cuda.py can use them on the card's machine): HMMER3
profiles, reference-format database dumps, and the bound that holds the
port's profile-HMM bit scores (measured in tests/test_torch_hmmsearch.py)."""

import json
import math
import os
import struct

import numpy as np

from gsearch_tpu_torch.models.hmmprofile import BG_FREQ, HMM_ALPHABET

AAS = np.array(list(HMM_ALPHABET))
#: |diff| <= BITS_RTOL * max(|bits|, 1): about 4x the largest relative
#: difference measured between the port and gsearch_tpu on the CPU
BITS_RTOL = 1.4e-5


def bits_bound(ref):
    return BITS_RTOL * np.maximum(np.abs(np.asarray(ref, np.float64)), 1.0)


def _nl(p):
    return "*" if p <= 0 else f"{-math.log(p):.5f}"


def write_profile(path, name, length, rng, *, ga=20.0, stats=True, consensus=None):
    """A HMMER3/f profile: each node's match state puts 0.45-0.85 on its
    consensus residue and the rest on the background; typical transitions
    drawn per node; the last node's m->d and d->d are `*`, as HMMER writes
    them, and node 0's d->d too.  Returns the consensus string."""
    consensus = consensus or "".join(rng.choice(AAS, length))
    lines = ["HMMER3/f [3.3 | Nov 2019]", f"NAME  {name}", f"ACC   PF{len(name):05d}.1",
             f"DESC  synthetic profile {name}", f"LENG  {length}", "ALPH  amino",
             "RF    no", "CONS  yes"]
    if ga is not None:
        lines.append(f"GA    {ga:.2f} {ga:.2f};")
    if stats:
        lines += ["STATS LOCAL MSV      -9.8000  0.71000",
                  "STATS LOCAL VITERBI  -10.5000  0.71000",
                  "STATS LOCAL FORWARD  -4.2000  0.71000"]
    lines += ["HMM          " + "        ".join(HMM_ALPHABET),
              "            m->m     m->i     m->d     i->m     i->i     d->m     d->d",
              "  COMPO   " + "  ".join(_nl(f) for f in BG_FREQ),
              "          " + "  ".join(_nl(f) for f in BG_FREQ)]
    lines.append("          " + "  ".join(_nl(p) for p in (0.98, 0.01, 0.01, 0.6, 0.4, 1.0, 0.0)))
    for k, aa in enumerate(consensus, start=1):
        top = rng.uniform(0.45, 0.85)
        hit = HMM_ALPHABET.index(aa)
        em = [top if i == hit else (1 - top) * f / (1.0 - BG_FREQ[hit]) for i, f in enumerate(BG_FREQ)]
        lines.append(f"  {k:5d}   " + "  ".join(_nl(p) for p in em) + f"  {k} {aa.lower()} - - -")
        lines.append("          " + "  ".join(_nl(f) for f in BG_FREQ))
        if k < length:
            mi, md = rng.uniform(0.005, 0.05, 2)
            ii, dd = rng.uniform(0.2, 0.6), rng.uniform(0.1, 0.5)
            tr = (1 - mi - md, mi, md, 1 - ii, ii, 1 - dd, dd)
        else:
            tr = (0.99, 0.01, 0.0, 0.6, 0.4, 1.0, 0.0)
        lines.append("          " + "  ".join(_nl(p) for p in tr))
    lines.append("//")
    with open(path, "a") as f:
        f.write("\n".join(lines) + "\n")
    return consensus



def write_reference_dump(d, sigs, params, seqdict_paths=None):
    """A reference-format database dump: hnswdump.hnsw.data as [u32 magic]
    [u64 DataId][u64 length][payload] records, a graph description naming
    the scalar type, the streamed seqdict.json, and `params`
    (a gsearch_tpu_torch ProcessingParams) as parameters.json."""
    n, dim = sigs.shape
    t_name = {"float32": "f32", "uint32": "u32", "uint16": "u16", "uint64": "u64"}[sigs.dtype.name]
    with open(os.path.join(d, "hnswdump.hnsw.data"), "wb") as f:
        for i in range(n):
            f.write(struct.pack("<IQQ", 0xA67F0CAF, i, dim) + sigs[i].tobytes())
    with open(os.path.join(d, "hnswdump.hnsw.graph"), "wb") as f:
        f.write(struct.pack("<IBBBQQQ", 0x2A3B4C5D, 1, 32, 16, 64, n, dim)
                + struct.pack("<Q", 11) + b"DistHamming" + struct.pack("<Q", 3) + t_name.encode()
                + b"\x00" * 64)
    with open(os.path.join(d, "seqdict.json"), "w") as f:
        for i in range(n):
            path = seqdict_paths[i] if seqdict_paths else f"/data/g{i}.fna"
            f.write(json.dumps({"id": {"path": path, "fasta_id": f"g{i}"}, "len": 1000 + i}))
    params.dump_json(d)
