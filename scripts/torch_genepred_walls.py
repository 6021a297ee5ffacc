"""Wall time of the port's `genepred -t standard` CLI over chip_smoke.py's
planted corpus (8 genomes, 30.0 Mbases), for one or more checkouts of the
repo, so two commits can be compared on one card.

    python3 scripts/torch_genepred_walls.py TREE [TREE ...]

writes the corpus once (chip_smoke.write_genepred_corpus, its seed), then
for each TREE in the order given starts one process with TREE's
gsearch_tpu_torch on the import path, which builds TREE's kernels, runs
genepred once on genome 0 untimed, then times the CLI on each genome on
the first CUDA card, and the sum of its `_decode_path` calls (windows,
upload, decode launch, download).  Give the trees as parent, change,
change, parent to see the spread between processes beside the difference.
Prints one JSON line a tree and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, sys, time
tree, files, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
sys.path.insert(0, tree)
import gsearch_tpu_torch.models.genepred as gp
from gsearch_tpu_torch.cli.main import main
from gsearch_tpu_torch.io import native
from gsearch_tpu_torch.ops import cuda_lib

cuda_lib.load()
native.build()
decode = [0.0]
inner = gp._decode_path

def timed(*a, **k):
    t0 = time.perf_counter()
    try:
        return inner(*a, **k)
    finally:
        decode[0] += time.perf_counter() - t0

gp._decode_path = timed

def genepred(path, prefix):
    t0 = time.perf_counter()
    if main(["genepred", "-s", path, "-o", prefix, "--device", "cuda"]) != 0:
        raise SystemExit(f"genepred failed on {path}")
    return time.perf_counter() - t0

genepred(files[0], os.path.join(out, "warm"))
decode[0] = 0.0
walls = {os.path.basename(f)[:-4]: genepred(f, os.path.join(out, os.path.basename(f)[:-4]))
         for f in files}
print(json.dumps({"tree": tree, "total_s": sum(walls.values()), "decode_s": decode[0],
                  "walls": walls}))
"""


def main(argv: list) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="genepred_walls_") as root:
        corpus = chip_smoke.write_genepred_corpus(root, chip_smoke.FULL)
        print(f"corpus: {len(corpus['files'])} genomes, {corpus['bases'] / 1e6:.1f} Mbases; card: {card}")
        for k, tree in enumerate(argv):
            out = os.path.join(root, f"out{k}")
            os.makedirs(out)
            proc = subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(tree),
                                   json.dumps(corpus["files"]), out],
                                  cwd=os.path.abspath(tree), capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
