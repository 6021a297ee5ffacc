"""Probe K1's design choices on a CUDA card.

    python -m gsearch_tpu_torch.ops.k1_probe

Prints, beside the card's name:
  - tile and ring variants: for each, a copy of csrc/hamming.cu with other
    `K1Tile` aliases (threads, stages) is compiled into build/ and K1 is
    timed (CUDA events) at Q x N = 37 x 4095 and 512 x 4095 (S = 12,000),
    the self-pair blocks [1024, 128, 1024] and the batch-mate block
    [1024, 1024]; every variant's output must equal the first's;
  - the small request shape 8 x 48 x 12,000: device-only time
    (torch.profiler) of launches whose S splits cover 5 and 2 chunks each,
    and host time per call of the wrapper, of torch.cdist(p=0) and of a
    bare launch through ctypes.
"""

from __future__ import annotations

import os
import re
import subprocess
import time

import torch

from . import cuda_lib
from . import distance as dist

# (WQ, WN, STAGES) of the wide, narrow16 and narrow8 tiles
VARIANTS = {
    "shipped": ((16, 8, 4), (4, 32, 3), (2, 32, 3)),
    "fewer stages": ((16, 8, 3), (4, 32, 2), (2, 32, 2)),
    "two stages, 128-row narrow": ((16, 8, 2), (4, 16, 4), (2, 16, 4)),
    "128-row narrow": ((16, 8, 4), (4, 16, 3), (2, 16, 3)),
}
_SMEM_SM = 227 * 1024


def _resident(wq: int, wn: int, stages: int) -> int:
    smem = stages * (wq * 4 + wn * 8) * dist.K1_CHUNK * 4
    return max(1, min(_SMEM_SM // (smem + 1024), 2048 // (wq * wn), 32))


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(fn, reps: int = 50) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0) or 0 for e in prof.key_averages()
               if "eqcount_kernel" in e.key) / reps / 1e3


def _host_us(fn, reps: int = 2000) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def variants(dev: torch.device) -> None:
    src = open(os.path.join(cuda_lib.CSRC_DIR, "hamming.cu")).read()
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    builds = {}
    for k, (name, tiles) in enumerate(VARIANTS.items()):
        text = src
        for alias, (wq, wn, st) in zip(("K1Wide", "K1Narrow16", "K1Narrow8"), tiles):
            text = re.sub(rf"using {alias} = K1Tile<[^>]*>;", f"using {alias} = K1Tile<{wq}, {wn}, {st}>;",
                          text)
        cu = os.path.join(cuda_lib.BUILD_DIR, f"k1_probe_{k}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        builds[name] = (so, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so, cu]))
    for _, proc in builds.values():
        if proc.wait() != 0:
            raise RuntimeError("a K1 variant did not build")
    g = torch.Generator(device=dev).manual_seed(1)
    db = torch.randint(0, 4, (4095, 12000), generator=g, device=dev, dtype=torch.int32)
    q37, q512 = db[:37].clone(), db[:512].clone()
    blocks = torch.randint(0, 3, (1024, 128, 1024), generator=g, device=dev, dtype=torch.int32)
    mates = torch.randint(0, 3, (1024, 1024), generator=g, device=dev, dtype=torch.int32)
    calls = {"37x4095": (lambda: dist.hamming_frac(q37, db), 20),
             "512x4095": (lambda: dist.hamming_frac(q512, db), 5),
             "self [1024,128,1024]": (lambda: dist.hamming_frac_self(blocks), 5),
             "mates [1024,1024]": (lambda: dist.hamming_frac_self(mates), 20)}
    saved, first = (cuda_lib._lib, dict(dist.K1_TILES)), None
    try:
        for name, (so, _) in builds.items():
            cuda_lib._lib = cuda_lib.bind(so)
            dist.K1_TILES = {k: (wq * 4, wn * 8, _resident(wq, wn, st)) for k, (wq, wn, st)
                             in zip(("wide", "narrow16", "narrow8"), VARIANTS[name])}
            dist.k1_plan.cache_clear()
            outs = [fn() for fn, _ in calls.values()]
            if first is None:
                first = outs
            if not all(torch.equal(a, b) for a, b in zip(outs, first)):
                raise AssertionError(f"variant {name} differs")
            times = ", ".join(f"{what} {_event_ms(fn, reps):.4f}" for what, (fn, reps) in calls.items())
            print(f"variant {name} {VARIANTS[name]}: {times} ms", flush=True)
    finally:
        cuda_lib._lib, dist.K1_TILES = saved[0], saved[1]
        dist.k1_plan.cache_clear()


def small(dev: torch.device) -> None:
    g = torch.Generator(device=dev).manual_seed(2)
    db = torch.randint(0, 4, (48, 12000), generator=g, device=dev, dtype=torch.int32)
    q = db[:8].clone()
    lib = cuda_lib.load()
    stream = cuda_lib.current_stream(dev)
    out = torch.empty((8, 48), device=dev)
    counts, tickets = dist._k1_workspace(dev, stream, 8 * 48, 1)
    tile = list(dist.K1_TILES).index("narrow8")

    def launch(span):
        def fn():
            cuda_lib.check(lib, lib.gs_hamming_frac(
                q.data_ptr(), db.data_ptr(), out.data_ptr(), counts.data_ptr(), tickets.data_ptr(),
                1, 8, 48, 12000, tile, span, 0, dev.index, stream), "gs_hamming_frac")
        return fn

    want = dist.hamming_frac_plain(q, db)
    for chunks in (5, 2):
        launch(chunks * dist.K1_CHUNK)()
        assert torch.equal(out, want)
        print(f"8x48: narrow8, {-(-12000 // (chunks * dist.K1_CHUNK))} splits of {chunks} chunks: "
              f"{_device_ms(launch(chunks * dist.K1_CHUNK)):.4f} ms device-only", flush=True)
    print(f"8x48: the plan {dist.k1_plan(1, 8, 48, 12000, dist._sm_count(dev.index))}")
    qf, dbf = q.float(), db.float()
    print(f"8x48 host us a call: hamming_frac {_host_us(lambda: dist.hamming_frac(q, db)):.1f}, "
          f"torch.cdist {_host_us(lambda: torch.cdist(qf, dbf, p=0)):.1f}, bare ctypes launch "
          f"{_host_us(launch(2 * dist.K1_CHUNK)):.1f}, torch.cuda.current_stream "
          f"{_host_us(lambda: torch.cuda.current_stream(dev).cuda_stream):.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    variants(dev)
    small(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
