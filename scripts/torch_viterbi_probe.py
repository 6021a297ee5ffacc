"""Where a step of the port's genepred decoder (gsearch_tpu_torch/csrc/
viterbi.cu) goes: a one-off timing probe, not a test.

    python3 scripts/torch_viterbi_probe.py

On a machine with a CUDA card and nvcc, it prints the decoder kernels'
registers and spills (ptxas -v), then times `gs_viterbi` and
`gs_genepred_decode` by CUDA events at [896, 8192] (a 5.5 Mb genome's
windows; seeded random codes with N runs) and [64, 8192], each in
scratch builds of csrc/*.cu under build/gsearch_tpu_torch/ made from
edited copies of viterbi.cu:
  - "shuffle exchange": dp exchanged by 11 shuffles instead of shared
    memory (its paths are checked equal to the kernel's);
  - "no backtrace", "no argmax" (the argmax byte store dropped, so the
    compiler drops the argmax) and "forward max chain alone" (both):
    timing probes whose paths are not checked.
An edit whose text viterbi.cu no longer holds raises: the probe follows
the source, it does not pin it.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsearch_tpu_torch.ops import cuda_lib  # noqa: E402
from gsearch_tpu_torch.ops.kernel_report import compile_verbose  # noqa: E402

#: (text of csrc/viterbi.cu, its replacement)
_SHUFFLE = [("    __syncwarp();\n    load11(s.x[j & 1], d);\n",
             "#pragma unroll\n    for (int f = 0; f < NS; ++f) d[f] = __shfl_sync(FULL, dp, f, 16);\n"),
            ("    s.x[(j + 1) & 1][slot] = dp;             // the next step's row\n", "")]
_NO_BACKTRACE = [("  for (int i0 = last; i0 >= 0; i0 -= CHUNK) {",
                  "  for (int i0 = last; i0 >= 0 && w < 0; i0 -= CHUNK) {")]
_NO_ARGMAX = [("    s.arg[j][slot] = (uint8_t)arg;\n", "")]
VARIANTS = {"kernel": [], "shuffle exchange": _SHUFFLE, "no backtrace": _NO_BACKTRACE,
            "no argmax": _NO_ARGMAX, "forward max chain alone": _NO_BACKTRACE + _NO_ARGMAX}


def variant_libs(variants: dict) -> dict:
    """{name: library} of scratch builds of csrc/*.cu, compiled together,
    viterbi.cu edited by each variant's (text, replacement) pairs."""
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    sources = sorted(os.path.join(cuda_lib.CSRC_DIR, p) for p in os.listdir(cuda_lib.CSRC_DIR)
                     if p.endswith(".cu"))
    with open(os.path.join(cuda_lib.CSRC_DIR, "viterbi.cu")) as f:
        text = f.read()
    outs, procs = {}, []
    for k, (name, edits) in enumerate(variants.items()):
        edited = text
        for old, new in edits:
            if old not in edited:
                raise RuntimeError(f"{name}: viterbi.cu no longer holds {old!r}")
            edited = edited.replace(old, new)
        src = os.path.join(cuda_lib.BUILD_DIR, f"viterbi_probe_v{k}.cu")
        with open(src, "w") as f:
            f.write(edited)
        out = os.path.join(cuda_lib.BUILD_DIR, f"viterbi_probe_v{k}.so")
        srcs = [src if os.path.basename(p) == "viterbi.cu" else p for p in sources]
        outs[name] = out
        procs.append(subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", out, *srcs],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
    return outs


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(windows: int = 896, w: int = 8192, reps: int = 5) -> int:
    import numpy as np
    import torch

    from gsearch_tpu_torch.models import genepred as gp
    from gsearch_tpu_torch.ops import viterbi as tv

    _, ptxas = compile_verbose()
    print("ptxas -v (decoder):")
    lines = ptxas.splitlines()
    for k, line in enumerate(lines):
        if "decode_kernel" in line and "Compiling entry" in line:
            print("  " + line.strip())
            for nxt in lines[k + 1 : k + 4]:
                if "registers" in nxt or "spill" in nxt:
                    print("    " + nxt.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (windows, w)).astype(np.uint8)
    for r in rng.integers(0, windows * w - 500, windows // 8):
        codes.reshape(-1)[r : r + int(rng.integers(50, 500))] = 255
    p = gp.GenePredParams()
    tables = {"codon_lu": gp.default_codon_logusage(),
              "dicodon_lu": rng.normal(-4.2, 1.0, (64, 64)).astype(np.float32),
              "nc_lm": np.log(rng.dirichlet(np.ones(4), 4)).astype(np.float32),
              "ctx": rng.normal(0.0, 0.3, (4, 61, 64)).astype(np.float32),
              "ctx_aff": np.tile(np.float32([1.0, 0.0]), (4, 1)),
              "start_prior": rng.normal(0.0, 1.0, 64).astype(np.float32)}
    scal = dict(start_codon_bonus=p.start_codon_bonus, stop_codon_bonus=p.stop_bonus,
                ctx_weight=p.ctx_weight, ctx_cap=p.ctx_cap, ctx_neg_cap=p.ctx_neg_cap)
    c = torch.from_numpy(codes).to(dev)
    dp0 = torch.zeros((windows, tv.NSTATE), dtype=torch.float32, device=dev)
    tb = torch.as_tensor(tv.transition_table(p.p_gene_start, tv.NEG_BIG), device=dev)
    on = {k: torch.as_tensor(v, device=dev) for k, v in tables.items()}
    scores = gp._precompute_scores(c, tables["codon_lu"], None, p.start_codon_bonus, p.stop_bonus)
    c64, dp64 = c[:64].contiguous(), dp0[:64].contiguous()
    sc64 = [x[:64].contiguous() for x in scores]
    forms = {(windows, "fused, codon table"):
             lambda: tv.genepred_decode(c, dp0, tb, codon_lu=on["codon_lu"], **scal),
             (windows, "fused, every table"): lambda: tv.genepred_decode(c, dp0, tb, **on, **scal),
             (windows, "gs_viterbi"): lambda: tv.viterbi(*scores, dp0, tb),
             (64, "fused, codon table"):
             lambda: tv.genepred_decode(c64, dp64, tb, codon_lu=on["codon_lu"], **scal),
             (64, "gs_viterbi"): lambda: tv.viterbi(*sc64, dp64, tb)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"decoder at [{windows} or 64, {w}] on {card}, CUDA events, {reps} calls a reading")
    libs = variant_libs(VARIANTS)
    paths = {}
    saved = cuda_lib._lib
    try:
        for variant, path in libs.items():
            cuda_lib._lib = cuda_lib.bind(path)
            for (nw, name), fn in forms.items():
                if variant in ("kernel", "shuffle exchange"):
                    out = fn().clone()
                    torch.cuda.synchronize()
                    if (nw, name) in paths and not torch.equal(paths[nw, name], out):
                        raise AssertionError(f"{name}: the shuffle exchange gives other paths")
                    paths[nw, name] = out
                elif name == "fused, every table":
                    continue
                ms = time_ms(fn, reps)
                print(f"  {variant} [{nw}, {w}] {name}: {ms:.4f} ms, {ms * 1e6 / w:.1f} ns a step")
    finally:
        cuda_lib._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
