#!/usr/bin/env python3
"""K5's pair kernels (csrc/g2.cu) at other block sizes and register caps,
timed against the kept build on one card.

    python3 k5_variants.py [--reps N]

Each variant is csrc/g2.cu with its block size (`PAIR_THREADS`) and its
kernels' launch bound rewritten: uncapped at 64 (the kept build), 128,
256 and 512 threads a block, and capped for 3 or 4 blocks of 128 threads
an SM (170 and 128 registers) or the same 6 or 8 warps an SM in blocks
of 64. The variants build in parallel with the flags of
ops/cuda/build.py into build/k5_variants/. It prints the card's name and
power limit, ptxas' registers / spill bytes of each variant's three
kernels, then one JSON line a round: each variant's time of madd_nodbl,
dbl and add on 2^19 lanes (CUDA events around `reps` calls, after a
warm-up; the inputs of kernel_times.py, chip_smoke.py `random_lanes`,
whose add doubles the tenth of its lanes that its dbl left as they
were; `add_generic` adds as chip_smoke.py phase 8 does, with no lane
doubling, as in the prove's sums), and of the prove's scalar-1 sum of
G2 points (`ops/msm.py` `sum_points` over the first 71,132 of those
lanes' points: one madd_nodbl and 16 adds, launches that the lane count
leaves short, by the profiler's device time). Rounds visit the variants in turn, so that a drift of the
card's clock spreads over all of them. Every variant's outputs must
equal the kept build's bit for bit (chip_smoke.py holds the kept build
against the plain versions); the script exits non-zero where one does
not.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import chip_smoke as smoke

# (threads a block, blocks an SM the launch bound asks for, or None)
VARIANTS = ((64, None), (128, None), (256, None), (512, None), (128, 3), (128, 4), (64, 6), (64, 8))
KEPT = (64, None)


def tag(threads: int, blocks: int | None) -> str:
    return f"t{threads}" + (f"_b{blocks}" if blocks else "")


def variant_source(src: str, threads: int, blocks: int | None) -> str:
    """csrc/g2.cu with PAIR_THREADS = threads and, if blocks, the launch
    bound __launch_bounds__(PAIR_THREADS, blocks) on its kernels."""
    src, n = re.subn(r"constexpr int PAIR_THREADS = \d+;", f"constexpr int PAIR_THREADS = {threads};", src)
    if n != 1:
        raise RuntimeError("csrc/g2.cu: no PAIR_THREADS constant to rewrite")
    if blocks:
        src, n = re.subn(r"__launch_bounds__\(PAIR_THREADS\)", f"__launch_bounds__(PAIR_THREADS, {blocks})", src)
        if n != 3:
            raise RuntimeError(f"csrc/g2.cu: {n} launch bounds to rewrite, not 3")
    return src


def build_variants(out_dir: str) -> dict:
    """{variant: (library path, ptxas report)}, every nvcc at once."""
    from crypto3_fil_proofs_torch.ops.cuda import build

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC, "g2.cu")) as f:
        src = f.read()
    procs = {}
    for v in VARIANTS:
        cu = os.path.join(out_dir, f"g2_{tag(*v)}.cu")
        so = os.path.join(out_dir, f"libg2_{tag(*v)}.so")
        with open(cu, "w") as f:
            f.write(variant_source(src, *v))
        cmd = [build._nvcc(), *build.FLAGS, "-I", build.CSRC, "-o", so, cu]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for v, (so, proc) in procs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc g2_{tag(*v)}.cu failed ({proc.returncode}):\n{e}{o}")
        out[v] = (so, e + o)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k5_variants: CUDA is not available", file=sys.stderr)
        return 1
    from crypto3_fil_proofs_torch import BUILD_DIR
    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.cuda import g2 as k5

    print(smoke.smi_line(), flush=True)
    built = build_variants(os.path.join(BUILD_DIR, "k5_variants"))

    class Variant(k4.PointKernels):
        """K5's wrapper over one variant's library."""

        def __init__(self, path: str):
            super().__init__(k5.G2, "g2")
            self.cdll = ctypes.CDLL(path)

        def _fn(self, op, argtypes):
            fn = getattr(self.cdll, f"g2_{op}")
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            return fn

    kerns, regs = {}, {}
    for v, (so, report) in built.items():
        kerns[v] = Variant(so)
        entries = smoke.ptxas_entries([report])
        regs[tag(*v)] = {op: smoke.registers(entries, f"pair_{op}_kernel")
                         for op in ("madd_nodbl", "dbl", "add")}
    print(json.dumps({"registers": regs}), flush=True)

    curve, n = k5.G2, 1 << smoke.LOG_N
    acc, q, valid = smoke.random_lanes(curve, k5.K5, n, 7)
    ones = sum(1 for w in smoke.prove_witness(np.random.default_rng(1 + 31)) if w == 1)
    pts = q[:ones].contiguous()
    d = k5.K5.dbl(acc, valid)
    # chip_smoke.py phase 8's add: the madd_nodbl sums plus their doubles
    s, _ = k5.K5.madd_nodbl(acc, q, valid)
    every = torch.ones(n, dtype=torch.bool, device=acc.device)
    s2 = k5.K5.dbl(s, every)

    def outputs(kern):
        out, same = kern.madd_nodbl(acc, q, valid)
        return out, same, kern.dbl(acc, valid), kern.add(acc, d), kern.add(s, s2)

    def summed(kern):
        saved, k5.K5 = k5.K5, kern  # ops/msm.py `kernels` reads k5.K5 at each call
        try:
            return M.sum_points(curve, pts)
        finally:
            k5.K5 = saved

    want = outputs(kerns[KEPT])
    want_sum = summed(kerns[KEPT])
    bad = []
    for v, kern in kerns.items():
        got = outputs(kern)
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or not torch.equal(summed(kern), want_sum):
            bad.append(tag(*v))
    if bad:
        print(f"k5_variants: outputs differ from the kept build's: {bad}", file=sys.stderr)
        return 1
    print(f"every variant's outputs equal the kept build's on {n} lanes and the {ones}-point sum", flush=True)

    for r in range(args.rounds):
        row = {}
        for v, kern in kerns.items():
            row[tag(*v)] = {
                "madd_nodbl": smoke.cuda_ms(lambda: kern.madd_nodbl(acc, q, valid), args.reps),
                "dbl": smoke.cuda_ms(lambda: kern.dbl(acc, valid), args.reps),
                "add": smoke.cuda_ms(lambda: kern.add(acc, d), args.reps),
                "add_generic": smoke.cuda_ms(lambda: kern.add(s, s2), args.reps),
                f"sum_points_{ones}_device": smoke.device_ms(lambda: summed(kern), ("pair_",), args.reps),
            }
        print(json.dumps({"round": r, "ms": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
