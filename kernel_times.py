#!/usr/bin/env python3
"""Device time of each CUDA kernel of the port at its path's shape, for
comparing two trees of the repository on one card.

    python3 kernel_times.py [--root DIR] [--reps N]

imports `crypto3_fil_proofs_torch` from DIR (default: the tree this file
is in), builds its kernels there, and prints the card's name and power
limit, then one JSON object {kernel: ms}: CUDA events around `reps`
calls after a warm-up, mean per call (for the two 20 us kernels also
their device time from torch.profiler, `_device`, since a loop of such
launches is paced by the host). The inputs and shapes are chip_smoke.py's
(`rand_elems`, `k2_shapes`, `random_lanes`, `known_log_msm_input`,
`MSM_POINTS`), from this file's tree whatever DIR is: the Fr product on a
512 MiB sector's leaves times R^2 and on 2^19 pairs, Poseidon at arity 2,
8 and 11, the NTT at 2^19, the point kernels on 2^19 lanes, both MSMs and
each MSM's stages (schedule, bucket_acc, the bucket reduction, the
aggregation). It checks nothing: chip_smoke.py holds every kernel against
its plain version. Run it alternately on two trees (A, B, B, A) to
compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import chip_smoke as smoke  # this tree's, before DIR goes first on sys.path


def device_ms(fn, prefix: str, reps: int = 50) -> float:
    """Mean device time per call of the kernels named `prefix...`, from
    one trace of `reps` calls."""
    fn()
    smoke.torch_sync()
    tr = smoke.trace_device(lambda: [fn() for _ in range(reps)])
    return sum(us for k, us in tr["us"].items() if k.startswith(prefix)) / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=smoke.REPO)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.cuda import field as k1
    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.cuda import g2 as k5
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
    from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2

    print(smoke.smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ms = smoke.cuda_ms

    out = {}
    x = smoke.rand_elems(F.FR, smoke.SECTOR_SIZE // 32, gen)
    r2 = F.ints_to_limbs32([F.FR.mont_r2])[0].cuda()
    out["fr_montmul_2^24"] = ms(lambda: k1.montmul(x, r2), 10)
    del x
    log_n = smoke.LOG_N
    a, b = smoke.rand_elems(F.FR, 1 << log_n, gen), smoke.rand_elems(F.FR, 1 << log_n, gen)
    out[f"ntt_2^{log_n}"] = ms(lambda: k3.transform(a, log_n, False), 10)
    out[f"fr_montmul_2^{log_n}"] = ms(lambda: k1.montmul(a, b), 20)
    out[f"fr_montmul_2^{log_n}_device"] = device_ms(lambda: k1.montmul(a, b), "void montmul_kernel<Fr>(")
    out[f"fr_sub_2^{log_n}"] = ms(lambda: k1.sub(a, b), 20)
    out[f"fr_sub_2^{log_n}_device"] = device_ms(lambda: k1.sub(a, b), "fr_sub_kernel(")
    for arity, n, _ in smoke.k2_shapes():
        pre = smoke.rand_elems(F.FR, n * arity, gen).reshape(n, arity, 8)
        out[f"poseidon_a{arity}_{n}"] = ms(lambda: k2.poseidon_hash(pre, arity), args.reps)
        del pre
    torch.cuda.empty_cache()
    for kern in (k4.K4, k5.K5):
        curve = kern.curve
        g = curve.name
        acc, q, valid = smoke.random_lanes(curve, kern, 1 << log_n, 7)
        out[f"{g}_madd_nodbl"] = ms(lambda: kern.madd_nodbl(acc, q, valid), 10)
        if "madd" in getattr(kern, "ops", ()):
            out[f"{g}_madd"] = ms(lambda: kern.madd(acc, q, valid), 10)
        out[f"{g}_dbl"] = ms(lambda: kern.dbl(acc, valid), 10)
        d = kern.dbl(acc, valid)
        out[f"{g}_add"] = ms(lambda: kern.add(acc, d), 10)
        del acc, q, d, valid
        n = smoke.MSM_POINTS[g]
        pts, _, _ = smoke.known_log_msm_input(curve, n, 7)
        raw = np.random.default_rng(3).integers(0, 256, (n, 32), dtype=np.uint8)
        limbs = torch.from_numpy(raw.view(np.int32).copy()).cuda()
        limbs[:, 7] &= 0x3FFFFFFF  # below 2^254 < r
        out[f"msm_{g}_{n}"] = ms(lambda: M.pippenger(curve, pts, limbs), args.reps)
        # its stages, at the window size pippenger chose
        c = M.pippenger(curve, pts, limbs)[1]
        windows = -(-M.scalar_bits(limbs) // c)
        bk = M.kernels(curve)[1]
        sched = M.schedule(limbs, c, windows)
        chunks = bk.bucket_acc(pts, sched.order, sched.start, sched.length)
        buckets = M.reduce_buckets(bk, chunks, sched.chunk_ptr)
        out[f"msm_{g}_schedule"] = ms(lambda: M.schedule(limbs, c, windows), args.reps)
        out[f"msm_{g}_bucket_acc"] = ms(lambda: bk.bucket_acc(pts, sched.order, sched.start, sched.length),
                                        args.reps)
        out[f"msm_{g}_reduce"] = ms(lambda: M.reduce_buckets(bk, chunks, sched.chunk_ptr), args.reps)
        out[f"msm_{g}_aggregate"] = ms(lambda: M.aggregate(curve, buckets, windows, 1 << c), args.reps)
        del pts, limbs, sched, chunks, buckets
        torch.cuda.empty_cache()
    print(json.dumps({"root": os.path.abspath(args.root), "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
