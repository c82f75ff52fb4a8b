#!/usr/bin/env python3
"""Device time of each CUDA kernel of the port at its path's shape, for
comparing two trees of the repository on one card.

    python3 kernel_times.py [--root DIR] [--reps N] [--sweep | --ntt]

imports `crypto3_fil_proofs_torch` from DIR (default: the tree this file
is in), builds its kernels there, and prints the card's name and power
limit, then one JSON object {kernel: ms}: CUDA events around `reps`
calls after a warm-up, mean per call; `_device` entries are the
profiler's device time of the kernels alone (chip_smoke.py `device_ms`),
for the two 20 us kernels, the scalar-1 sums and the MSM stages (three
readings each), whose event times are paced by the host. The inputs and shapes are
chip_smoke.py's (`rand_elems`, `k2_shapes`, `random_lanes`,
`known_log_msm_input`, `MSM_POINTS`, `prove_witness`), from this file's
tree whatever DIR is: the Fr product on a 512 MiB sector's leaves times
R^2 and on 2^19 pairs, Poseidon at arity 2, 8 and 11, in a tree that has
it the witness replay K7 at phase 32's shapes and at the batch sizes that
C2 and the PoSt paths launch (`WITNESS_SHAPES`, `WITNESS_PATH_SHAPES`:
the wrapper's call, the kernel alone into a buffer of the caller's
[n, n_int, 8] layout, and, in a tree that has two layouts, each of them
alone), the NTT at 2^19 and at the commit's 2^23 (each of its passes
too), in a tree that has it the batched transform at the four-step
shapes of 2^23 on 8 shards (256 x 2^12 and 512 x 2^11; each of K3's
passes over those batches; in a tree that has K3b, K3b alone into one
buffer), the point kernels on 2^19 lanes (G1's madd with q == acc on
every 64th lane), the prove's sums of its scalar-1 points (`sum_points`: one
madd_nodbl and a halving tree of adds, bound by latency), both MSMs and
each MSM's stages (schedule, bucket_acc, the bucket reduction, the
aggregation). It checks nothing: chip_smoke.py holds every kernel
against its plain version. Run it alternately on two trees (A, B, B, A)
to compare them.

--sweep times only K7, both of its layouts (`WITNESS_LAYOUTS`) at batch
sizes 2^8 .. 2^17 of each arity, at the launcher's switch and the size
below it, and at 0.8, 0.9, 1.1 and 1.25 times the switch, and prints
ptxas' registers and spills of its kernels: where the lane groups stop
winning is the switch (csrc/poseidon_witness.cu `one_thread_from`).

--ntt times only the NTT entries (K3 at every domain of the paths,
NTT_DOMAINS: 2^17, 2^18, 2^19, 2^21 and 2^23, each with its passes; the
h pipeline at 2^19; the batched shapes with K3's passes and K3b alone),
each transform and the h pipeline as the median of five means of 10
calls, then the profiler's kernel time of each (with PDL off in a tree
that has it), and prints ptxas' registers and spills of the tree's NTT
kernels and each entry's bound and share (chip_smoke.py `bound_ms` over
`ntt_products`); in a tree that has K3b, also K3b alone at 2^11 and 2^12
over batches from one wave of blocks to many. --ntt --tiles also times K3's transforms at
each domain under other plans (`passes` with other TILE_LOG, at each trip
radix, `radix_log` replaced, with each pass's time) and with its PDL
choice flipped, in a tree whose K3 has tiles.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys

import chip_smoke as smoke  # this tree's, before DIR goes first on sys.path


# the point kernels of each group, as the profiler names them in this
# tree and in the parent's one-thread G2 layout
POINT_KERNELS = {
    "g1": tuple(f"void {op}_kernel<fq_t>(" for op in ("madd_nodbl", "dbl", "add")),
    "g2": tuple(f"{pre}{op}_kernel{post}(" for op in ("madd_nodbl", "dbl", "add")
                for pre, post in (("pair_", ""), ("void ", "<fq2_t>"))),
}


def witness_times(k2, gen, arity: int, n: int, reps: int) -> dict:
    """K7 at one shape: the wrapper's call, the kernel alone into a buffer
    of the caller's layout, and each layout alone where the tree has two."""
    import torch

    from crypto3_fil_proofs_torch.ops import field as F
    from crypto3_fil_proofs_torch.ops import poseidon_torch as PT

    key = f"poseidon_witness_a{arity}_{n}"
    ms = smoke.cuda_ms
    pre = smoke.rand_elems(F.FR, max(3, n * arity), gen)[: n * arity].reshape(n, arity, 8)
    raw = torch.empty((n, PT.witness_len(arity), 8), dtype=torch.int32, device=pre.device)
    out = {key: ms(lambda: k2.witness(pre, arity), reps),
           f"{key}_kernel": ms(lambda: k2._launch("poseidon_witness", "poseidon_witness", pre, raw, arity), reps)}
    for layout, entry in getattr(k2, "WITNESS_LAYOUTS", {}).items():
        out[f"{key}_{layout}"] = ms(lambda: k2._launch("poseidon_witness", entry, pre, raw, arity), reps)
    del pre, raw
    torch.cuda.empty_cache()
    return out


def plan(k3, log_n: int, batch: int = 1) -> list:
    """The passes of k3.transform on `batch` rows of 2^log_n: (s0, cnt) in
    older trees, (s0, cnt, log_c) at the radix `plan` picks since K3 has
    tiles."""
    return k3.plan(log_n, batch, "cuda") if hasattr(k3, "plan") else k3.passes(log_n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=smoke.REPO)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true", help="only K7's two layouts over batch sizes")
    ap.add_argument("--ntt", action="store_true", help="only the NTT kernels")
    ap.add_argument("--tiles", action="store_true", help="with --ntt: K3 under other tile plans")
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
    if args.sweep:
        from crypto3_fil_proofs_torch.ops.cuda import build

        out["switch"] = {a: k2.witness_switch(a) for a in k2.ARITIES}
        for arity, switch in out["switch"].items():
            around = {round(switch * f) for f in (0.8, 0.9, 1.0, 1.1, 1.25)} | {switch - 1}
            for n in sorted({1 << log_n for log_n in range(8, 18)} | around):
                out.update(witness_times(k2, gen, arity, n, args.reps))
        out["ptxas"] = [line.strip() for line in build.ptxas_reports.get("poseidon_witness", "").splitlines()
                        if "registers" in line or "spill" in line or "Compiling entry" in line]
        print(json.dumps({"root": os.path.abspath(args.root), "ms": out}), flush=True)
        return 0
    if not args.ntt:
        # the scalar-1 sums of the 2^19 prove (chip_smoke.py's witness)
        ones = sum(1 for w in smoke.prove_witness(np.random.default_rng(1 + 31)) if w == 1)
        x = smoke.rand_elems(F.FR, smoke.SECTOR_SIZE // 32, gen)
        r2 = F.ints_to_limbs32([F.FR.mont_r2])[0].cuda()
        out["fr_montmul_2^24"] = ms(lambda: k1.montmul(x, r2), 10)
        del x
    log_n = smoke.LOG_N
    a, b = smoke.rand_elems(F.FR, 1 << log_n, gen), smoke.rand_elems(F.FR, 1 << log_n, gen)
    # K3 at each domain of the paths (only the prove's 2^19 and the commit's
    # 2^23 without --ntt): the transform and each of its passes, the first
    # reading x, the others in place (a pass is (s0, cnt) in older trees,
    # (s0, cnt, log_c) since K3 has tiles)
    # --ntt: the median of five means of 10 calls (a mean alone swings by several % with the shared host);
    # the kernels' own time (the profiler's, PDL off where the tree has it: a PDL pass's kernel time counts
    # its wait for the one before) is taken after every event time
    tms = (lambda fn: statistics.median(ms(fn, 10) for _ in range(5))) if args.ntt else (lambda fn: ms(fn, 10))
    device = []
    for lg in smoke.NTT_DOMAINS if args.ntt else (log_n, 23):
        x = smoke.rand_elems(F.FR, 1 << lg, gen)
        out[f"ntt_2^{lg}"] = tms(lambda: k3.transform(x, lg, False))
        if args.ntt:
            device.append((f"ntt_2^{lg}_device", lambda x=x, lg=lg: k3.transform(x, lg, False)))
        y = k3.transform(x, lg, False)
        out[f"ntt_2^{lg}_passes"] = [ms(lambda: k3.run_pass(x if p[0] == 0 else y, y, lg, *p, False), 10)
                                     for p in plan(k3, lg)]
        if args.tiles and hasattr(k3, "TILE_LOG"):
            # other plans: [radix log, tile_log, passes, ms, each pass's ms], each distinct plan once
            kept = k3.TILE_LOG, k3.radix_log
            plans = out[f"ntt_2^{lg}_plans"] = []
            for r, tile_log in itertools.product((3, 2), (10, 11, 12)):
                k3.TILE_LOG, k3.radix_log = tile_log, lambda elems, device, r=r: r
                p = k3.passes(lg, radix=r)
                if all(q[0] != r or q[2] != p for q in plans):
                    plans.append([r, tile_log, p, tms(lambda: k3.transform(x, lg, False)),
                                  [ms(lambda: k3.run_pass(x if q[0] == 0 else y, y, lg, *q, False), 10) for q in p]])
                k3.TILE_LOG, k3.radix_log = kept
            # the launch behind the pass before (PDL) flipped
            k3.PDL = False
            out[f"ntt_2^{lg}_no_pdl"] = tms(lambda: k3.transform(x, lg, False))
            k3.PDL = True
        del y
    if args.ntt:
        c = smoke.rand_elems(F.FR, 1 << log_n, gen)
        out[f"h_pipeline_2^{log_n}"] = tms(lambda: k3.h_from_evals(a, b, c, log_n))
        if args.tiles and hasattr(k3, "PDL"):
            k3.PDL = False
            out[f"h_pipeline_2^{log_n}_no_pdl"] = tms(lambda: k3.h_from_evals(a, b, c, log_n))
            k3.PDL = True
        device.append((f"h_pipeline_2^{log_n}_ntt_device", lambda: k3.h_from_evals(a, b, c, log_n)))
    if hasattr(k3, "MAX_BATCH"):  # the batched transform, at the four-step shapes of 2^23 on 8 shards
        for lg, batch in ((12, 256), (11, 512)):
            xb = smoke.rand_elems(F.FR, batch << lg, gen).reshape(batch, 1 << lg, 8)
            key = f"ntt_batched_{batch}x2^{lg}"
            out[key] = tms(lambda: k3.transform(xb, lg, False))
            yb = k3.transform(xb, lg, False)
            out[f"{key}_passes"] = [ms(lambda: k3.run_pass(xb if p[0] == 0 else yb, yb, lg, *p, False), 10)
                                    for p in plan(k3, lg, batch)]
            if hasattr(k3, "run_rows"):  # K3b alone, into one buffer
                out[f"{key}_rows"] = ms(lambda: k3.run_rows(xb, yb, lg, False), 10)
            del xb, yb
        if args.ntt:
            from crypto3_fil_proofs_torch.ops.cuda import build

            out["ptxas"] = [line.strip() for name in ("ntt", "ntt_rows")
                            for line in build.ptxas_reports.get(name, "").splitlines()
                            if "registers" in line or "spill" in line or "Compiling entry" in line]
    if args.ntt:
        def bound(lg, batch):
            return smoke.bound_ms(2 * (batch << lg) * 32 + (1 << lg) // 2 * 32,
                                  batch * smoke.ntt_products(lg) * smoke.montmul_mads(F.FR.n32))

        out["bound_ms"] = {key: bound(lg, batch) for key, lg, batch in (
            *((f"ntt_2^{lg}", lg, 1) for lg in smoke.NTT_DOMAINS), ("ntt_batched_256x2^12", 12, 256),
            ("ntt_batched_512x2^11", 11, 512))}
        out["share"] = {key: b[0] / out[key] for key, b in out["bound_ms"].items()}
        if hasattr(k3, "run_rows"):
            # K3b alone by batch, [ms, share of the bound]: 132 / 264 rows fill one wave of one / two
            # blocks an SM; many waves show the rate once the blocks' loads, stores and barriers no
            # longer start together
            for lg, batches in ((11, (132, 264, 512, 528, 8448)), (12, (132, 256, 264, 4224))):
                for batch in batches:
                    xb = smoke.rand_elems(F.FR, batch << lg, gen).reshape(batch, 1 << lg, 8)
                    yb = k3.transform(xb, lg, False)
                    t = ms(lambda: k3.run_rows(xb, yb, lg, False), 10)
                    out[f"ntt_rows_{batch}x2^{lg}"] = [t, bound(lg, batch)[0] / t]
                    del xb, yb
        for key, fn in device:
            out[key] = smoke.k3_device_ms(fn, 10)
        print(json.dumps({"root": os.path.abspath(args.root), "ms": out}), flush=True)
        return 0
    out[f"fr_montmul_2^{log_n}"] = ms(lambda: k1.montmul(a, b), 20)
    out[f"fr_montmul_2^{log_n}_device"] = smoke.device_ms(lambda: k1.montmul(a, b), smoke.TRACE_NAMES["fr_montmul"])
    out[f"fr_sub_2^{log_n}"] = ms(lambda: k1.sub(a, b), 20)
    out[f"fr_sub_2^{log_n}_device"] = smoke.device_ms(lambda: k1.sub(a, b), smoke.TRACE_NAMES["fr_sub"])
    for arity, n, _ in smoke.k2_shapes():
        pre = smoke.rand_elems(F.FR, n * arity, gen).reshape(n, arity, 8)
        out[f"poseidon_a{arity}_{n}"] = ms(lambda: k2.poseidon_hash(pre, arity), args.reps)
        del pre
    if hasattr(k2, "witness"):  # K7, at phase 32's shapes and the paths' batch sizes
        for arity, n in smoke.WITNESS_SHAPES + smoke.WITNESS_PATH_SHAPES:
            out.update(witness_times(k2, gen, arity, n, args.reps))
    torch.cuda.empty_cache()
    for kern in (k4.K4, k5.K5):
        curve = kern.curve
        g = curve.name
        acc, q, valid = smoke.random_lanes(curve, kern, 1 << log_n, 7)
        out[f"{g}_madd_nodbl"] = ms(lambda: kern.madd_nodbl(acc, q, valid), 10)
        if "madd" in getattr(kern, "ops", ()):
            # q == acc on every 64th lane, as in chip_smoke.py
            q2 = q.clone()
            q2[::64] = curve.normalize(acc[::64])[0]
            out[f"{g}_madd"] = ms(lambda: kern.madd(acc, q2, valid), 10)
            del q2
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
        out[f"{g}_sum_points_{ones}"] = ms(lambda: M.sum_points(curve, pts[:ones]), args.reps)
        out[f"{g}_sum_points_{ones}_device"] = smoke.device_ms(lambda: M.sum_points(curve, pts[:ones]),
                                                                POINT_KERNELS[g], 10)
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
        # the stages' kernels alone, three readings (a trace can lose
        # events): the event times above carry the host's syncs and small
        # torch ops between launches
        e = "fq_t" if g == "g1" else "fq2_t"
        for stage, kernel, fn in (
            ("bucket_acc", "bucket_acc", lambda: bk.bucket_acc(pts, sched.order, sched.start, sched.length)),
            ("reduce", "bucket_reduce", lambda: M.reduce_buckets(bk, chunks, sched.chunk_ptr)),
            ("aggregate", "agg_level", lambda: M.aggregate(curve, buckets, windows, 1 << c)),
        ):
            out[f"msm_{g}_{stage}_device"] = [smoke.device_ms(fn, (f"void {kernel}_kernel<{e}>(",), 10)
                                              for _ in range(3)]
        del pts, limbs, sched, chunks, buckets
        torch.cuda.empty_cache()
    print(json.dumps({"root": os.path.abspath(args.root), "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
