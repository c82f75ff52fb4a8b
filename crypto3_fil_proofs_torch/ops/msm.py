"""Pippenger multi-scalar multiplication over BLS12-381 G1 and G2.

Counterpart of crypto3_fil_proofs_tpu/ops/msm.py (`_reslice_digits`
:133, `pick_buckets` :182) and ops/pallas/msm.py (bucket accumulation
:206, aggregation :367 / :438, `_sum_points` :525, `_combine_host`
:615), and of the density split of zk/groth16.py (:822-858, :943-979).

`msm(curve, points, scalars)` computes sum_i s_i P_i for affine points
in the working form (ops/g1_torch.py) and int32 [N, 8] canonical
scalars, on the device the tensors lie on:

1. density split: scalars 0 are dropped, the points with scalar 1 are
   summed by `sum_points` (a halving tree of K4/K5 launches), the rest
   go through Pippenger;
2. `schedule`: c-bit digits of every scalar, sorted by (window, digit)
   with torch.sort, and each bucket's run cut into chunks of at most
   CHUNK points;
3. the bucket stages of kernel K6 (ops/cuda/msm.py): chunk sums, bucket
   sums (`reduce_buckets`, in levels of at most REDUCE_GROUP chunks), and
   `aggregate` (sum_b b * S_b per window) in log2(buckets) levels that
   each halve the window, one thread per pair of entries;
4. the windows' totals are combined on the host (Horner over c
   doublings).

The result is a group element, so it is unique: the window size, the
chunking and the aggregation order are free. The plain versions of the
K6 stages live here (`*_plain`); the K6 wrapper runs them for CPU
tensors, so the same driver is the plain MSM on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .bls12_381 import G1_GEN, G2_GEN_X, G2_GEN_Y, R, g1_from_affine, g2_from_affine
from .cuda import g1 as k4
from .cuda import g2 as k5
from .cuda import msm as k6
from .g1_torch import G1, Curve
from .g2_torch import G2

CHUNK = 32  # most points one thread of the bucket pass walks
REDUCE_GROUP = 8  # most chunk sums one thread of the bucket reduction adds
AGG_GROUP = 2  # entries one aggregation thread combines per level


class Plain:
    """The plain versions behind the wrappers' interface, on any device:
    the plain MSM of `pippenger(..., plain=True)`, which the smoke run
    holds the kernels against on the card."""

    def __init__(self, curve: Curve):
        self.curve = curve

    def madd_nodbl(self, acc, q, valid):
        return self.curve.madd_nodbl_plain(acc, q, valid)

    def dbl(self, p, mask):
        return self.curve.dbl_plain(p, mask)

    def add(self, p, q):
        return self.curve.add_plain(p, q)

    def bucket_acc(self, pts, order, start, length):
        return bucket_acc_plain(self.curve, pts, order, start, length)

    def bucket_reduce(self, chunks, ptr):
        return bucket_reduce_plain(self.curve, chunks, ptr)

    def agg_level(self, s, t, group, want_s):
        return agg_level_plain(self.curve, s, t, group, want_s)


def kernels(curve: Curve, plain: bool = False):
    """(point kernels, bucket kernels) of a group: the wrappers, which
    run the plain versions for CPU tensors only, or `Plain`."""
    if plain:
        return Plain(curve), Plain(curve)
    return (k4.K4, k6.K6_G1) if curve is G1 else (k5.K5, k6.K6_G2)


def window_bits(n: int, bits: int = 255) -> int:
    """Window size c for n points of `bits`-bit scalars: the bucket adds
    (W n) and the aggregation adds (about 3 W 2^c) balance near
    2^c = n / 16. A top window of fewer than c / 2 bits would put every
    point into a few buckets, whose chunk sums are then reduced in serial
    levels: c narrows by one there (at 2^19 points and 254-255 bits, 13
    in place of 14, which measured faster for G1 and G2)."""
    c = max(2, min(16, n.bit_length() - 5))
    if c > 2 and 0 < bits % c < c // 2:
        c -= 1
    return c


def scalar_bits(scalars: torch.Tensor) -> int:
    """Bit length of the largest of int32 [N, 8] canonical scalars."""
    limbs = scalars.long() & 0xFFFFFFFF
    nz = (limbs != 0).any(0).nonzero()
    if nz.numel() == 0:
        return 0
    top = int(nz.max())
    return 32 * top + int(limbs[:, top].max()).bit_length()


def digits(scalars: torch.Tensor, c: int, windows: int) -> torch.Tensor:
    """int64 [W, N] c-bit windows of int32 [N, 8] scalars, ascending:
    window w holds bits [w c, w c + c), taken from the two 32-bit limbs
    it straddles (c <= 16 never straddles three)."""
    limbs = scalars.long() & 0xFFFFFFFF
    mask = (1 << c) - 1
    out = []
    for w in range(windows):
        lo = w * c
        li, off = lo // 32, lo % 32
        v = limbs[:, li] >> off
        if off + c > 32 and li + 1 < limbs.shape[1]:
            v = v | (limbs[:, li + 1] << (32 - off))
        out.append(v & mask)
    return torch.stack(out)


@dataclass
class Schedule:
    """Bucket b of window w is lane w * 2^c + b. Its points are
    order[starts[b] : starts[b] + count[b]], cut into the chunks
    chunk_ptr[b] .. chunk_ptr[b + 1] - 1; chunk i covers
    order[start[i] : start[i] + length[i]]."""

    order: torch.Tensor  # int32 [M], point index per nonzero digit
    start: torch.Tensor  # int32 [C]
    length: torch.Tensor  # int32 [C]
    chunk_ptr: torch.Tensor  # int32 [W * 2^c + 1]
    madds: int  # nonzero digits: the mixed adds the buckets need


def schedule(scalars: torch.Tensor, c: int, windows: int) -> Schedule:
    n = scalars.shape[0]
    lanes = windows << c
    d = digits(scalars, c, windows)
    key = d + (torch.arange(windows, device=d.device) << c)[:, None]
    key = torch.where(d == 0, lanes, key).reshape(-1)  # digit 0: no bucket
    # int32 keys (lanes < 2^31): fewer radix passes than int64 keys
    sorted_key, perm = torch.sort(key.to(torch.int32))
    m = int((sorted_key < lanes).sum())
    sorted_key = sorted_key[:m]
    counts = torch.bincount(sorted_key.long(), minlength=lanes)
    starts = torch.cumsum(counts, 0) - counts
    nch = (counts + CHUNK - 1) // CHUNK
    chunk_ptr = torch.cat([nch.new_zeros(1), torch.cumsum(nch, 0)])
    bucket = torch.repeat_interleave(torch.arange(lanes, device=d.device), nch)
    k = torch.arange(bucket.shape[0], device=d.device) - chunk_ptr[bucket]
    start = starts[bucket] + k * CHUNK
    length = torch.minimum(counts[bucket] - k * CHUNK, torch.full_like(k, CHUNK))
    i32 = lambda t: t.to(torch.int32).contiguous()
    return Schedule(i32(perm[:m] % n), i32(start), i32(length), i32(chunk_ptr), m)


# ---------------------------------------------------------------------------
# Plain versions of the K6 stages (csrc/msm.cu), over the plain curve ops
# ---------------------------------------------------------------------------


def _lanes(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def bucket_acc_plain(curve: Curve, pts, order, start, length) -> torch.Tensor:
    """Every chunk at once, one point of each per pass (the pass
    structure of the JAX package's `_bucket_accumulate_soa`)."""
    n = start.shape[0]
    acc = curve.infinity(n, pts.device)
    if n == 0:
        return acc
    start, length = start.long(), length.long()
    for s in range(int(length.max())):
        live = s < length
        q = pts[order.long()[torch.where(live, start + s, 0)]]
        acc, same = curve.madd_nodbl_plain(acc, q, live)
        if bool(same.any()):
            acc = curve.dbl_plain(acc, same)
    return acc


def bucket_reduce_plain(curve: Curve, chunks, ptr) -> torch.Tensor:
    ptr = ptr.long()
    nb, counts = ptr.shape[0] - 1, ptr[1:] - ptr[:-1]
    acc = curve.infinity(nb, chunks.device)
    for k in range(int(counts.max()) if nb else 0):
        live = k < counts
        q = chunks[torch.where(live, ptr[:-1] + k, 0)]
        acc = torch.where(_lanes(live, acc), curve.add_plain(acc, q) if k else q, acc)
    return acc


def agg_level_plain(curve: Curve, s, t, group: int, want_s: bool):
    """One aggregation level, in the kernel's order of operations: per
    group of entries S_0 .. S_{g-1} (and T_j), t' = sum_j j S_j (a running
    sum walked from the top) + sum_j T_j, s' = g * sum_j S_j (doublings)."""
    shape = (-1, group, 3) + curve.coord
    b = s.reshape(shape)
    run = curve.infinity(b.shape[0], s.device)
    acc = run.clone()
    for j in range(group - 1, 0, -1):
        run = curve.add_plain(run, b[:, j])
        acc = curve.add_plain(acc, run)
    run = curve.add_plain(run, b[:, 0])
    if t is not None:
        tb = t.reshape(shape)
        for j in range(group):
            acc = curve.add_plain(acc, tb[:, j])
    if not want_s:
        return acc, None
    every = torch.ones(run.shape[0], dtype=torch.bool, device=s.device)
    for _ in range(group.bit_length() - 1):
        run = curve.dbl_plain(run, every)
    return acc, run


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def reduce_buckets(bk, chunks: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Bucket sums from chunk sums (bucket b owns chunks[ptr[b]:ptr[b+1]]).
    One thread sums at most REDUCE_GROUP chunks, so a bucket with more (the
    few buckets of a top window that holds only the scalars' last bits,
    or repeated scalars) is reduced in levels, one launch each: groups of
    REDUCE_GROUP consecutive chunks of a bucket become one, until every
    bucket has at most REDUCE_GROUP left. A level's time is the serial
    adds of its longest thread, so the groups are short."""
    while True:
        counts = (ptr[1:] - ptr[:-1]).long()
        if int(counts.max()) <= REDUCE_GROUP:
            return bk.bucket_reduce(chunks, ptr)
        groups = (counts + REDUCE_GROUP - 1) // REDUCE_GROUP
        bucket = torch.repeat_interleave(torch.arange(counts.shape[0], device=ptr.device), groups)
        first = torch.cat([groups.new_zeros(1), torch.cumsum(groups, 0)])
        k = torch.arange(bucket.shape[0], device=ptr.device) - first[bucket]
        starts = ptr.long()[bucket] + k * REDUCE_GROUP  # groups tile the chunks in order
        chunks = bk.bucket_reduce(chunks, torch.cat([starts, ptr[-1:].long()]).to(torch.int32))
        ptr = first.to(torch.int32)


def aggregate(curve: Curve, buckets: torch.Tensor, windows: int, nb: int, plain: bool = False) -> torch.Tensor:
    """sum_b b * S_b for each window of nb buckets ([W * nb] -> [W]).
    Each level keeps sum_t t S_t + sum_t T_t of a window while halving it
    (AGG_GROUP = 2): T'_u = S_2u+1 + T_2u + T_2u+1, S'_u = 2 (S_2u + S_2u+1),
    from T = 0, until one entry is left, whose T is the window's total."""
    _, bk = kernels(curve, plain)
    s, t = buckets.contiguous(), None
    while nb > 1:
        group = min(AGG_GROUP, nb)
        nb //= group
        t, s = bk.agg_level(s, t, group, nb > 1)
    return t if t is not None else curve.infinity(windows, buckets.device)


def sum_points(curve: Curve, aff: torch.Tensor) -> torch.Tensor:
    """Sum of affine points [n, 2, ...] as one Jacobian point [1, 3, ...]:
    the two halves are paired by a mixed add (doubling where equal), then
    the sums halve by full adds (infinity pads an odd count)."""
    pk, _ = kernels(curve)
    n = aff.shape[0]
    if n == 0:
        return curve.infinity(1, aff.device)
    h = n // 2
    acc = curve.lift(aff[:h])
    if h:
        acc, same = pk.madd_nodbl(acc, aff[h : 2 * h].contiguous(),
                                  torch.ones(h, dtype=torch.bool, device=aff.device))
        if bool(same.any()):
            acc = pk.dbl(acc, same)
    if n % 2:
        acc = torch.cat([acc, curve.lift(aff[2 * h :])])
    return fold(curve, acc)


def fold(curve: Curve, acc: torch.Tensor) -> torch.Tensor:
    """The sum of Jacobian points [n, 3, ...] as [1, 3, ...]: a halving
    tree of full adds (infinity pads an odd count)."""
    pk, _ = kernels(curve)
    while acc.shape[0] > 1:
        if acc.shape[0] % 2:
            acc = torch.cat([acc, curve.infinity(1, acc.device)])
        h = acc.shape[0] // 2
        acc = pk.add(acc[:h].contiguous(), acc[h:].contiguous())
    return acc


def combine_host(curve: Curve, totals: list, c: int):
    """sum_w 2^(c w) T_w on the host, windows ascending (Horner)."""
    res = curve.host_inf
    for w in range(len(totals) - 1, -1, -1):
        if w != len(totals) - 1:
            for _ in range(c):
                res = curve.host_double(res)
        res = curve.host_add(res, totals[w])
    return res


def pippenger(curve: Curve, aff: torch.Tensor, scalars: torch.Tensor, c: int | None = None,
              plain: bool = False):
    """Windowed bucket MSM of affine points [N, 2, ...] and int32 [N, 8]
    scalars. Returns (the per-window totals [W, 3, ...], c)."""
    _, bk = kernels(curve, plain)
    bits = scalar_bits(scalars)
    c = c or window_bits(aff.shape[0], bits)
    windows = max(1, -(-bits // c))
    sched = schedule(scalars, c, windows)
    chunks = bk.bucket_acc(aff.contiguous(), sched.order, sched.start, sched.length)
    buckets = reduce_buckets(bk, chunks, sched.chunk_ptr)
    return aggregate(curve, buckets, windows, 1 << c, plain), c


def msm(curve: Curve, aff: torch.Tensor, scalars: torch.Tensor, c: int | None = None):
    """sum_i s_i P_i as a host Jacobian point (ops/bls12_381.py form)."""
    if aff.shape[0] != scalars.shape[0]:
        raise ValueError("one scalar per point")
    is_zero = (scalars == 0).all(1)
    is_one = (scalars[:, 0] == 1) & (scalars[:, 1:] == 0).all(1)
    acc = curve.host_inf
    ones = is_one.nonzero().flatten()
    if ones.numel():
        acc = curve.host_add(acc, curve.host_point(sum_points(curve, aff[ones])))
    rest = (~is_zero & ~is_one).nonzero().flatten()
    if rest.numel():
        totals, c = pippenger(curve, aff[rest], scalars[rest], c)
        acc = curve.host_add(acc, combine_host(curve, curve.points_from_device(totals), c))
    return acc


def random_walk_bases(curve: Curve, count: int, seed: int):
    """`count` distinct points with known discrete logs, by the random
    walk of the JAX package's `random_bench_input` (ops/msm.py:241-262):
    P <- P + G or 2P + G. Returns (host points, their logs mod r)."""
    gen = g1_from_affine(G1_GEN) if curve is G1 else g2_from_affine((G2_GEN_X, G2_GEN_Y))
    rng = np.random.default_rng(seed)
    p, k, pts, logs = gen, 1, [], []
    for _ in range(count):
        if rng.integers(2):
            p, k = curve.host_add(p, gen), k + 1
        else:
            p, k = curve.host_add(curve.host_double(p), gen), 2 * k + 1
        pts.append(p)
        logs.append(k % R)
    return pts, logs
