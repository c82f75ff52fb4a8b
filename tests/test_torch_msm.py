"""The port's Pippenger MSM on CPU tensors (ops/msm.py driving the plain
versions of kernels K4/K5/K6) against the JAX package's host curve
arithmetic (ops/bls12_381.py): G1 and G2, two window sizes each, with
scalars 0, 1 and r - 1 and repeated bases (collisions inside buckets).
Inputs are made with numpy from a seed; the tolerance is exact equality
of the affine result.
"""
import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu.ops import bls12_381 as JB
from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops import msm as M
from crypto3_fil_proofs_torch.ops.g1_torch import G1
from crypto3_fil_proofs_torch.ops.g2_torch import G2

torch.set_num_threads(1)

GROUPS = {
    "g1": (G1, JB.g1_from_affine(JB.G1_GEN), JB.g1_mul, JB.g1_add, JB.g1_to_affine, JB.G1_INF),
    "g2": (G2, JB.g2_from_affine((JB.G2_GEN_X, JB.G2_GEN_Y)), JB.g2_mul, JB.g2_add,
           JB.g2_to_affine, JB.G2_INF),
}


def _inputs(curve, n, distinct, seed):
    """n points tiled from `distinct` bases of known log, and n scalars:
    uniform in [0, r), then 0, 1, r - 1, and 1 or 2 on a quarter each."""
    bases, logs = M.random_walk_bases(curve, distinct, seed)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    scalars = [int.from_bytes(r.tobytes(), "little") % JB.R for r in raw]
    for i in range(0, n, 4):
        scalars[i] = 1
    for i in range(1, n, 8):
        scalars[i] = 2
    scalars[:3] = [0, 1, JB.R - 1]
    idx = [i % distinct for i in range(n)]
    return [bases[i] for i in idx], [logs[i] for i in idx], scalars


@pytest.mark.parametrize(
    "name,n,c",
    [("g1", 64, 3), ("g1", 64, 4), ("g2", 64, 2), ("g2", 64, 3)],
)
def test_msm_matches_host_sum(name, n, c, rng_seed):
    curve, gen, mul, add, to_affine, inf = GROUPS[name]
    pts, logs, scalars = _inputs(curve, n, 16, rng_seed + n + c)
    aff, valid = curve.points_to_device(pts)
    assert bool(valid.all())
    got = M.msm(curve, aff, F.ints_to_limbs32(scalars), c)
    if name == "g1":  # the host sum itself
        want = JB.g1_msm_naive(pts, scalars)
    else:  # the same element through the known logs (one host product)
        want = mul(gen, sum(s * k for s, k in zip(scalars, logs)) % JB.R)
    assert to_affine(got) == to_affine(want)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_density_split_sums_the_ones(name, rng_seed):
    """sum_points (the scalar-1 class) equals the host sum of its points,
    doubling where a point meets itself; an MSM of scalars 0 and 1 only
    is that sum."""
    curve, _, _, add, to_affine, inf = GROUPS[name]
    pts, _, _ = _inputs(curve, 21, 8, rng_seed)
    aff, _ = curve.points_to_device(pts)
    want = inf
    for p in pts:
        want = add(want, p)
    assert to_affine(curve.host_point(M.sum_points(curve, aff))) == to_affine(want)
    scalars = [1] * 21
    scalars[5] = 0
    got = M.msm(curve, aff, F.ints_to_limbs32(scalars))
    want = inf
    for p, s in zip(pts, scalars):
        want = add(want, p) if s else want
    assert to_affine(got) == to_affine(want)


def test_crowded_buckets_reduce_in_levels(monkeypatch, rng_seed):
    """A bucket with more chunks than one thread sums (here CHUNK = 2,
    REDUCE_GROUP = 2 and 24 equal scalars in one bucket) is reduced in
    levels."""
    monkeypatch.setattr(M, "CHUNK", 2)
    monkeypatch.setattr(M, "REDUCE_GROUP", 2)
    curve, gen, mul, *_ = GROUPS["g1"]
    pts, logs, scalars = _inputs(curve, 32, 8, rng_seed)
    scalars[:24] = [5] * 24
    aff, _ = curve.points_to_device(pts)
    s = F.ints_to_limbs32(scalars)
    sched = M.schedule(s, 3, -(-M.scalar_bits(s) // 3))
    assert int((sched.chunk_ptr[1:] - sched.chunk_ptr[:-1]).max()) > 2 * M.CHUNK
    got = M.msm(curve, aff, s, 3)
    want = mul(gen, sum(k * x for k, x in zip(scalars, logs)) % JB.R)
    assert JB.g1_to_affine(got) == JB.g1_to_affine(want)


def test_schedule_covers_every_nonzero_digit(rng_seed):
    _, _, scalars = _inputs(G1, 64, 8, rng_seed)
    s = F.ints_to_limbs32(scalars)
    c = 5
    windows = -(-M.scalar_bits(s) // c)
    d = M.digits(s, c, windows)
    sched = M.schedule(s, c, windows)
    assert sched.madds == int((d != 0).sum())
    assert int(sched.length.sum()) == sched.madds
    assert int(sched.length.max()) <= M.CHUNK
    # the windows rebuild every scalar
    rebuilt = [sum(int(d[w, i]) << (c * w) for w in range(windows)) for i in range(64)]
    assert rebuilt == scalars


@pytest.mark.parametrize("name,c", [("g1", 3), ("g1", 4), ("g2", 2)])
def test_aggregate_matches_host_weighted_sum(name, c, rng_seed):
    """The aggregation levels (plain) give sum_b b S_b of every window,
    with empty buckets (infinity) among them and one window all infinity."""
    curve, gen, mul, _, to_affine, inf = GROUPS[name]
    windows, nb = 3, 1 << c
    pts, logs = M.random_walk_bases(curve, windows * nb, rng_seed + c)
    empty = set(range(0, windows * nb, 3)) | set(range(2 * nb, 3 * nb))
    pts = [inf if i in empty else p for i, p in enumerate(pts)]
    buckets = curve.encode_coords([x for p in pts for x in p]).reshape((windows * nb, 3) + curve.coord)
    got = curve.points_from_device(M.aggregate(curve, buckets, windows, nb, plain=True))
    for w in range(windows):
        k = sum(b * logs[w * nb + b] for b in range(nb) if w * nb + b not in empty) % JB.R
        want = mul(gen, k) if k else inf
        assert to_affine(got[w]) == to_affine(want), w
