"""The plain versions of kernels K4 (G1) and K5 (G2), the entry points of
ops/cuda/{g1,g2}.py on CPU tensors (madd_nodbl, madd, dbl, add), against the JAX package's host curve
arithmetic (ops/bls12_381.py `g1_add`/`g2_add`/doubling), normalized to
affine, on a 64-lane batch with every edge case; and the `same` and
infinity flags as ops/pallas/g1.py (:418-459) defines them.

The JAX package's jitted curve code and its Pallas interpret mode are
not run here (their XLA:CPU compiles take minutes). Inputs are made with
numpy from a seed; the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu.ops import bls12_381 as JB
from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
from crypto3_fil_proofs_torch.ops.cuda import g2 as k5
from crypto3_fil_proofs_torch.ops.g1_torch import G1
from crypto3_fil_proofs_torch.ops.g2_torch import G2

torch.set_num_threads(1)

LANES = 64
# lanes with an edge case; every other lane is a generic pair
INF_ACC, SAME, NEG, MASKED, INF_MASKED, INF_Q = 0, 1, 2, 3, 4, 5

CASES = {
    "g1": (G1, k4, JB.g1_add, JB.g1_double, JB.g1_neg, JB.g1_to_affine,
           JB.g1_from_affine(JB.G1_GEN), JB.G1_INF),
    "g2": (G2, k5, JB.g2_add, JB.g2_double, JB.g2_neg, JB.g2_to_affine,
           JB.g2_from_affine((JB.G2_GEN_X, JB.G2_GEN_Y)), JB.G2_INF),
}


def _jacobian(curve, pts):
    """Host Jacobian points -> int32 [N, 3, ...] Montgomery, Z kept."""
    coords = [c for p in pts for c in p]
    return curve.encode_coords(coords).reshape((len(pts), 3) + curve.coord)


def _batch(name, seed):
    """acc (Jacobian, Z != 1 on generic lanes), q (affine) host points."""
    curve, _, add, dbl, neg, _, gen, inf = CASES[name]
    rng = np.random.default_rng(seed)
    walk, p = [], gen
    for _ in range(2 * LANES):
        p = add(p, gen) if rng.integers(2) else add(dbl(p), gen)
        walk.append(p)
    two = dbl(gen)
    acc = [add(walk[2 * i], two) for i in range(LANES)]  # Jacobian, Z != 1
    q = [walk[2 * i + 1] for i in range(LANES)]
    acc[INF_ACC] = inf
    acc[INF_MASKED] = inf
    q[SAME] = acc[SAME]
    q[NEG] = neg(acc[NEG])
    return acc, q


def _rescale(name, p, lam=7):
    """The same point with Z multiplied by lam: (X l^2, Y l^3, Z l)."""
    if name == "g1":
        return (p[0] * lam**2 % JB.P, p[1] * lam**3 % JB.P, p[2] * lam % JB.P)
    return tuple(JB.fq2_mul_scalar(c, lam**k) for c, k in zip(p, (2, 3, 1)))


def _affine(name, pts):
    to_affine = CASES[name][5]
    return [to_affine(p) for p in pts]


@pytest.mark.parametrize("name", sorted(CASES))
def test_madd_nodbl_and_dbl_match_host(name, rng_seed):
    curve, kern, add, dbl, *_ = CASES[name]
    acc_h, q_h = _batch(name, rng_seed)
    acc = _jacobian(curve, acc_h)
    q, _ = curve.points_to_device(q_h)
    valid = torch.ones(LANES, dtype=torch.bool)
    valid[[MASKED, INF_MASKED]] = False
    out, same = kern.madd_nodbl(acc, q, valid)
    # `same` flags exactly the valid P == Q lane, which keeps P
    assert same.nonzero().flatten().tolist() == [SAME]
    assert torch.equal(out[SAME], acc[SAME])
    # masked lanes keep the accumulator bit for bit, at infinity too
    assert torch.equal(out[[MASKED, INF_MASKED]], acc[[MASKED, INF_MASKED]])
    # an accumulator at infinity lifts q with Z = 1 (Montgomery)
    assert torch.equal(out[INF_ACC], curve.lift(q[INF_ACC : INF_ACC + 1])[0])
    # P == -Q is infinity
    assert curve.points_from_device(out[NEG : NEG + 1])[0][2] == curve.host_inf[2]
    got = _affine(name, curve.points_from_device(out))
    for i in range(LANES):
        if i in (SAME, MASKED, INF_MASKED):
            want = acc_h[i]
        else:
            want = add(acc_h[i], q_h[i])
        assert got[i] == _affine(name, [want])[0], i
    # the caller doubles the flagged lane: 2P there, nothing elsewhere
    doubled = kern.dbl(out, same)
    assert torch.equal(doubled[~same], out[~same])
    assert _affine(name, curve.points_from_device(doubled[SAME : SAME + 1]))[0] == \
        _affine(name, [dbl(acc_h[SAME])])[0]
    assert _affine(name, curve.points_from_device(doubled)) == \
        _affine(name, [add(acc_h[i], q_h[i]) if i not in (MASKED, INF_MASKED) else acc_h[i]
                       for i in range(LANES)])


@pytest.mark.parametrize("name", ["g1"])
def test_madd_matches_host(name, rng_seed):
    """madd (ops/pallas/g1.py `madd_soa`, G1 only): the mixed add with its
    doubling path, on the edge lanes of the madd_nodbl case."""
    curve, kern, add, dbl, *_ = CASES[name]
    acc_h, q_h = _batch(name, rng_seed + 3)
    acc = _jacobian(curve, acc_h)
    q, _ = curve.points_to_device(q_h)
    valid = torch.ones(LANES, dtype=torch.bool)
    valid[[MASKED, INF_MASKED]] = False
    out = kern.madd(acc, q, valid)
    # masked lanes keep the accumulator bit for bit, at infinity too
    assert torch.equal(out[[MASKED, INF_MASKED]], acc[[MASKED, INF_MASKED]])
    # an accumulator at infinity lifts q with Z = 1 (Montgomery)
    assert torch.equal(out[INF_ACC], curve.lift(q[INF_ACC : INF_ACC + 1])[0])
    # P == -Q is infinity; P == Q is the doubling's bits
    assert curve.points_from_device(out[NEG : NEG + 1])[0][2] == curve.host_inf[2]
    every = torch.ones(1, dtype=torch.bool)
    assert torch.equal(out[SAME : SAME + 1], kern.dbl(acc[SAME : SAME + 1], every))
    got = _affine(name, curve.points_from_device(out))
    want = [acc_h[i] if i in (MASKED, INF_MASKED) else add(acc_h[i], q_h[i]) for i in range(LANES)]
    assert got == _affine(name, want)
    assert _affine(name, [want[SAME]]) == _affine(name, [dbl(acc_h[SAME])])


@pytest.mark.parametrize("name", sorted(CASES))
def test_add_matches_host(name, rng_seed):
    curve, kern, add, _, neg, _, _, inf = CASES[name]
    acc_h, q_h = _batch(name, rng_seed + 1)
    p_h = list(acc_h)
    r_h = [_rescale(name, q) for q in q_h]  # Jacobian, Z = 7
    r_h[INF_Q] = inf
    r_h[INF_MASKED] = inf  # both at infinity
    r_h[SAME] = _rescale(name, p_h[SAME])  # P == Q in another representation
    r_h[NEG] = neg(p_h[NEG])
    p, r = _jacobian(curve, p_h), _jacobian(curve, r_h)
    out = kern.add(p, r)
    got = _affine(name, curve.points_from_device(out))
    assert got == _affine(name, [add(a, b) for a, b in zip(p_h, r_h)])
    # an operand at infinity passes the other through bit for bit
    assert torch.equal(out[INF_ACC], r[INF_ACC])
    assert torch.equal(out[INF_Q], p[INF_Q])
    assert curve.points_from_device(out[NEG : NEG + 1])[0][2] == curve.host_inf[2]


@pytest.mark.parametrize("name", sorted(CASES))
def test_normalize_matches_host_staging(name, rng_seed):
    """Batch normalization (one host inversion) stages Jacobian points as
    the host's points_to_device does, infinity as x = y = 0."""
    curve = CASES[name][0]
    acc_h, _ = _batch(name, rng_seed + 2)
    aff, valid = curve.normalize(_jacobian(curve, acc_h))
    want, want_valid = curve.points_to_device(acc_h)
    assert torch.equal(aff, want) and torch.equal(valid, want_valid)
    assert not bool(valid[INF_ACC]) and bool(valid.sum() == LANES - 2)


def test_entry_points_refuse_mixed_devices():
    a = G1.infinity(4, "cpu")
    with pytest.raises(ValueError):
        k4.add(a, a.to("meta"))
    with pytest.raises(ValueError):
        k5.dbl(G2.infinity(4, "meta"), torch.ones(4, dtype=torch.bool, device="meta"))
