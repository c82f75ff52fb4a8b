"""In-circuit Poseidon matching ops/poseidon.py bit-exactly.

Replaces the reference's consumed `hash2_circuit` / POSEIDON_CONSTANTS
blueprint components (reference: stacked/circuit/hash.hpp:42-56 hashes
columns in-circuit with arity 2/11 constants; circuit/column.hpp:41-100).

Linear layers (round-constant add, MDS mix) are folded into the linear
combinations — only the x^5 S-boxes allocate variables (3 constraints
each), so a t=9 hash costs 3*(t*R_F + R_P) + 1 constraints.

Copied from crypto3_fil_proofs_tpu/zk/gadgets/poseidon.py with its imports rewritten.
"""
from __future__ import annotations

from ...ops.bls12_381 import R
from ...ops.poseidon import poseidon_constants
from ..r1cs import ConstraintSystem, LinearCombination, lc_one
from .num import AllocatedNum


def _sbox(cs, lc: LinearCombination, value: int):
    """x -> x^5 with 3 constraints; returns (lc', value')."""
    v2 = (value * value) % R
    x2 = cs.alloc(v2, "sbox_x2")
    cs.enforce(lc, lc, LinearCombination.from_var(x2), "x2")
    v4 = (v2 * v2) % R
    x4 = cs.alloc(v4, "sbox_x4")
    cs.enforce(
        LinearCombination.from_var(x2),
        LinearCombination.from_var(x2),
        LinearCombination.from_var(x4),
        "x4",
    )
    v5 = (v4 * value) % R
    x5 = cs.alloc(v5, "sbox_x5")
    cs.enforce(LinearCombination.from_var(x4), lc, LinearCombination.from_var(x5), "x5")
    return LinearCombination.from_var(x5), v5


def poseidon_hash_circuit(
    cs: ConstraintSystem, preimage: list[AllocatedNum], arity: int | None = None
) -> AllocatedNum:
    """Hash `arity` AllocatedNums to one (Merkle domain tag), returning
    the digest as an AllocatedNum. Matches ops/poseidon.poseidon_hash."""
    if arity is None:
        arity = len(preimage)
    assert len(preimage) == arity
    from ...ops.poseidon import optimized_partial_schedule

    consts = poseidon_constants(arity)
    t, rc, mds = consts.t, consts.round_constants, consts.mds
    # sparse partial-round schedule (ops/poseidon.py appendix-B
    # factorization): the folded linear layers compose to the SAME
    # final LC coefficients, so the emitted R1CS is unchanged — but
    # mix work drops from t^2 to 2t-1 LC-accumulates per partial round
    c_prime, m00s, vs, w_hats, d_last = optimized_partial_schedule(arity)

    lcs = [LinearCombination.constant(consts.domain_tag)] + [
        n.lc() for n in preimage
    ]
    vals = [consts.domain_tag] + [n.value for n in preimage]
    c = 0
    half_f = consts.r_f // 2

    def add_rc(row=None):
        nonlocal c
        src = rc[c : c + t] if row is None else row
        for i in range(t):
            lcs[i] = lcs[i] + src[i]
            vals[i] = (vals[i] + src[i]) % R
        c += t

    def _accum(acc: dict, terms: dict, k: int):
        get = acc.get
        for var, co in terms.items():
            acc[var] = get(var, 0) + co * k

    def _from_acc(acc: dict) -> LinearCombination:
        return LinearCombination.from_terms(
            {v: co % R for v, co in acc.items()}
        )

    def mat_mix(mat):
        new_lcs, new_vals = [], []
        for i in range(t):
            acc: dict = {}
            acc_v = 0
            row = mat[i]
            for j in range(t):
                _accum(acc, lcs[j].terms, row[j])
                acc_v += row[j] * vals[j]
            new_lcs.append(_from_acc(acc))
            new_vals.append(acc_v % R)
        lcs[:], vals[:] = new_lcs, new_vals

    for _ in range(half_f):
        add_rc()
        for i in range(t):
            lcs[i], vals[i] = _sbox(cs, lcs[i], vals[i])
        mat_mix(mds)
    for k in range(consts.r_p):
        add_rc(c_prime[k])
        lcs[0], vals[0] = _sbox(cs, lcs[0], vals[0])
        # sparse mix E_k: out0 = m00*x0 + sum v_j x_{j+1};
        # out_i = w_hat_i*x0 + x_i
        acc: dict = {}
        _accum(acc, lcs[0].terms, m00s[k])
        out0_v = m00s[k] * vals[0]
        for j in range(t - 1):
            _accum(acc, lcs[j + 1].terms, vs[k][j])
            out0_v += vs[k][j] * vals[j + 1]
        new_lcs = [_from_acc(acc)]
        new_vals = [out0_v % R]
        for i in range(t - 1):
            acc_i: dict = dict(lcs[i + 1].terms)
            _accum(acc_i, lcs[0].terms, w_hats[k][i])
            new_lcs.append(_from_acc(acc_i))
            new_vals.append((w_hats[k][i] * vals[0] + vals[i + 1]) % R)
        lcs[:], vals[:] = new_lcs, new_vals
    mat_mix(d_last)
    for _ in range(half_f):
        add_rc()
        for i in range(t):
            lcs[i], vals[i] = _sbox(cs, lcs[i], vals[i])
        mat_mix(mds)

    out = AllocatedNum.alloc(cs, vals[1], "poseidon_digest")
    cs.enforce(lcs[1] - out.lc(), lc_one(), LinearCombination(), "digest")
    return out


def hash2_circuit(cs, a: AllocatedNum, b: AllocatedNum) -> AllocatedNum:
    """comm_r = H2(comm_c, comm_r_last) in-circuit
    (reference: stacked/circuit/proof.hpp comm_r == H2 constraint)."""
    return poseidon_hash_circuit(cs, [a, b], 2)
