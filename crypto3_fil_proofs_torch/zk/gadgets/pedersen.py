"""In-circuit Pedersen hash over Jubjub (legacy hasher's circuit half).

The reference's pedersen.hpp names the hasher but ships an empty stub
(reference: .../core/hasher/pedersen.hpp:27-34); the circuits that
would consume it (sapling-style fixed-base windowed scalar-mul) are
implemented here against our R1CS layer so the hasher has the same
vanilla+circuit coverage as Poseidon/SHA-256.

Construction (Zcash spec §5.4.1.7, §A.3.3.8): each 3-bit chunk
(s0, s1, s2) selects m = 1 + s0 + 2*s1 from a 4-entry precomputed table
of multiples (m * 2^(4j) * I_i, constants known at synthesis time) via a
2-bit lookup — coordinates stay *linear combinations*, costing one
constraint for the b0*b1 product — then s2 conditionally negates the x
coordinate (one product constraint). Points accumulate with complete
twisted Edwards addition (a = -1): six constraints per add, no
exceptional cases to analyze (unlike the Montgomery-ladder trick
sapling uses, completeness means chunk windows can sum in any order
with zero side conditions — the simpler circuit is the safer one and
the constraint count is irrelevant on this legacy path).

Copied from crypto3_fil_proofs_tpu/zk/gadgets/pedersen.py with its
imports rewritten.
"""
from __future__ import annotations

from ...ops.bls12_381 import R
from ...ops import pedersen as ped
from ..r1cs import ConstraintSystem, LinearCombination, lc_one
from .boolean import Boolean
from .num import AllocatedNum

_D = ped.D


def _window_tables(n_chunks: int):
    """Constant tables: tables[w][m] = (m+1) * 2^(4j) * I_i in affine
    Edwards coordinates, for chunk w = (segment i, offset j)."""
    tables = []
    for w in range(n_chunks):
        seg, j = divmod(w, ped.CHUNKS_PER_SEGMENT)
        base = ped.scalar_mul(1 << (4 * j), ped.pedersen_generator(seg))
        row, acc = [], base
        for _ in range(4):
            row.append(acc)
            acc = ped.add(acc, base)
        tables.append(row)
    return tables


def _lookup2(cs, b0: Boolean, b1: Boolean, consts: list[int]):
    """Linear part of the 2-bit lookup consts[b0 + 2*b1]: returns
    (lc, hi) where the full selection is lc + (b0*b1)*hi.

    x = c0 + b0*(c1-c0) + b1*(c2-c0) + b0*b1*(c3-c2-c1+c0) — linear in
    (1, b0, b1, b0*b1), so only the shared b0*b1 product costs a
    constraint (allocated once by the caller for both coordinates)."""
    c0, c1, c2, c3 = consts
    lc = LinearCombination.constant(c0)
    lc = lc + b0.lc((c1 - c0) % R)
    lc = lc + b1.lc((c2 - c0) % R)
    return lc, (c3 - c2 - c1 + c0) % R


def pedersen_hash_circuit(
    cs: ConstraintSystem, bits: list[Boolean], personalization=()
) -> AllocatedNum:
    """Synthesize PedersenHash(bits) and return the digest (Extract_J =
    x-coordinate) as an AllocatedNum. Mirrors ops.pedersen.pedersen_hash
    bit-for-bit (tests assert equality)."""
    m = list(personalization) + list(bits)
    if not m:
        m = [Boolean.const(False)]
    while len(m) % 3:
        m.append(Boolean.const(False))
    n_chunks = len(m) // 3
    tables = _window_tables(n_chunks)

    # accumulator starts at the identity (0, 1); complete addition makes
    # this safe with no special casing
    acc_x = AllocatedNum.alloc(cs, 0, "ped_acc_x0")
    acc_y = AllocatedNum.alloc(cs, 1, "ped_acc_y0")
    cs.enforce(acc_x.lc(), lc_one(), LinearCombination(), "ped_acc_x0_is_0")
    cs.enforce(acc_y.lc(), lc_one(), lc_one(), "ped_acc_y0_is_1")

    for w in range(n_chunks):
        b0, b1, b2 = m[3 * w], m[3 * w + 1], m[3 * w + 2]
        xs = [p[0] for p in tables[w]]
        ys = [p[1] for p in tables[w]]

        # shared 2-bit product
        pv = (b0.value * b1.value) % R
        prod = AllocatedNum.alloc(cs, pv, f"ped_prod_{w}")
        cs.enforce(b0.lc(), b1.lc(), prod.lc(), f"ped_prod_{w}")

        x_lc, x_hi = _lookup2(cs, b0, b1, xs)
        y_lc, y_hi = _lookup2(cs, b0, b1, ys)
        x_lc = x_lc + prod.lc(x_hi)
        y_lc = y_lc + prod.lc(y_hi)
        sel = b0.value + 2 * b1.value
        x_val, y_val = tables[w][sel]

        # conditional negation by s2: x' = x - 2*(s2*x)
        t_val = (b2.value * x_val) % R
        t = AllocatedNum.alloc(cs, t_val, f"ped_neg_{w}")
        cs.enforce(x_lc, b2.lc(), t.lc(), f"ped_neg_{w}")
        x_lc = x_lc - t.lc(2)
        if b2.value:
            x_val = (R - x_val) % R

        # complete Edwards add: acc = acc + (x_lc, y_lc)
        # T3 = x1*x2, T4 = y1*y2, T5 = T3*T4,
        # U = (x1+y1)*(x2+y2)  =>  T1+T2 = U - T3 - T4
        # x3 * (1 + d*T5) = U - T3 - T4 ;  y3 * (1 - d*T5) = T4 + T3
        x1v, y1v = acc_x.value, acc_y.value
        t3v = x1v * x_val % R
        t4v = y1v * y_val % R
        t5v = t3v * t4v % R
        uv = (x1v + y1v) * (x_val + y_val) % R
        t3 = AllocatedNum.alloc(cs, t3v, f"ped_t3_{w}")
        t4 = AllocatedNum.alloc(cs, t4v, f"ped_t4_{w}")
        t5 = AllocatedNum.alloc(cs, t5v, f"ped_t5_{w}")
        u = AllocatedNum.alloc(cs, uv, f"ped_u_{w}")
        cs.enforce(acc_x.lc(), x_lc, t3.lc(), f"ped_t3_{w}")
        cs.enforce(acc_y.lc(), y_lc, t4.lc(), f"ped_t4_{w}")
        cs.enforce(t3.lc(), t4.lc(), t5.lc(), f"ped_t5_{w}")
        cs.enforce(acc_x.lc() + acc_y.lc(), x_lc + y_lc, u.lc(), f"ped_u_{w}")

        dxy = _D * t5v % R
        x3v = (uv - t3v - t4v) * pow(1 + dxy, -1, R) % R
        y3v = (t4v + t3v) * pow((1 - dxy) % R, -1, R) % R
        x3 = AllocatedNum.alloc(cs, x3v, f"ped_x_{w}")
        y3 = AllocatedNum.alloc(cs, y3v, f"ped_y_{w}")
        cs.enforce(x3.lc(), lc_one() + t5.lc(_D), u.lc() - t3.lc() - t4.lc(), f"ped_x_{w}")
        cs.enforce(y3.lc(), lc_one() - t5.lc(_D), t4.lc() + t3.lc(), f"ped_y_{w}")
        acc_x, acc_y = x3, y3

    return acc_x
