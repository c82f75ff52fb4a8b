"""BLS12-381 host arithmetic: fields, curves, pairing, compression.

Copied from crypto3_fil_proofs_tpu/ops/bls12_381.py (host only; it
imports nothing of JAX). The port's kernels (csrc/), their plain
versions (ops/g1_torch.py, ops/g2_torch.py, ops/ntt.py, ops/msm.py) and
the Groth16 prover (zk/groth16.py) are checked against it; `verify`
uses its pairing.

- Field elements are plain Python ints (canonical residues).
- G1/G2 points use Jacobian coordinates (X, Y, Z); Z=0 is infinity.
- The pairing is the optimal ate pairing over the Fq2/Fq6/Fq12 tower.
"""
from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Field moduli and curve constants
# ---------------------------------------------------------------------------

# Base field Fq modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field Fr modulus (255 bits)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

FR_BITS = 255
FQ_BITS = 381
FR_BYTES = 32
FQ_BYTES = 48

# BLS parameter x (t): curve is parameterized by x = -0xd201000000010000
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

# Fr multiplicative group: r - 1 = 2^32 * t0; generator 7 is a primitive root.
FR_TWO_ADICITY = 32
FR_MULT_GEN = 7
# 2^32-th primitive root of unity in Fr: 7^((r-1)/2^32)
FR_ROOT_OF_UNITY = pow(FR_MULT_GEN, (R - 1) >> FR_TWO_ADICITY, R)

# G1 generator (affine)
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
# G2 generator (affine over Fq2, coordinates as (c0, c1))
G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# ---------------------------------------------------------------------------
# Fr / Fq scalar helpers
# ---------------------------------------------------------------------------


def fr_add(a: int, b: int) -> int:
    return (a + b) % R


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R


def fr_neg(a: int) -> int:
    return (-a) % R


def fr_inv(a: int) -> int:
    if a % R == 0:
        raise ZeroDivisionError("Fr inverse of zero")
    return pow(a, R - 2, R)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, R)


def fr_from_le_bytes(b: bytes) -> int:
    """Interpret 32 LE bytes as an Fr element; raises if >= modulus.

    Mirrors the reference's `as_safe_commitment` validity check
    (reference: libs/filecoin/.../api/utilities.hpp:34-39).
    """
    v = int.from_bytes(b, "little")
    if v >= R:
        raise ValueError("bytes do not encode a valid Fr element")
    return v


def fr_from_le_bytes_safe(b: bytes) -> int:
    """32 LE bytes -> Fr, masking the top two bits first.

    Mirrors `bytes_into_fr_repr_safe` / the label `&0x3F` masking
    (reference: .../stacked/vanilla/create_label.hpp:77,118).
    """
    masked = bytes(b[:31]) + bytes([b[31] & 0x3F])
    return int.from_bytes(masked, "little")


def fr_to_le_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "little")


def fq_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("Fq inverse of zero")
    return pow(a, P - 2, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p % 4 == 3 so a^((p+1)/4))."""
    r_ = pow(a, (P + 1) // 4, P)
    return r_ if (r_ * r_) % P == a % P else None


# ---------------------------------------------------------------------------
# G1 (Jacobian over Fq)
# ---------------------------------------------------------------------------

G1_INF = (1, 1, 0)


def g1_is_inf(p) -> bool:
    return p[2] == 0


def g1_from_affine(xy) -> tuple:
    if xy is None:
        return G1_INF
    return (xy[0], xy[1], 1)


def g1_to_affine(p):
    if p[2] == 0:
        return None
    zi = fq_inv(p[2])
    zi2 = (zi * zi) % P
    return ((p[0] * zi2) % P, (p[1] * zi2 * zi) % P)


def g1_double(p):
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return G1_INF if Y1 == 0 else p
    A = (X1 * X1) % P
    B = (Y1 * Y1) % P
    C = (B * B) % P
    D = (2 * ((X1 + B) * (X1 + B) - A - C)) % P
    E = (3 * A) % P
    F = (E * E) % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = (2 * Y1 * Z1) % P
    return (X3, Y3, Z3)


def g1_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = (Z1 * Z1) % P
    Z2Z2 = (Z2 * Z2) % P
    U1 = (X1 * Z2Z2) % P
    U2 = (X2 * Z1Z1) % P
    S1 = (Y1 * Z2 * Z2Z2) % P
    S2 = (Y2 * Z1 * Z1Z1) % P
    if U1 == U2:
        if S1 != S2:
            return G1_INF
        return g1_double(p)
    H = (U2 - U1) % P
    I = (4 * H * H) % P
    J = (H * I) % P
    r_ = (2 * (S2 - S1)) % P
    V = (U1 * I) % P
    X3 = (r_ * r_ - J - 2 * V) % P
    Y3 = (r_ * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % P
    Z3 = (Z3 * H) % P
    return (X3, Y3, Z3)


def g1_neg(p):
    if p[2] == 0:
        return p
    return (p[0], (-p[1]) % P, p[2])


def g1_mul(p, k: int):
    k %= R
    acc = G1_INF
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_double(p)
        k >>= 1
    return acc


def g1_eq(p, q) -> bool:
    if p[2] == 0 or q[2] == 0:
        return p[2] == q[2]
    Z1Z1 = (p[2] * p[2]) % P
    Z2Z2 = (q[2] * q[2]) % P
    if (p[0] * Z2Z2 - q[0] * Z1Z1) % P != 0:
        return False
    return (p[1] * q[2] * Z2Z2 - q[1] * p[2] * Z1Z1) % P == 0


def g1_is_on_curve(p) -> bool:
    if p[2] == 0:
        return True
    x, y = g1_to_affine(p)
    return (y * y - x * x * x - 4) % P == 0


def g1_msm_naive(points, scalars):
    """Reference MSM (for validating the Pippenger kernels)."""
    acc = G1_INF
    for pt, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(pt, s))
    return acc


# ---------------------------------------------------------------------------
# Fq2 / Fq6 / Fq12 tower (tuples of ints; functional style)
# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def fq2_sq(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def fq2_mul_scalar(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


def fq2_inv(a):
    d = fq_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, (-a[1] * d) % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
# Nonresidue xi = u + 1 used to build Fq6
XI = (1, 1)


def fq2_mul_xi(a):
    # (a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


# Fq6 = Fq2[v] / (v^3 - xi); element = (c0, c1, c2) of Fq2


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))), fq2_mul(a0, c0))
    ti = fq2_inv(t)
    return (fq2_mul(c0, ti), fq2_mul(c1, ti), fq2_mul(c2, ti))


FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)

# Fq12 = Fq6[w] / (w^2 - v); element = (c0, c1) of Fq6


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sq(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_inv(fq6_sub(fq6_mul(a0, a0), fq6_mul_by_v(fq6_mul(a1, a1))))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    if e < 0:
        a = fq12_inv(a)
        e = -e
    acc = FQ12_ONE
    while e:
        if e & 1:
            acc = fq12_mul(acc, a)
        a = fq12_sq(a)
        e >>= 1
    return acc


FQ12_ONE = (FQ6_ONE, FQ6_ZERO)

# Frobenius coefficients for Fq2: gamma = xi^((p-1)/k) powers.
_FROB_C1 = [pow((1 + 0), 1, P)]  # placeholder; computed below


def _fq2_pow(a, e: int):
    acc = FQ2_ONE
    while e:
        if e & 1:
            acc = fq2_mul(acc, a)
        a = fq2_sq(a)
        e >>= 1
    return acc


# Frobenius on Fq2: conjugation. On Fq6/Fq12 we use coefficient tables.
_FROB6_C1 = [_fq2_pow(XI, ((P**i - 1) // 3)) for i in range(6)]
_FROB6_C2 = [_fq2_pow(XI, ((2 * P**i - 2) // 3)) for i in range(6)]
_FROB12_C1 = [_fq2_pow(XI, ((P**i - 1) // 6)) for i in range(12)]


def fq6_frobenius(a, power: int):
    i = power % 6
    c0 = fq2_conj(a[0]) if power % 2 else a[0]
    c1 = fq2_conj(a[1]) if power % 2 else a[1]
    c2 = fq2_conj(a[2]) if power % 2 else a[2]
    return (c0, fq2_mul(c1, _FROB6_C1[i]), fq2_mul(c2, _FROB6_C2[i]))


def fq12_frobenius(a, power: int):
    i = power % 12
    c0 = fq6_frobenius(a[0], power)
    c1 = fq6_frobenius(a[1], power)
    c1 = tuple(fq2_mul(x, _FROB12_C1[i]) for x in c1)
    return (c0, c1)


# ---------------------------------------------------------------------------
# G2 (Jacobian over Fq2); curve y^2 = x^3 + 4(u+1)
# ---------------------------------------------------------------------------

G2_B = fq2_mul_scalar(XI, 4)
G2_INF = (FQ2_ONE, FQ2_ONE, FQ2_ZERO)


def g2_is_inf(p) -> bool:
    return p[2] == FQ2_ZERO


def g2_from_affine(xy):
    if xy is None:
        return G2_INF
    return (xy[0], xy[1], FQ2_ONE)


def g2_to_affine(p):
    if p[2] == FQ2_ZERO:
        return None
    zi = fq2_inv(p[2])
    zi2 = fq2_sq(zi)
    return (fq2_mul(p[0], zi2), fq2_mul(p[1], fq2_mul(zi2, zi)))


def g2_double(p):
    X1, Y1, Z1 = p
    if Z1 == FQ2_ZERO:
        return p
    if Y1 == FQ2_ZERO:
        return G2_INF
    A = fq2_sq(X1)
    B = fq2_sq(Y1)
    C = fq2_sq(B)
    D = fq2_mul_scalar(fq2_sub(fq2_sub(fq2_sq(fq2_add(X1, B)), A), C), 2)
    E = fq2_mul_scalar(A, 3)
    F = fq2_sq(E)
    X3 = fq2_sub(F, fq2_mul_scalar(D, 2))
    Y3 = fq2_sub(fq2_mul(E, fq2_sub(D, X3)), fq2_mul_scalar(C, 8))
    Z3 = fq2_mul_scalar(fq2_mul(Y1, Z1), 2)
    return (X3, Y3, Z3)


def g2_add(p, q):
    if p[2] == FQ2_ZERO:
        return q
    if q[2] == FQ2_ZERO:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = fq2_sq(Z1)
    Z2Z2 = fq2_sq(Z2)
    U1 = fq2_mul(X1, Z2Z2)
    U2 = fq2_mul(X2, Z1Z1)
    S1 = fq2_mul(fq2_mul(Y1, Z2), Z2Z2)
    S2 = fq2_mul(fq2_mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return G2_INF
        return g2_double(p)
    H = fq2_sub(U2, U1)
    I = fq2_mul_scalar(fq2_sq(H), 4)
    J = fq2_mul(H, I)
    r_ = fq2_mul_scalar(fq2_sub(S2, S1), 2)
    V = fq2_mul(U1, I)
    X3 = fq2_sub(fq2_sub(fq2_sq(r_), J), fq2_mul_scalar(V, 2))
    Y3 = fq2_sub(fq2_mul(r_, fq2_sub(V, X3)), fq2_mul_scalar(fq2_mul(S1, J), 2))
    Z3 = fq2_mul(fq2_sub(fq2_sub(fq2_sq(fq2_add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def g2_neg(p):
    return (p[0], fq2_neg(p[1]), p[2])


def g2_mul(p, k: int):
    k %= R
    acc = G2_INF
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_double(p)
        k >>= 1
    return acc


def g2_eq(p, q) -> bool:
    pa, qa = g2_to_affine(p), g2_to_affine(q)
    return pa == qa


def g2_is_on_curve(p) -> bool:
    if p[2] == FQ2_ZERO:
        return True
    x, y = g2_to_affine(p)
    return fq2_sub(fq2_sq(y), fq2_add(fq2_mul(fq2_sq(x), x), G2_B)) == FQ2_ZERO


# ---------------------------------------------------------------------------
# Pairing (optimal ate)
# ---------------------------------------------------------------------------


# The Miller loop below uses affine G2 arithmetic: one Fq2 inversion per
# step (~128 steps) is negligible for verification workloads and far easier
# to verify for correctness than fused Jacobian line formulas. Line
# evaluations embed into Fq12 with the D-type twist untwist map
# (x', y') -> (x'/w^2, y'/w^3) where w^2 = v, v^3 = xi = u+1.


def _line_eval(tq, q2, p_aff):
    """Line through tq and q2 (affine Fq2 points), evaluated at G1 point p.

    Returns a full Fq12 element. Handles tq == q2 (tangent).
    twist: E': y^2 = x^3 + 4(u+1). Untwist map: (x', y') -> (x'/w^2, y'/w^3).
    A line a*x + b*y + c = 0 on E' evaluated at untwisted P=(px, py) becomes
    a*px*w^2... — we embed G1 coords into Fq12 and do it naively, which is
    slow but obviously correct; verification does only ~256 of these.
    """
    (x1, y1), (x2, y2) = tq, q2
    px, py = p_aff
    if tq == q2:
        lam = fq2_mul(fq2_mul_scalar(fq2_sq(x1), 3), fq2_inv(fq2_mul_scalar(y1, 2)))
    elif x1 == x2:
        return None  # vertical line
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    # Line on E': y - y1 = lam (x - x1). Evaluated at untwisted-embedded P:
    # xP embeds as px * w^2, yP embeds as py * w^3 (D-twist, w^2 = v, v^3 = xi).
    # value = py * w^3 - y1 - lam * (px * w^2 - x1)
    #       = (lam*x1 - y1) + (-lam*px) w^2 + (py) w^3
    c0 = fq2_sub(fq2_mul(lam, x1), y1)  # coefficient of 1
    c2 = ((-lam[0] * px) % P, (-lam[1] * px) % P)  # coefficient of w^2 (= v)
    c3 = (py % P, 0)  # coefficient of w^3 (= v*w)
    # Assemble Fq12: (c0 + c2 v + 0 v^2) + (0 + c3 v + 0 v^2) w
    a = (c0, c2, FQ2_ZERO)
    b = (FQ2_ZERO, c3, FQ2_ZERO)
    return (a, b)


def _g2_affine_add(tq, q2):
    (x1, y1), (x2, y2) = tq, q2
    if tq == q2:
        lam = fq2_mul(fq2_mul_scalar(fq2_sq(x1), 3), fq2_inv(fq2_mul_scalar(y1, 2)))
    elif x1 == x2:
        return None
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sq(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(p_aff, q_aff):
    """Miller loop f_{|x|, Q}(P) for BLS12-381 (x negative handled by caller)."""
    t = q_aff
    f = FQ12_ONE
    bits = bin(BLS_X)[3:]  # skip leading 1
    for bit in bits:
        f = fq12_sq(f)
        line = _line_eval(t, t, p_aff)
        if line is not None:
            f = fq12_mul(f, line)
        t = _g2_affine_add(t, t)
        if bit == "1":
            line = _line_eval(t, q_aff, p_aff)
            if line is not None:
                f = fq12_mul(f, line)
            t = _g2_affine_add(t, q_aff)
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r).

    Easy part done with frobenius/conjugation; hard part via direct bigint
    exponentiation (host-only verification path, correctness over speed).
    """
    # easy part: f^(p^6 - 1) * ... -> f1 = conj(f) * inv(f); f2 = frob^2(f1)*f1
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))  # f^(p^6-1)
    f2 = fq12_mul(fq12_frobenius(f1, 2), f1)  # ^(p^2+1)
    hard_exp = (P**4 - P**2 + 1) // R
    return fq12_pow(f2, hard_exp)


def _as_g1_affine(p):
    """Accept a Jacobian (X, Y, Z) with int coords or affine (x, y)."""
    if len(p) == 3:
        return g1_to_affine(p)
    return p


def _as_g2_affine(q):
    """Accept a Jacobian (X, Y, Z) with Fq2 coords or affine (x, y)."""
    if len(q) == 3:
        return g2_to_affine(q)
    return q


def pairing(p, q):
    """e(P, Q) for P in G1, Q in G2 (Jacobian or affine). Returns Fq12."""
    p, q = _as_g1_affine(p), _as_g2_affine(q)
    if p is None or q is None:
        return FQ12_ONE
    f = miller_loop(p, q)
    if BLS_X_IS_NEG:
        f = fq12_conj(f)
    return final_exponentiation(f)


def multi_pairing(pairs) -> tuple:
    """Product of pairings e(Pi, Qi); shares the final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        p, q = _as_g1_affine(p), _as_g2_affine(q)
        if p is None or q is None:
            continue
        f = fq12_mul(f, miller_loop(p, q))
    if BLS_X_IS_NEG:
        f = fq12_conj(f)
    return final_exponentiation(f)


# ---------------------------------------------------------------------------
# Serialization (zcash/arkworks-compatible compressed form, for proof bytes)
# ---------------------------------------------------------------------------


def g1_to_compressed(p) -> bytes:
    """48-byte big-endian x with flag bits, zcash BLS12-381 wire format.

    Used for the 192-byte Groth16 proof serialization
    (reference: core/proof/multi_proof.hpp + SINGLE_PARTITION_PROOF_LEN=192,
    libs/filecoin/.../constants.hpp:93).
    """
    a = g1_to_affine(p)
    if a is None:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x, y = a
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80  # compressed flag
    if y > (P - 1) // 2:  # lexicographically largest y
        out[0] |= 0x20
    return bytes(out)


def g1_from_compressed(b: bytes):
    if len(b) != 48:
        raise ValueError("G1 compressed encoding must be 48 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("missing compression flag")
    if flags & 0x40:
        return G1_INF
    x = int.from_bytes(bytes([flags & 0x1F]) + b[1:], "big")
    y2 = (x * x * x + 4) % P
    y = fq_sqrt(y2)
    if y is None:
        raise ValueError("x not on curve")
    y_is_largest = y > (P - 1) // 2
    if bool(flags & 0x20) != y_is_largest:
        y = P - y
    pt = (x, y, 1)
    if not g1_is_on_curve(pt):
        raise ValueError("point not on curve")
    return pt


def g2_to_compressed(p) -> bytes:
    a = g2_to_affine(p)
    if a is None:
        out = bytearray(96)
        out[0] = 0xC0
        return bytes(out)
    (x0, x1), (y0, y1) = a
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= 0x80
    neg = fq2_neg((y0, y1))
    if (y1, y0) > (neg[1], neg[0]):  # lexicographically largest (c1, c0)
        out[0] |= 0x20
    return bytes(out)


def g2_from_compressed(b: bytes):
    if len(b) != 96:
        raise ValueError("G2 compressed encoding must be 96 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("missing compression flag")
    if flags & 0x40:
        return G2_INF
    x1 = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:96], "big")
    x = (x0, x1)
    y2 = fq2_add(fq2_mul(fq2_sq(x), x), G2_B)
    # sqrt in Fq2 via exponentiation: candidate = y2^((p^2+7)/16)? Use
    # the simple algorithm: a^((p^2+7)/16) doesn't apply; p^2 % 4 == 1.
    y = _fq2_sqrt(y2)
    if y is None:
        raise ValueError("x not on curve")
    neg = fq2_neg(y)
    y_is_largest = (y[1], y[0]) > (neg[1], neg[0])
    if bool(flags & 0x20) != y_is_largest:
        y = neg
    pt = (x, y, FQ2_ONE)
    if not g2_is_on_curve(pt):
        raise ValueError("point not on curve")
    return pt


def _fq2_sqrt(a):
    """Square root in Fq2 (p % 4 == 3 case, standard complex method)."""
    if a == FQ2_ZERO:
        return FQ2_ZERO
    a1 = _fq2_pow(a, (P - 3) // 4)
    alpha = fq2_mul(fq2_sq(a1), a)
    x0 = fq2_mul(a1, a)
    if alpha == (P - 1, 0):
        x = fq2_mul((0, 1), x0)  # i * x0
    else:
        b = _fq2_pow(fq2_add(FQ2_ONE, alpha), (P - 1) // 2)
        x = fq2_mul(b, x0)
    return x if fq2_sq(x) == a else None


__all__ = [k for k in dir() if not k.startswith("_")]
