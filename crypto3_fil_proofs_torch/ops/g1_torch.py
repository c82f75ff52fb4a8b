"""BLS12-381 G1 in Jacobian coordinates on tensors: the plain versions of
kernel K4, and the curve-generic formulas that G2 shares.

Counterpart of crypto3_fil_proofs_tpu/ops/g1_jax.py (formulas, infinity,
`points_to_device` / `points_from_device`) and of the kernel bodies of
ops/pallas/g1.py (`_madd_kernel_u` :328, `_madd_nodbl_kernel_u` :418,
`_dbl_kernel_u` :462, `_add_kernel_u` :373), whose edge semantics the
port keeps exactly:

- infinity is Z = 0 (X and Y are whatever the formula left there);
- an accumulator at infinity lifts q with Z = 1 (Montgomery form);
- P == -Q gives infinity;
- in `madd_nodbl`, a lane with P == Q keeps P and is flagged `same`, for
  the caller to double; a lane with valid = 0 keeps P;
- `madd` doubles where P == Q (otherwise it is `madd_nodbl`);
- `add` doubles where P == Q and passes the other operand through where
  one of them is infinity.

Formulas: madd-2007-bl (7M + 4S), dbl-2009-l (2M + 5S), add-2007-bl
(11M + 5S), over the Montgomery field ops of ops/field.py.

Points in the working form are int32 tensors of 32-bit limbs: affine
[N, 2, 12] (x, y) and Jacobian [N, 3, 12] (X, Y, Z), Montgomery form;
the plain formulas run on int64 16-bit limbs ([..., 24] per element).
`Curve` bundles what the kernel wrappers and the MSM need of a group;
ops/g2_torch.py builds the G2 instance over Fq2.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache

import torch

from . import bls12_381 as B
from . import field as F

FQ = F.FQ
P = FQ.modulus
R_INV = pow(FQ.mont_r, -1, P)


@lru_cache(maxsize=None)
def _one16(device: str) -> torch.Tensor:
    return F._limbs_const(FQ.mont_r, FQ.n16, device)


class FqOps:
    """Plain Fq on int64 [..., 24]."""

    @staticmethod
    def mul(a, b):
        return F.mont_mul(a, b, FQ)

    @staticmethod
    def add(a, b):
        return F.add(a, b, FQ)

    @staticmethod
    def sub(a, b):
        return F.sub(a, b, FQ)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)

    @staticmethod
    def sel(cond, a, b):
        return torch.where(cond[..., None], a, b)

    @staticmethod
    def one_like(a):
        return _one16(str(a.device)).expand(a.shape)

    @staticmethod
    def inv_pieces(a):
        """(n, c) with a^-1 = c * n^-1 and n in Fq: here n = a, c = 1."""
        return a, None

    @staticmethod
    def scale(c, n_inv):
        return n_inv


def batch_inverse(d: torch.Tensor) -> torch.Tensor:
    """Inverses of nonzero Fq elements [N, 24] (plain, Montgomery): prefix
    and suffix products by log-depth scans, one host inversion of the
    total (the JAX package's `batch_fq_inverse`)."""
    n = d.shape[0]
    one = FqOps.one_like(d[:1])
    pre, suf, k = d, d, 1
    while k < n:  # inclusive scans: pre[i] = d[0..i], suf[i] = d[i..n-1]
        pre = torch.cat([pre[:k], FqOps.mul(pre[k:], pre[:-k])])
        suf = torch.cat([FqOps.mul(suf[:-k], suf[k:]), suf[-k:]])
        k *= 2
    total = F.limbs32_to_ints(F.to_limbs32(pre[-1:]))[0]  # T R mod p
    inv_total = F._limbs_const(pow(total, -1, P) * FQ.mont_r * FQ.mont_r % P, FQ.n16, str(d.device))
    before = torch.cat([one, pre[:-1]])  # d[0..i-1]
    after = torch.cat([suf[1:], one])  # d[i+1..n-1]
    return FqOps.mul(FqOps.mul(before, after), inv_total)


# ---------------------------------------------------------------------------
# Curve-generic Jacobian formulas (plain), over a field-ops class `f`
# ---------------------------------------------------------------------------


def _dbl(f, a):
    return f.add(a, a)


def double(f, X1, Y1, Z1):
    """dbl-2009-l; Z = 0 stays 0."""
    A = f.mul(X1, X1)
    Bv = f.mul(Y1, Y1)
    C = f.mul(Bv, Bv)
    xb = f.add(X1, Bv)
    D = _dbl(f, f.sub(f.sub(f.mul(xb, xb), A), C))
    E = f.add(_dbl(f, A), A)
    X3 = f.sub(f.mul(E, E), _dbl(f, D))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), _dbl(f, _dbl(f, _dbl(f, C))))
    Z3 = _dbl(f, f.mul(Y1, Z1))
    return X3, Y3, Z3


def madd_nodbl(f, X1, Y1, Z1, x2, y2, valid):
    """madd-2007-bl without the doubling path. Returns (X, Y, Z, same)."""
    Z1Z1 = f.mul(Z1, Z1)
    U2 = f.mul(x2, Z1Z1)
    S2 = f.mul(f.mul(y2, Z1), Z1Z1)
    H = f.sub(U2, X1)
    HH = f.mul(H, H)
    I = _dbl(f, _dbl(f, HH))
    J = f.mul(H, I)
    r = _dbl(f, f.sub(S2, Y1))
    V = f.mul(X1, I)
    X3 = f.sub(f.sub(f.mul(r, r), J), _dbl(f, V))
    Y3 = f.sub(f.mul(r, f.sub(V, X3)), _dbl(f, f.mul(Y1, J)))
    zh = f.add(Z1, H)
    Z3 = f.sub(f.sub(f.mul(zh, zh), Z1Z1), HH)

    h_zero, r_zero, inf1 = f.is_zero(H), f.is_zero(r), f.is_zero(Z1)
    same = h_zero & r_zero & ~inf1 & valid
    neg = h_zero & ~r_zero & ~inf1
    Z = f.sel(neg, torch.zeros_like(Z3), Z3)
    X = f.sel(inf1, x2, X3)
    Y = f.sel(inf1, y2, Y3)
    Z = f.sel(inf1, f.one_like(Z), Z)
    keep = ~valid | same
    return f.sel(keep, X1, X), f.sel(keep, Y1, Y), f.sel(keep, Z1, Z), same


def add(f, X1, Y1, Z1, X2, Y2, Z2):
    """add-2007-bl, doubling where P == Q, infinity where P == -Q."""
    Z1Z1 = f.mul(Z1, Z1)
    Z2Z2 = f.mul(Z2, Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, U1)
    r = _dbl(f, f.sub(S2, S1))
    dh = _dbl(f, H)
    I = f.mul(dh, dh)
    J = f.mul(H, I)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.mul(r, r), J), _dbl(f, V))
    Y3 = f.sub(f.mul(r, f.sub(V, X3)), _dbl(f, f.mul(S1, J)))
    zz = f.add(Z1, Z2)
    Z3 = f.mul(H, f.sub(f.sub(f.mul(zz, zz), Z1Z1), Z2Z2))

    h_zero, r_zero = f.is_zero(H), f.is_zero(r)
    inf1, inf2 = f.is_zero(Z1), f.is_zero(Z2)
    same = h_zero & r_zero & ~inf1 & ~inf2
    neg = h_zero & ~r_zero & ~inf1 & ~inf2
    X, Y, Z = X3, Y3, Z3
    if bool(same.any()):
        dX, dY, dZ = double(f, X1, Y1, Z1)
        X, Y, Z = f.sel(same, dX, X), f.sel(same, dY, Y), f.sel(same, dZ, Z)
    Z = f.sel(neg, torch.zeros_like(Z), Z)
    X = f.sel(inf1, X2, f.sel(inf2, X1, X))
    Y = f.sel(inf1, Y2, f.sel(inf2, Y1, Y))
    Z = f.sel(inf1, Z2, f.sel(inf2, Z1, Z))
    return X, Y, Z


# ---------------------------------------------------------------------------
# A group, its plain entry points in the working form, host conversions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Curve:
    """One group: its plain field ops, the shape of a coordinate in the
    working form, and its host arithmetic (ops/bls12_381.py)."""

    name: str
    f: type
    coord: tuple  # (12,) for Fq, (2, 12) for Fq2
    host_add: object
    host_double: object
    host_inf: tuple
    encode: object  # host coordinate -> list of Fq ints
    decode: object  # list of Fq ints -> host coordinate

    @property
    def caxis(self) -> int:
        """The coordinate axis of a point tensor."""
        return -1 - len(self.coord)

    def _split16(self, p):
        p16 = F.to_limbs16(p)
        return [p16.select(self.caxis, k) for k in range(p16.shape[self.caxis])]

    def _join32(self, *coords):
        return F.to_limbs32(torch.stack(coords, dim=self.caxis))

    # plain versions of the K4/K5 entry points (ops/cuda/curve.py)
    def madd_nodbl_plain(self, acc, q, valid):
        X, Y, Z, same = madd_nodbl(self.f, *self._split16(acc), *self._split16(q), valid)
        return self._join32(X, Y, Z), same

    def madd_plain(self, acc, q, valid):
        """The mixed add with its doubling path (ops/pallas/g1.py
        `madd_soa` :496): madd_nodbl, then 2P on the P == Q lanes, which
        madd_nodbl left at P."""
        out, same = self.madd_nodbl_plain(acc, q, valid)
        return self.dbl_plain(out, same)

    def dbl_plain(self, p, mask):
        X1, Y1, Z1 = self._split16(p)
        X, Y, Z = double(self.f, X1, Y1, Z1)
        s = self.f.sel
        return self._join32(s(mask, X, X1), s(mask, Y, Y1), s(mask, Z, Z1))

    def add_plain(self, p, q):
        return self._join32(*add(self.f, *self._split16(p), *self._split16(q)))

    # working-form helpers
    @cached_property
    def one(self) -> torch.Tensor:
        """1 (Montgomery) as one coordinate, int32 [*coord] on the CPU."""
        return self.encode_coords([self.decode([1] + [0] * (self._nfq() - 1))])[0]

    def infinity(self, n: int, device) -> torch.Tensor:
        """n points at infinity: X = Y = 1, Z = 0 (Montgomery)."""
        out = torch.zeros((n, 3) + self.coord, dtype=torch.int32)
        out[:, 0] = self.one
        out[:, 1] = self.one
        return out.to(device)

    def lift(self, aff: torch.Tensor) -> torch.Tensor:
        """Affine [N, 2, ...] -> Jacobian [N, 3, ...] with Z = 1."""
        z = self.one.to(aff.device).expand((aff.shape[0], 1) + self.coord)
        return torch.cat([aff, z], dim=1)

    def normalize(self, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Jacobian [N, 3, ...] -> (affine [N, 2, ...], valid [N]) in the
        staging of `points_to_device` (infinity as 0, 0), with one host
        inversion for the whole batch: the plain counterpart of the JAX
        package's `normalize_batch` (g1_jax.py:234, g2_jax.py:236)."""
        f = self.f
        if p.shape[0] == 0:
            return p[:, :2].clone(), torch.zeros(0, dtype=torch.bool, device=p.device)
        X, Y, Z = self._split16(p)
        valid = ~f.is_zero(Z)
        z = f.sel(valid, Z, f.one_like(Z))
        norm, conj = f.inv_pieces(z)
        zinv = f.scale(conj, batch_inverse(norm))
        zinv2 = f.mul(zinv, zinv)
        x, y = f.mul(X, zinv2), f.mul(Y, f.mul(zinv2, zinv))
        zero = torch.zeros_like(x)
        return self._join32(f.sel(valid, x, zero), f.sel(valid, y, zero)), valid

    def _nfq(self) -> int:
        return 1 if len(self.coord) == 1 else self.coord[0]

    def encode_coords(self, coords) -> torch.Tensor:
        """Host coordinates -> int32 [len, *coord] Montgomery."""
        flat = [v * FQ.mont_r % P for c in coords for v in self.encode(c)]
        return F.ints_to_limbs32(flat, FQ).reshape((len(coords),) + self.coord)

    def points_to_device(self, points) -> tuple[torch.Tensor, torch.Tensor]:
        """Host points (Jacobian or affine) -> (affine [N, 2, ...] int32
        Montgomery on the CPU, valid [N] bool); infinity stages as 0, 0."""
        zero = self.decode([0] * self._nfq())
        coords, valid = [], []
        for pt in points:
            aff = self.to_affine(pt) if len(pt) == 3 else pt
            if aff is None:
                coords += [zero, zero]
                valid.append(False)
            else:
                coords += [aff[0], aff[1]]
                valid.append(True)
        t = self.encode_coords(coords).reshape((len(valid), 2) + self.coord)
        return t, torch.tensor(valid, dtype=torch.bool)

    def to_affine(self, p):
        fn = B.g1_to_affine if self.name == "g1" else B.g2_to_affine
        return fn(p)

    def points_from_device(self, p: torch.Tensor) -> list:
        """Jacobian [N, 3, ...] Montgomery -> host Jacobian points."""
        vals = F.limbs32_to_ints(p.reshape(-1, FQ.n32))
        k = self._nfq()
        out = []
        for i in range(0, len(vals), 3 * k):
            c = [self.decode([v * R_INV % P for v in vals[i + j * k : i + (j + 1) * k]]) for j in range(3)]
            out.append(tuple(c))
        return out

    def host_point(self, p: torch.Tensor):
        """The host point of one Jacobian row (infinity as host_inf)."""
        pt = self.points_from_device(p.reshape((1, 3) + self.coord))[0]
        return self.host_inf if self.is_host_inf(pt) else pt

    def is_host_inf(self, pt) -> bool:
        return pt[2] == self.decode([0] * self._nfq())


G1 = Curve(
    name="g1",
    f=FqOps,
    coord=(FQ.n32,),
    host_add=B.g1_add,
    host_double=B.g1_double,
    host_inf=B.G1_INF,
    encode=lambda c: [c],
    decode=lambda vs: vs[0],
)
