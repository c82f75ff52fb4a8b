"""BLS12-381 field arithmetic on tensors: the plain version of kernel K1.

Counterpart of crypto3_fil_proofs_tpu/ops/fr_limbs.py (`Field`, `FR`,
`FQ` :52-115 and the `FieldOps` limb kernels) and the moduli of
ops/bls12_381.py.

Two representations of an element, both little-endian:
- the port's working form: an int32 tensor [..., 8] (Fr) or [..., 12]
  (Fq) of 32-bit limbs read as u32. It is the byte layout of the LE
  field element and the layout the CUDA kernels take (csrc/field.cuh).
- the plain form: an int64 tensor [..., 16] or [..., 24] of 16-bit
  limbs. Torch's CPU uint32 has no add, shift or compare, so the plain
  CIOS runs in int64, where the deferred carries of 16-bit limbs have
  room to spare.

The Montgomery radix is 2^256 (Fr) or 2^384 (Fq) in every form, here
and in the JAX package, so moving between the forms re-views bytes and
does no arithmetic.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# BLS12-381 base field Fq (381 bits) and scalar field Fr (255 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


class Field:
    """Static per-field data: modulus limbs, Montgomery constants."""

    def __init__(self, modulus: int, n16: int, name: str):
        self.name = name
        self.modulus = modulus
        self.n16 = n16  # 16-bit limbs (plain form)
        self.n32 = n16 // 2  # 32-bit limbs (working form)
        self.nbytes = 2 * n16
        self.mont_r = (1 << (LIMB_BITS * n16)) % modulus
        self.mont_r2 = (self.mont_r * self.mont_r) % modulus
        # -modulus^-1 mod 2^16 (plain CIOS) and mod 2^32 (the kernels)
        self.n0inv16 = (-pow(modulus, -1, 1 << 16)) & 0xFFFF
        self.n0inv32 = (-pow(modulus, -1, 1 << 32)) & 0xFFFFFFFF
        self.p16 = [(modulus >> (LIMB_BITS * j)) & LIMB_MASK for j in range(n16)]
        self.p32 = [(modulus >> (32 * j)) & 0xFFFFFFFF for j in range(self.n32)]


FR = Field(R, 16, "Fr")
FQ = Field(P, 24, "Fq")


# ---------------------------------------------------------------------------
# Conversions (byte re-views, no arithmetic)
# ---------------------------------------------------------------------------


def to_limbs16(x: torch.Tensor) -> torch.Tensor:
    """int32 [..., n32] -> int64 [..., 2*n32] of 16-bit limbs."""
    return x.contiguous().view(torch.int16).to(torch.int64) & LIMB_MASK


def to_limbs32(x: torch.Tensor) -> torch.Tensor:
    """int64 [..., 2*n32] of 16-bit limbs -> int32 [..., n32]."""
    # map [0, 2^16) onto int16's two's complement range, then re-view
    signed = x - ((x >> 15) & 1) * (1 << 16)
    return signed.to(torch.int16).contiguous().view(torch.int32)


def bytes_to_limbs32(x: torch.Tensor) -> torch.Tensor:
    """uint8 [..., nbytes] LE elements -> int32 [..., nbytes/4]."""
    return x.contiguous().view(torch.int32)


def limbs32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


def ints_to_limbs32(values, field: Field = FR) -> torch.Tensor:
    """Python ints (reduced mod p) -> int32 [len, n32] on the CPU."""
    raw = b"".join((v % field.modulus).to_bytes(field.nbytes, "little") for v in values)
    arr = np.frombuffer(raw, dtype="<i4").reshape(-1, field.n32)
    return torch.from_numpy(arr.copy())


def limbs32_to_ints(x: torch.Tensor) -> list[int]:
    """int32 [..., n32] -> python ints, one per element."""
    flat = x.detach().to("cpu").contiguous()
    raw = flat.numpy().astype("<i4").tobytes()
    nbytes = flat.shape[-1] * 4
    return [int.from_bytes(raw[i : i + nbytes], "little") for i in range(0, len(raw), nbytes)]


def from_jax_limbs(arr) -> torch.Tensor:
    """The JAX package's [..., 16|24] u32 arrays of 16-bit limbs -> the
    port's int32 [..., 8|12] on the CPU."""
    u16 = np.ascontiguousarray(np.asarray(arr), dtype="<u2")
    return torch.from_numpy(u16.view("<i4").copy())


def to_jax_limbs(x: torch.Tensor) -> np.ndarray:
    """The port's int32 [..., 8|12] -> [..., 16|24] uint32 of 16-bit limbs."""
    i32 = x.detach().to("cpu").contiguous().numpy().astype("<i4")
    return i32.view("<u2").astype(np.uint32)


# ---------------------------------------------------------------------------
# Plain arithmetic on int64 16-bit limbs (canonical in, canonical out)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _limbs_const(value: int, n: int, device: str) -> torch.Tensor:
    return torch.tensor(
        [(value >> (LIMB_BITS * j)) & LIMB_MASK for j in range(n)],
        dtype=torch.int64,
        device=device,
    )


def _normalize(t: torch.Tensor, n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate the carries (or borrows: the shift is arithmetic) of an
    int64 limb vector of at most n_out limbs. Returns (n_out 16-bit limbs,
    the carry left over), the carry negative where the value was.

    Carries move up one limb per pass, all limbs at once, until none is
    left: a few passes on CIOS output, at most n_out + 1. The passes work
    in place on a padded copy (whole-tensor ops through `narrow`: on the
    small batches of a bit loop the per-op cost is what counts)."""
    x = torch.nn.functional.pad(t, (0, n_out + 1 - t.shape[-1]))  # a new tensor: t has <= n_out limbs
    d = x.dim() - 1
    low = x.narrow(d, 0, n_out)
    while True:
        carry = low >> LIMB_BITS
        if not bool(carry.any()):
            return low, x.narrow(d, n_out, 1).squeeze(d)
        low.bitwise_and_(LIMB_MASK)
        x.narrow(d, 1, n_out).add_(carry)


def _sub_if_ge(x: torch.Tensor, field: Field) -> torch.Tensor:
    """x - p where x >= p, for x < 2p in n16 canonical limbs."""
    p = _limbs_const(field.modulus, field.n16, str(x.device))
    d, borrow = _normalize(x - p, field.n16)
    return torch.where((borrow < 0).unsqueeze(-1), x, d)


def add(a: torch.Tensor, b: torch.Tensor, field: Field = FR) -> torch.Tensor:
    s, _ = _normalize(a + b, field.n16)  # a + b < 2p < 2^(16n): no carry out
    return _sub_if_ge(s, field)


def sub(a: torch.Tensor, b: torch.Tensor, field: Field = FR) -> torch.Tensor:
    d, borrow = _normalize(a - b, field.n16)
    p = _limbs_const(field.modulus, field.n16, str(d.device))
    d_plus_p, _ = _normalize(d + p, field.n16)
    return torch.where((borrow < 0).unsqueeze(-1), d_plus_p, d)


def mod_sum(terms: torch.Tensor, dim: int, field: Field = FR) -> torch.Tensor:
    """Sum mod p of fewer than 16 canonical elements along `dim`."""
    if terms.shape[dim] >= 16:
        raise ValueError("mod_sum takes fewer than 16 terms")
    n = field.n16
    x, _ = _normalize(terms.sum(dim=dim), n + 1)  # < 16p < 2^(16n + 4)
    for mult in (8, 4, 2, 1):
        pm = _limbs_const(field.modulus * mult, n + 1, str(x.device))
        d, borrow = _normalize(x - pm, n + 1)
        x = torch.where((borrow < 0).unsqueeze(-1), x, d)
    return x[..., :n]


def mont_mul(a: torch.Tensor, b: torch.Tensor, field: Field = FR) -> torch.Tensor:
    """Montgomery product a*b*2^(-16n) mod p on int64 16-bit limbs
    (broadcasting). CIOS over a 2n-column accumulator: step i adds the
    row a*b_i at column i, then clears column i with m*p and moves its
    high part up. Every column stays below 2^39, so int64 never
    overflows, and memory stays linear in n. The steps update the
    accumulator in place through `narrow` views (indexing assignment
    would add a getitem and a setitem copy to each)."""
    n = field.n16
    a, b = torch.broadcast_tensors(a, b)
    p = _limbs_const(field.modulus, n, str(a.device))
    t = torch.zeros(a.shape[:-1] + (2 * n,), dtype=torch.int64, device=a.device)
    d = t.dim() - 1
    for i in range(n):
        row = t.narrow(d, i, n)
        row.addcmul_(a, b.narrow(d, i, 1))
        col = t.narrow(d, i, 1)
        row.addcmul_((col & LIMB_MASK) * field.n0inv16 & LIMB_MASK, p)
        # column i is now 0 mod 2^16: its high part moves up
        t.narrow(d, i + 1, 1).add_(col >> LIMB_BITS)
    x, _ = _normalize(t.narrow(d, n, n), n)  # < 2p < 2^(16n)
    return _sub_if_ge(x, field)


def to_mont(x: torch.Tensor, field: Field = FR) -> torch.Tensor:
    return mont_mul(x, _limbs_const(field.mont_r2, field.n16, str(x.device)), field)


def from_mont(x: torch.Tensor, field: Field = FR) -> torch.Tensor:
    return mont_mul(x, _limbs_const(1, field.n16, str(x.device)), field)


def mont_mul32(a: torch.Tensor, b: torch.Tensor, field: Field = FR) -> torch.Tensor:
    """The plain version of K1 in the working form: int32 [..., n32]."""
    return to_limbs32(mont_mul(to_limbs16(a), to_limbs16(b), field))


def sub32(a: torch.Tensor, b: torch.Tensor, field: Field = FR) -> torch.Tensor:
    """a - b mod p in the working form (the plain version of the Fr sub
    launch in csrc/field.cu)."""
    return to_limbs32(sub(to_limbs16(a), to_limbs16(b), field))
