"""Radix-2 NTT over BLS12-381 Fr: domain tables and the plain transforms.

Counterpart of crypto3_fil_proofs_tpu/ops/ntt.py (roots of unity, bit
reversal, twiddle tables, `ntt_host`, and the `ntt`/`intt`/`coset_ntt`/
`coset_intt` chain) and of the tables of ops/pallas/ntt.py (:455-541).

Vectors are int32 [n, 8] Fr elements in Montgomery form (the port's
working form, ops/field.py). `transform_plain` is the plain version of
kernel K3 (csrc/ntt.cu): a bit-reversal gather, then log2(n) DIT stages
(u + t, u - t; t = v * w) on the plain int64 Fr ops. The transforms
below run it; ops/cuda/ntt.py puts the kernel in its place for CUDA
tensors. Every table is built in Montgomery form on the device that asks
for it (the power tables by doubling, through K1) and cached per size
and device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import field as F
from .bls12_381 import FR_MULT_GEN, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R

FR = F.FR


def root_of_unity(log_n: int) -> int:
    """A primitive 2^log_n-th root of unity of Fr."""
    if not 0 <= log_n <= FR_TWO_ADICITY:
        raise ValueError(f"Fr has no 2^{log_n}-th roots of unity")
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - log_n), R)


def bit_reverse_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def powers(base: int, count: int, scale: int = 1) -> list[int]:
    """[scale * base^i for i < count] mod r."""
    out, acc = [], scale % R
    for _ in range(count):
        out.append(acc)
        acc = acc * base % R
    return out


def mont_powers(base: int, count: int, scale: int = 1, device="cpu") -> torch.Tensor:
    """[scale * base^i for i < count] as int32 [count, 8] Montgomery form
    on `device`, built by doubling: the powers so far times base^(2^k),
    one K1 product each step (its plain version on the CPU). The
    Montgomery factor rides in the scale."""
    from .cuda import field as k1

    out = torch.empty((count, FR.n32), dtype=torch.int32, device=device)
    out[:1] = F.ints_to_limbs32([scale * FR.mont_r % R]).to(device)
    k, step = 1, base % R
    while k < count:
        n = min(k, count - k)
        out[k : k + n] = k1.montmul(out[:n], F.ints_to_limbs32([step * FR.mont_r % R])[0].to(device))
        k, step = 2 * k, step * step % R
    return out


class Domain:
    """The scalars of one domain size 2^log_n: w, w^-1, 1/n, the inverse
    of the multiplicative generator g = FR_MULT_GEN and 1 / Z(g)."""

    def __init__(self, log_n: int):
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = root_of_unity(log_n)
        self.omega_inv = pow(self.omega, R - 2, R)
        self.n_inv = pow(self.n, R - 2, R)
        self.gen_inv = pow(FR_MULT_GEN, R - 2, R)
        self.z_inv = pow((pow(FR_MULT_GEN, self.n, R) - 1) % R, R - 2, R)

    def powers(self, name: str) -> tuple[int, int, int]:
        """(base, count, scale) of a power table:
        tw_fwd / tw_inv: w^j and w^-j (j < n/2); coset_fwd / coset_inv:
        g^i and g^-i; h_in_scale: g^i / n (the iNTT's 1/n and the shift
        onto the coset); h_out_scale: g^-i / (n Z(g)), Z(g) = g^n - 1
        (back from the coset; ops/cuda/ntt.py `h_from_evals`)."""
        half = max(self.n // 2, 1)
        return {
            "tw_fwd": (self.omega, half, 1),
            "tw_inv": (self.omega_inv, half, 1),
            "coset_fwd": (FR_MULT_GEN, self.n, 1),
            "coset_inv": (self.gen_inv, self.n, 1),
            "h_in_scale": (FR_MULT_GEN, self.n, self.n_inv),
            "h_out_scale": (self.gen_inv, self.n, self.n_inv * self.z_inv),
        }[name]


@lru_cache(maxsize=4)
def domain(log_n: int) -> Domain:
    return Domain(log_n)


def stage_table(tw: torch.Tensor, log_n: int) -> torch.Tensor:
    """The twiddles of every stage of a transform of 2^log_n from its power
    table tw (w^k, k < n/2): the root of stage s (of order 2^s) to the power
    j < 2^(s-1) at row 2^(s-1) + j, i.e. tw[j 2^(log_n - s)]; row 0 is w^0.
    int32 [n, 8], n x 32 bytes (256 MiB at 2^23)."""
    out = torch.empty((1 << log_n, FR.n32), dtype=torch.int32, device=tw.device)
    out[:1] = tw[:1]
    for s in range(1, log_n + 1):
        out[1 << (s - 1) : 1 << s] = tw[:: 1 << (log_n - s)][: 1 << (s - 1)]
    return out


@lru_cache(maxsize=64)
def table(log_n: int, name: str, device: str) -> torch.Tensor:
    """One table of the domain of size 2^log_n, built on `device` (cached):
    `bitrev`, `n_inv_mont` (1/n, one element), a power table of
    `Domain.powers`, or `tw_stages_fwd` / `tw_stages_inv`, the stage tables
    (`stage_table`) of tw_fwd / tw_inv that kernel K3 reads and
    `transform_plain` does not (their power table is built for them and
    not kept)."""
    d = domain(log_n)
    if name == "bitrev":
        return torch.from_numpy(bit_reverse_indices(log_n)).to(device)
    if name == "n_inv_mont":
        return F.ints_to_limbs32([d.n_inv * FR.mont_r % R])[0].to(device)
    if name.startswith("tw_stages_"):
        return stage_table(mont_powers(*d.powers("tw_" + name[len("tw_stages_") :]), device=device), log_n)
    return mont_powers(*d.powers(name), device=device)


# ---------------------------------------------------------------------------
# The plain transform (the plain version of kernel K3)
# ---------------------------------------------------------------------------


def transform_plain(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Unscaled DIT transform of int32 [n, 8] Montgomery values, natural
    order in and out: sum_j x_j w^(+-ij). The inverse is not divided by n.
    A batch [batch, n, 8] is transformed row by row (all rows at once)."""
    n = 1 << log_n
    if x.dim() not in (2, 3) or x.shape[-2:] != (n, FR.n32):
        raise ValueError(f"expected [{n}, {FR.n32}] or [batch, {n}, {FR.n32}], got {tuple(x.shape)}")
    dev = str(x.device)
    tw = F.to_limbs16(table(log_n, "tw_inv" if inverse else "tw_fwd", dev))
    rows = x.reshape(-1, n, FR.n32)
    a = F.to_limbs16(rows)[:, table(log_n, "bitrev", dev)]
    for s in range(1, log_n + 1):
        m = 1 << s
        w = tw[:: n // m][: m // 2]
        blocks = a.reshape(rows.shape[0], n // m, m, FR.n16)
        even, odd = blocks[:, :, : m // 2], blocks[:, :, m // 2 :]
        t = F.mont_mul(odd, w)
        a = torch.cat([F.add(even, t), F.sub(even, t)], dim=2).reshape(rows.shape[0], n, FR.n16)
    return F.to_limbs32(a).reshape(x.shape)


def ntt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Forward NTT of Montgomery coefficients: evaluations on <w>."""
    return transform_plain(x, log_n, False)


def intt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Inverse NTT, 1/n included."""
    out = transform_plain(x, log_n, True)
    return F.mont_mul32(out, table(log_n, "n_inv_mont", str(x.device)))


def coset_ntt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Evaluations on the coset g<w>: scale coefficient i by g^i, then NTT."""
    return transform_plain(F.mont_mul32(x, table(log_n, "coset_fwd", str(x.device))), log_n, False)


def coset_intt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Inverse of coset_ntt: iNTT, then scale coefficient i by g^-i."""
    return F.mont_mul32(intt(x, log_n), table(log_n, "coset_inv", str(x.device)))


# ---------------------------------------------------------------------------
# Host reference
# ---------------------------------------------------------------------------


def ntt_host(values: list[int], inverse: bool = False) -> list[int]:
    """O(n log n) transform on python ints (copied from the JAX package)."""
    n = len(values)
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("ntt_host takes a power-of-two length")
    omega = root_of_unity(log_n)
    if inverse:
        omega = pow(omega, R - 2, R)
    a = [values[i] % R for i in bit_reverse_indices(log_n)]
    m = 2
    while m <= n:
        wm = pow(omega, n // m, R)
        for k in range(0, n, m):
            w = 1
            for j in range(m // 2):
                t = (w * a[k + j + m // 2]) % R
                u = a[k + j]
                a[k + j] = (u + t) % R
                a[k + j + m // 2] = (u - t) % R
                w = (w * wm) % R
        m *= 2
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [(v * n_inv) % R for v in a]
    return a
