"""Groth16 over BLS12-381: prove on the card, verify on the host.

Counterpart of crypto3_fil_proofs_tpu/zk/groth16.py: the key and proof
types (:64-132), the QAP evaluation of the rows with the input rows
appended (:599-669), `prove` / `prove_from_assignment` (:1005-1084) and
`verify` (:1122). The signatures are the JAX package's plus `device`.

- h(x) = (A(x) B(x) - C(x)) / Z(x): the row evaluations are taken on the
  host and the seven transforms run in `ops/cuda/ntt.py` `h_from_evals`
  (kernel K3, with K1 for the elementwise products); h is truncated to
  m - 1 coefficients.
- The five commitments are MSMs (`ops/msm.py`: kernels K4/K5/K6) at
  every size, each on the device the call names.
- r and s come from random.Random(sha256(randomness)); A, B and C are
  assembled on the host exactly as the JAX package assembles them, so a
  proof's bytes equal the JAX package's for the same key, witness and
  randomness.

`device="cuda"` (the default) needs CUDA and raises without it;
`device="cpu"` runs the kernels' plain versions.

The proof is the zcash-compressed 192-byte layout (a: G1 48 | b: G2 96 |
c: G1 48).
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

import numpy as np
import torch

from ..api.seal import check_device
from ..core.measure import measure_op
from ..ops import field as F
from ..ops import msm as M
from ..ops.bls12_381 import (
    FQ12_ONE,
    R,
    g1_add,
    g1_from_compressed,
    g1_mul,
    g1_neg,
    g1_to_compressed,
    g2_add,
    g2_from_compressed,
    g2_mul,
    g2_to_compressed,
    multi_pairing,
)
from ..ops.cuda import field as k1
from ..ops.cuda import ntt as k3
from ..ops.g1_torch import G1
from ..ops.g2_torch import G2

# ---------------------------------------------------------------------------
# Key / proof types
# ---------------------------------------------------------------------------


@dataclass
class Proof:
    a: tuple  # host G1 Jacobian
    b: tuple  # host G2 Jacobian
    c: tuple

    def to_bytes(self) -> bytes:
        return g1_to_compressed(self.a) + g2_to_compressed(self.b) + g1_to_compressed(self.c)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Proof":
        if len(data) != 192:
            raise ValueError("a Groth16 proof is 192 bytes")
        return cls(
            g1_from_compressed(data[:48]),
            g2_from_compressed(data[48:144]),
            g1_from_compressed(data[144:192]),
        )


def _points_to_bytes(points, compress) -> np.ndarray:
    return np.frombuffer(b"".join(compress(p) for p in points), dtype=np.uint8)


def _points_from_bytes(data, decompress, size) -> list:
    raw = bytes(np.asarray(data, dtype=np.uint8))
    return [decompress(raw[i : i + size]) for i in range(0, len(raw), size)]


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list  # G1 points, one per input (the constant 1 first)

    def to_npz_dict(self) -> dict:
        enc = _points_to_bytes
        return {
            "vk_alpha": enc([self.alpha_g1], g1_to_compressed),
            "vk_beta": enc([self.beta_g2], g2_to_compressed),
            "vk_gamma": enc([self.gamma_g2], g2_to_compressed),
            "vk_delta": enc([self.delta_g2], g2_to_compressed),
            "vk_ic": enc(self.ic, g1_to_compressed),
        }

    @classmethod
    def from_npz_dict(cls, d) -> "VerifyingKey":
        return cls(
            _points_from_bytes(d["vk_alpha"], g1_from_compressed, 48)[0],
            _points_from_bytes(d["vk_beta"], g2_from_compressed, 96)[0],
            _points_from_bytes(d["vk_gamma"], g2_from_compressed, 96)[0],
            _points_from_bytes(d["vk_delta"], g2_from_compressed, 96)[0],
            _points_from_bytes(d["vk_ic"], g1_from_compressed, 48),
        )


QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


@dataclass
class ProvingKey:
    """Each query is (affine points in the working form, valid [N] bool):
    int32 [N, 2, 12] (G1) or [N, 2, 2, 12] (G2), Montgomery, on the
    device the key lives on (`to`)."""

    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: tuple
    b_g1_query: tuple
    b_g2_query: tuple
    h_query: tuple
    l_query: tuple
    log_n: int

    def to(self, device) -> "ProvingKey":
        """The key with its queries on `device`."""
        moved = {q: tuple(t.to(device) for t in getattr(self, q)) for q in QUERIES}
        return ProvingKey(self.vk, self.beta_g1, self.delta_g1, log_n=self.log_n, **moved)

    def save(self, path: str) -> None:
        """One npz: the compressed vk, beta_g1, delta_g1 and log_n, and
        each query's points and valid flags."""
        arrays = dict(self.vk.to_npz_dict())
        arrays["beta_g1"] = _points_to_bytes([self.beta_g1], g1_to_compressed)
        arrays["delta_g1"] = _points_to_bytes([self.delta_g1], g1_to_compressed)
        arrays["log_n"] = np.asarray(self.log_n)
        for q in QUERIES:
            pts, valid = getattr(self, q)
            arrays[f"{q}_points"] = pts.cpu().numpy()
            arrays[f"{q}_valid"] = valid.cpu().numpy()
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "ProvingKey":
        with np.load(path) as d:
            queries = {
                q: (torch.from_numpy(d[f"{q}_points"]), torch.from_numpy(d[f"{q}_valid"]))
                for q in QUERIES
            }
            return cls(
                VerifyingKey.from_npz_dict(d),
                g1_from_compressed(bytes(d["beta_g1"])),
                g1_from_compressed(bytes(d["delta_g1"])),
                log_n=int(d["log_n"]),
                **queries,
            )


# the JAX ProvingKey's query arrays, as proving_key_from_jax takes them
JAX_G1_QUERIES = {"a_query": "a", "b_g1_query": "b_g1", "h_query": "h", "l_query": "l"}


def proving_key_from_jax(arrays: dict) -> ProvingKey:
    """The JAX package's proving key, as numpy arrays, in the port's form.

    `arrays` holds the vk as `VerifyingKey.to_npz_dict` gives it,
    `beta_g1` / `delta_g1` compressed (48 bytes each), `log_n`, and each
    query as the JAX package stages it (16-bit limbs, Montgomery): for
    a, b_g1, h and l the arrays `<q>_x`, `<q>_y` [N, 24] and `<q>_valid`
    [N]; for b_g2 `b_g2_x0`, `b_g2_x1`, `b_g2_y0`, `b_g2_y1` and
    `b_g2_valid`. The limbs are re-viewed as 32-bit limbs; no arithmetic
    is done, so both packages prove with the same key."""
    queries = {}
    for q, k in JAX_G1_QUERIES.items():
        pts = torch.stack([F.from_jax_limbs(arrays[f"{k}_x"]), F.from_jax_limbs(arrays[f"{k}_y"])], dim=1)
        queries[q] = (pts, torch.from_numpy(np.asarray(arrays[f"{k}_valid"]).astype(bool)))
    x = torch.stack([F.from_jax_limbs(arrays["b_g2_x0"]), F.from_jax_limbs(arrays["b_g2_x1"])], dim=1)
    y = torch.stack([F.from_jax_limbs(arrays["b_g2_y0"]), F.from_jax_limbs(arrays["b_g2_y1"])], dim=1)
    queries["b_g2_query"] = (
        torch.stack([x, y], dim=1),
        torch.from_numpy(np.asarray(arrays["b_g2_valid"]).astype(bool)),
    )
    return ProvingKey(
        VerifyingKey.from_npz_dict(arrays),
        g1_from_compressed(bytes(np.asarray(arrays["beta_g1"], dtype=np.uint8))),
        g1_from_compressed(bytes(np.asarray(arrays["delta_g1"], dtype=np.uint8))),
        log_n=int(arrays["log_n"]),
        **queries,
    )


# ---------------------------------------------------------------------------
# QAP witness reduction
# ---------------------------------------------------------------------------


def qap_evals(cs_finalized, assignment: list[int], log_n: int):
    """A, B and C evaluated on the domain rows: row j of the circuit, then
    one row per public input (A = x_i, B = C = 0), then zeros."""
    n_in, _, rows, _, _ = cs_finalized
    m = 1 << log_n
    if len(rows) + n_in > m:
        raise ValueError(f"{len(rows) + n_in} rows do not fit a domain of {m}")
    evals = [[0] * m for _ in range(3)]
    for j, row in enumerate(rows):
        for side, terms in zip(evals, row):
            side[j] = sum(co * assignment[v] for v, co in terms.items()) % R
    for i in range(n_in):
        evals[0][len(rows) + i] = assignment[i]
    return evals


def h_from_evals(a: list[int], b: list[int], c: list[int], log_n: int, device="cuda") -> list[int]:
    """The m - 1 coefficients of h from the evaluations of A, B, C on the
    domain of size m = 2^log_n, computed on `device`."""
    dev = check_device(device)
    m = 1 << log_n
    ev = [k1.to_mont(F.ints_to_limbs32(v).to(dev)) for v in (a, b, c)]
    h = k1.from_mont(k3.h_from_evals(*ev, log_n))
    return F.limbs32_to_ints(h)[: m - 1]


def compute_h(cs_finalized, assignment: list[int], log_n: int, device="cuda") -> list[int]:
    """h(x) = (a(x) b(x) - c(x)) / Z(x): the row evaluations on the host,
    the transforms on `device`."""
    check_device(device)
    return h_from_evals(*qap_evals(cs_finalized, assignment, log_n), log_n, device)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


def _msm(curve, query, scalars: torch.Tensor):
    pts, valid = query
    if pts.shape[0] != scalars.shape[0]:
        raise ValueError(f"{pts.shape[0]} query points for {scalars.shape[0]} scalars")
    return M.msm(curve, pts, torch.where(valid[:, None], scalars, 0))


def prove(pk: ProvingKey, cs, randomness: bytes = b"fil-tpu-prove", device="cuda") -> Proof:
    """Groth16 prove; deterministic for fixed `randomness`."""
    check_device(device)
    fin = cs.finalize()
    _, _, _, inputs, aux = fin
    with measure_op("prove_h"):
        h = compute_h(fin, inputs + aux, pk.log_n, device)
    return prove_from_assignment(pk, inputs, aux, h, randomness, device)


def prove_from_assignment(
    pk: ProvingKey,
    inputs: list[int],
    aux: list[int],
    h: list[int],
    randomness: bytes = b"fil-tpu-prove",
    device="cuda",
) -> Proof:
    """The MSM and assembly half of `prove`, from the finalized
    assignment and the h coefficients. Spans (core/measure.py):
    prove_to_device, prove_msm_{a,b_g1,b_g2,h,l}, prove_assembly."""
    dev = check_device(device)
    rng = random.Random(hashlib.sha256(randomness).digest())
    r = rng.randrange(R)
    s = rng.randrange(R)
    with measure_op("prove_to_device"):
        key = pk.to(dev)
        assignment = F.ints_to_limbs32(inputs + aux).to(dev)
        h_t = F.ints_to_limbs32(h).to(dev)
    with measure_op("prove_msm_a"):
        ev_a = _msm(G1, key.a_query, assignment)
    with measure_op("prove_msm_b_g1"):
        ev_b_g1 = _msm(G1, key.b_g1_query, assignment)
    with measure_op("prove_msm_b_g2"):
        ev_b_g2 = _msm(G2, key.b_g2_query, assignment)
    with measure_op("prove_msm_h"):
        ev_h = _msm(G1, key.h_query, h_t)
    with measure_op("prove_msm_l"):
        ev_l = _msm(G1, key.l_query, assignment[len(inputs) :])
    with measure_op("prove_assembly"):
        g_a = g1_add(g1_add(pk.vk.alpha_g1, ev_a), g1_mul(pk.delta_g1, r))
        g_b = g2_add(g2_add(pk.vk.beta_g2, ev_b_g2), g2_mul(pk.vk.delta_g2, s))
        g_b_g1 = g1_add(g1_add(pk.beta_g1, ev_b_g1), g1_mul(pk.delta_g1, s))
        # C = l + h + s*A + r*B1 - rs*delta
        g_c = g1_add(ev_l, ev_h)
        g_c = g1_add(g_c, g1_mul(g_a, s))
        g_c = g1_add(g_c, g1_mul(g_b_g1, r))
        g_c = g1_add(g_c, g1_neg(g1_mul(pk.delta_g1, r * s % R)))
    return Proof(g_a, g_b, g_c)


# ---------------------------------------------------------------------------
# Verifier (host pairing)
# ---------------------------------------------------------------------------


def verify(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    """public_inputs excludes the leading constant 1 (ic[0])."""
    if len(public_inputs) + 1 != len(vk.ic):
        return False
    acc = vk.ic[0]
    for x, pt in zip(public_inputs, vk.ic[1:]):
        acc = g1_add(acc, g1_mul(pt, x % R))
    # e(A, B) * e(-acc, gamma) * e(-C, delta) * e(-alpha, beta) == 1
    result = multi_pairing(
        [
            (proof.a, proof.b),
            (g1_neg(acc), vk.gamma_g2),
            (g1_neg(proof.c), vk.delta_g2),
            (g1_neg(vk.alpha_g1), vk.beta_g2),
        ]
    )
    return result == FQ12_ONE
