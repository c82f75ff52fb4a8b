"""Groth16 over BLS12-381: setup and prove on the card, verify on the host.

Counterpart of crypto3_fil_proofs_tpu/zk/groth16.py: the key and proof
types (:64-132), `setup` (:475) with its QAP evaluation at tau (:355,
host) and fixed-base batches (:147-320, `ops/fixed_base.py`: kernels K4,
K5 and K1), the QAP evaluation of the rows with the input rows appended
(:599-669: dict rows, `BulkBlock`s and `FieldBlock`/`TiledBlock`s),
`prove` / `prove_from_assignment` (:1005-1084), `prove_many` (:1087)
and `verify` (:1122). The signatures are the JAX package's plus `device`.

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
    G1_GEN,
    G2_GEN_X,
    G2_GEN_Y,
    R,
    g1_from_affine,
    g1_add,
    g1_from_compressed,
    g1_mul,
    g1_neg,
    g1_to_compressed,
    g2_add,
    g2_from_compressed,
    g2_from_affine,
    g2_mul,
    g2_to_compressed,
    multi_pairing,
)
from ..ops.cuda import field as k1
from ..ops.cuda import ntt as k3
from ..ops.fixed_base import fixed_base, host_points
from ..ops.g1_torch import G1
from ..ops.g2_torch import G2
from ..ops.ntt import root_of_unity

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
        """One npz in the JAX package's parameter-cache layout
        (core/parameter_cache.py `_save_pk` :50, uncompressed): the
        compressed vk, beta_g1 and delta_g1, log_n, and each query as
        [N, 24] 16-bit limbs (Montgomery) with its valid flags, so either
        package loads what the other wrote."""
        arrays = dict(self.vk.to_npz_dict())
        arrays["beta_g1"] = _points_to_bytes([self.beta_g1], g1_to_compressed)
        arrays["delta_g1"] = _points_to_bytes([self.delta_g1], g1_to_compressed)
        arrays["log_n"] = np.int64(self.log_n)
        for q in G1_QUERIES:
            pts, valid = getattr(self, q)
            arrays[f"{q}_x"] = F.to_jax_limbs(pts[:, 0])
            arrays[f"{q}_y"] = F.to_jax_limbs(pts[:, 1])
            arrays[f"{q}_valid"] = valid.cpu().numpy()
        pts, valid = self.b_g2_query
        for i, coord in enumerate("xy"):
            for j in range(2):
                arrays[f"b_g2_{coord}{j}"] = F.to_jax_limbs(pts[:, i, j])
        arrays["b_g2_valid"] = valid.cpu().numpy()
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "ProvingKey":
        """A key in the parameter-cache layout, written by either package."""
        with np.load(path) as d:
            return proving_key_from_jax(d)

    def nbytes(self) -> int:
        """Bytes of the query tensors."""
        return sum(t.numel() * t.element_size() for q in QUERIES for t in getattr(self, q))


G1_QUERIES = ("a_query", "b_g1_query", "h_query", "l_query")
# the short array prefixes of the arrays tests/torch_jax_ref.py stages
# (the cubic golden); the parameter-cache layout uses the query names
SHORT_G1_QUERIES = {"a_query": "a", "b_g1_query": "b_g1", "h_query": "h", "l_query": "l"}


def proving_key_from_jax(arrays: dict) -> ProvingKey:
    """The JAX package's proving key, as numpy arrays, in the port's form.

    `arrays` holds the vk as `VerifyingKey.to_npz_dict` gives it,
    `beta_g1` / `delta_g1` compressed (48 bytes each), `log_n`, and each
    query as the JAX package stages it (16-bit limbs, Montgomery): for
    a, b_g1, h and l the arrays `<q>_x`, `<q>_y` [N, 24] and `<q>_valid`
    [N], `<q>` being `a_query` .. `l_query` (the parameter cache's
    layout) or `a`, `b_g1`, `h`, `l`; for b_g2 `b_g2_x0`, `b_g2_x1`,
    `b_g2_y0`, `b_g2_y1` and `b_g2_valid`. The limbs are re-viewed as
    32-bit limbs; no arithmetic is done, so both packages prove with the
    same key."""
    names = {q: q for q in G1_QUERIES} if "a_query_x" in arrays else SHORT_G1_QUERIES
    queries = {}
    for q, k in names.items():
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

# R as four LE 64-bit words (negative int64 row values lift to R - |x|)
_R_WORDS = np.asarray([(R >> (64 * i)) & (2**64 - 1) for i in range(4)], dtype=np.uint64)


def _i64_to_limbs32(x: np.ndarray) -> np.ndarray:
    """Signed int64 values -> canonical Fr (x mod r) as uint32 [n, 8]."""
    neg = x < 0
    mag = np.abs(x).astype(np.uint64)
    words = np.zeros((x.shape[0], 4), dtype=np.uint64)
    words[:, 0] = np.where(neg, _R_WORDS[0] - mag, mag)  # wraps mod 2^64
    words[neg, 1] = _R_WORDS[1] - (mag[neg] > _R_WORDS[0]).astype(np.uint64)
    words[neg, 2:] = _R_WORDS[2:]
    return words.view(np.uint32)


def _limbs(values) -> torch.Tensor:
    """python ints or an int32 [n, 8] tensor -> an int32 [n, 8] tensor."""
    return values if isinstance(values, torch.Tensor) else F.ints_to_limbs32(values)


def _eval_block(block, asg: np.ndarray) -> tuple:
    """One vectorized block's rows: (A, B, C) as uint32 [n, 8] canonical."""
    from ..ops import fr_vec as fv
    from .r1cs import FieldBlock

    cols = np.concatenate([block.a_cols, block.b_cols, block.c_cols])
    uniq = np.unique(cols) if len(cols) else np.zeros(0, np.int64)
    if hasattr(block, "pool"):  # FieldBlock or tiled.TiledBlock
        # compact the assignment to the referenced variables
        comp = np.full(int(uniq.max()) + 1 if len(uniq) else 1, -1, dtype=np.int64)
        comp[uniq] = np.arange(len(uniq))
        vals_v = np.ascontiguousarray(asg[uniq]).view("<u2").astype(np.uint64)
        view = FieldBlock(
            block.n,
            block.a_indptr, comp[block.a_cols], block.a_idx,
            block.b_indptr, comp[block.b_cols], block.b_idx,
            block.c_indptr, comp[block.c_cols], block.c_idx,
            block.pool,
        )
        return tuple(np.ascontiguousarray(v.astype("<u2")).view(np.uint32) for v in view.eval_rows_v(vals_v))
    # BulkBlock: referenced values fit int64 (the gadgets' contract), so
    # the low two words of each referenced value are the value
    lut = np.zeros(int(uniq.max()) + 1 if len(uniq) else 1, np.int64)
    lut[uniq] = np.ascontiguousarray(asg[uniq, :2]).view(np.int64)[:, 0]
    return tuple(_i64_to_limbs32(v) for v in block.eval_rows(lut))


def qap_evals(cs_finalized, assignment, log_n: int) -> list[torch.Tensor]:
    """A, B and C evaluated on the domain rows, as int32 [m, 8] canonical
    tensors on the CPU: row j of the circuit (dict rows by python-int
    sums, vectorized blocks by numpy, as the JAX package's `_compute_h`
    :599-669 evaluates them), then one row per public input (A = x_i,
    B = C = 0), then zeros. `assignment` is python ints or int32 [N, 8]
    canonical limbs."""
    n_in, _, rows, _, _ = cs_finalized
    m = 1 << log_n
    if len(rows) + n_in > m:
        raise ValueError(f"{len(rows) + n_in} rows do not fit a domain of {m}")
    asg = _limbs(assignment).cpu().numpy().view(np.uint32)
    ev = np.zeros((3, m, 8), dtype=np.uint32)
    segments = rows.segments() if hasattr(rows, "segments") else [("d", rows, 0)]
    for kind, seg, base in segments:
        if kind != "d":
            for side, vals in zip(ev, _eval_block(seg, asg)):
                side[base : base + seg.n] = vals
            continue
        if not seg:
            continue
        used = sorted({v for row in seg for terms in row for v in terms})
        vals = dict(zip(used, F.limbs32_to_ints(torch.from_numpy(asg[used].view(np.int32)))))
        sums = [sum(co * vals[v] for v, co in terms.items()) % R for row in seg for terms in row]
        ev[:, base : base + len(seg)] = (
            F.ints_to_limbs32(sums).numpy().view(np.uint32).reshape(len(seg), 3, 8).transpose(1, 0, 2)
        )
    ev[0, len(rows) : len(rows) + n_in] = asg[:n_in]
    return [torch.from_numpy(side.view(np.int32)) for side in ev]


def h_limbs(a, b, c, log_n: int, device="cuda") -> torch.Tensor:
    """The m - 1 coefficients of h, int32 [m - 1, 8] canonical on
    `device`, from the evaluations of A, B, C on the domain of size
    m = 2^log_n (python ints or int32 [m, 8] canonical tensors)."""
    dev = check_device(device)
    m = 1 << log_n
    ev = [k1.to_mont(_limbs(v).to(dev)) for v in (a, b, c)]
    return k1.from_mont(k3.h_from_evals(*ev, log_n))[: m - 1]


def h_from_evals(a, b, c, log_n: int, device="cuda") -> list[int]:
    """`h_limbs` as python ints."""
    return F.limbs32_to_ints(h_limbs(a, b, c, log_n, device))


def compute_h(cs_finalized, assignment, log_n: int, device="cuda") -> list[int]:
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
    """Groth16 prove; deterministic for fixed `randomness`. h stays on
    `device` between the transforms and its MSM. Spans (core/measure.py):
    prove_finalize, prove_evals, prove_h, and those of
    `prove_from_assignment`."""
    dev = check_device(device)
    with measure_op("prove_finalize"):
        fin = cs.finalize()
        n_in, _, _, inputs, aux = fin
        asg = F.ints_to_limbs32(inputs + aux)
    with measure_op("prove_evals"):
        evals = qap_evals(fin, asg, pk.log_n)
    with measure_op("prove_h"):
        h = h_limbs(*evals, pk.log_n, dev)
    del evals
    return prove_from_assignment(pk, asg[:n_in], asg[n_in:], h, randomness, device)


def prove_from_assignment(
    pk: ProvingKey,
    inputs,
    aux,
    h,
    randomness: bytes = b"fil-tpu-prove",
    device="cuda",
) -> Proof:
    """The MSM and assembly half of `prove`, from the finalized
    assignment and the h coefficients (each python ints or int32 [n, 8]
    canonical limbs). Spans (core/measure.py): prove_to_device,
    prove_msm_{a,b_g1,b_g2,h,l}, prove_assembly."""
    dev = check_device(device)
    rng = random.Random(hashlib.sha256(randomness).digest())
    r = rng.randrange(R)
    s = rng.randrange(R)
    with measure_op("prove_to_device"):
        key = pk.to(dev)
        n_in = len(inputs)
        assignment = torch.cat([_limbs(inputs), _limbs(aux)]).to(dev)
        h_t = _limbs(h).to(dev)
    with measure_op("prove_msm_a"):
        ev_a = _msm(G1, key.a_query, assignment)
    with measure_op("prove_msm_b_g1"):
        ev_b_g1 = _msm(G1, key.b_g1_query, assignment)
    with measure_op("prove_msm_b_g2"):
        ev_b_g2 = _msm(G2, key.b_g2_query, assignment)
    with measure_op("prove_msm_h"):
        ev_h = _msm(G1, key.h_query, h_t)
    with measure_op("prove_msm_l"):
        ev_l = _msm(G1, key.l_query, assignment[n_in:])
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


def partition_devices(devices=None, device="cuda") -> list[torch.device]:
    """The devices `prove_many` spreads partitions over: `devices` (a
    list or a `Mesh`) when given; else the card that `device` names
    ("cuda:1"), every card for a bare "cuda", or the CPU."""
    from ..parallel.sharded import Mesh, make_mesh

    if devices is None:
        dev = torch.device(device)
        devices = [dev] if dev.index is not None else make_mesh(device=dev)
    return list(devices.devices if isinstance(devices, Mesh) else map(torch.device, devices))


def prove_many(
    pk: ProvingKey,
    circuits: list,
    randomness: bytes = b"fil-tpu-prove",
    devices=None,
    device="cuda",
) -> list[Proof]:
    """Partition-parallel Groth16 (JAX :1087-1112): partition k is proved
    on devices[k mod D] with randomness + bytes([k]), the bytes of the
    serial per-partition loop, in a pool of min(k, D, 8) threads, each
    proof under its device and a stream of its own. `circuits` holds a
    constraint system per partition, or a function that makes one on
    the device given to it (the device that proves it, where the
    circuit's witness is replayed), called with that device current: on
    one device each is made just before its proof and dropped after it,
    so one partition is held at a time, both in the calling thread under
    the device; over several devices all are made first, in the calling
    thread. `devices`: see `partition_devices`. The key moves once to
    each distinct device."""
    from concurrent.futures import ThreadPoolExecutor

    from ..parallel.sharded import caller_streams, on_device

    check_device(device)
    devs = partition_devices(devices, device)
    keys = {d: pk.to(d) for d in dict.fromkeys(devs)}

    def circuit(k: int, cs):
        if not callable(cs):
            return cs
        d = devs[k % len(devs)]
        with on_device(d):
            return cs(d)

    def one(k: int, cs) -> Proof:
        d = devs[k % len(devs)]
        return prove(keys[d], circuit(k, cs), randomness=randomness + bytes([k]), device=d)

    workers = min(len(circuits), len(devs), 8)
    if workers <= 1:  # in the calling thread, each partition under its device
        proofs = []
        for k, cs in enumerate(circuits):
            with on_device(devs[k % len(devs)]):
                proofs.append(one(k, cs))
        return proofs
    made = [circuit(k, cs) for k, cs in enumerate(circuits)]
    callers = caller_streams(keys)

    def run(k: int) -> Proof:
        d = devs[k % len(devs)]
        with on_device(d, after=callers.get(d)):
            return one(k, made[k])

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(run, range(len(made))))


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _qap_tau_evals(constraints, n_in, num_vars, tau, log_n):
    """u_i(tau), v_i(tau), w_i(tau) for every variable i, on the host.

    Copied from the JAX package (zk/groth16.py:355): constraint rows are
    the evaluation domain points; the input consistency rows (one per
    public input: x_i * 0 = 0) follow the real constraints, mirroring
    bellperson's assembly.
    """
    m = 1 << log_n
    omega = root_of_unity(log_n)
    # Lagrange coefficients L_j(tau) = Z(tau) * omega^j / (m * (tau - omega^j))
    z_tau = (pow(tau, m, R) - 1) % R
    u = [0] * num_vars
    v = [0] * num_vars
    w = [0] * num_vars
    n_rows = len(constraints) + n_in
    if n_rows > m:
        raise ValueError(f"{n_rows} rows do not fit a domain of {m}")
    # batch-invert (tau - omega^j)
    omega_pows, cur = [], 1
    for _ in range(n_rows):
        omega_pows.append(cur)
        cur = cur * omega % R
    denoms = [(tau - wj) % R for wj in omega_pows]
    inv_denoms = _batch_inverse(denoms)
    m_inv = pow(m, R - 2, R)
    lag = [z_tau * wj % R * inv % R * m_inv % R for wj, inv in zip(omega_pows, inv_denoms)]

    def _accumulate_dicts(rows, base):
        for j, (a, b, c) in enumerate(rows):
            lj = lag[base + j]
            for var, coeff in a.items():
                u[var] = (u[var] + coeff * lj) % R
            for var, coeff in b.items():
                v[var] = (v[var] + coeff * lj) % R
            for var, coeff in c.items():
                w[var] = (w[var] + coeff * lj) % R

    def _accumulate_block(block, base):
        if hasattr(block, "pool"):  # FieldBlock or tiled.TiledBlock
            return _accumulate_field_block(block, base)
        for indptr, cols, coeffs, target in (
            (block.a_indptr, block.a_cols, block.a_coeffs, u),
            (block.b_indptr, block.b_cols, block.b_coeffs, v),
            (block.c_indptr, block.c_cols, block.c_coeffs, w),
        ):
            lens = np.diff(indptr)
            rows = np.repeat(np.arange(block.n, dtype=np.int64), lens)
            for var, coeff, row in zip(cols.tolist(), coeffs.tolist(), rows.tolist()):
                target[var] = (target[var] + coeff * lag[base + row]) % R

    def _accumulate_field_block(block, base):
        """u[var] += pool[idx] * lag[row] mod R, vectorized: products in
        limb space, then per-var segment sums over a col-sorted order —
        python-int work is one add per DISTINCT var, not per nnz."""
        from ..ops import fr_vec as fv

        lag_v = fv.to_v(lag[base : base + block.n])
        lag_m = fv.to_mont(lag_v)
        pool_v = block.pool_limbs()
        for indptr, cols, idx, target in (
            (block.a_indptr, block.a_cols, block.a_idx, u),
            (block.b_indptr, block.b_cols, block.b_idx, v),
            (block.c_indptr, block.c_cols, block.c_idx, w),
        ):
            if len(cols) == 0:
                continue
            lens = np.diff(indptr)
            rows = np.repeat(np.arange(block.n, dtype=np.int64), lens)
            terms = fv.mont_mul(pool_v[idx], lag_m[rows])
            order = np.argsort(cols, kind="stable")
            sorted_cols = cols[order]
            boundaries = np.nonzero(np.diff(sorted_cols, prepend=sorted_cols[0] - 1))[0]
            seg_ptr = np.concatenate([boundaries, [len(sorted_cols)]]).astype(np.int64)
            sums = fv.sum_mod_csr(terms[order], seg_ptr)
            for var, s in zip(sorted_cols[boundaries].tolist(), fv.from_v(sums)):
                target[var] = (target[var] + s) % R

    if hasattr(constraints, "segments"):
        for kind, seg, base in constraints.segments():
            if kind == "d":
                _accumulate_dicts(seg, base)
            else:
                _accumulate_block(seg, base)
    else:
        _accumulate_dicts(constraints, 0)
    # input consistency rows: A = x_i, B = 0, C = 0
    for i in range(n_in):
        u[i] = (u[i] + lag[len(constraints) + i]) % R
    return u, v, w, z_tau


def _batch_inverse(values: list[int]) -> list[int]:
    """Montgomery batch inversion over Fr (zk/groth16.py:456)."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, val in enumerate(values):
        prefix[i + 1] = prefix[i] * val % R
    inv_all = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * values[i] % R
    return out


def setup(cs, seed: bytes = b"fil-tpu-setup", device="cuda") -> ProvingKey:
    """A CRS for the circuit, deterministic from `seed`, with its queries
    on `device`: the JAX package's `setup` (zk/groth16.py:475) with the
    same draws of tau, alpha, beta, gamma and delta, the same scalars and
    the same query layout, so the key is the same bit for bit. The QAP
    evaluation at tau and the scalar lists run on the host; the
    fixed-base batches and their normalisation on `device`
    (ops/fixed_base.py): every G1 query in one batch, b_g2 in another.
    Spans (core/measure.py): setup_finalize, setup_qap, setup_scalars,
    setup_fixed_base_g1, setup_fixed_base_g2."""
    dev = check_device(device)
    rng = random.Random(hashlib.sha256(seed).digest())
    tau = rng.randrange(1, R)
    alpha = rng.randrange(1, R)
    beta = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    delta = rng.randrange(1, R)

    with measure_op("setup_finalize"):
        n_in, n_aux, constraints, _, _ = cs.finalize()
    num_vars = n_in + n_aux
    n_rows = len(constraints) + n_in
    log_n = max(1, (n_rows - 1).bit_length())
    with measure_op("setup_qap"):
        u, v, w, z_tau = _qap_tau_evals(constraints, n_in, num_vars, tau, log_n)
    del constraints

    with measure_op("setup_scalars"):
        gamma_inv = pow(gamma, R - 2, R)
        delta_inv = pow(delta, R - 2, R)
        ic_scalars = [(beta * u[i] + alpha * v[i] + w[i]) % R * gamma_inv % R for i in range(n_in)]
        l_scalars = F.ints_to_limbs32(
            [(beta * u[i] + alpha * v[i] + w[i]) % R * delta_inv % R for i in range(n_in, num_vars)]
        )
        del w
        h_scalars, cur = [], z_tau * delta_inv % R
        for _ in range((1 << log_n) - 1):
            h_scalars.append(cur)
            cur = cur * tau % R
        h_scalars = F.ints_to_limbs32(h_scalars)
        u = F.ints_to_limbs32(u)
        v = F.ints_to_limbs32(v)

    # every G1 query in one fixed-base batch: a (u), b_g1 (v), ic, l, h
    g1_scalars = torch.cat([u, v, F.ints_to_limbs32(ic_scalars), l_scalars, h_scalars]).to(dev)
    del u, l_scalars, h_scalars
    with measure_op("setup_fixed_base_g1"):
        aff, valid = fixed_base(G1, g1_scalars)
    del g1_scalars
    parts = [num_vars, num_vars, n_in, n_aux, (1 << log_n) - 1]
    a_query, b_g1_query, ic_query, l_query, h_query = zip(aff.split(parts), valid.split(parts))
    ic = host_points(G1, *ic_query)
    with measure_op("setup_fixed_base_g2"):
        b_g2_query = fixed_base(G2, v.to(dev))
    del v

    g1 = g1_from_affine(G1_GEN)
    g2 = g2_from_affine((G2_GEN_X, G2_GEN_Y))
    vk = VerifyingKey(
        alpha_g1=g1_mul(g1, alpha),
        beta_g2=g2_mul(g2, beta),
        gamma_g2=g2_mul(g2, gamma),
        delta_g2=g2_mul(g2, delta),
        ic=ic,
    )
    return ProvingKey(
        vk=vk,
        beta_g1=g1_mul(g1, beta),
        delta_g1=g1_mul(g1, delta),
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
        log_n=log_n,
    )


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
