"""Challenge-batched SDR circuit emission (VERDICT r4 item 6).

Semantically identical to circuit/proof.synthesize (same constraint
CONTENT per challenge, same public-input order/values — reference
stacked/circuit/proof.hpp:42-337), but emitted op-major across the K
challenges of a partition:

- the SHA-256 mass (tree_d node hashes + the 11 labeling digests; ~84%
  of constraints) goes through the K-instance batched emitter
  (zk/gadgets/sha256_vec.sha256_batch) — witness values ride the
  BitVec lanes, so there is no separate replay;
- column hashes and the oct-tree PoRs ride the tiled poseidon/PoR
  templates (zk/gadgets/tiled.py) with their vectorized replays;
- the ~100 big-coefficient rows per challenge (254-bit packings,
  label/encoding ties) stay python dict rows — they are O(K), not
  O(K * bits).

Public inputs are pre-allocated up front in the scalar order, so
generate_public_inputs is unchanged. Variable order differs from the
scalar path (which is invisible to Groth16 as long as setup and prove
share one path); the committed seal2k goldens are regenerated
accordingly.

Copied from crypto3_fil_proofs_tpu/models/porep/stacked/circuit/batched.py with its imports rewritten.
"""
from __future__ import annotations

import numpy as np

from crypto3_fil_proofs_torch.ops import fr_vec as fv
from crypto3_fil_proofs_torch.ops.bls12_381 import R
from crypto3_fil_proofs_torch.zk.gadgets import tiled
from crypto3_fil_proofs_torch.zk.gadgets.num import AllocatedNum
from crypto3_fil_proofs_torch.zk.gadgets.poseidon import hash2_circuit
from crypto3_fil_proofs_torch.zk.gadgets.por import (
    packed_position_input_values,
)
from crypto3_fil_proofs_torch.zk.gadgets.sha256 import le_bits_to_be
from crypto3_fil_proofs_torch.zk.gadgets.sha256_vec import (
    BitVec,
    ShaEmitter,
    _EMPTY_I64,
    sha256_batch,
    state_bits_le_batch,
)
from crypto3_fil_proofs_torch.zk.r1cs import ConstraintSystem

from ..vanilla.params import TOTAL_PARENTS

_LE = lambda b: int.from_bytes(b, "little")


def _bytes_vals(rows: list[bytes]) -> np.ndarray:
    """32-byte LE values -> [N] object array of python ints."""
    return np.array([_LE(r) for r in rows], dtype=object)


def _bits_of(vals: np.ndarray, n_bits: int) -> np.ndarray:
    """[K] ints -> [K, n_bits] uint8 LE bits."""
    out = np.empty((len(vals), n_bits), np.uint8)
    for i, v in enumerate(vals):
        iv = int(v)
        out[i] = [(iv >> b) & 1 for b in range(n_bits)]
    return out


class _Batch:
    """Small helper around one ShaEmitter for batched non-sha rows."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.em = ShaEmitter(cs)

    # -- K nums, no constraints (AllocatedNum.alloc content) ----------
    def alloc_nums(self, values) -> np.ndarray:
        base = self.cs.bulk_alloc([int(v) % R for v in values])
        return np.arange(base, base + len(values), dtype=np.int64)

    # -- K bit-decompositions with booleanity + one pack row each -----
    def to_bits_le(self, num_vars, values, n_bits) -> BitVec:
        """Mirror of AllocatedNum.to_bits_le per instance: bulk bits +
        booleanity rows + a 254-coeff dict pack row per instance."""
        K = len(num_vars)
        bits = _bits_of(values, n_bits)
        ids = self.em.alloc_bits(bits.ravel(), booleanity=True)
        ids2 = ids.reshape(K, n_bits)
        for k in range(K):
            a = {int(ids2[k, i]): pow(2, i, R) for i in range(n_bits)}
            a[int(num_vars[k])] = R - 1
            self.cs.enforce_raw(a, {0: 1}, {})
        return BitVec(
            ids.copy(),
            np.zeros(K * n_bits, bool),
            bits.ravel().astype(np.uint8),
        )

    # -- K binary picks: out = cond ? a : b ---------------------------
    # NOTE pick/equals rows reference FULL field values (leaves,
    # siblings), which the BulkBlock int64 evaluation contract forbids —
    # they go out as dict rows (O(K), cheap); only bit-referencing rows
    # ride BulkBlocks.
    def pick(self, cond_vars, cond_vals, a_vars, a_vals, b_vars, b_vals):
        """(a - b) * cond = out - b, one row per instance (num.pick)."""
        K = len(cond_vars)
        out_vals = [
            int(a_vals[k]) if cond_vals[k] else int(b_vals[k])
            for k in range(K)
        ]
        out_vars = self.alloc_nums(out_vals)
        for k in range(K):
            av, bv = int(a_vars[k]), int(b_vars[k])
            a = {av: 1}
            a[bv] = (a.get(bv, 0) + R - 1) % R
            c = {int(out_vars[k]): 1}
            c[bv] = (c.get(bv, 0) + R - 1) % R
            self.cs.enforce_raw(a, {int(cond_vars[k]): 1}, c)
        return out_vars, np.array(out_vals, dtype=object)

    # -- K equality rows: a == b --------------------------------------
    def equals(self, a_vars, b_vars):
        for k in range(len(a_vars)):
            av, bv = int(a_vars[k]), int(b_vars[k])
            a = {av: 1}
            a[bv] = (a.get(bv, 0) + R - 1) % R
            self.cs.enforce_raw(a, {0: 1}, {})

    def flush(self, label: str):
        self.em.flush(label)


def _pack_le254_rows(cs, le_bits: BitVec, K: int, tie_vars):
    """Per instance: sum 2^i le_bits[k, i] (i < 254) - tie_var = 0 as a
    dict row. le_bits lanes [K*256] instance-major (const lanes fold
    into the row constant via var 0)."""
    v2 = le_bits.var.reshape(K, -1)
    n2 = le_bits.neg.reshape(K, -1)
    a2 = le_bits.val.reshape(K, -1)
    for k in range(K):
        a: dict[int, int] = {}
        const = 0
        for i in range(254):
            var = int(v2[k, i])
            coeff = pow(2, i, R)
            if var < 0:
                if a2[k, i]:
                    const += coeff
            elif n2[k, i]:
                # negated: semantic bit = 1 - raw
                const += coeff
                a[var] = (a.get(var, 0) - coeff) % R
            else:
                a[var] = (a.get(var, 0) + coeff) % R
        if const:
            a[0] = (a.get(0, 0) + const) % R
        a[int(tie_vars[k])] = (a.get(int(tie_vars[k]), 0) + R - 1) % R
        cs.enforce_raw(a, {0: 1}, {})


def _le254_value(le_bits: BitVec, K: int) -> list[int]:
    a2 = le_bits.val.reshape(K, -1)
    return [
        int(sum(int(b) << i for i, b in enumerate(a2[k, :254])) % R)
        for k in range(K)
    ]


def _sha256_digest_batch(bt: _Batch, msg: BitVec, L: int, K: int):
    """Batched sha256 -> (le_bits [K*256] BitVec, values [K])."""
    state = sha256_batch(bt.em, msg, L, K)
    le = state_bits_le_batch(state, K)
    return le, _le254_value(le, K)


def _num_bits_to_be256(bits: BitVec, K: int, n_bits: int) -> BitVec:
    """Per instance: n_bits LE bits (+ const-0 padding to 256) reordered
    BE-within-byte (_num_to_256_le_bits + le_bits_to_be of the scalar
    path)."""
    var = np.full((K, 256), -1, np.int64)
    neg = np.zeros((K, 256), bool)
    val = np.zeros((K, 256), np.uint8)
    var[:, :n_bits] = bits.var.reshape(K, n_bits)
    neg[:, :n_bits] = bits.neg.reshape(K, n_bits)
    val[:, :n_bits] = bits.val.reshape(K, n_bits)
    idx = np.arange(256).reshape(-1, 8)[:, ::-1].ravel()
    return BitVec(
        var[:, idx].ravel(), neg[:, idx].ravel(), val[:, idx].ravel()
    )


def _be64_bits_batch(d_bits: BitVec, K: int, n_bits: int) -> BitVec:
    """LE node bits (padded to 64) -> BE64 byte-stream bits
    (_be64_bits of the scalar path), batched."""
    var = np.full((K, 64), -1, np.int64)
    neg = np.zeros((K, 64), bool)
    val = np.zeros((K, 64), np.uint8)
    var[:, :n_bits] = d_bits.var.reshape(K, -1)[:, :n_bits]
    neg[:, :n_bits] = d_bits.neg.reshape(K, -1)[:, :n_bits]
    val[:, :n_bits] = d_bits.val.reshape(K, -1)[:, :n_bits]
    order = []
    for kk in range(8):
        base = 8 * (7 - kk)
        for i in range(7, -1, -1):
            order.append(base + i)
    idx = np.asarray(order)
    return BitVec(
        var[:, idx].ravel(), neg[:, idx].ravel(), val[:, idx].ravel()
    )


def _concat_bitvecs(parts: list[tuple[BitVec, int]], K: int) -> BitVec:
    """Concatenate per-instance segments: parts = [(vec, seg_len)]."""
    var = np.concatenate(
        [p.var.reshape(K, n) for p, n in parts], axis=1
    ).ravel()
    neg = np.concatenate(
        [p.neg.reshape(K, n) for p, n in parts], axis=1
    ).ravel()
    val = np.concatenate(
        [p.val.reshape(K, n) for p, n in parts], axis=1
    ).ravel()
    return BitVec(var, neg, val)


def _broadcast_bools(bits, K: int) -> BitVec:
    one = BitVec.from_booleans(bits)
    n = len(bits)
    return BitVec(
        np.tile(one.var, K), np.tile(one.neg, K), np.tile(one.val, K)
    )


def synthesize_batched(
    cs: ConstraintSystem,
    pub_params,
    replica_id: bytes,
    comm_d: bytes,
    comm_r: bytes,
    comm_c: bytes,
    comm_r_last: bytes,
    vanilla_proofs,
    blank: bool = False,
    device="cuda",
) -> None:
    """The partition's circuit into cs; the Poseidon witness of the column
    hashes and PoRs replayed on `device`."""
    from .proof import _num_to_256_le_bits

    layers = pub_params.layers
    K = len(vanilla_proofs)
    p0 = vanilla_proofs[0]
    d_opts0 = p0.comm_d_proof.as_options()
    depth_d = len(d_opts0)
    oct_opts0 = p0.replica_column_proofs.c_x.inclusion_proof.as_options()
    oct_arities = tuple(len(s) + 1 for s, _ in oct_opts0)
    oct_bits_per = [(len(s)).bit_length() for s, _ in oct_opts0]
    oct_total_bits = sum(oct_bits_per)
    n_oct_packs = -(-oct_total_bits // 254)
    n_d_packs = -(-depth_d // 254)
    r_opts0 = p0.comm_r_last_proof.as_options()
    r_arities = tuple(len(s) + 1 for s, _ in r_opts0)
    r_total_bits = sum((len(s)).bit_length() for s, _ in r_opts0)
    n_r_packs = -(-r_total_bits // 254)
    n_drg = len(p0.replica_column_proofs.drg_parents)
    n_exp = len(p0.replica_column_proofs.exp_parents)

    # ---- globals (scalar gadgets, one instance) ----------------------
    replica_id_num = AllocatedNum.alloc_input(cs, _LE(replica_id), "replica_id")
    comm_d_num = AllocatedNum.alloc_input(cs, _LE(comm_d), "comm_d")
    comm_r_num = AllocatedNum.alloc_input(cs, _LE(comm_r), "comm_r")
    comm_r_last_num = AllocatedNum.alloc(cs, _LE(comm_r_last), "comm_r_last")
    comm_c_num = AllocatedNum.alloc(cs, _LE(comm_c), "comm_c")
    hashed = hash2_circuit(cs, comm_c_num, comm_r_last_num)
    AllocatedNum.equals(cs, hashed, comm_r_num)
    replica_id_bits_le = _num_to_256_le_bits(cs, replica_id_num)
    replica_id_bits_be = le_bits_to_be(replica_id_bits_le)
    rid_be_vec = _broadcast_bools(replica_id_bits_be, K)

    # ---- pre-allocate the per-challenge public inputs in order -------
    def _challenge_of(proof) -> int:
        idx, mult = 0, 1
        for sibs, i in proof.comm_d_proof.as_options():
            idx += i * mult
            mult *= len(sibs) + 1
        return idx

    def _path_index(opts, bits_per) -> int:
        idx, shift = 0, 0
        for (sibs, i), nb in zip(opts, bits_per):
            idx |= i << shift
            shift += nb
        return idx

    d_pack_vars = np.empty((K, n_d_packs), np.int64)
    drg_pack_vars = np.empty((K, n_drg, n_oct_packs), np.int64)
    exp_pack_vars = np.empty((K, n_exp, n_oct_packs), np.int64)
    chal_vars = np.empty(K, np.int64)
    r_pack_vars = np.empty((K, n_r_packs), np.int64)
    cx_pack_vars = np.empty((K, n_oct_packs), np.int64)
    challenges = [_challenge_of(p) for p in vanilla_proofs]
    for k, p in enumerate(vanilla_proofs):
        rcp = p.replica_column_proofs
        for j, v in enumerate(
            packed_position_input_values(challenges[k], depth_d)
        ):
            d_pack_vars[k, j] = cs.alloc_input(v, "packed_bits")
        for pi, cp in enumerate(rcp.drg_parents):
            pos = _path_index(cp.inclusion_proof.as_options(), oct_bits_per)
            for j, v in enumerate(
                packed_position_input_values(pos, oct_total_bits)
            ):
                drg_pack_vars[k, pi, j] = cs.alloc_input(v, "packed_bits")
        for pi, cp in enumerate(rcp.exp_parents):
            pos = _path_index(cp.inclusion_proof.as_options(), oct_bits_per)
            for j, v in enumerate(
                packed_position_input_values(pos, oct_total_bits)
            ):
                exp_pack_vars[k, pi, j] = cs.alloc_input(v, "packed_bits")
        chal_vars[k] = cs.alloc_input(challenges[k], "inputized")
        rpos = _path_index(
            p.comm_r_last_proof.as_options(),
            [(len(s)).bit_length() for s, _ in p.comm_r_last_proof.as_options()],
        )
        for j, v in enumerate(
            packed_position_input_values(rpos, r_total_bits)
        ):
            r_pack_vars[k, j] = cs.alloc_input(v, "packed_bits")
        cpos = _path_index(rcp.c_x.inclusion_proof.as_options(), oct_bits_per)
        for j, v in enumerate(
            packed_position_input_values(cpos, oct_total_bits)
        ):
            cx_pack_vars[k, j] = cs.alloc_input(v, "packed_bits")

    bt = _Batch(cs)

    # ---- 1. tree_d PoR (binary, sha256 nodes), batched ---------------
    leaf_d_vals = _bytes_vals([p.comm_d_proof.leaf for p in vanilla_proofs])
    leaf_d_vars = bt.alloc_nums(leaf_d_vals)
    cur_vars, cur_vals = leaf_d_vars, leaf_d_vals
    d_bit_parts = []
    for lvl in range(depth_d):
        # one index bit per instance (alloc_bits_bulk content)
        bvals = np.asarray(
            [p.comm_d_proof.as_options()[lvl][1] for p in vanilla_proofs],
            np.uint8,
        )
        bids = bt.em.alloc_bits(bvals, booleanity=True)
        bvec = BitVec(bids.copy(), np.zeros(K, bool), bvals)
        d_bit_parts.append((bvec, 1))
        sib_vals = _bytes_vals(
            [p.comm_d_proof.as_options()[lvl][0][0] for p in vanilla_proofs]
        )
        sib_vars = bt.alloc_nums(sib_vals)
        c0_vars, c0_vals = bt.pick(
            bids, bvals, sib_vars, sib_vals, cur_vars, cur_vals
        )
        c1_vars, c1_vals = bt.pick(
            bids, bvals, cur_vars, cur_vals, sib_vars, sib_vals
        )
        # sha256_node: two 256-bit decompositions + sha256 + digest tie
        bits0 = bt.to_bits_le(c0_vars, c0_vals, 256)
        bits1 = bt.to_bits_le(c1_vars, c1_vals, 256)
        le512 = _concat_bitvecs([(bits0, 256), (bits1, 256)], K)
        # block_be = le_bits_to_be(le512)
        idx = np.arange(512).reshape(-1, 8)[:, ::-1].ravel()
        blk = BitVec(
            le512.var.reshape(K, 512)[:, idx].ravel(),
            le512.neg.reshape(K, 512)[:, idx].ravel(),
            le512.val.reshape(K, 512)[:, idx].ravel(),
        )
        le_dig, dig_vals = _sha256_digest_batch(bt, blk, 512, K)
        out_vars = bt.alloc_nums(dig_vals)
        _pack_le254_rows(cs, le_dig, K, out_vars)
        cur_vars, cur_vals = out_vars, np.array(dig_vals, dtype=object)
    # root equality
    bt.equals(cur_vars, np.full(K, comm_d_num.var, np.int64))
    d_bits = _concat_bitvecs(d_bit_parts, K)  # [K * depth_d]
    # pack d bits into the pre-allocated inputs
    for j in range(n_d_packs):
        lo = j * 254
        seg = BitVec(
            d_bits.var.reshape(K, -1)[:, lo : lo + 254],
            d_bits.neg.reshape(K, -1)[:, lo : lo + 254],
            d_bits.val.reshape(K, -1)[:, lo : lo + 254],
        )
        n_seg = seg.var.shape[1]
        for k in range(K):
            a = {
                int(seg.var[k, i]): pow(2, i, R) for i in range(n_seg)
            }
            a[int(d_pack_vars[k, j])] = R - 1
            cs.enforce_raw(a, {0: 1}, {})
    bt.flush("tree_d_por")

    # ---- 2. columns: alloc + poseidon hash + oct PoR (tiled) ---------
    def _columns(kind):
        if kind == "cx":
            return [
                [p.replica_column_proofs.c_x] for p in vanilla_proofs
            ]
        src = (
            [p.replica_column_proofs.drg_parents for p in vanilla_proofs]
            if kind == "drg"
            else [p.replica_column_proofs.exp_parents for p in vanilla_proofs]
        )
        return src

    # order per scalar path: drg cols, exp cols, (challenge), r_last,
    # c_x — emission order here is free; keep that grouping for clarity
    col_sets = {}
    for kind, packs in (
        ("drg", drg_pack_vars),
        ("exp", exp_pack_vars),
        ("cx", cx_pack_vars.reshape(K, 1, n_oct_packs)),
    ):
        cols = _columns(kind)
        P = len(cols[0])
        # [K * P, layers] values, instance-major (k major, parent minor)
        vals = [
            _LE(row)
            for k in range(K)
            for cp in cols[k]
            for row in cp.column.rows
        ]
        base = cs.bulk_alloc(vals)
        col_vars = np.arange(
            base, base + K * P * layers, dtype=np.int64
        ).reshape(K * P, layers)
        col_v = tiled.bytes_rows_to_v(
            [
                row
                for k in range(K)
                for cp in cols[k]
                for row in cp.column.rows
            ]
        ).reshape(K * P, layers, 16)
        digest_vars, digest_v = tiled.poseidon_circuit_batch(
            cs, col_vars, None if blank else col_v, layers, device
        )
        # oct PoR with the digest as external leaf
        if blank:
            levels = None
        else:
            incls = [
                cp.inclusion_proof for k in range(K) for cp in cols[k]
            ]
            levels = []
            for lvl in range(len(oct_arities)):
                sibs = tiled.bytes_rows_to_v(
                    [s for ip in incls for s in ip.as_options()[lvl][0]]
                ).reshape(len(incls), oct_arities[lvl] - 1, 16)
                idxs = np.asarray(
                    [ip.as_options()[lvl][1] for ip in incls], np.int64
                )
                levels.append((sibs, idxs))
        tiled.por_circuit_batch_extleaf(
            cs,
            np.full(K * P, comm_c_num.var, np.int64),
            digest_vars,
            packs.reshape(K * P, n_oct_packs),
            oct_arities,
            digest_v,
            levels,
            device,
        )
        col_sets[kind] = (col_vars.reshape(K, P, layers),
                          col_v.reshape(K, P, layers, 16))

    # ---- 3. challenge value tie (mirror from_bits_le + inputize) -----
    packed_vals = [int(c) % R for c in challenges]
    packed_vars = bt.alloc_nums(packed_vals)
    v2 = d_bits.var.reshape(K, depth_d)
    for k in range(K):
        a = {int(v2[k, i]): pow(2, i, R) for i in range(depth_d)}
        a[int(packed_vars[k])] = R - 1
        cs.enforce_raw(a, {0: 1}, {})  # "packing"
        cs.enforce_raw(
            {int(chal_vars[k]): 1}, {0: 1}, {int(packed_vars[k]): 1}
        )  # "inputize"

    # ---- 4. comm_r_last PoR (tiled standard template) ----------------
    leaf_r_v = tiled.bytes_rows_to_v(
        [p.comm_r_last_proof.leaf for p in vanilla_proofs]
    )
    r_levels = []
    for lvl in range(len(r_arities)):
        sibs = tiled.bytes_rows_to_v(
            [
                s
                for p in vanilla_proofs
                for s in p.comm_r_last_proof.as_options()[lvl][0]
            ]
        ).reshape(K, r_arities[lvl] - 1, 16)
        idxs = np.asarray(
            [p.comm_r_last_proof.as_options()[lvl][1] for p in vanilla_proofs],
            np.int64,
        )
        r_levels.append((sibs, idxs))
    r_bases = tiled.por_circuit_batch(
        cs,
        np.full(K, comm_r_last_num.var, np.int64),
        r_pack_vars,
        r_arities,
        None if blank else leaf_r_v,
        None if blank else r_levels,
        device,
    )
    leaf_r_vars = r_bases  # leaf is the template's first internal

    # ---- 5. label digests per layer + ties ---------------------------
    # label bits for drg (layers 1..layers) and exp (layers 1..layers-1)
    drg_vars, drg_v = col_sets["drg"]
    exp_vars, exp_v = col_sets["exp"]

    bit_cache: dict[tuple, BitVec] = {}

    def label_bits(kind, p, layer) -> BitVec:
        key = (kind, p, layer)
        vec = bit_cache.get(key)
        if vec is None:
            cvars, cv = (drg_vars, drg_v) if kind == "drg" else (exp_vars, exp_v)
            nums = cvars[:, p, layer - 1]
            vals = fv.from_v(np.ascontiguousarray(cv[:, p, layer - 1]))
            le = bt.to_bits_le(nums, vals, 254)
            vec = _num_bits_to_be256(le, K, 254)
            bit_cache[key] = vec
        return vec

    node_be64 = _be64_bits_batch(d_bits, K, depth_d)
    L_msg = 256 + 32 + 64 + 160 + TOTAL_PARENTS * 256
    # all layers' messages are independent given the column bits, so
    # the whole partition's labeling is ONE layers*K-instance sha256
    # call (lane order layer-major) — the per-layer loop paid ~1.5 ms
    # of small-array numpy overhead per addmany call (r5 profile)
    msgs = []
    for layer in range(1, layers + 1):
        if layer == 1:
            parents = [label_bits("drg", p, 1) for p in range(n_drg)]
        else:
            parents = [
                label_bits("drg", p, layer) for p in range(n_drg)
            ] + [label_bits("exp", p, layer - 1) for p in range(n_exp)]
        full = [parents[i % len(parents)] for i in range(TOTAL_PARENTS)]
        layer_bits = [(layer >> i) & 1 for i in range(31, -1, -1)]
        msgs.append(
            _concat_bitvecs(
                [(rid_be_vec, 256),
                 (BitVec.const(
                     np.tile(np.asarray(layer_bits, np.uint8), K)), 32),
                 (node_be64, 64),
                 (BitVec.const(np.zeros(K * 160, np.uint8)), 160)]
                + [(pb, 256) for pb in full],
                K,
            )
        )
    big = BitVec(
        np.concatenate([m.var for m in msgs]),
        np.concatenate([m.neg for m in msgs]),
        np.concatenate([m.val for m in msgs]),
    )
    le_all, vals_all = _sha256_digest_batch(bt, big, L_msg, layers * K)
    lv = le_all.var.reshape(layers, K, 256)
    ln = le_all.neg.reshape(layers, K, 256)
    la = le_all.val.reshape(layers, K, 256)
    key_rows = None
    for layer in range(1, layers + 1):
        le_dig = BitVec(
            lv[layer - 1].ravel(), ln[layer - 1].ravel(),
            la[layer - 1].ravel(),
        )
        # tie: label_lc - expected_col = 0 (dict row per instance)
        cx_vars = col_sets["cx"][0][:, 0, layer - 1]
        _pack_le254_rows(cs, le_dig, K, cx_vars)
        if layer == layers:
            key_rows = (
                le_dig, vals_all[(layer - 1) * K : layer * K]
            )
    bt.flush("labels")

    # ---- 6. encoding: leaf_d + key - leaf_r = 0 ----------------------
    le_key, _ = key_rows
    v2 = le_key.var.reshape(K, -1)
    n2 = le_key.neg.reshape(K, -1)
    a2 = le_key.val.reshape(K, -1)
    for k in range(K):
        a: dict[int, int] = {}
        const = 0
        for i in range(254):
            var = int(v2[k, i])
            coeff = pow(2, i, R)
            if var < 0:
                if a2[k, i]:
                    const += coeff
            elif n2[k, i]:
                const += coeff
                a[var] = (a.get(var, 0) - coeff) % R
            else:
                a[var] = (a.get(var, 0) + coeff) % R
        if const:
            a[0] = (a.get(0, 0) + const) % R
        a[int(leaf_d_vars[k])] = (a.get(int(leaf_d_vars[k]), 0) + 1) % R
        a[int(leaf_r_vars[k])] = (
            a.get(int(leaf_r_vars[k]), 0) + R - 1
        ) % R
        cs.enforce_raw(a, {0: 1}, {})
