"""Array-synthesis SHA-256 circuit (the vectorized emission path).

Semantics are identical to the per-bit gadget (zk/gadgets/sha256.py +
boolean.py/uint32.py, bellperson sha256.rs): same constraint CONTENT
per bit (xor/and/and_not/nor patterns, one packing row per addmany with
static-bound width), same tri-state constant folding — but emitted 32
bits at a time into numpy CSR BulkBlocks (zk/r1cs.BulkBlock) instead of
one python dict per constraint. Variable/constraint ordering differs
from the scalar gadget (op-major instead of bit-major), which is
invisible to Groth16 as long as setup and prove both synthesize through
this path.

This is the SURVEY §2.9 synthesis-throughput item (VERDICT r1 weak #5:
python dict synthesis ~45-120k constraints/s): SHA-256 is ~84%% of SDR
circuit synthesis (the 37-parent labeling digests,
stacked/circuit/proof.py _labeling_digest; reference consumed blueprint
sha256 — rust-fil-proofs create_label_circuit semantics).

Coefficient contract: all coefficients emitted here are signed ints
with |coeff| < 2^40 (powers of two up to the addmany static bound), so
BulkBlock int64 evaluation is exact.

Copied from crypto3_fil_proofs_tpu/zk/gadgets/sha256_vec.py with its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..r1cs import _EMPTY_I64, ConstraintSystem, _BulkBuilder
from .boolean import AllocatedBit, Boolean
from .sha256 import IV, ROUND_CONSTANTS


_ONES_CACHE: dict[int, np.ndarray] = {}
_ZEROS_CACHE: dict[int, np.ndarray] = {}


def _zeros(n: int) -> np.ndarray:
    out = _ZEROS_CACHE.get(n)
    if out is None:
        out = np.zeros(n, np.int64)
        out.setflags(write=False)
        _ZEROS_CACHE[n] = out
    return out
_XORC_CACHE: dict[int, np.ndarray] = {}
_ROLL_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _ones(n: int) -> np.ndarray:
    out = _ONES_CACHE.get(n)
    if out is None:
        out = np.ones(n, np.int64)
        out.setflags(write=False)
        _ONES_CACHE[n] = out
    return out


def _xor_c_coeffs(n: int) -> np.ndarray:
    """[1, 1, -1] * n, the c-side of the non-degenerate xor row."""
    out = _XORC_CACHE.get(n)
    if out is None:
        out = np.tile(np.array([1, 1, -1], np.int64), n)
        out.setflags(write=False)
        _XORC_CACHE[n] = out
    return out


def _roll_idx(n: int, k: int) -> np.ndarray:
    key = (n, k)
    out = _ROLL_CACHE.get(key)
    if out is None:
        out = (np.arange(n) - k) % n
        out.setflags(write=False)
        _ROLL_CACHE[key] = out
    return out


@dataclass
class BitVec:
    """A batch of tri-state Booleans as SoA numpy arrays.

    var: int64, -1 for constants; neg: negation flag (var lanes);
    val: semantic value 0/1 (the underlying AllocatedBit's raw value is
    val ^ neg)."""

    var: np.ndarray
    neg: np.ndarray
    val: np.ndarray

    @classmethod
    def const(cls, vals) -> "BitVec":
        v = np.asarray(vals, np.uint8)
        return cls(np.full(v.shape, -1, np.int64),
                   np.zeros(v.shape, bool), v)

    @classmethod
    def from_booleans(cls, bits: list[Boolean]) -> "BitVec":
        n = len(bits)
        var = np.full(n, -1, np.int64)
        neg = np.zeros(n, bool)
        val = np.zeros(n, np.uint8)
        for i, b in enumerate(bits):
            if b.constant is None:
                var[i] = b.bit.var
                neg[i] = b.negated
            val[i] = b.value
        return cls(var, neg, val)

    def to_booleans(self) -> list[Boolean]:
        out = []
        for i in range(len(self.var)):
            if self.var[i] < 0:
                out.append(Boolean.const(bool(self.val[i])))
            else:
                raw = int(self.val[i]) ^ int(self.neg[i])
                out.append(
                    Boolean(
                        bit=AllocatedBit(int(self.var[i]), raw),
                        negated=bool(self.neg[i]),
                    )
                )
        return out

    def not_(self) -> "BitVec":
        isvar = self.var >= 0
        return BitVec(
            self.var.copy(),
            np.where(isvar, ~self.neg, False),
            (1 - self.val).astype(np.uint8),
        )

    def roll(self, k: int) -> "BitVec":
        idx = _roll_idx(len(self.var), k)
        return BitVec(self.var[idx], self.neg[idx], self.val[idx])

    def take(self, idx) -> "BitVec":
        return BitVec(self.var[idx], self.neg[idx], self.val[idx])


class ShaEmitter:
    """Accumulates bulk constraints + allocations for one sha256 call,
    flushed into the ConstraintSystem as a single BulkBlock."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.builder = _BulkBuilder()

    def flush(self, label="sha256"):
        if self.builder.n:
            self.cs.add_bulk_block(self.builder.build(label))
        self.builder = _BulkBuilder()

    # -- allocation ---------------------------------------------------------

    def alloc_bits(self, raw_vals: np.ndarray, booleanity=True) -> np.ndarray:
        """Allocate bits (raw values) and, like AllocatedBit.alloc, add
        the b*(1-b)=0 booleanity rows. Returns var ids."""
        raw_vals = np.asarray(raw_vals, np.uint8)
        n = len(raw_vals)
        base = self.cs.bulk_alloc(raw_vals)
        ids = np.arange(base, base + n, dtype=np.int64)
        if booleanity and n:
            ones = np.ones(n, np.int64)
            # a = {b:1}, b = {one:1, b:-1}, c = {}
            b_cols = np.empty(2 * n, np.int64)
            b_cols[0::2] = 0
            b_cols[1::2] = ids
            b_coeffs = np.empty(2 * n, np.int64)
            b_coeffs[0::2] = 1
            b_coeffs[1::2] = -1
            self.builder.add_rows(
                n,
                ones, ids, ones,
                2 * ones, b_cols, b_coeffs,
                _zeros(n), _EMPTY_I64, _EMPTY_I64,
            )
        return ids

    # -- boolean ops (Boolean.xor / Boolean.and_ semantics) -----------------

    def _xor_allvar(self, a: BitVec, b: BitVec) -> BitVec:
        """Fast path: every lane var-var, no degenerate a==b lanes."""
        n = len(a.var)
        ids = self.alloc_bits(
            (a.val ^ a.neg ^ b.val ^ b.neg).astype(np.uint8),
            booleanity=False,
        )
        ones = _ones(n)
        c_cols = np.empty((n, 3), np.int64)
        c_cols[:, 0] = a.var
        c_cols[:, 1] = b.var
        c_cols[:, 2] = ids
        self.builder.add_rows(
            n,
            ones, a.var, 2 * ones,
            ones, b.var, ones,
            3 * ones, c_cols.ravel(), _xor_c_coeffs(n),
        )
        return BitVec(ids, a.neg ^ b.neg, a.val ^ b.val)

    def xor(self, a: BitVec, b: BitVec) -> BitVec:
        a_var = a.var >= 0
        b_var = b.var >= 0
        if not a_var.any() and not b_var.any():  # all-const fold
            return BitVec.const(a.val ^ b.val)
        if a_var.all() and b_var.all() and not (a.var == b.var).any():
            return self._xor_allvar(a, b)
        both = a_var & b_var
        out_var = np.full(a.var.shape, -1, np.int64)
        out_neg = np.zeros(a.var.shape, bool)
        out_val = (a.val ^ b.val).astype(np.uint8)
        # const folding lanes keep the other side's variable
        only_a = b_var & ~a_var
        out_var[only_a] = b.var[only_a]
        out_neg[only_a] = b.neg[only_a] ^ (a.val[only_a] != 0)
        only_b = a_var & ~b_var
        out_var[only_b] = a.var[only_b]
        out_neg[only_b] = a.neg[only_b] ^ (b.val[only_b] != 0)
        idx = np.nonzero(both)[0]
        if len(idx):
            ra = (a.val[idx] ^ a.neg[idx]).astype(np.uint8)
            rb = (b.val[idx] ^ b.neg[idx]).astype(np.uint8)
            ids = self.alloc_bits(ra ^ rb, booleanity=False)
            av = a.var[idx]
            bv = b.var[idx]
            n = len(idx)
            ones = np.ones(n, np.int64)
            # 2a * b = a + b - v   (degenerate a==b: 2a * b = 2a - v)
            degen = av == bv
            c_lens = np.where(degen, 2, 3).astype(np.int64)
            c_cols3 = np.stack([av, bv, ids], axis=1)
            c_coeffs3 = np.stack(
                [
                    np.where(degen, 2, 1),
                    np.where(degen, -1, 1),
                    np.where(degen, 0, -1),
                ],
                axis=1,
            ).astype(np.int64)
            keep = np.ones((n, 3), bool)
            keep[:, 2] = ~degen
            # degenerate rows: [a:2, v:-1]
            c_cols3[degen, 1] = ids[degen]
            self.builder.add_rows(
                n,
                ones, av, 2 * ones,
                ones, bv, ones,
                c_lens, c_cols3[keep], c_coeffs3[keep],
            )
            out_var[idx] = ids
            out_neg[idx] = a.neg[idx] != b.neg[idx]
        return BitVec(out_var, out_neg, out_val)

    def _and_uniform(self, a: BitVec, b: BitVec, na: bool, nb: bool) -> BitVec:
        """Fast path: all lanes var-var with uniform negation flags."""
        n = len(a.var)
        out_val = (a.val & b.val).astype(np.uint8)
        ids = self.alloc_bits(out_val, booleanity=False)
        ones = _ones(n)
        plain_first = b.var if na else a.var
        other = a.var if na else b.var
        if na and nb:  # nor: {1,-p}{1,-o}{v}
            cols2 = np.empty((n, 2), np.int64)
            cols2[:, 0] = 0
            cols2[:, 1] = plain_first
            coeffs2 = np.tile(np.array([1, -1], np.int64), n)
            ocols2 = np.empty((n, 2), np.int64)
            ocols2[:, 0] = 0
            ocols2[:, 1] = other
            self.builder.add_rows(
                n,
                2 * ones, cols2.ravel(), coeffs2,
                2 * ones, ocols2.ravel(), coeffs2,
                ones, ids, ones,
            )
        elif na or nb:  # and_not: {p}{1,-o}{v}
            ocols2 = np.empty((n, 2), np.int64)
            ocols2[:, 0] = 0
            ocols2[:, 1] = other
            coeffs2 = np.tile(np.array([1, -1], np.int64), n)
            self.builder.add_rows(
                n,
                ones, plain_first, ones,
                2 * ones, ocols2.ravel(), coeffs2,
                ones, ids, ones,
            )
        else:  # and: {a}{b}{v}
            self.builder.add_rows(
                n,
                ones, a.var, ones,
                ones, b.var, ones,
                ones, ids, ones,
            )
        return BitVec(ids, np.zeros(n, bool), out_val)

    def and_(self, a: BitVec, b: BitVec) -> BitVec:
        a_var = a.var >= 0
        b_var = b.var >= 0
        if not a_var.any() and not b_var.any():  # all-const fold
            return BitVec.const(a.val & b.val)
        if a_var.all() and b_var.all():
            na_any, na_all = a.neg.any(), a.neg.all()
            nb_any, nb_all = b.neg.any(), b.neg.all()
            if (na_all or not na_any) and (nb_all or not nb_any):
                return self._and_uniform(a, b, bool(na_all), bool(nb_all))
        both = a_var & b_var
        out_var = np.full(a.var.shape, -1, np.int64)
        out_neg = np.zeros(a.var.shape, bool)
        out_val = (a.val & b.val).astype(np.uint8)
        only_a = b_var & ~a_var  # a const
        sel = only_a & (a.val != 0)
        out_var[sel] = b.var[sel]
        out_neg[sel] = b.neg[sel]
        only_b = a_var & ~b_var
        sel = only_b & (b.val != 0)
        out_var[sel] = a.var[sel]
        out_neg[sel] = a.neg[sel]
        idx = np.nonzero(both)[0]
        if len(idx):
            na = a.neg[idx]
            nb = b.neg[idx]
            av = a.var[idx]
            bv = b.var[idx]
            # result raw value = semantic product (result never negated)
            ids = self.alloc_bits(out_val[idx], booleanity=False)
            n = len(idx)
            ones = np.ones(n, np.int64)
            # four patterns (and / and_not(a,b) / and_not(b,a) / nor):
            #  a-side: plain x -> {x:1}; negated x -> {one:1, x:-1}
            #  (and_not swaps so the PLAIN operand is on the a-side)
            plain_first = np.where(na, bv, av)  # the non-negated operand
            other = np.where(na, av, bv)
            first_negated = na & nb  # nor: both sides negated
            sec_negated = na | nb
            a_lens = np.where(first_negated, 2, 1).astype(np.int64)
            a_cols2 = np.stack(
                [np.where(first_negated, 0, plain_first), plain_first],
                axis=1,
            )
            a_coeffs2 = np.stack(
                [np.where(first_negated, 1, 1), np.full(n, -1)], axis=1
            ).astype(np.int64)
            keep_a = np.ones((n, 2), bool)
            keep_a[:, 1] = first_negated
            b_lens = np.where(sec_negated, 2, 1).astype(np.int64)
            b_cols2 = np.stack(
                [np.where(sec_negated, 0, other), other], axis=1
            )
            b_coeffs2 = np.stack(
                [np.ones(n), np.full(n, -1)], axis=1
            ).astype(np.int64)
            keep_b = np.ones((n, 2), bool)
            keep_b[:, 1] = sec_negated
            self.builder.add_rows(
                n,
                a_lens, a_cols2[keep_a], a_coeffs2[keep_a],
                b_lens, b_cols2[keep_b], b_coeffs2[keep_b],
                ones, ids, ones,
            )
            out_var[idx] = ids
            out_neg[idx] = False
        return BitVec(out_var, out_neg, out_val)

    # -- uint32 ops ----------------------------------------------------------

    def u32_xor(self, a: BitVec, b: BitVec) -> BitVec:
        return self.xor(a, b)

    def addmany(self, operands: list[BitVec]) -> BitVec:
        """Sum mod 2^32 of 32-bit LE words; one packing constraint with
        the static-bound result width (uint32.UInt32.addmany parity)."""
        assert len(operands) >= 2
        pow2 = (np.int64(1) << np.arange(32, dtype=np.int64))
        total = 0
        bound = 0
        for op in operands:
            total += int((op.val.astype(np.int64) * pow2).sum())
            if (op.var < 0).all():
                bound += int((op.val.astype(np.int64) * pow2).sum())
            else:
                bound += 0xFFFFFFFF
        n_bits = max(bound.bit_length(), 32)
        res_vals = np.array(
            [(total >> i) & 1 for i in range(n_bits)], np.uint8
        )
        res_ids = self.alloc_bits(res_vals, booleanity=True)
        cols_parts, coeff_parts = [], []
        for op in operands:
            isvar = op.var >= 0
            isneg = isvar & op.neg
            # constants (or negation offsets) land on var 0
            const_contrib = isneg | (~isvar & (op.val != 0))
            cidx = np.nonzero(const_contrib)[0]
            if len(cidx):
                cols_parts.append(np.zeros(len(cidx), np.int64))
                coeff_parts.append(pow2[cidx])
            vidx = np.nonzero(isvar)[0]
            if len(vidx):
                cols_parts.append(op.var[vidx])
                sign = np.where(op.neg[vidx], -1, 1).astype(np.int64)
                coeff_parts.append(pow2[vidx] * sign)
        # result bits: -2^i
        cols_parts.append(res_ids)
        coeff_parts.append(
            -(np.int64(1) << np.arange(n_bits, dtype=np.int64))
        )
        cols = np.concatenate(cols_parts)
        coeffs = np.concatenate(coeff_parts)
        self.builder.add_rows(
            1,
            np.array([len(cols)], np.int64), cols, coeffs,
            np.ones(1, np.int64), np.zeros(1, np.int64), np.ones(1, np.int64),
            _zeros(1), _EMPTY_I64, _EMPTY_I64,
        )
        out_val = np.array(
            [(total >> i) & 1 for i in range(32)], np.uint8
        )
        return BitVec(
            res_ids[:32].copy(), np.zeros(32, bool), out_val
        )

    def maj(self, a: BitVec, b: BitVec, c: BitVec) -> BitVec:
        t1 = self.xor(b, c)
        t2 = self.and_(a, t1)
        t3 = self.and_(b, c)
        return self.xor(t2, t3)

    def ch(self, e: BitVec, f: BitVec, g: BitVec) -> BitVec:
        t1 = self.and_(e, f)
        t2 = self.and_(e.not_(), g)
        return self.xor(t1, t2)


def _rotr(w: BitVec, k: int) -> BitVec:
    # bits are little-endian: rotr(k) maps out[i] = in[(i + k) % 32]
    return w.roll(-k)


def _shr(w: BitVec, k: int) -> BitVec:
    var = np.full(32, -1, np.int64)
    neg = np.zeros(32, bool)
    val = np.zeros(32, np.uint8)
    var[: 32 - k] = w.var[k:]
    neg[: 32 - k] = w.neg[k:]
    val[: 32 - k] = w.val[k:]
    return BitVec(var, neg, val)


def _word_const(value: int) -> BitVec:
    return BitVec.const([(value >> i) & 1 for i in range(32)])


def _from_bits_be(bits: BitVec) -> BitVec:
    return bits.take(np.arange(31, -1, -1))


def sha256_compress_vec(em: ShaEmitter, block: list[BitVec],
                        state: list[BitVec]) -> list[BitVec]:
    """block: 16 LE words; state: 8 LE words. Mirrors
    sha256.sha256_compress op-for-op."""
    w = list(block)
    for i in range(16, 64):
        s0s = w[i - 15]
        s0 = em.xor(
            em.xor(_rotr(s0s, 7), _rotr(s0s, 18)), _shr(s0s, 3)
        )
        s1s = w[i - 2]
        s1 = em.xor(
            em.xor(_rotr(s1s, 17), _rotr(s1s, 19)), _shr(s1s, 10)
        )
        w.append(em.addmany([w[i - 16], s0, w[i - 7], s1]))

    a, b, c, d, e, f, g, h = state
    for i in range(64):
        big_s1 = em.xor(em.xor(_rotr(e, 6), _rotr(e, 11)), _rotr(e, 25))
        ch = em.ch(e, f, g)
        t1 = em.addmany(
            [h, big_s1, ch, _word_const(ROUND_CONSTANTS[i]), w[i]]
        )
        big_s0 = em.xor(em.xor(_rotr(a, 2), _rotr(a, 13)), _rotr(a, 22))
        maj = em.maj(a, b, c)
        t2 = em.addmany([big_s0, maj])
        h, g, f = g, f, e
        e = em.addmany([d, t1])
        d, c, b = c, b, a
        a = em.addmany([t1, t2])

    return [
        em.addmany([s, v])
        for s, v in zip(state, [a, b, c, d, e, f, g, h])
    ]


def _be_words(bits: BitVec) -> list[BitVec]:
    """512 BE bits -> 16 LE words."""
    return [
        _from_bits_be(bits.take(np.arange(i * 32, (i + 1) * 32)))
        for i in range(len(bits.var) // 32)
    ]


def _state_bits_be(state: list[BitVec]) -> list[Boolean]:
    """8 LE words -> 256 output bits in BE order (into_bits_be)."""
    out: list[Boolean] = []
    rev = np.arange(31, -1, -1)
    for word in state:
        out.extend(word.take(rev).to_booleans())
    return out


def sha256_vec(cs: ConstraintSystem, data_bits: list[Boolean]) -> list[Boolean]:
    """Drop-in for gadgets.sha256.sha256 via the array emitter."""
    length = len(data_bits)
    assert length % 8 == 0
    em = ShaEmitter(cs)
    bits = BitVec.from_booleans(data_bits)
    pad_n = 0
    pad_vals = [1]
    while (length + len(pad_vals) + 64) % 512 != 0:
        pad_vals.append(0)
    pad_vals += [(length >> i) & 1 for i in range(63, -1, -1)]
    pad = BitVec.const(pad_vals)
    full = BitVec(
        np.concatenate([bits.var, pad.var]),
        np.concatenate([bits.neg, pad.neg]),
        np.concatenate([bits.val, pad.val]),
    )
    state = [_word_const(v) for v in IV]
    words = _be_words(full)
    for off in range(0, len(words), 16):
        state = sha256_compress_vec(em, words[off : off + 16], state)
    em.flush("sha256")
    return _state_bits_be(state)


def sha256_block_no_padding_vec(
    cs: ConstraintSystem, block_bits: list[Boolean]
) -> list[Boolean]:
    """Drop-in for gadgets.sha256.sha256_block_no_padding."""
    assert len(block_bits) == 512
    em = ShaEmitter(cs)
    bits = BitVec.from_booleans(block_bits)
    state = [_word_const(v) for v in IV]
    state = sha256_compress_vec(em, _be_words(bits), state)
    em.flush("sha256_block")
    return _state_bits_be(state)


# ---------------------------------------------------------------------------
# K-instance batched SHA-256 (r5, VERDICT r4 item 6): one emission for K
# messages of identical length. Words are BitVecs of K*32 lanes
# (instance-major); xor/and_/maj/ch are lane-generic already, so only
# the word-boundary helpers (rotr/shr/const/addmany) need group-aware
# twins. Values ride the BitVec lanes, so the witness for all K
# instances is computed as a side effect of emission — no separate
# replay (the fallback-PoSt tiled path needed hand-mirrored replays).
# ---------------------------------------------------------------------------

_ROLL32_CACHE: dict = {}


def _rotr_k(w: BitVec, k: int, K: int) -> BitVec:
    key = (K, k)
    idx = _ROLL32_CACHE.get(key)
    if idx is None:
        base = (np.arange(32) + k) % 32  # out[i] = in[(i+k) % 32]
        idx = (np.arange(K)[:, None] * 32 + base[None, :]).ravel()
        idx.setflags(write=False)
        _ROLL32_CACHE[key] = idx
    return w.take(idx)


def _shr_k(w: BitVec, k: int, K: int) -> BitVec:
    var = np.full((K, 32), -1, np.int64)
    neg = np.zeros((K, 32), bool)
    val = np.zeros((K, 32), np.uint8)
    var[:, : 32 - k] = w.var.reshape(K, 32)[:, k:]
    neg[:, : 32 - k] = w.neg.reshape(K, 32)[:, k:]
    val[:, : 32 - k] = w.val.reshape(K, 32)[:, k:]
    return BitVec(var.ravel(), neg.ravel(), val.ravel())


def _word_const_k(value: int, K: int) -> BitVec:
    bits = np.asarray([(value >> i) & 1 for i in range(32)], np.uint8)
    return BitVec.const(np.tile(bits, K))


def _addmany_k(em: ShaEmitter, operands: list[BitVec], K: int) -> BitVec:
    """K-instance addmany: per instance the SAME constraint content as
    ShaEmitter.addmany (booleanity'd result bits at the static bound
    width + one packing row); emitted as K rows in one builder call."""
    assert len(operands) >= 2
    pow2_32 = np.int64(1) << np.arange(32, dtype=np.int64)
    totals = np.zeros(K, np.int64)
    bounds = np.zeros(K, np.int64)
    for op in operands:
        v2 = op.val.reshape(K, 32).astype(np.int64)
        opv = (v2 * pow2_32[None, :]).sum(axis=1)
        totals += opv
        all_const = (op.var.reshape(K, 32) < 0).all(axis=1)
        bounds += np.where(all_const, opv, np.int64(0xFFFFFFFF))
    # the per-instance static bound fixes the result width (scalar
    # addmany parity). Instances batched across LAYERS can carry
    # different all-const words (the BE32 layer number), so widths may
    # differ — split into per-width groups and recombine (rare: widths
    # only diverge when a const crosses a power-of-two boundary)
    widths = np.maximum(
        [int(b).bit_length() for b in bounds], 32
    ).astype(np.int64)
    if not (widths == widths[0]).all():
        out_var = np.empty(K * 32, np.int64)
        out_neg = np.zeros(K * 32, bool)
        out_val = np.empty(K * 32, np.uint8)
        for w in np.unique(widths):
            sel = np.nonzero(widths == w)[0]
            sub_ops = [
                BitVec(
                    op.var.reshape(K, 32)[sel].ravel(),
                    op.neg.reshape(K, 32)[sel].ravel(),
                    op.val.reshape(K, 32)[sel].ravel(),
                )
                for op in operands
            ]
            sub = _addmany_k(em, sub_ops, len(sel))
            lanes = (sel[:, None] * 32 + np.arange(32)[None, :]).ravel()
            out_var[lanes] = sub.var
            out_neg[lanes] = sub.neg
            out_val[lanes] = sub.val
        return BitVec(out_var, out_neg, out_val)
    n_bits = int(widths[0])
    shifts = np.arange(n_bits, dtype=np.int64)
    res_vals = ((totals[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    res_ids = em.alloc_bits(res_vals.ravel(), booleanity=True)
    rid2 = res_ids.reshape(K, n_bits)

    cols_parts, coeff_parts, inst_parts = [], [], []
    for op in operands:
        isvar = op.var >= 0
        isneg = isvar & op.neg
        const_contrib = isneg | (~isvar & (op.val != 0))
        cidx = np.nonzero(const_contrib)[0]
        if len(cidx):
            cols_parts.append(np.zeros(len(cidx), np.int64))
            coeff_parts.append(pow2_32[cidx % 32])
            inst_parts.append(cidx // 32)
        vidx = np.nonzero(isvar)[0]
        if len(vidx):
            cols_parts.append(op.var[vidx])
            sign = np.where(op.neg[vidx], -1, 1).astype(np.int64)
            coeff_parts.append(pow2_32[vidx % 32] * sign)
            inst_parts.append(vidx // 32)
    cols_parts.append(res_ids)
    coeff_parts.append(np.tile(-(np.int64(1) << shifts), K))
    inst_parts.append(np.repeat(np.arange(K), n_bits))
    cols = np.concatenate(cols_parts)
    coeffs = np.concatenate(coeff_parts)
    inst = np.concatenate(inst_parts)
    order = np.argsort(inst, kind="stable")
    lens = np.bincount(inst, minlength=K).astype(np.int64)
    ones = _ones(K)
    em.builder.add_rows(
        K,
        lens, cols[order], coeffs[order],
        ones, np.zeros(K, np.int64), ones,
        _zeros(K), _EMPTY_I64, _EMPTY_I64,
    )
    keep = rid2[:, :32]
    return BitVec(
        keep.ravel().copy(),
        np.zeros(K * 32, bool),
        ((totals[:, None] >> shifts[None, :32]) & 1)
        .astype(np.uint8)
        .ravel(),
    )


def sha256_compress_batch(
    em: ShaEmitter, block: list[BitVec], state: list[BitVec], K: int
) -> list[BitVec]:
    """K-instance compress; mirrors sha256_compress_vec op-for-op."""
    w = list(block)
    for i in range(16, 64):
        s0s = w[i - 15]
        s0 = em.xor(
            em.xor(_rotr_k(s0s, 7, K), _rotr_k(s0s, 18, K)),
            _shr_k(s0s, 3, K),
        )
        s1s = w[i - 2]
        s1 = em.xor(
            em.xor(_rotr_k(s1s, 17, K), _rotr_k(s1s, 19, K)),
            _shr_k(s1s, 10, K),
        )
        w.append(_addmany_k(em, [w[i - 16], s0, w[i - 7], s1], K))

    a, b, c, d, e, f, g, h = state
    for i in range(64):
        big_s1 = em.xor(
            em.xor(_rotr_k(e, 6, K), _rotr_k(e, 11, K)), _rotr_k(e, 25, K)
        )
        ch = em.ch(e, f, g)
        t1 = _addmany_k(
            em, [h, big_s1, ch, _word_const_k(ROUND_CONSTANTS[i], K), w[i]],
            K,
        )
        big_s0 = em.xor(
            em.xor(_rotr_k(a, 2, K), _rotr_k(a, 13, K)), _rotr_k(a, 22, K)
        )
        maj = em.maj(a, b, c)
        t2 = _addmany_k(em, [big_s0, maj], K)
        h, g, f = g, f, e
        e = _addmany_k(em, [d, t1], K)
        d, c, b = c, b, a
        a = _addmany_k(em, [t1, t2], K)

    return [
        _addmany_k(em, [s, v], K)
        for s, v in zip(state, [a, b, c, d, e, f, g, h])
    ]


_BE_IDX_CACHE: dict = {}


def _be_word_idx(K: int, L: int, word: int) -> np.ndarray:
    """Lane indices of word `word` (BE bits -> LE order) for K instances
    of an L-bit message laid out instance-major."""
    key = (K, L, word)
    idx = _BE_IDX_CACHE.get(key)
    if idx is None:
        base = word * 32 + np.arange(31, -1, -1)
        idx = (np.arange(K)[:, None] * L + base[None, :]).ravel()
        idx.setflags(write=False)
        _BE_IDX_CACHE[key] = idx
    return idx


def sha256_batch(
    em: ShaEmitter, msg: BitVec, L: int, K: int
) -> list[BitVec]:
    """K-instance SHA-256 of BE-bit messages (length L each, lanes
    instance-major). Returns the 8 state words as K-batched LE-word
    BitVecs; same per-instance constraint content as sha256_vec."""
    assert len(msg.var) == K * L and L % 8 == 0
    pad_vals = [1]
    while (L + len(pad_vals) + 64) % 512 != 0:
        pad_vals.append(0)
    pad_vals += [(L >> i) & 1 for i in range(63, -1, -1)]
    P = len(pad_vals)
    pad = np.asarray(pad_vals, np.uint8)
    Lp = L + P
    var = np.concatenate(
        [msg.var.reshape(K, L), np.full((K, P), -1, np.int64)], axis=1
    ).ravel()
    neg = np.concatenate(
        [msg.neg.reshape(K, L), np.zeros((K, P), bool)], axis=1
    ).ravel()
    val = np.concatenate(
        [msg.val.reshape(K, L), np.tile(pad, (K, 1))], axis=1
    ).ravel()
    full = BitVec(var, neg, val)
    state = [_word_const_k(v, K) for v in IV]
    n_words = Lp // 32
    for off in range(0, n_words, 16):
        block = [
            full.take(_be_word_idx(K, Lp, off + i)) for i in range(16)
        ]
        state = sha256_compress_batch(em, block, state, K)
    return state


def state_bits_le_batch(state: list[BitVec], K: int) -> BitVec:
    """8 K-batched LE state words -> per-instance 256 bits in the
    LE-within-byte order (le_bits_to_be of the BE digest bits — what
    packing/labeling consume). Lanes instance-major [K*256]."""
    # BE digest bits: per word, bits 31..0; byte-reverse within bytes:
    # le_bits_to_be groups 8 and reverses -> net order per word:
    # bytes MSB-first, bits LSB-first within byte
    per_word = np.concatenate(
        [np.arange(24, 32), np.arange(16, 24), np.arange(8, 16),
         np.arange(0, 8)]
    )
    var = np.empty((K, 256), np.int64)
    neg = np.empty((K, 256), bool)
    val = np.empty((K, 256), np.uint8)
    for wi, word in enumerate(state):
        v2 = word.var.reshape(K, 32)
        n2 = word.neg.reshape(K, 32)
        a2 = word.val.reshape(K, 32)
        var[:, wi * 32 : (wi + 1) * 32] = v2[:, per_word]
        neg[:, wi * 32 : (wi + 1) * 32] = n2[:, per_word]
        val[:, wi * 32 : (wi + 1) * 32] = a2[:, per_word]
    return BitVec(var.ravel(), neg.ravel(), val.ravel())
