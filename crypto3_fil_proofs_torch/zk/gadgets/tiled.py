"""Template-tiled gadget emission: synthesize a subcircuit ONCE, then
instantiate it K times as one FieldBlock via numpy tiling.

The poseidon/PoR gadget structure is data-independent (fixed coefficient
values, fixed relative variable positions), so a window-PoSt partition
— 2349 sectors x 10 challenges of identical PoR instances, 125M
constraints at production scale (reference constants.hpp:85-88) — can
be emitted at numpy speed instead of the ~14k constraints/s the scalar
dict-LC path measured (VERDICT r3 missing #4). Witness values for the
tiled internal variables are computed by vectorized replays (the
Poseidon ones on the device, below) that mirror the scalar gadgets'
allocation order.

Templates capture from a scratch ConstraintSystem run of the EXISTING
scalar gadgets, so the tiled circuits are semantically identical to the
scalar ones (same rows, same coefficients) — only variable ordering
differs (per-instance blocks instead of interleaved allocation).

Copied from crypto3_fil_proofs_tpu/zk/gadgets/tiled.py with its imports
rewritten. Its witness replays (the numpy one and the XLA program
:659-815) become one dispatch, `poseidon_witness_v`: kernel K7
(csrc/poseidon_witness.cu) on a CUDA device, its plain PyTorch version
on the CPU. Every function that replays a witness takes the `device`
to replay on.
"""
from __future__ import annotations

import numpy as np

from ...ops import fr_vec as fv
from ...ops.bls12_381 import R
from ..r1cs import ConstraintSystem, FieldBlock

ONE = 0


def _disable_thp() -> None:
    """Transparent-hugepage fault-in stalled fresh numpy allocations at
    ~56 MB/s on this kernel (each retained [K, E] block is a new mmap;
    THP-madvise fault-in + compaction dominated instantiate by 20x).
    PR_SET_THP_DISABLE turns it off for this process only."""
    try:
        import ctypes

        ctypes.CDLL(None).prctl(41, 1, 0, 0, 0)  # PR_SET_THP_DISABLE
    except Exception:
        pass


_disable_thp()


class CircuitTemplate:
    """CSR capture of a one-instance subcircuit for K-fold tiling.

    build_fn(cs, ext_vars: list[int]) synthesizes the gadget once on a
    scratch CS where ext_vars are pre-allocated variable ids 1..n_ext
    (the instance's external interface: inputs the caller owns). All
    variables the gadget allocates become per-instance internals.
    """

    def __init__(self, build_fn, n_ext: int, ext_dummy_values=None,
                 label: str = ""):
        scratch = ConstraintSystem()
        dummies = ext_dummy_values or [0] * n_ext
        ext = [scratch.alloc(v % R, "ext") for v in dummies]
        assert ext == list(range(1, n_ext + 1))
        build_fn(scratch, ext)
        assert not any(scratch.is_input[1:]), (
            "templates cannot allocate public inputs — pre-allocate them "
            "as externals"
        )
        self.label = label or build_fn.__name__
        self.n_ext = n_ext
        self.n_int = len(scratch.values) - 1 - n_ext
        self.scratch_int_values = scratch.values[1 + n_ext :]
        # row-ordered view: dict rows interleaved with any BulkBlocks the
        # scalar gadgets emitted (e.g. boolean.alloc_bits_bulk) — block
        # rows flatten into the same CSR template
        from ..r1cs import _block_rows_as_dicts

        rows: list[tuple] = []
        d_pos = 0
        for kind, val in scratch.row_layout:
            if kind == "d":
                rows.extend(scratch.constraints[d_pos : d_pos + val])
                d_pos += val
            else:
                rows.extend(_block_rows_as_dicts(scratch.bulk_blocks[val]))
        self.n_rows = len(rows)

        pool_map: dict[int, int] = {}
        pool: list[int] = []

        def pool_idx(coeff: int) -> int:
            c = coeff % R
            i = pool_map.get(c)
            if i is None:
                i = pool_map[c] = len(pool)
                pool.append(c)
            return i

        self.sides = []
        for s in range(3):
            lens = np.empty(self.n_rows, np.int64)
            cols: list[int] = []
            idx: list[int] = []
            for r, row in enumerate(rows):
                terms = row[s]
                lens[r] = len(terms)
                for var, coeff in terms.items():
                    cols.append(var)
                    idx.append(pool_idx(coeff))
            tcols = np.asarray(cols, np.int64)
            tidx = np.asarray(idx, np.uint32)
            # instance k's column for entry e is AFFINE in k for ONE and
            # internal entries: const[e] (+ base) + k * n_int; runtime
            # build is ONE outer-sum pass, then small patches for the
            # non-affine entries (ONE columns and the gadget's external
            # inputs). indptr is affine in k too (see side()) — no
            # np.tile / runtime cumsum (those measured 0.8s per call on
            # this kernel and dominated 100M-row partitions).
            ext_pos = np.nonzero((tcols >= 1) & (tcols <= n_ext))[0]
            is_int = tcols > n_ext
            zero_pos = np.nonzero(~is_int)[0]  # ONE + ext entries
            prefix = np.zeros(self.n_rows + 1, np.int64)
            np.cumsum(lens, out=prefix[1:])
            self.sides.append(
                dict(
                    lens=lens,
                    tidx=tidx,
                    E=len(tcols),
                    nnz_inst=int(prefix[-1]),
                    prefix1=prefix[1:].copy(),
                    ext_pos=ext_pos,
                    ext_slot=tcols[ext_pos] - 1,
                    zero_pos=zero_pos,
                    const=np.where(is_int, tcols - 1 - n_ext, 0).astype(
                        np.int32
                    ),
                )
            )
        self.pool = pool
        # nnz per instance (for size estimates)
        self.nnz = sum(s["E"] for s in self.sides)

    def int_rel(self, scratch_var: int) -> int:
        """Relative internal slot of a scratch-run variable id."""
        assert scratch_var > self.n_ext
        return scratch_var - 1 - self.n_ext

    # rows per emitted FieldBlock: big enough to amortize the numpy
    # per-call overheads, small enough that one block's CSR arrays stay
    # ~hundreds of MB (page-fault cost grows superlinearly with
    # single-allocation size on this kernel)
    CHUNK_ROWS = 6_000_000

    @property
    def CHUNK(self) -> int:
        return max(64, self.CHUNK_ROWS // max(1, self.n_rows))

    def instantiate(
        self,
        cs: ConstraintSystem,
        ext_vars: np.ndarray,  # [K, n_ext] int64 global var ids
        int_values,  # list of K*n_int python ints (instance-major) or None
    ) -> np.ndarray:
        """Emit K instances as FieldBlocks (chunked at CHUNK instances);
        returns inst_bases [K] int64 — instance k's internal slot r is
        inst_bases[k] + r. int_values=None allocates zeros (blank
        synthesis: CRS/counting paths never read aux values)."""
        K = ext_vars.shape[0]
        assert ext_vars.shape == (K, self.n_ext)
        if K > self.CHUNK:
            bases = []
            for lo in range(0, K, self.CHUNK):
                hi = min(lo + self.CHUNK, K)
                vals = (
                    None
                    if int_values is None
                    else int_values[lo * self.n_int : hi * self.n_int]
                )
                bases.append(self.instantiate(cs, ext_vars[lo:hi], vals))
            return np.concatenate(bases)
        if int_values is None:
            int_values = [0] * (K * self.n_int)
        assert len(int_values) == K * self.n_int
        base = cs.bulk_alloc(int_values)

        inst_base = base + np.arange(K, dtype=np.int64) * self.n_int

        assert len(cs.values) + K * self.n_int < (1 << 31), (
            "int32 column space exceeded"
        )
        k_step = (np.arange(K, dtype=np.int64) * self.n_int).astype(np.int32)

        cs.add_bulk_block(
            TiledBlock(self, K, base, np.ascontiguousarray(ext_vars))
        )
        return base + np.arange(K, dtype=np.int64) * self.n_int


# ---------------------------------------------------------------------------
# Batched Poseidon
# ---------------------------------------------------------------------------

_POSEIDON_TEMPLATES: dict[int, CircuitTemplate] = {}


def poseidon_template(arity: int) -> CircuitTemplate:
    tpl = _POSEIDON_TEMPLATES.get(arity)
    if tpl is None:
        from .num import AllocatedNum
        from .poseidon import poseidon_hash_circuit

        def build(cs, ext):
            pre = [AllocatedNum(v, 0) for v in ext]
            poseidon_hash_circuit(cs, pre, arity)

        tpl = CircuitTemplate(build, arity, label=f"poseidon{arity}")
        # the digest is the last allocation of the scalar gadget
        tpl.digest_rel = tpl.n_int - 1
        _POSEIDON_TEMPLATES[arity] = tpl
    return tpl


def poseidon_witness_v(preimages_v: np.ndarray, arity: int, device="cuda") -> np.ndarray:
    """Vectorized witness replay for K poseidon instances on `device`.

    preimages_v: [K, arity, 16] plain-form limb array. Returns
    [K, n_int, 16] plain-form internal values in the scalar gadget's
    allocation order: (x2, x4, x5) per S-box — half_f rounds of t boxes,
    r_p single boxes, half_f rounds of t boxes — then the digest.
    Mirrors gadgets/poseidon.poseidon_hash_circuit exactly.

    A CUDA device runs kernel K7 (K1 takes the preimages into Montgomery
    form) with that device current, at every batch size, and raises
    where it cannot; the CPU runs their plain versions. The 16-bit limbs of the arrays and the kernels'
    32-bit limbs are views of the same bytes."""
    import torch

    from ...api.seal import check_device
    from ...ops.cuda import field as k1
    from ...ops.cuda import poseidon as k2
    from ...parallel.sharded import on_device

    dev = check_device(device)
    K = preimages_v.shape[0]
    pre = np.ascontiguousarray(preimages_v, dtype="<u2").view("<i4").reshape(K * arity, 8)
    with on_device(dev):
        mont = k1.to_mont(torch.from_numpy(pre).to(dev)).reshape(K, arity, 8)
        wit = k2.witness(mont, arity).cpu().numpy()
    return wit.view("<u2").astype(np.uint64)


def poseidon_circuit_batch(
    cs: ConstraintSystem,
    input_vars: np.ndarray,  # [K, arity] int64 global var ids
    input_values_v: np.ndarray | None,  # [K, arity, 16] plain limbs
    arity: int,
    device="cuda",
):
    """K poseidon hashes as one FieldBlock, the witness replayed on
    `device`. Returns (digest_vars [K] int64, digest_values_v [K, 16]
    plain limbs or None for blank)."""
    tpl = poseidon_template(arity)
    if input_values_v is None:
        int_values = None
        digests_v = None
    else:
        wit = poseidon_witness_v(input_values_v, arity, device)
        assert wit.shape[1] == tpl.n_int
        int_values = fv.from_v(wit.reshape(-1, 16))
        digests_v = np.ascontiguousarray(wit[:, tpl.digest_rel])
    inst_bases = tpl.instantiate(cs, input_vars, int_values)
    digest_vars = inst_bases + tpl.digest_rel
    return digest_vars, digests_v


# ---------------------------------------------------------------------------
# Batched PoR (Merkle inclusion) — the window/winning-PoSt hot gadget
# ---------------------------------------------------------------------------

_POR_TEMPLATES: dict[tuple, CircuitTemplate] = {}


def _limb01(arr: np.ndarray) -> np.ndarray:
    """[K] 0/1 ints -> [K, 16] limb arrays."""
    out = np.zeros((len(arr), 16), np.uint64)
    out[:, 0] = arr
    return out


def bytes_rows_to_v(rows: list[bytes]) -> np.ndarray:
    """list of 32-byte LE values -> [N, 16] u64 limbs."""
    raw = b"".join(rows)
    return (
        np.frombuffer(raw, dtype="<u2").astype(np.uint64).reshape(-1, 16)
    )


def por_template(arities: tuple[int, ...], n_packs: int) -> CircuitTemplate:
    """Template for one full PoR instance over a path with the given
    per-level arities, plus the packed-position input-tie rows.

    ext = [root] + packed input vars. Internals: leaf, then per level
    (position bits, siblings, insertion, poseidon), in the scalar
    gadgets' order (gadgets/por.por_circuit)."""
    key = (arities, n_packs)
    tpl = _POR_TEMPLATES.get(key)
    if tpl is None:
        from ...ops.bls12_381 import R as _R
        from ..r1cs import LinearCombination, lc_one
        from .boolean import pack_bits_lc
        from .num import AllocatedNum
        from .por import por_circuit

        def build(cs, ext):
            root = AllocatedNum(ext[0], 0)
            leaf = AllocatedNum.alloc(cs, 0, "leaf")
            path = [
                ([b"\x00" * 32] * (a - 1), 0) for a in arities
            ]
            bits = por_circuit(cs, leaf, path, root, hasher="poseidon")
            cap = 254
            packs = [bits[s : s + cap] for s in range(0, len(bits), cap)]
            assert len(packs) == n_packs
            for j, chunk in enumerate(packs):
                lc, _ = pack_bits_lc(chunk)
                lc.accumulate(ext[1 + j], _R - 1)
                cs.enforce(lc, lc_one(), LinearCombination(), "pack_input")

        tpl = CircuitTemplate(
            build, 1 + n_packs, label=f"por{'x'.join(map(str, arities))}"
        )
        _POR_TEMPLATES[key] = tpl
    return tpl


def por_witness_v(
    leaf_v: np.ndarray,  # [K, 16] plain limbs
    levels: list[tuple[np.ndarray, np.ndarray]],  # per level: (siblings_v [K, a-1, 16], idx [K] int64)
    ext_leaf: bool = False,
    device="cuda",
) -> np.ndarray:
    """Vectorized internal-value replay for K PoR instances, in the
    scalar gadget allocation order (por_circuit + insertion + poseidon),
    the Poseidon levels on `device`.
    Returns [K, n_int, 16] plain limbs. ext_leaf=True mirrors the
    external-leaf template (the leaf var belongs to the caller — e.g. a
    column-hash digest — so it is not an internal allocation)."""
    K = leaf_v.shape[0]
    rec: list[np.ndarray] = [] if ext_leaf else [leaf_v]
    cur = leaf_v
    for sib_v, idx in levels:
        arity = sib_v.shape[1] + 1
        n_bits = (arity - 1).bit_length()
        bits = [((idx >> b) & 1).astype(np.uint64) for b in range(n_bits)]
        rec.extend(_limb01(b) for b in bits)  # alloc_bits_bulk order
        for j in range(arity - 1):
            rec.append(np.ascontiguousarray(sib_v[:, j]))
        if arity == 2:
            b0 = bits[0][:, None].astype(bool)
            first = np.where(b0, sib_v[:, 0], cur)
            second = np.where(b0, cur, sib_v[:, 0])
            rec.extend((first, second))
            children = [first, second]
        else:
            eqs = []
            for k in range(arity):
                lits = [
                    bits[b] if (k >> b) & 1 else 1 - bits[b]
                    for b in range(n_bits)
                ]
                acc = lits[0]
                for b in range(1, n_bits):
                    acc = acc * lits[b]
                    rec.append(_limb01(acc))  # Boolean.and_ alloc
                eqs.append(acc.astype(bool))
            children = []
            for k in range(arity):
                if k == 0:
                    other = sib_v[:, 0]
                elif k == arity - 1:
                    other = sib_v[:, arity - 2]
                else:
                    gt = idx > k
                    rec.append(_limb01(gt.astype(np.uint64)))
                    inner = np.where(
                        gt[:, None], sib_v[:, k], sib_v[:, k - 1]
                    )
                    rec.append(inner)  # pick alloc
                    other = inner
                outer = np.where(eqs[k][:, None], cur, other)
                rec.append(outer)  # pick alloc
                children.append(outer)
        pre = np.stack(children, axis=1)  # [K, arity, 16]
        pos_wit = poseidon_witness_v(pre, arity, device)  # [K, n_pos_int, 16]
        for r in range(pos_wit.shape[1]):
            rec.append(np.ascontiguousarray(pos_wit[:, r]))
        cur = pos_wit[:, -1]
    return np.stack(rec, axis=1)


_POR_EXT_TEMPLATES: dict[tuple, CircuitTemplate] = {}


def por_template_extleaf(arities: tuple[int, ...], n_packs: int) -> CircuitTemplate:
    """PoR template whose LEAF is an external variable (the SDR column
    PoRs prove inclusion of an already-allocated column-hash digest —
    stacked/circuit/proof._column_por). ext = [root, leaf] + packs."""
    key = (arities, n_packs)
    tpl = _POR_EXT_TEMPLATES.get(key)
    if tpl is None:
        from ...ops.bls12_381 import R as _R
        from ..r1cs import LinearCombination, lc_one
        from .boolean import pack_bits_lc
        from .num import AllocatedNum
        from .por import por_circuit

        def build(cs, ext):
            root = AllocatedNum(ext[0], 0)
            leaf = AllocatedNum(ext[1], 0)
            path = [([b"\x00" * 32] * (a - 1), 0) for a in arities]
            bits = por_circuit(cs, leaf, path, root, hasher="poseidon")
            cap = 254
            packs = [bits[s : s + cap] for s in range(0, len(bits), cap)]
            assert len(packs) == n_packs
            for j, chunk in enumerate(packs):
                lc, _ = pack_bits_lc(chunk)
                lc.accumulate(ext[2 + j], _R - 1)
                cs.enforce(lc, lc_one(), LinearCombination(), "pack_input")

        tpl = CircuitTemplate(
            build, 2 + n_packs,
            label=f"porx{'x'.join(map(str, arities))}",
        )
        _POR_EXT_TEMPLATES[key] = tpl
    return tpl


def por_circuit_batch_extleaf(
    cs: ConstraintSystem,
    root_vars: np.ndarray,  # [K] int64
    leaf_vars: np.ndarray,  # [K] int64 (caller-owned digests)
    packed_vars: np.ndarray,  # [K, n_packs] int64
    arities: tuple[int, ...],
    leaf_v: np.ndarray | None = None,
    levels=None,
    device="cuda",
) -> np.ndarray:
    """K external-leaf PoR instances as FieldBlocks, the witness replayed
    on `device`. Returns inst_bases."""
    tpl = por_template_extleaf(arities, packed_vars.shape[1])
    if leaf_v is None:
        int_values = None
    else:
        wit = por_witness_v(leaf_v, levels, ext_leaf=True, device=device)
        assert wit.shape[1] == tpl.n_int, (wit.shape, tpl.n_int)
        int_values = fv.from_v(wit.reshape(-1, 16))
    ext = np.concatenate(
        [root_vars[:, None], leaf_vars[:, None], packed_vars], axis=1
    )
    return tpl.instantiate(cs, ext, int_values)


def por_circuit_batch(
    cs: ConstraintSystem,
    root_vars: np.ndarray,  # [K] int64
    packed_vars: np.ndarray,  # [K, n_packs] int64 (pre-allocated inputs)
    arities: tuple[int, ...],
    leaf_v: np.ndarray | None = None,
    levels=None,
    device="cuda",
) -> np.ndarray:
    """K PoR instances as FieldBlocks; leaf_v/levels None = blank. The
    witness is replayed on `device`. Returns inst_bases [K]."""
    tpl = por_template(arities, packed_vars.shape[1])
    if leaf_v is None:
        int_values = None
    else:
        wit = por_witness_v(leaf_v, levels, device=device)
        assert wit.shape[1] == tpl.n_int, (wit.shape, tpl.n_int)
        int_values = fv.from_v(wit.reshape(-1, 16))
    ext = np.concatenate([root_vars[:, None], packed_vars], axis=1)
    return tpl.instantiate(cs, ext, int_values)


class TiledBlock:
    """Lazy K-instance view of a CircuitTemplate: the CSR arrays are
    EXPANDED ON ACCESS instead of materialized at synthesis.

    Rationale: this host's page fault-in collapses to ~50 MB/s past
    ~8 GiB RSS (hypervisor-backed memory), so retaining the full CSR of
    a 125M-row window-PoSt partition (~25 GiB) made emission 17x slower
    between 36M and 73M rows. A tiled block IS template + affine map +
    external columns — O(K) retained state; consumers that walk blocks
    (QAP tau evals, h-poly eval, satisfaction) materialize one block
    transiently (blocks are capped at CHUNK_ROWS rows) and free it.

    Duck-typed to FieldBlock's interface (a_indptr/a_cols/a_idx/...,
    pool, remap, eval_rows_v); consumers dispatch on `pool`."""

    __slots__ = (
        "tpl", "K", "base", "ext_vars", "pool", "label", "remap_table",
        "_pool_v", "_pool_v_mont",
    )

    def __init__(self, tpl, K, base, ext_vars, label="", remap_table=None):
        self.tpl = tpl
        self.K = K
        self.base = base
        self.ext_vars = ext_vars
        self.pool = tpl.pool
        self.label = label or f"{tpl.label} x{K}"
        self.remap_table = remap_table
        self._pool_v = None
        self._pool_v_mont = None

    @property
    def n(self) -> int:
        return self.K * self.tpl.n_rows

    def _side(self, i: int, what: str):
        sd = self.tpl.sides[i]
        E = sd["E"]
        K = self.K
        if what == "indptr":
            if E == 0:
                return np.zeros(K * self.tpl.n_rows + 1, np.int64)
            indptr = np.empty((K, self.tpl.n_rows), np.int64)
            np.add.outer(
                np.arange(K, dtype=np.int64) * sd["nnz_inst"],
                sd["prefix1"],
                out=indptr,
            )
            return np.concatenate([[0], indptr.reshape(-1)])
        if E == 0:
            return (
                np.zeros(0, np.int32)
                if what == "cols"
                else np.zeros(0, np.uint32)
            )
        if what == "idx":
            idx = np.empty((K, E), np.uint32)
            idx[:] = sd["tidx"][None, :]
            return idx.reshape(-1)
        k_step = (np.arange(K, dtype=np.int64) * self.tpl.n_int).astype(
            np.int32
        )
        cols = np.add.outer(k_step, sd["const"] + np.int32(self.base))
        if len(sd["zero_pos"]):
            cols[:, sd["zero_pos"]] -= k_step[:, None] + np.int32(self.base)
        if len(sd["ext_pos"]):
            cols[:, sd["ext_pos"]] = self.ext_vars[:, sd["ext_slot"]]
        cols = cols.reshape(-1)
        if self.remap_table is not None:
            cols = self.remap_table[cols]
        return cols

    a_indptr = property(lambda s: s._side(0, "indptr"))
    a_cols = property(lambda s: s._side(0, "cols"))
    a_idx = property(lambda s: s._side(0, "idx"))
    b_indptr = property(lambda s: s._side(1, "indptr"))
    b_cols = property(lambda s: s._side(1, "cols"))
    b_idx = property(lambda s: s._side(1, "idx"))
    c_indptr = property(lambda s: s._side(2, "indptr"))
    c_cols = property(lambda s: s._side(2, "cols"))
    c_idx = property(lambda s: s._side(2, "idx"))

    def remap(self, new_index: np.ndarray) -> "TiledBlock":
        assert self.remap_table is None, "compose remaps unsupported"
        return TiledBlock(
            self.tpl, self.K, self.base, self.ext_vars, self.label,
            remap_table=new_index,
        )

    pool_limbs = FieldBlock.pool_limbs
    eval_rows_v = FieldBlock.eval_rows_v
