"""Merkle trees: level-batched build over a linear store, inclusion proofs.

Counterpart of crypto3_fil_proofs_tpu/core/merkle/tree.py: building a
base tree (`MerkleTree.build`, tree.py:112-138), the root of a compound
tree, and the proof side copied as it is (`level_offsets` :34,
`ProofLevel` :47, `MerkleProof` :56, `from_store` :141, `gen_proof`
:151-216 for stores without discarded rows, `CompoundMerkleTree.gen_proof`
:270). Proofs read the store on the host.

A level is one batched backend call. For Poseidon the leaves go to the
device once; the levels above them stay there in Montgomery form, and
each level is written to the store once, as canonical LE bytes. The
store files are the JAX package's, byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass

from crypto3_fil_proofs_torch.ops.tree_hash import get_backend

from .storage import (
    DiskStore,
    Store,
    StoreConfig,
    VecStore,
    get_merkle_tree_len,
    get_merkle_tree_row_count,
)


def level_offsets(leafs: int, arity: int) -> list[int]:
    """Linear-layout offset of each level (level 0 = leaves)."""
    offs, off, n = [], 0, leafs
    while True:
        offs.append(off)
        if n == 1:
            break
        off += n
        n //= arity
    return offs


@dataclass
class ProofLevel:
    """One path level: the (arity-1) sibling hashes and the child index
    (reference: core/path_element.hpp:36-50)."""

    siblings: list[bytes]
    index: int


@dataclass
class MerkleProof:
    """Inclusion proof over (base, sub, top) segments.

    `path` is base-tree levels bottom-up, then the sub level (siblings
    among base-tree roots), then the top level — matching the reference's
    SingleProof/SubProof/TopProof variants (old_proof.hpp:98-608).
    """

    leaf: bytes
    root: bytes
    path: list[ProofLevel]
    backend: str = "poseidon"

    def validate(self) -> bool:
        backend = get_backend(self.backend)
        cur = self.leaf
        for lvl in self.path:
            children = list(lvl.siblings)
            children.insert(lvl.index, cur)
            cur = backend.hash_single(children)
        return cur == self.root

    def validate_data(self, data: bytes) -> bool:
        return self.leaf == data and self.validate()

    def leaf_index(self) -> int:
        """Reconstruct the challenged leaf index from path indices
        (reference old_proof.hpp `proves_challenge`)."""
        idx, mult = 0, 1
        for lvl in self.path:
            idx += lvl.index * mult
            mult *= len(lvl.siblings) + 1
        return idx

    def proves_challenge(self, challenge: int) -> bool:
        return self.leaf_index() == challenge

    def as_options(self) -> list[tuple[list[bytes], int]]:
        """Circuit witness form (reference old_proof.hpp `as_options`)."""
        return [(lvl.siblings, lvl.index) for lvl in self.path]


class MerkleTree:
    """Single base tree of one arity over a linear store."""

    def __init__(self, store: Store, leafs: int, arity: int, backend: str = "poseidon"):
        self.store = store
        self.leafs = leafs
        self.arity = arity
        self.backend = backend
        self.tree_len = get_merkle_tree_len(leafs, arity)
        self.offsets = level_offsets(leafs, arity)
        self.row_count = get_merkle_tree_row_count(leafs, arity)

    @classmethod
    def build(
        cls,
        leaves,
        arity: int,
        backend: str = "poseidon",
        config: StoreConfig | None = None,
        device=None,
    ) -> "MerkleTree":
        """Build from (N, 32) uint8 leaves (numpy array, memmap or
        tensor), or for Poseidon an int32 [N, 8] tensor of Montgomery
        leaves; one batched hash call per level. `device` is where a
        Poseidon tree is hashed (default: the device of a leaf tensor)."""
        leafs = leaves.shape[0]
        tree_len = get_merkle_tree_len(leafs, arity)
        if config is not None:
            config.size = tree_len
            store: Store = DiskStore(config, size=tree_len)
        else:
            store = VecStore(tree_len)
        hb = get_backend(backend)
        store.write_range(0, hb.leaf_bytes(leaves))
        off = leafs
        for level in hb.tree_levels(leaves, arity, device):
            store.write_range(off, level)
            off += level.shape[0]
        store.sync()
        return cls(store, leafs, arity, backend)

    @classmethod
    def from_store(cls, store: Store, leafs: int, arity: int, backend: str = "poseidon") -> "MerkleTree":
        return cls(store, leafs, arity, backend)

    def root(self) -> bytes:
        return self.store.read_at(self.tree_len - 1)

    def read_at(self, index: int) -> bytes:
        return self.store.read_at(index)

    def leaf(self, index: int) -> bytes:
        return self.store.read_at(index)

    def gen_proof(self, challenge: int) -> MerkleProof:
        a = self.arity
        path: list[ProofLevel] = []
        idx = challenge
        for level in range(self.row_count - 1):
            group = idx // a
            pos = idx % a
            base = self.offsets[level] + group * a
            nodes = self.store.read_range(base, base + a)
            path.append(ProofLevel([nodes[j].tobytes() for j in range(a) if j != pos], pos))
            idx = group
        return MerkleProof(leaf=self.leaf(challenge), root=self.root(), path=path, backend=self.backend)


class CompoundMerkleTree:
    """1-3 layer compound tree over equally-sized base trees.

    Shape (base_arity, sub_arity, top_arity) with 0 = absent, matching the
    reference SectorShape table (constants.hpp:116-125): e.g. 32GiB =
    (8, 8, 0): 8 base trees, their roots hashed with arity 8.
    """

    def __init__(self, base_trees: list[MerkleTree], sub_arity: int, top_arity: int):
        self.base_trees = base_trees
        self.backend = base_trees[0].backend
        self.sub_arity = sub_arity
        self.top_arity = top_arity
        count = len(base_trees)
        expected = (top_arity or 1) * (sub_arity or 1)
        if count != expected:
            raise ValueError(f"expected {expected} base trees, got {count}")
        hb = get_backend(base_trees[0].backend)
        roots = [t.root() for t in base_trees]
        if sub_arity:
            self.sub_roots = [
                hb.hash_single(roots[i : i + sub_arity])
                for i in range(0, count, sub_arity)
            ]
        else:
            self.sub_roots = roots
        if top_arity:
            self._root = hb.hash_single(self.sub_roots)
        else:
            self._root = self.sub_roots[0]

    def root(self) -> bytes:
        return self._root

    def leaf(self, index: int) -> bytes:
        per = self.base_trees[0].leafs
        return self.base_trees[index // per].leaf(index % per)

    def gen_proof(self, challenge: int) -> MerkleProof:
        per = self.base_trees[0].leafs
        tree_idx = challenge // per
        base_proof = self.base_trees[tree_idx].gen_proof(challenge % per)
        path = list(base_proof.path)
        roots = [t.root() for t in self.base_trees]
        if self.sub_arity:
            group = tree_idx // self.sub_arity
            pos = tree_idx % self.sub_arity
            sibs = [roots[group * self.sub_arity + j] for j in range(self.sub_arity) if j != pos]
            path.append(ProofLevel(sibs, pos))
            if self.top_arity:
                pos_t = group % self.top_arity
                sibs_t = [self.sub_roots[j] for j in range(self.top_arity) if j != pos_t]
                path.append(ProofLevel(sibs_t, pos_t))
        return MerkleProof(leaf=base_proof.leaf, root=self._root, path=path, backend=self.backend)
