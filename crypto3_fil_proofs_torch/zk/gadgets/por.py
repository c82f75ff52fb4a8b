"""PoR (Merkle inclusion) circuit — reference core/components/por.hpp.

Per path level: allocate position bits and siblings, insert the running
hash at its position (gadgets/insertion.py), hash the children with the
level hasher (Poseidon for tree_c/tree_r_last, SHA-256 with Fr trim for
tree_d), and finally constrain equality with the root. Position bits
across all levels concatenate to the challenge index (LE), matching the
reference's packed-path public input (core/components/por.hpp:52-253,
AuthPath base/sub/top segments = our MerkleProof.path levels).

Copied from crypto3_fil_proofs_tpu/zk/gadgets/por.py with its imports rewritten.
"""
from __future__ import annotations

from ...ops.bls12_381 import R
from ..r1cs import ConstraintSystem, LinearCombination, lc_one
from .boolean import AllocatedBit, Boolean
from .insertion import insert
from .num import AllocatedNum
from .poseidon import poseidon_hash_circuit
from .sha256 import digest_bits_value, le_bits_to_be, sha256


def _le_value_bits(cs, value: int, n_bits: int) -> list:
    """Allocate the LE bits of a known value (no packing constraint; the
    consumer ties them via hashing/insertion)."""
    from .boolean import alloc_bits_bulk

    return alloc_bits_bulk(
        cs, [(value >> i) & 1 for i in range(n_bits)]
    )


def sha256_node_circuit(cs, children: list[AllocatedNum]) -> AllocatedNum:
    """Binary SHA-256 node hash with Fr trim (tree_d semantics:
    ops/tree_hash.Sha256Backend — digest of 64 bytes, last byte &0x3F)."""
    assert len(children) == 2
    bits_le = []
    for child in children:
        bits_le.extend(child.to_bits_le(cs, 256))
    block_be = le_bits_to_be(bits_le)
    digest_be = sha256(cs, block_be)  # full SHA-256 incl. padding block
    from .boolean import pack_bits_lc

    value = digest_bits_value(digest_be)
    out = AllocatedNum.alloc(cs, value, "sha_node")
    le = le_bits_to_be(digest_be)  # back to LE-within-byte ordering
    lc, _ = pack_bits_lc(le[:254])  # trim top two bits (&0x3F on byte 31)
    lc.accumulate(out.var, R - 1)
    cs.enforce(lc, lc_one(), LinearCombination(), "sha_node_pack")
    return out


def por_circuit(
    cs: ConstraintSystem,
    leaf: AllocatedNum,
    path: list[tuple[list[bytes], int]],
    root: AllocatedNum,
    hasher: str = "poseidon",
) -> list[Boolean]:
    """Synthesize the inclusion proof; returns the concatenated LE
    position bits (the challenge index decomposition).

    `path` is MerkleProof.as_options(): [(sibling bytes, index)] levels
    bottom-up. `root` is an AllocatedNum (private here; the caller
    inputizes or constrains it per protocol).
    """
    cur = leaf
    all_bits: list[Boolean] = []
    for siblings_bytes, index in path:
        arity = len(siblings_bytes) + 1
        n_bits = (arity - 1).bit_length()
        assert 1 << n_bits == arity
        bits = _le_value_bits(cs, index, n_bits)
        siblings = [
            AllocatedNum.alloc(cs, int.from_bytes(s, "little"), "sibling")
            for s in siblings_bytes
        ]
        children = insert(cs, cur, bits, siblings)
        if hasher == "poseidon":
            cur = poseidon_hash_circuit(cs, children, arity)
        elif hasher == "sha256":
            cur = sha256_node_circuit(cs, children)
        else:
            raise ValueError(f"unknown hasher {hasher}")
        all_bits.extend(bits)
    AllocatedNum.equals(cs, cur, root)
    return all_bits


def pack_position_bits_into_inputs(cs, bits: list[Boolean]) -> None:
    """Expose packed path bits as public inputs, Fr-capacity chunks
    (reference compound generate_public_inputs packs challenge bits)."""
    from .boolean import pack_bits_lc

    cap = 254  # Fr capacity (bellperson multipack convention)
    for start in range(0, len(bits), cap):
        chunk = bits[start : start + cap]
        lc, value = pack_bits_lc(chunk)
        inp = cs.alloc_input(value, "packed_bits")
        lc.accumulate(inp, R - 1)
        cs.enforce(lc, lc_one(), LinearCombination(), "pack_input")


def packed_position_input_values(challenge: int, total_bits: int) -> list[int]:
    """Host-side: the public-input values pack_position_bits_into_inputs
    produces for a challenge (verifier side, no synthesis)."""
    bits = [(challenge >> i) & 1 for i in range(total_bits)]
    out = []
    for start in range(0, total_bits, 254):
        chunk = bits[start : start + 254]
        out.append(sum(b << i for i, b in enumerate(chunk)) % R)
    return out
