"""The Pedersen hasher over Jubjub in the port against the JAX package on
the CPU, bit for bit.

- The curve constants, the group laws, the point codec and the
  BLAKE2s "Zcash_PH" generators (generator 0 is Zcash's published
  PEDERSEN_HASH_GENERATORS[0]; the JAX package's tests pin 0-3).
- `pedersen_hash` on the frozen vectors of tests/test_pedersen.py and on
  seeded messages of 1 to 96 bytes, and `pedersen_md_no_padding`.
- The tree-hash backend (`get_backend("pedersen")`, loaded at its first
  use): `hash_level` at arity 2 and 4, `hash_single`, and a Merkle tree
  built over it.
- The gadget: `pedersen_hash_circuit` over 32 and 64 bytes equals the
  JAX package's circuit (SHA-256 of every segment's arrays, the
  assignment and the inputs), its digest is `pedersen_hash`, and a
  digest pinned to a wrong value is unsatisfied.

Host Python integers in both packages; the tolerance is exact equality.
"""
import numpy as np
import pytest

from crypto3_fil_proofs_tpu.ops import pedersen as jax_ped
from crypto3_fil_proofs_tpu.ops.tree_hash import get_backend as jax_get_backend
from crypto3_fil_proofs_torch.core.merkle import MerkleTree
from crypto3_fil_proofs_torch.ops import pedersen as ped
from crypto3_fil_proofs_torch.ops.tree_hash import get_backend
from test_torch_commit import circuit_summary

GENERATOR_0 = (
    0x73C016A42DED9578B5EA25DE7EC0E3782F0C718F6F0FBADD194E42926F661B51,
    0x289E87A2D3521B5779C9166B837EDC5EF9472E8BC04E463277BFABD432243CCA,
)


def test_curve_and_generators_equal_jax():
    assert (ped.Q, ped.D, ped.SUBGROUP_ORDER, ped.URS) == (jax_ped.Q, jax_ped.D, jax_ped.SUBGROUP_ORDER, jax_ped.URS)
    assert (ped.D * 10241 + 10240) % ped.Q == 0
    assert ped.pedersen_generator(0) == GENERATOR_0
    gens = [ped.pedersen_generator(i) for i in range(6)]
    assert gens == [jax_ped.pedersen_generator(i) for i in range(6)]
    assert len(set(gens)) == 6
    for g in gens[:2]:
        assert ped.is_on_curve(g)
        assert ped.scalar_mul(ped.SUBGROUP_ORDER, g) == ped.IDENTITY
    g, h = gens[0], gens[1]
    assert ped.add(g, ped.negate(g)) == ped.IDENTITY
    assert ped.add(g, h) == ped.add(h, g) == jax_ped.add(h, g)
    for k in (1, 2, 7, 12345):
        p = ped.scalar_mul(k, g)
        assert p == jax_ped.scalar_mul(k, g)
        assert ped.point_to_bytes(p) == jax_ped.point_to_bytes(p)
        assert ped.point_from_bytes(ped.point_to_bytes(p)) == p
    assert ped.point_from_bytes(ped.point_to_bytes(ped.IDENTITY)) == ped.IDENTITY
    assert ped.point_from_bytes(b"\xff" * 32) is None


def test_pedersen_hash_frozen_vectors():
    assert ped.pedersen_hash(b"\x01" * 64) == 0x61604968258B66EEE5323997D8D6F3FD22E0F75C65A8B58B5ACA7A3090733B6F
    assert ped.pedersen_hash(b"abc" + b"\x00" * 61) == \
        0x712FC298A5FB29D98702ABDB4C008BB5C23D0E7C2CA51FB7AE71942B6A7F39A5


@pytest.mark.parametrize("nbytes", [1, 31, 32, 64, 96])
def test_pedersen_hash_equals_jax(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    assert ped.pedersen_hash(data) == jax_ped.pedersen_hash(data)
    assert ped.pedersen_hash(data, [1, 0, 1]) == jax_ped.pedersen_hash(data, [1, 0, 1])
    if nbytes >= 64 and nbytes % 32 == 0:
        assert ped.pedersen_md_no_padding(data) == jax_ped.pedersen_md_no_padding(data)


def test_backend_equals_jax():
    be, jbe = get_backend("pedersen"), jax_get_backend("pedersen")
    assert be.name == jbe.name == "pedersen"
    nodes = np.random.default_rng(7).integers(0, 256, size=(8, 32), dtype=np.uint8)
    nodes[:, 31] &= 0x3F  # nodes below q, as fr32 leaves
    for arity in (2, 4):
        assert np.array_equal(be.hash_level(nodes, arity), jbe.hash_level(nodes, arity))
    lvl4 = be.hash_level(nodes, 4)
    assert lvl4[0].tobytes() == ped.pedersen_md_no_padding(nodes[:4].tobytes()).to_bytes(32, "little")
    assert be.hash_single([nodes[0].tobytes(), nodes[1].tobytes()]) == \
        jbe.hash_single([nodes[0].tobytes(), nodes[1].tobytes()])
    with pytest.raises(ValueError):
        be.hash_single([b"\0" * 31])
    tree = MerkleTree.build(nodes, 2, "pedersen")
    level = nodes
    while level.shape[0] > 1:
        level = be.hash_level(level, 2)
    assert tree.root() == level[0].tobytes()
    proof = tree.gen_proof(5)
    assert proof.validate() and proof.proves_challenge(5)


def _gadget(pkg: str, data: bytes):
    import importlib

    r1cs = importlib.import_module(f"{pkg}.zk.r1cs")
    boolean = importlib.import_module(f"{pkg}.zk.gadgets.boolean")
    gadget = importlib.import_module(f"{pkg}.zk.gadgets.pedersen")
    cs = r1cs.ConstraintSystem()
    bits = [boolean.Boolean.alloc(cs, b) for b in ped.bytes_to_bits(data)]
    return cs, gadget.pedersen_hash_circuit(cs, bits)


@pytest.mark.parametrize("nbytes", [32, 64])
def test_gadget_equals_jax(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    cs, digest = _gadget("crypto3_fil_proofs_torch", data)
    jcs, jdigest = _gadget("crypto3_fil_proofs_tpu", data)
    assert digest.value == jdigest.value == ped.pedersen_hash(data)
    assert cs.is_satisfied()
    assert circuit_summary(cs) == circuit_summary(jcs)


def test_gadget_pinned_wrong_digest_unsatisfied():
    from crypto3_fil_proofs_torch.zk.r1cs import LinearCombination, lc_one

    cs, digest = _gadget("crypto3_fil_proofs_torch", b"\x05" * 32)
    cs.enforce(digest.lc() - LinearCombination.constant((digest.value + 1) % ped.Q), lc_one(),
               LinearCombination(), "pin_wrong")
    assert not cs.is_satisfied()
