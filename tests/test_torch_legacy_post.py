"""Election and Rational PoSt in the port against the JAX package on the
CPU, bit for bit.

- `hash_md` (the arity-36 Poseidon Merkle-Damgard fold) at 1, 2, 35,
  36, 37 and 70 elements, some of them above r; the sparse partial-round
  schedule at arities 2, 4, 8 and 11.
- Election PoSt over a seeded 2 KiB oct tree (64 leaves): the sector
  challenges, the candidates (partial ticket and ticket), the vanilla
  proof field by field, `verify`, and a wrong partial ticket and a
  wrong comm_r rejected.
- The 2 x 1 Election circuit equals the JAX package's (SHA-256 of every
  segment's arrays, the assignment and the inputs), is satisfied, and
  its inputs are `generate_public_inputs` (the packed leaf bits before
  randomness, prover id, sector id and the partial ticket); a tampered
  comm_c leaves it unsatisfied; the blank circuit equals the JAX
  package's; the cache prefix is the JAX string; the blank counts of
  2 x 1 at 2 KiB and of 40 x 1 over 512 MiB are the frozen JAX golden's
  (tests/golden/torch_election_2k.json: 139,099 constraints and 46
  inputs at 40 x 1).
- Rational PoSt: `derive_challenges` with and without faults, and the
  roundtrip over two sectors with a faulty challenged sector rejected.

The JAX package's circuits are synthesized once per pytest run
(tests/test_torch_setup.py `shared_reference`). The Groth16 setup and
prove run on the card (tests/test_torch_cuda.py, chip_smoke.py phases
24-25). The tolerance is exact equality throughout.
"""
import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from crypto3_fil_proofs_tpu.core.merkle.tree import MerkleTree as JaxMerkleTree
from crypto3_fil_proofs_tpu.models.post.election import vanilla as jax_election
from crypto3_fil_proofs_tpu.models.post.rational import vanilla as jax_rational
from crypto3_fil_proofs_tpu.ops import poseidon as jax_poseidon
from crypto3_fil_proofs_torch.core.merkle import MerkleTree
from crypto3_fil_proofs_torch.models.post.election import circuit as ecirc
from crypto3_fil_proofs_torch.models.post.election import vanilla as election
from crypto3_fil_proofs_torch.models.post.rational import vanilla as rational
from crypto3_fil_proofs_torch.ops import poseidon
from crypto3_fil_proofs_torch.ops.bls12_381 import R
from test_torch_commit import circuit_summary
from test_torch_setup import shared_reference

with open(os.path.join(os.path.dirname(__file__), "golden", "torch_election_2k.json")) as _f:
    GOLDEN = json.load(_f)
SECTOR = 2048  # 64 leaves = 8^2, a whole oct tree
LEAVES = SECTOR // 32
COMM_C = bytes([5] * 32)
RANDOMNESS = bytes([7] * 31 + [0])
PROVER_ID = bytes([3] * 31 + [0])
SECTOR_ID = 11


def _leaves(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, size=(LEAVES, 32), dtype=np.uint8)


def _comm_r(hash2, comm_c: bytes, root: bytes) -> bytes:
    return hash2(int.from_bytes(comm_c, "little"), int.from_bytes(root, "little")).to_bytes(32, "little")


def _election(pkg, tree, hash2, challenges: int):
    """Setup, candidate, public and private inputs and the vanilla proof
    over either package's modules."""
    pp = pkg.ElectionPoSt.setup(pkg.SetupParams(sector_size=SECTOR, challenge_count=challenges, challenged_nodes=1))
    cand = pkg.generate_candidate(pp, tree, PROVER_ID, SECTOR_ID, RANDOMNESS, 0)
    pub = pkg.PublicInputs(randomness=RANDOMNESS, sector_id=SECTOR_ID, prover_id=PROVER_ID,
                           comm_r=_comm_r(hash2, COMM_C, tree.root()), partial_ticket=cand.partial_ticket,
                           sector_challenge_index=0)
    priv = pkg.PrivateInputs(tree=tree, comm_c=COMM_C, comm_r_last=tree.root())
    return pp, cand, pub, pkg.ElectionPoSt.prove(pp, pub, priv)


@pytest.fixture(scope="module")
def trees():
    leaves = _leaves(0x5EED)
    return MerkleTree.build(leaves, 8, "poseidon"), JaxMerkleTree.build(leaves, 8, "poseidon")


@pytest.mark.parametrize("count", [1, 2, 35, 36, 37, 70])
def test_hash_md_equals_jax(count):
    rng = np.random.default_rng(count)
    elements = [int.from_bytes(rng.bytes(32), "little") for _ in range(count)]
    elements[0] += R  # reduced mod r, also when it passes through alone
    assert poseidon.POSEIDON_MD_ARITY == jax_poseidon.POSEIDON_MD_ARITY == 36
    assert poseidon.hash_md(elements) == jax_poseidon.hash_md(elements)


@pytest.mark.parametrize("arity", [2, 4, 8, 11])
def test_partial_schedule_equals_jax(arity):
    """The sparse partial-round schedule (one inversion of the MDS block
    in the port, two inversions a round in the JAX package); arity 36's
    is held through the Election circuits below."""
    assert poseidon.optimized_partial_schedule(arity) == tuple(jax_poseidon.optimized_partial_schedule(arity))


def test_election_vanilla_equals_jax(trees):
    tree, jtree = trees
    assert tree.root() == jtree.root()
    sectors = [0, 11, 42]
    assert election.generate_sector_challenges(RANDOMNESS, 5, sectors) == \
        jax_election.generate_sector_challenges(RANDOMNESS, 5, sectors)
    pp, cand, pub, proof = _election(election, tree, poseidon.hash2, 4)
    jpp, jcand, jpub, jproof = _election(jax_election, jtree, jax_poseidon.hash2, 4)
    assert dataclasses.asdict(cand) == dataclasses.asdict(jcand)
    for other in (1, 2):
        assert dataclasses.asdict(election.generate_candidate(pp, tree, PROVER_ID, 42, RANDOMNESS, other)) == \
            dataclasses.asdict(jax_election.generate_candidate(jpp, jtree, PROVER_ID, 42, RANDOMNESS, other))
    assert dataclasses.asdict(pub) == dataclasses.asdict(jpub)
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    assert proof.ticket == cand.ticket
    assert election.ElectionPoSt.verify(pp, pub, proof)
    assert not election.ElectionPoSt.verify(pp, dataclasses.replace(pub, partial_ticket=bytes(32)), proof)
    assert not election.ElectionPoSt.verify(pp, dataclasses.replace(pub, comm_r=bytes(32)), proof)


def _jax_circuits(shared) -> dict:
    """The JAX package's 2 x 1 circuit over the seeded tree, its public
    inputs and its blank circuit, summarized."""
    from crypto3_fil_proofs_tpu.models.post.election import circuit as jax_ecirc

    jtree = JaxMerkleTree.build(_leaves(0x5EED), 8, "poseidon")
    pp, _, pub, proof = _election(jax_election, jtree, jax_poseidon.hash2, 2)
    comp = jax_ecirc.ElectionPoStCompound(shape=(8, 0, 0))
    return {
        "circuit": circuit_summary(jax_ecirc.circuit_from_vanilla(pp, pub, proof)),
        "inputs": jax_ecirc.generate_public_inputs(pp, pub),
        "blank": circuit_summary(comp.blank_circuit(pp)),
        "prefix": comp.cache_prefix(pp),
    }


@pytest.fixture(scope="module")
def jax_circuits(tmp_path_factory):
    return shared_reference(tmp_path_factory, "jax_election_2x1", _jax_circuits)


def test_election_circuit_equals_jax(trees, jax_circuits):
    pp, _, pub, proof = _election(election, trees[0], poseidon.hash2, 2)
    cs = ecirc.circuit_from_vanilla(pp, pub, proof)
    assert cs.which_unsatisfied() is None
    comp = ecirc.ElectionPoStCompound(shape=(8, 0, 0))
    inputs = comp.generate_public_inputs(pp, pub)
    assert [v for v, i in zip(cs.values, cs.is_input) if i][1:] == inputs == jax_circuits["inputs"]
    # comm_r, the packed leaf bits, then randomness, prover id, sector id, partial ticket
    assert inputs[-4:] == [int.from_bytes(RANDOMNESS, "little"), int.from_bytes(PROVER_ID, "little"),
                           SECTOR_ID, int.from_bytes(pub.partial_ticket, "little")]
    assert circuit_summary(cs) == jax_circuits["circuit"]
    assert circuit_summary(comp.blank_circuit(pp)) == jax_circuits["blank"]
    assert comp.cache_prefix(pp) == jax_circuits["prefix"] == \
        "proof-of-spacetime-election-poseidon-8-0-0-2048-2-1"
    bad = copy.deepcopy(proof)
    bad.comm_c = bytes([6] * 32)
    assert ecirc.circuit_from_vanilla(pp, pub, bad).which_unsatisfied() is not None


@pytest.mark.parametrize("blank", GOLDEN["blank_counts"], ids=lambda b: f"{b['sector_size']}-{b['challenge_count']}")
def test_election_blank_counts_equal_golden(blank):
    pp = election.ElectionPoSt.setup(
        election.SetupParams(blank["sector_size"], blank["challenge_count"], blank["challenged_nodes"]))
    cs = ecirc.ElectionPoStCompound(shape=(8, 0, 0)).blank_circuit(pp)
    assert (cs.num_constraints, cs.num_inputs, len(cs.values)) == \
        (blank["constraints"], blank["inputs"], blank["variables"])
    if blank["sector_size"] == 512 << 20:
        assert (cs.num_constraints, cs.num_inputs) == (139_099, 46)


def _rational(pkg, tree_cls, hash2, faults: set):
    pp = pkg.RationalPoSt.setup(pkg.SetupParams(sector_size=SECTOR, challenges_count=4))
    trees = {s: tree_cls.build(_leaves(0x5EED + s), 8, "poseidon") for s in (1, 5)}
    comm_c = {1: bytes([1] * 32), 5: bytes([5] * 32)}
    comm_rs = {s: _comm_r(hash2, comm_c[s], t.root()) for s, t in trees.items()}
    challenges = pkg.derive_challenges(4, SECTOR, [1, 5], bytes([9] * 32), faults=faults)
    pub = pkg.PublicInputs(challenges=challenges, faults=faults, comm_rs=comm_rs)
    priv = pkg.PrivateInputs(trees=trees, comm_c=comm_c, comm_r_last={s: t.root() for s, t in trees.items()})
    return pp, pub, pkg.RationalPoSt.prove(pp, pub, priv)


@pytest.mark.parametrize("faults", [set(), {1}, {5}, {7}], ids=str)
def test_rational_derive_challenges_equal_jax(faults):
    sectors = [7, 1, 5, 12]
    for seed in (bytes([9] * 32), bytes(range(32))):
        got = rational.derive_challenges(64, SECTOR, sectors, seed, faults)
        assert [dataclasses.asdict(c) for c in got] == \
            [dataclasses.asdict(c) for c in jax_rational.derive_challenges(64, SECTOR, sectors, seed, faults)]
        assert not {c.sector for c in got} & faults
    with pytest.raises(AssertionError):
        rational.derive_challenges(4, SECTOR, [1], bytes(32), {1})


def test_rational_roundtrip_equals_jax():
    pp, pub, proof = _rational(rational, MerkleTree, poseidon.hash2, set())
    _, jpub, jproof = _rational(jax_rational, JaxMerkleTree, jax_poseidon.hash2, set())
    assert [dataclasses.asdict(c) for c in pub.challenges] == [dataclasses.asdict(c) for c in jpub.challenges]
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    assert rational.RationalPoSt.verify(pp, pub, proof)
    faulty = dataclasses.replace(pub, faults={pub.challenges[0].sector})
    assert not rational.RationalPoSt.verify(pp, faulty, proof)
    short = dataclasses.replace(proof, inclusion_proofs=proof.inclusion_proofs[:-1])
    assert not rational.RationalPoSt.verify(pp, pub, short)
    # challenges avoid faults at derivation
    _, pub5, proof5 = _rational(rational, MerkleTree, poseidon.hash2, {1})
    assert all(c.sector == 5 for c in pub5.challenges)
    assert rational.RationalPoSt.verify(pp, pub5, proof5)
