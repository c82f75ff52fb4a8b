"""DRG PoRep in the port against the JAX package on the CPU, bit for bit.

- The DRG graph's parents, the ChaCha8 RNG and the Feistel permutation
  (the modules DRG PoRep and the stacked graph share) on seeded inputs.
- A 64-node sector (degree 6, two challenges, as tests/test_drg.py):
  `replicate` (the commitments and the replica), `extract_all`, `prove`
  field by field and `verify`, with the tampered challenge set and
  replica id rejected by both packages.
- The drg8 instance of tests/golden/drg8 (8 nodes, degree 6, one
  challenge: 1,989,928 constraints, 12 inputs): its commitments equal
  the golden's; the circuit equals the JAX package's (SHA-256 of every
  segment's arrays, the assignment and the inputs), is satisfied and its
  inputs are `generate_public_inputs`; the blank circuit equals the JAX
  package's and has the real one's counts; the cache prefix is the JAX
  string; a tampered parent value leaves the circuit unsatisfied.
- The port's verifier accepts the golden drg8 proof under its vk and
  rejects tampered bytes and a wrong replica id.

The JAX package's drg8 circuits are synthesized once per pytest run and
shared across xdist workers (tests/test_torch_setup.py
`shared_reference`). The Groth16 setup and prove of drg8 (a 2^21 domain)
run on the card only (chip_smoke.py phase 23). The tolerance is exact
equality throughout.
"""
import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from crypto3_fil_proofs_tpu.core import chacha as jax_chacha
from crypto3_fil_proofs_tpu.core import drgraph as jax_drgraph
from crypto3_fil_proofs_tpu.core import feistel as jax_feistel
from crypto3_fil_proofs_tpu.models.porep.drg import vanilla as jax_vanilla
from crypto3_fil_proofs_torch.core import chacha, drgraph, feistel
from crypto3_fil_proofs_torch.core.compound import CompoundProof, MultiProof
from crypto3_fil_proofs_torch.models.porep.drg import circuit
from crypto3_fil_proofs_torch.models.porep.drg import vanilla
from crypto3_fil_proofs_torch.zk import groth16
from test_torch_commit import circuit_summary
from test_torch_setup import shared_reference

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "drg8")
with open(os.path.join(GOLDEN, "inputs.json")) as _f:
    DRG8 = json.load(_f)
DRG_SEED = bytes.fromhex(DRG8["drg_seed"])


def _sector(pkg_vanilla, nodes: int, challenges: int):
    """Setup and replicate a seeded sector, as tests/test_drg.py and
    scripts/drg_groth16_e2e.py make it."""
    sp = pkg_vanilla.SetupParams(
        drg=pkg_vanilla.DrgParams(nodes=nodes, degree=6, expansion_degree=0, seed=DRG_SEED),
        challenges_count=challenges,
    )
    pp = pkg_vanilla.DrgPoRep.setup(sp)
    rng = np.random.default_rng(0x5EED)
    data = rng.integers(0, 64, size=(nodes, 32), dtype=np.uint8)
    replica_id = bytes(rng.integers(0, 64, size=32, dtype=np.uint8))
    tau, aux, replica = pkg_vanilla.DrgPoRep.replicate(pp, replica_id, data)
    return pp, replica_id, data, tau, aux, replica


def _proved(pkg_vanilla, nodes: int, challenges: list[int]):
    pp, replica_id, data, tau, aux, replica = _sector(pkg_vanilla, nodes, len(challenges))
    pub = pkg_vanilla.PublicInputs(replica_id=replica_id, challenges=challenges, tau=tau)
    proof = pkg_vanilla.DrgPoRep.prove(pp, pub, pkg_vanilla.PrivateInputs(tree_d=aux.tree_d, tree_r=aux.tree_r))
    return pp, pub, proof


@pytest.fixture(scope="module")
def sector64():
    return _sector(vanilla, 64, 2), _sector(jax_vanilla, 64, 2)


def test_graph_parents_and_rng_equal_jax():
    for nodes, porep_id in ((8, DRG_SEED), (64, DRG_SEED), (1000, bytes(range(32)))):
        g, jg = drgraph.BucketGraph(nodes, 6, porep_id), jax_drgraph.BucketGraph(nodes, 6, porep_id)
        assert np.array_equal(g.parents_all(), jg.parents_all())
        for node in (0, 1, 2, nodes - 1):
            assert np.array_equal(g.parents(node), jg.parents(node))
        assert (g.size(), g.degree(), g.sector_size(), g.identifier()) == \
            (jg.size(), jg.degree(), jg.sector_size(), jg.identifier())
        data = np.random.default_rng(nodes).integers(0, 256, nodes * 32, dtype=np.uint8).tobytes()
        for node in (0, 1, 5):
            parents = g.parents(node)
            assert g.create_key(DRG_SEED, node, parents, data) == jg.create_key(DRG_SEED, node, parents, data)
    rng, jrng = chacha.ChaCha8Rng(bytes(range(32))), jax_chacha.ChaCha8Rng(bytes(range(32)))
    assert [rng.next_u64() for _ in range(40)] == [jrng.next_u64() for _ in range(40)]
    key = np.arange(8, dtype=np.uint32) * 0x01010101
    for counter in (0, 1, (1 << 32) + 3):
        assert np.array_equal(chacha.chacha_block(key, counter), jax_chacha.chacha_block(key, counter))
    with pytest.raises(ValueError):
        chacha.ChaCha8Rng(bytes(31))


@pytest.mark.parametrize("num_elements", [1, 10, 64, 1000, 1 << 20])
def test_feistel_equals_jax_and_inverts(num_elements):
    keys = [0xDEADBEEF, 0x0123456789ABCDEF, 42]
    pre = feistel.precompute(num_elements)
    assert pre == jax_feistel.precompute(num_elements)
    idx = np.random.default_rng(num_elements).integers(0, num_elements, 64).tolist()
    for i in idx:
        p = feistel.permute(num_elements, i, keys, pre)
        assert p == jax_feistel.permute(num_elements, i, keys, pre)
        assert p < num_elements
        assert feistel.invert_permute(num_elements, p, keys, pre) == i
        assert feistel.encode(i, keys, pre) == jax_feistel.encode(i, keys, pre)
        assert feistel.decode(feistel.encode(i, keys, pre), keys, pre) == i


def test_replicate_and_extract_equal_jax(sector64):
    (pp, replica_id, data, tau, aux, replica), (_, jid, jdata, jtau, jaux, jreplica) = sector64
    assert replica_id == jid and np.array_equal(data, jdata)
    assert dataclasses.asdict(tau) == dataclasses.asdict(jtau)
    assert np.array_equal(replica, jreplica)
    assert not np.array_equal(replica, data)
    assert np.array_equal(vanilla.DrgPoRep.extract_all(pp, replica_id, replica), data)


def test_prove_verify_equal_jax(sector64):
    (pp, replica_id, _, tau, aux, _), (jpp, _, _, jtau, jaux, _) = sector64
    pub = vanilla.PublicInputs(replica_id=replica_id, challenges=[3, 7], tau=tau)
    proof = vanilla.DrgPoRep.prove(pp, pub, vanilla.PrivateInputs(tree_d=aux.tree_d, tree_r=aux.tree_r))
    jpub = jax_vanilla.PublicInputs(replica_id=replica_id, challenges=[3, 7], tau=jtau)
    jproof = jax_vanilla.DrgPoRep.prove(jpp, jpub, jax_vanilla.PrivateInputs(tree_d=jaux.tree_d, tree_r=jaux.tree_r))
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    assert vanilla.DrgPoRep.verify(pp, pub, proof)
    bad_id = bytes([replica_id[0] ^ 1]) + replica_id[1:]
    for bad, jbad in (
        (dataclasses.replace(pub, challenges=[3, 8]), dataclasses.replace(jpub, challenges=[3, 8])),
        (dataclasses.replace(pub, replica_id=bad_id), dataclasses.replace(jpub, replica_id=bad_id)),
    ):
        assert not vanilla.DrgPoRep.verify(pp, bad, proof)
        assert not jax_vanilla.DrgPoRep.verify(jpp, jbad, jproof)
    with pytest.raises(AssertionError):  # the first node cannot be proved
        vanilla.DrgPoRep.prove(pp, dataclasses.replace(pub, challenges=[64]),
                               vanilla.PrivateInputs(tree_d=aux.tree_d, tree_r=aux.tree_r))


def _jax_drg8(shared) -> dict:
    """The JAX package's drg8 circuit and its blank circuit, summarized."""
    from crypto3_fil_proofs_tpu.models.porep.drg import circuit as jax_circuit

    pp, pub, proof = _proved(jax_vanilla, DRG8["nodes"], DRG8["challenges"])
    comp = jax_circuit.DrgPoRepCompound()
    return {
        "circuit": circuit_summary(jax_circuit.circuit_from_vanilla(pp, pub, proof)),
        "blank": circuit_summary(comp.blank_circuit(pp)),
        "inputs": comp.generate_public_inputs(pp, pub),
        "prefix": comp.cache_prefix(pp),
    }


@pytest.fixture(scope="module")
def jax_drg8(tmp_path_factory):
    return shared_reference(tmp_path_factory, "jax_drg8", _jax_drg8)


@pytest.fixture(scope="module")
def drg8():
    return _proved(vanilla, DRG8["nodes"], DRG8["challenges"])


def test_drg8_circuit_equals_jax(drg8, jax_drg8):
    pp, pub, proof = drg8
    assert (pub.tau.comm_d.hex(), pub.tau.comm_r.hex(), pub.replica_id.hex()) == \
        (DRG8["comm_d"], DRG8["comm_r"], DRG8["replica_id"])
    assert vanilla.DrgPoRep.verify(pp, pub, proof)
    cs = circuit.circuit_from_vanilla(pp, pub, proof)
    assert (cs.num_constraints, cs.num_inputs) == (1_989_928, 12)
    assert cs.which_unsatisfied() is None
    comp = circuit.DrgPoRepCompound()
    inputs = comp.generate_public_inputs(pp, pub)
    assert [v for v, i in zip(cs.values, cs.is_input) if i][1:] == inputs == jax_drg8["inputs"]
    assert comp.cache_prefix(pp) == jax_drg8["prefix"] == "drg-proof-of-replication-sha256-8-6-1"
    summary = circuit_summary(cs)
    assert summary == jax_drg8["circuit"]
    blank = circuit_summary(comp.blank_circuit(pp))
    assert blank == jax_drg8["blank"]
    assert (blank["constraints"], blank["n_in"], blank["n_aux"]) == \
        (summary["constraints"], summary["n_in"], summary["n_aux"])


def test_drg8_tampered_parent_unsatisfied(drg8):
    pp, pub, proof = drg8
    bad = copy.deepcopy(proof)
    idx, dp = bad.replica_parents[0][0]
    flipped = bytearray(dp.data)
    flipped[0] ^= 1
    bad.replica_parents[0][0] = (idx, vanilla.DataProof(proof=dp.proof, data=bytes(flipped)))
    assert circuit.circuit_from_vanilla(pp, pub, bad).which_unsatisfied() is not None


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(GOLDEN, "proof.bin"), "rb") as f:
        proof = f.read()
    with np.load(os.path.join(GOLDEN, "vk.npz"), allow_pickle=False) as d:
        vk = groth16.VerifyingKey.from_npz_dict(d)
    pp = vanilla.DrgPoRep.setup(vanilla.SetupParams(
        drg=vanilla.DrgParams(nodes=DRG8["nodes"], degree=DRG8["degree"], expansion_degree=0, seed=DRG_SEED),
        challenges_count=len(DRG8["challenges"])))
    pub = vanilla.PublicInputs(
        replica_id=bytes.fromhex(DRG8["replica_id"]), challenges=DRG8["challenges"],
        tau=vanilla.Tau(comm_d=bytes.fromhex(DRG8["comm_d"]), comm_r=bytes.fromhex(DRG8["comm_r"])))
    return pp, pub, proof, vk


def test_golden_drg8_proof_verifies(golden):
    pp, pub, proof, vk = golden
    assert len(proof) == DRG8["proof_len"] == 192
    assert CompoundProof(circuit.DrgPoRepCompound()).verify(pp, pub, MultiProof.from_bytes(proof, 1), vk)


@pytest.mark.parametrize("byte,mask", [(7, 0x20), (50, 0x01), (191, 0x80)])
def test_golden_drg8_tampered_rejected(golden, byte, mask):
    pp, pub, proof, vk = golden
    bad = bytearray(proof)
    bad[byte] ^= mask
    try:
        mp = MultiProof.from_bytes(bytes(bad), 1)
    except ValueError:  # the flipped x lands off the curve
        return
    assert not CompoundProof(circuit.DrgPoRepCompound()).verify(pp, pub, mp, vk)


def test_golden_drg8_wrong_replica_id_rejected(golden):
    pp, pub, proof, vk = golden
    pub = dataclasses.replace(pub, replica_id=bytes(32))
    assert not CompoundProof(circuit.DrgPoRepCompound()).verify(pp, pub, MultiProof.from_bytes(proof, 1), vk)
