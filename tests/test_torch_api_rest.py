"""The rest of the port's host API on the CPU against the JAX package,
with exact equality: piece alignment (the reference's tables,
tests/test_fr32_pieces.py:109 and :134), compute_comm_d, the streaming
commitment and fr32 readers, fauxrep, clear_cache on a 2 KiB cache, the
PoR scheme (core/por.py), the sector-shape predicates and config.ini
seeding of the settings.
"""
import os
import random
import shutil

import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu import constants as jax_constants
from crypto3_fil_proofs_tpu.api import pieces as jax_pieces
from crypto3_fil_proofs_tpu.api import seal as jax_seal
from crypto3_fil_proofs_tpu.api.commitment_reader import CommitmentReader as JaxCommitmentReader
from crypto3_fil_proofs_tpu.api.fr32_reader import Fr32Reader as JaxFr32Reader
from crypto3_fil_proofs_tpu.core.merkle.tree import MerkleTree as JaxMerkleTree
from crypto3_fil_proofs_tpu.core.por import PoR as JaxPoR
from crypto3_fil_proofs_tpu.core.por import PoRPrivateInputs as JaxPriv
from crypto3_fil_proofs_tpu.core.por import PoRPublicInputs as JaxPub
from crypto3_fil_proofs_tpu.core.por import PoRSetupParams as JaxSetup
from crypto3_fil_proofs_tpu.types import PieceInfo as JaxPieceInfo
from crypto3_fil_proofs_torch import constants
from crypto3_fil_proofs_torch.api import pieces
from crypto3_fil_proofs_torch.api import seal as api_seal
from crypto3_fil_proofs_torch.api.commitment_reader import CommitmentReader
from crypto3_fil_proofs_torch.api.fr32_reader import Fr32Reader
from crypto3_fil_proofs_torch.core import settings as port_settings
from crypto3_fil_proofs_torch.core.fr32 import write_padded
from crypto3_fil_proofs_torch.core.merkle import MerkleTree
from crypto3_fil_proofs_torch.core.por import PoR, PoRPrivateInputs, PoRPublicInputs, PoRSetupParams
from crypto3_fil_proofs_torch.ops.poseidon import hash2
from crypto3_fil_proofs_torch.types import PieceInfo, PoRepConfig
from test_torch_setup import shared_reference
from test_torch_unseal import _jax_reference as unseal_reference


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


# the reference's tables (libs/filecoin/test/pieces.cpp:97-135)
ALIGNMENT_TABLE = [
    (0, 0, (0, 127)), (0, 127, (0, 0)), (0, 254, (0, 0)), (0, 508, (0, 0)), (0, 1016, (0, 0)),
    (127, 127, (0, 0)), (127, 254, (127, 0)), (127, 508, (381, 0)), (100, 100, (27, 27)),
    (200, 200, (54, 54)), (300, 300, (208, 208)),
]


def test_piece_alignment_equals_reference_and_jax():
    for written, piece, want in ALIGNMENT_TABLE:
        al = pieces.get_piece_alignment(written, piece)
        assert (al.left_bytes, al.right_bytes) == want
    assert [pieces.get_piece_start_byte([31, 32, 33][:i], p) for i, p in enumerate([31, 32, 33])] == [0, 127, 254]
    rng = random.Random(4)
    for _ in range(200):
        existing = [rng.choice([127, 254, 508, 1016, 2032]) - rng.randrange(3) for _ in range(rng.randrange(6))]
        piece = rng.randrange(1, 4000)
        assert pieces.sum_piece_bytes_with_alignment(existing) == jax_pieces.sum_piece_bytes_with_alignment(existing)
        assert pieces.get_piece_start_byte(existing, piece) == jax_pieces.get_piece_start_byte(existing, piece)


def _piece_infos(sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for size in sizes:
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        out.append(pieces.generate_piece_commitment(data))
    return out


@pytest.mark.parametrize("sector_size,sizes", [(2048, [127, 254, 1016]), (2048, [508]), (4096, [127, 1016, 2032])])
def test_compute_comm_d_equals_jax(sector_size, sizes):
    infos = _piece_infos(sizes, sector_size + len(sizes))
    got = api_seal.compute_comm_d(sector_size, [PieceInfo(p.commitment, p.size) for p in infos])
    want = jax_seal.compute_comm_d(sector_size, [JaxPieceInfo(p.commitment, p.size) for p in infos])
    assert got == want and len(got) == 32


def test_commitment_reader_equals_piece_commitment():
    rng = np.random.default_rng(11)
    for nodes in (127 * 2, 127 * 4, 127 * 16):
        raw = rng.integers(0, 256, nodes, dtype=np.uint8).tobytes()
        padded = write_padded(raw)
        mine, theirs = CommitmentReader(), JaxCommitmentReader()
        for i in range(0, len(padded), 100):  # uneven chunks
            mine.consume(padded[i : i + 100])
            theirs.consume(padded[i : i + 100])
        assert mine.bytes_consumed == len(padded)
        assert mine.finish() == theirs.finish() == pieces.generate_piece_commitment(raw).commitment
    partial = CommitmentReader()
    partial.consume(bytes(96))
    with pytest.raises(ValueError):
        partial.finish()


def test_fr32_reader_equals_write_padded():
    rng = np.random.default_rng(12)
    for size in (0, 1, 126, 127, 128, 1000, 2032, 127 * 600 + 5):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        want = write_padded(data)
        assert Fr32Reader(data).read() == want == JaxFr32Reader(data).read()
        r, got = Fr32Reader(data), b""
        while chunk := r.read(100):
            got += chunk
        assert got == want


def test_fauxrep_layout(tmp_path):
    config = PoRepConfig.for_sector_size(2048)
    cache, out = str(tmp_path / "cache"), str(tmp_path / "replica")
    comm_r = api_seal.fauxrep(config, cache, out)
    with open(os.path.join(cache, "p_aux"), "rb") as f:
        p_aux = f.read()
    assert len(p_aux) == 64 and len(comm_r) == 32
    c, r_last = (int.from_bytes(p_aux[i : i + 32], "little") for i in (0, 32))
    assert comm_r == hash2(c, r_last).to_bytes(32, "little")
    from crypto3_fil_proofs_tpu.ops.poseidon import hash2 as jax_hash2

    assert comm_r == jax_hash2(c, r_last).to_bytes(32, "little")
    assert open(out, "rb").read() == bytes(2048)


def test_clear_cache_on_2k_cache_equals_jax(tmp_path, tmp_path_factory):
    """clear_cache of either package, on copies of one 2 KiB sealed cache
    (tests/test_torch_unseal.py's, made once a run), keeps the same
    files: p_aux, t_aux and tree_r_last."""
    run = shared_reference(tmp_path_factory, "jax_unseal_2k", unseal_reference)
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    shutil.copytree(run["cache"], mine)
    shutil.copytree(run["cache"], theirs)
    api_seal.clear_cache(mine)
    jax_seal.clear_cache(theirs)
    kept = sorted(os.listdir(mine))
    assert kept == sorted(os.listdir(theirs)) and len(kept) < len(os.listdir(run["cache"]))
    assert "p_aux" in kept and "t_aux" in kept and any("tree-r-last" in n for n in kept)
    assert not any("layer-" in n or "tree-c" in n or "tree-d" in n for n in kept)


@pytest.mark.parametrize("backend,arity", [("poseidon", 8), ("sha256", 2)])
def test_por_equals_jax(backend, arity):
    leaves = np.random.default_rng(arity).integers(0, 64, size=(arity**2, 32), dtype=np.uint8)
    tree, jax_tree = MerkleTree.build(leaves, arity, backend), JaxMerkleTree.build(leaves, arity, backend)
    assert tree.root() == jax_tree.root()
    pp = PoR.setup(PoRSetupParams(leaves=arity**2))
    jax_pp = JaxPoR.setup(JaxSetup(leaves=arity**2))
    for challenge in (5, arity**2 + 3):  # the second reduced mod the leaf count
        pub = PoRPublicInputs(challenge=challenge, commitment=tree.root())
        proof = PoR.prove(pp, pub, PoRPrivateInputs(leaf=tree.leaf(challenge % arity**2), tree=tree))
        jax_proof = JaxPoR.prove(jax_pp, JaxPub(challenge=challenge, commitment=tree.root()),
                                 JaxPriv(leaf=jax_tree.leaf(challenge % arity**2), tree=jax_tree))
        assert proof.data == jax_proof.data and proof.proof.root == jax_proof.proof.root
        assert [(lvl.siblings, lvl.index) for lvl in proof.proof.path] == [
            (lvl.siblings, lvl.index) for lvl in jax_proof.proof.path]
        assert PoR.verify(pp, pub, proof)
        assert not PoR.verify(pp, PoRPublicInputs(challenge=challenge, commitment=bytes(32)), proof)
        assert not PoR.verify(pp, PoRPublicInputs(challenge=challenge + 1, commitment=tree.root()), proof)


def test_sector_shape_predicates_equal_jax():
    assert constants.SUPPORTED_SECTOR_SIZES == jax_constants.SUPPORTED_SECTOR_SIZES
    for size in constants.SUPPORTED_SECTOR_SIZES:
        for name in ("sector_shape", "is_sector_shape_base", "is_sector_shape_sub2", "is_sector_shape_sub8",
                     "is_sector_shape_top2"):
            assert getattr(constants, name)(size) == getattr(jax_constants, name)(size), (name, size)
    assert [constants.is_sector_shape_top2(s) for s in (2048, 32 << 10, 64 << 30)] == [False, True, True]


def test_config_ini_seeds_unset_variables(tmp_path, monkeypatch):
    """FIL_PROOFS_CONFIG names the file; its keys fill the FIL_PROOFS_*
    variables the environment leaves unset, and never override one it
    sets (as the JAX package's settings do)."""
    from crypto3_fil_proofs_tpu.core import settings as jax_settings

    ini = tmp_path / "config.ini"
    ini.write_text("[proofs]\nrows_to_discard = 3\nparameter_cache = /from/ini\nparent_cache = /from/ini2\n")
    monkeypatch.setenv("FIL_PROOFS_CONFIG", str(ini))
    for name in ("FIL_PROOFS_ROWS_TO_DISCARD", "FIL_PROOFS_PARAMETER_CACHE"):
        # set, then unset, so that monkeypatch restores the value from
        # before the test, not the one the ini seeds into the environment
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    monkeypatch.setenv("FIL_PROOFS_PARENT_CACHE", "/from/env")
    s = port_settings.settings()
    assert (s.rows_to_discard, s.parameter_cache, s.parent_cache) == (3, "/from/ini", "/from/env")
    jax_settings.reset_settings()
    j = jax_settings.settings()
    assert (j.rows_to_discard, j.parameter_cache, j.parent_cache) == (3, "/from/ini", "/from/env")
    jax_settings.reset_settings()
    monkeypatch.setenv("FIL_PROOFS_CONFIG", str(tmp_path / "absent.ini"))
    monkeypatch.delenv("FIL_PROOFS_ROWS_TO_DISCARD")
    assert port_settings.settings().rows_to_discard == 2
