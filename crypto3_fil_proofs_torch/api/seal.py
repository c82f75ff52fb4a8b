"""Sealing API: pre-commit (PC1, PC2), commit (C1, C2) and verification.

Counterpart of crypto3_fil_proofs_tpu/api/seal.py (reference libs/filecoin
api/seal.hpp:37-440):
- seal_pre_commit_phase1 (:37-112): copy+pad data, tree_d/comm_d,
  verify_pieces, replica_id, SDR labeling persisted per layer. Host work.
- seal_pre_commit_phase2 (:114-177): tree_c over the column hashes,
  encode + tree_r_last, comm_r = H2(comm_c, comm_r_last); persist
  p_aux/t_aux. The Poseidon work runs on `device`.
- seal_commit_phase1 (:179-258): reload the stored trees (a missing
  store file raises), vanilla `prove_all_partitions` and its check.
  Host work.
- seal_commit_phase2 (:260-337): the stacked circuit per partition and
  its Groth16 proof on `device` (setup there too where the parameter
  cache has no key), 192 B per partition, checked by verify_seal.
- verify_seal / verify_batch_seal (:339-440): public inputs and the
  pairing, on the host.
- compute_comm_d, fauxrep (:487-520) and clear_cache: host work, as in
  the JAX package (fauxrep hashes its one pair on the host Poseidon).

The pre-commit and C2 entry points take the JAX package's arguments plus
`device` ("cuda" by default; "cpu" runs the kernels' plain versions).
The cache files are the JAX package's: the layer files, tree-d, tree-c,
tree-r-last, p_aux (raw 64-byte comm_c||comm_r_last) and t_aux, so
either package's commit phases resume from either's pre-commit.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..constants import NODE_SIZE, SECTOR_SHAPES
from ..core import cache_key
from ..core.measure import measure_op
from ..core.merkle import (
    CompoundMerkleTree,
    DiskStore,
    MerkleTree,
    StoreConfig,
    get_base_tree_count,
    split_config,
)
from ..models.porep.stacked.vanilla.cache import ParentCache
from ..models.porep.stacked.vanilla.params import (
    Labels,
    PersistentAux,
    PrivateInputs,
    PublicInputs,
    Tau,
    TemporaryAux,
    generate_replica_id,
)
from ..models.porep.stacked.vanilla.proof import StackedDrg
from ..ops.poseidon import hash2
from ..parameters import public_params
from ..types import (
    PieceInfo,
    PoRepConfig,
    SealCommitOutput,
    SealCommitPhase1Output,
    SealPreCommitOutput,
    SealPreCommitPhase1Output,
)
from . import pieces as piece_api


def check_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present if asked
    for (there is no quiet fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_comm_d(sector_size: int, piece_infos: list[PieceInfo]) -> bytes:
    """(reference src/api/seal.cpp compute_comm_d)"""
    infos = [piece_api.PieceInfo(p.commitment, p.size) for p in piece_infos]
    return piece_api.compute_comm_d(sector_size, infos)


def _layer_path(cache_path: str, layer: int) -> str:
    return os.path.join(cache_path, f"sc-02-data-{cache_key.label_layer(layer)}.dat")


def _paux_path(cache_path: str) -> str:
    return os.path.join(cache_path, cache_key.PAUX)


def _taux_path(cache_path: str) -> str:
    return os.path.join(cache_path, cache_key.TAUX)


def _load_labels(labels_config: dict, nodes: int) -> Labels:
    return Labels(
        [
            np.memmap(p, dtype=np.uint8, mode="r", shape=(nodes, NODE_SIZE))
            for p in labels_config["paths"]
        ]
    )


def seal_pre_commit_phase1(
    config: PoRepConfig,
    cache_path: str,
    in_path: str,
    out_path: str,
    prover_id: bytes,
    sector_id: int,
    ticket: bytes,
    piece_infos: list[PieceInfo],
    device="cuda",
) -> SealPreCommitPhase1Output:
    """PC1 runs on the host; `device` is checked here, so a caller
    without the device it will ask PC2 for learns it before labeling."""
    check_device(device)
    pp = public_params(config)
    nodes = config.sector_size // NODE_SIZE
    os.makedirs(cache_path, exist_ok=True)

    # stream-copy the (already fr32-preprocessed) staged data and
    # zero-pad to the sector size (reference seal.hpp:55-64); the leaves
    # view is a read-only memmap of out_path
    with open(in_path, "rb") as src, open(out_path, "wb") as dst:
        shutil.copyfileobj(src, dst, 1 << 24)
        if dst.tell() > config.sector_size:
            raise ValueError("staged data exceeds the sector")
        dst.truncate(config.sector_size)  # zero tail
    leaves = np.memmap(out_path, dtype=np.uint8, mode="r", shape=(nodes, NODE_SIZE))

    # tree_d (binary SHA-256) persisted in the cache dir
    tree_d_config = StoreConfig(cache_path, cache_key.COMM_D_TREE)
    with measure_op("comm_d"):
        tree_d = MerkleTree.build(leaves, 2, "sha256", tree_d_config)
    comm_d = tree_d.root()

    if not piece_api.verify_pieces(
        comm_d,
        [piece_api.PieceInfo(p.commitment, p.size) for p in piece_infos],
        config.sector_size,
    ):
        raise ValueError("pieces and comm_d do not match")

    replica_id = generate_replica_id(prover_id, sector_id, ticket, comm_d, config.porep_id)

    # SDR labeling: 2-layer ping-pong working set, each layer persisted
    # to its file as it finishes (reference proof.hpp:311-313, 339-354)
    layer_paths = [_layer_path(cache_path, l) for l in range(1, pp.layers + 1)]
    with measure_op("generate_labels"):
        StackedDrg.generate_labels_streamed(
            pp.graph,
            pp.layers,
            replica_id,
            layer_paths,
            # disk-backed parent table, generated once per graph identity
            # and mmapped on reuse (reference cache.hpp:52-252)
            parent_cache=ParentCache(pp.graph),
        )

    return SealPreCommitPhase1Output(
        labels_config={"layers": pp.layers, "paths": layer_paths},
        config={"path": cache_path, "id": cache_key.COMM_D_TREE},
        comm_d=comm_d,
    )


def seal_pre_commit_phase2(
    config: PoRepConfig,
    phase1_output: SealPreCommitPhase1Output,
    cache_path: str,
    replica_path: str,
    device="cuda",
) -> SealPreCommitOutput:
    device = check_device(device)
    nodes = config.sector_size // NODE_SIZE
    shape = SECTOR_SHAPES[config.sector_size]
    labels = _load_labels(phase1_output.labels_config, nodes)
    count = get_base_tree_count(shape[1], shape[2])

    # tree_c from the layer files; the replica (data + key layer) in
    # place on the padded data that phase 1 left in replica_path;
    # tree_r_last; comm_r
    data = np.memmap(replica_path, dtype=np.uint8, mode="r+", shape=(nodes, NODE_SIZE))
    tree_c, tree_r_last, comm_r = StackedDrg.encode_and_build(
        labels,
        data,
        data,
        shape,
        split_config(StoreConfig(cache_path, cache_key.COMM_C_TREE), count),
        split_config(StoreConfig(cache_path, cache_key.COMM_R_LAST_TREE), count),
        device,
    )
    comm_c, comm_r_last = tree_c.root(), tree_r_last.root()

    # checkpoint p_aux (raw 64 B, reference layout) + t_aux (json)
    with open(_paux_path(cache_path), "wb") as f:
        f.write(comm_c + comm_r_last)
    with open(_taux_path(cache_path), "w") as f:
        json.dump(
            {
                "labels": phase1_output.labels_config,
                "tree_d": {"path": cache_path, "id": cache_key.COMM_D_TREE},
                "tree_c": {"path": cache_path, "id": cache_key.COMM_C_TREE},
                "tree_r_last": {"path": cache_path, "id": cache_key.COMM_R_LAST_TREE},
                "shape": list(shape),
            },
            f,
        )
    return SealPreCommitOutput(comm_r=comm_r, comm_d=phase1_output.comm_d)


def _reload_tree(cache_path: str, tree_id: str, leafs: int, arity: int, sub: int, top: int, backend: str):
    """A stored tree, reopened; a missing store file raises."""
    count = get_base_tree_count(sub, top)
    cfgs = split_config(StoreConfig(cache_path, tree_id), count)
    leafs_per = leafs // count
    trees = [MerkleTree.from_store(DiskStore(cfg, create=False), leafs_per, arity, backend) for cfg in cfgs]
    if count == 1:
        return trees[0]
    return CompoundMerkleTree(trees, sub, top)


def seal_commit_phase1(
    config: PoRepConfig,
    cache_path: str,
    replica_path: str,
    prover_id: bytes,
    sector_id: int,
    ticket: bytes,
    seed: bytes,
    pre_commit: SealPreCommitOutput,
    piece_infos: list[PieceInfo],
) -> SealCommitPhase1Output:
    """C1: the vanilla proofs of every partition, from the stored trees
    and labels, checked before they are returned. Host work."""
    pp = public_params(config)
    nodes = config.sector_size // NODE_SIZE
    shape = SECTOR_SHAPES[config.sector_size]

    with open(_paux_path(cache_path), "rb") as f:
        raw = f.read()
    p_aux = PersistentAux(comm_c=raw[:32], comm_r_last=raw[32:64])
    with open(_taux_path(cache_path)) as f:
        taux = json.load(f)

    labels = _load_labels(taux["labels"], nodes)
    tree_d = _reload_tree(cache_path, cache_key.COMM_D_TREE, nodes, 2, 0, 0, "sha256")
    tree_c = _reload_tree(cache_path, cache_key.COMM_C_TREE, nodes, *shape, "poseidon")
    tree_r_last = _reload_tree(cache_path, cache_key.COMM_R_LAST_TREE, nodes, *shape, "poseidon")
    t_aux = TemporaryAux(labels=labels, tree_d=tree_d, tree_c=tree_c, tree_r_last=tree_r_last)

    replica_id = generate_replica_id(prover_id, sector_id, ticket, pre_commit.comm_d, config.porep_id)
    pub_inputs = PublicInputs(
        replica_id=replica_id,
        seed=seed,
        tau=Tau(comm_d=pre_commit.comm_d, comm_r=pre_commit.comm_r),
        k=None,
    )
    priv_inputs = PrivateInputs(p_aux=p_aux, t_aux=t_aux)
    vanilla_proofs = StackedDrg.prove_all_partitions(pp, pub_inputs, priv_inputs, config.partitions)
    if not StackedDrg.verify_all_partitions(pp, pub_inputs, vanilla_proofs):
        raise AssertionError("generated vanilla proofs do not verify")
    return SealCommitPhase1Output(
        vanilla_proofs=vanilla_proofs,
        comm_r=pre_commit.comm_r,
        comm_d=pre_commit.comm_d,
        replica_id=replica_id,
        seed=seed,
        ticket=ticket,
    )


def _stacked_compound(config: PoRepConfig):
    from ..core.compound import CompoundProof
    from ..models.porep.stacked.circuit.compound import StackedCompound

    return CompoundProof(StackedCompound(shape=SECTOR_SHAPES[config.sector_size]))


def seal_commit_phase2(
    config: PoRepConfig,
    phase1_output: SealCommitPhase1Output,
    prover_id: bytes,
    sector_id: int,
    device="cuda",
) -> SealCommitOutput:
    """C2: the Groth16 proof of every partition's circuit on `device`,
    checked by verify_seal before it is returned."""
    from ..caches import get_stacked_params

    device = check_device(device)
    pp = public_params(config)
    compound = _stacked_compound(config)
    pk = get_stacked_params(config, pp, compound, device)
    pub_inputs = PublicInputs(
        replica_id=phase1_output.replica_id,
        seed=phase1_output.seed,
        tau=Tau(comm_d=phase1_output.comm_d, comm_r=phase1_output.comm_r),
        k=None,
    )
    multi = compound.prove(pp, pub_inputs, phase1_output.vanilla_proofs, pk, device=device)
    proof_bytes = multi.to_bytes()
    if not verify_seal(
        config,
        phase1_output.comm_r,
        phase1_output.comm_d,
        prover_id,
        sector_id,
        phase1_output.ticket,
        phase1_output.seed,
        proof_bytes,
    ):
        raise AssertionError("post-commit verification failed")
    return SealCommitOutput(proof=proof_bytes)


def verify_seal(
    config: PoRepConfig,
    comm_r: bytes,
    comm_d: bytes,
    prover_id: bytes,
    sector_id: int,
    ticket: bytes,
    seed: bytes,
    proof_bytes: bytes,
) -> bool:
    """(reference api/seal.hpp:339-395) Host work: the verifying key
    comes from the parameter cache."""
    from ..caches import get_stacked_verifying_key
    from ..core.compound import MultiProof
    from .utilities import as_safe_commitment

    try:
        as_safe_commitment(comm_r)
        as_safe_commitment(comm_d)
    except ValueError:
        return False
    if int.from_bytes(comm_r, "little") == 0 or int.from_bytes(comm_d, "little") == 0:
        return False  # "Invalid all zero commitment"

    pp = public_params(config)
    compound = _stacked_compound(config)
    vk = get_stacked_verifying_key(config, pp, compound)
    replica_id = generate_replica_id(prover_id, sector_id, ticket, comm_d, config.porep_id)
    pub_inputs = PublicInputs(
        replica_id=replica_id,
        seed=seed,
        tau=Tau(comm_d=comm_d, comm_r=comm_r),
        k=None,
    )
    try:
        multi = MultiProof.from_bytes(proof_bytes, config.partitions)
    except (AssertionError, ValueError):
        return False
    return compound.verify(pp, pub_inputs, multi, vk)


def verify_batch_seal(config: PoRepConfig, batch: list[dict]) -> bool:
    """(reference api/seal.hpp verify_batch_seal — all-or-nothing)"""
    return all(verify_seal(config, **item) for item in batch)


def fauxrep(config: PoRepConfig, cache_path: str, out_path: str) -> bytes:
    """Fake replication for chain-sync testing: random comm_c and
    comm_r_last in p_aux, comm_r = Poseidon-2 of them, a zero replica
    (reference api/seal.hpp:487-520)."""
    import secrets

    from ..ops.bls12_381 import R

    os.makedirs(cache_path, exist_ok=True)
    comm_c = secrets.randbelow(R).to_bytes(32, "little")
    comm_r_last = secrets.randbelow(R).to_bytes(32, "little")
    comm_r = hash2(int.from_bytes(comm_c, "little"), int.from_bytes(comm_r_last, "little")).to_bytes(32, "little")
    with open(_paux_path(cache_path), "wb") as f:
        f.write(comm_c + comm_r_last)
    with open(out_path, "wb") as f:
        f.write(b"\0" * config.sector_size)
    return comm_r


def clear_cache(cache_path: str) -> None:
    """Drop what PoSt does not need (reference api/post.hpp:151-173
    clear_cache + TemporaryAux::clear_temp params.hpp:201-258): layer
    files, tree_c and tree_d; keep p_aux/t_aux and tree_r_last."""
    for name in os.listdir(cache_path):
        if name.startswith("sc-02-data-layer-") or cache_key.COMM_C_TREE in name or (
            cache_key.COMM_D_TREE in name and cache_key.COMM_R_LAST_TREE not in name
        ):
            os.remove(os.path.join(cache_path, name))
