"""API types: the PoRep config, piece info and the seal phases' outputs.

Copied from crypto3_fil_proofs_tpu/types.py (reference libs/filecoin
types/mod.hpp:42-78, porep_config.hpp, piece_info.hpp), cut to what
sealing needs.
"""
from __future__ import annotations

from dataclasses import dataclass

from .constants import LAYERS, POREP_PARTITIONS

# 32-byte aliases (reference types/mod.hpp:42-46)
Commitment = bytes
Ticket = bytes


@dataclass
class PoRepConfig:
    """(reference types/porep_config.hpp:34-70)"""

    sector_size: int
    partitions: int
    porep_id: bytes

    @classmethod
    def for_sector_size(cls, sector_size: int, porep_id: bytes = bytes(32)):
        return cls(sector_size, POREP_PARTITIONS[sector_size], porep_id)

    @property
    def layers(self) -> int:
        return LAYERS[self.sector_size]


@dataclass
class SealPreCommitPhase1Output:
    labels_config: dict
    config: dict  # tree_d store config
    comm_d: Commitment


@dataclass
class SealPreCommitOutput:
    comm_r: Commitment
    comm_d: Commitment


@dataclass
class SealCommitPhase1Output:
    vanilla_proofs: list
    comm_r: Commitment
    comm_d: Commitment
    replica_id: bytes
    seed: Ticket
    ticket: Ticket


@dataclass
class SealCommitOutput:
    proof: bytes


@dataclass
class PieceInfo:
    commitment: Commitment
    size: int  # unpadded bytes
