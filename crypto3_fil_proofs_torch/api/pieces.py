"""Piece pipeline: piece commitments and comm_d aggregation.

Copied from crypto3_fil_proofs_tpu/api/pieces.py: reference
libs/filecoin/.../pieces.hpp:40-136 + src/pieces.cpp (compute_comm_d /
verify_pieces / zero padding / alignment math).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from crypto3_fil_proofs_torch.core.fr32 import to_padded_bytes, to_unpadded_bytes, write_padded
from crypto3_fil_proofs_torch.core.merkle import MerkleTree

MIN_PIECE_SIZE = 127  # unpadded bytes (reference constants.hpp:102)
NODE_SIZE = 32


@dataclass(frozen=True)
class PieceInfo:
    """(commitment, unpadded size) — reference types/piece_info.hpp:32-46."""

    commitment: bytes
    size: int  # unpadded bytes


def piece_hash(a: bytes, b: bytes) -> bytes:
    """Binary SHA-256 node hash with Fr trim (DefaultPieceHasher)."""
    d = bytearray(hashlib.sha256(a + b).digest())
    d[31] &= 0x3F
    return bytes(d)


def generate_piece_commitment(data: bytes, piece_size: int | None = None) -> PieceInfo:
    """comm_p: binary SHA-256 tree root over the fr32-padded piece
    (reference: core/pieces.hpp generate_piece_commitment_bytes_from_source,
    api/mod.hpp generate_piece_commitment)."""
    if piece_size is None:
        piece_size = len(data)
    if piece_size < MIN_PIECE_SIZE:
        raise ValueError(f"piece must be >= {MIN_PIECE_SIZE} bytes")
    if piece_size % 127 != 0:
        raise ValueError("piece size must be a multiple of 127 unpadded bytes")
    padded_size = to_padded_bytes(piece_size)
    if padded_size & (padded_size - 1):
        raise ValueError("padded piece size must be a power of two")
    padded = write_padded(data[:piece_size])
    leaves = np.frombuffer(padded, dtype=np.uint8).reshape(-1, NODE_SIZE)
    if leaves.shape[0] * NODE_SIZE < padded_size:
        full = np.zeros((padded_size // NODE_SIZE, NODE_SIZE), dtype=np.uint8)
        full[: leaves.shape[0]] = leaves
        leaves = full
    tree = MerkleTree.build(leaves, 2, "sha256")
    return PieceInfo(commitment=tree.root(), size=piece_size)


@lru_cache(maxsize=None)
def zero_padding(size: int) -> PieceInfo:
    """Commitment of an all-zero piece of `size` unpadded bytes
    (reference: src/pieces.cpp zero_padding)."""
    padded = to_padded_bytes(size)
    commitment = bytes(NODE_SIZE)
    hashed = 64
    commitment = piece_hash(commitment, commitment)
    while hashed < padded:
        commitment = piece_hash(commitment, commitment)
        hashed *= 2
    return PieceInfo(commitment=commitment, size=size)


@lru_cache(maxsize=None)
def empty_comm_d(sector_size: int) -> bytes:
    """comm_d of an empty sector (memoized per size,
    reference: pieces.hpp empty_comm_d)."""
    return zero_padding(to_unpadded_bytes(sector_size)).commitment


def _join(a: PieceInfo, b: PieceInfo) -> PieceInfo:
    assert a.size == b.size, "cannot join pieces of different sizes"
    return PieceInfo(piece_hash(a.commitment, b.commitment), a.size + b.size)


def compute_comm_d(sector_size: int, piece_infos: list[PieceInfo]) -> bytes:
    """Aggregate piece commitments into comm_d with zero-piece alignment
    (reference: pieces.hpp compute_comm_d / src/pieces.cpp)."""
    if not piece_infos:
        return empty_comm_d(sector_size)
    unpadded = to_unpadded_bytes(sector_size)
    total = sum(p.size for p in piece_infos)
    if total > unpadded:
        raise ValueError("pieces exceed sector capacity")
    stack: list[PieceInfo] = []

    def reduce_():
        while len(stack) > 1 and stack[-1].size == stack[-2].size:
            b, a = stack.pop(), stack.pop()
            stack.append(_join(a, b))

    def shift_reduce(p: PieceInfo):
        stack.append(p)
        reduce_()

    first = piece_infos[0]
    fp = to_padded_bytes(first.size)
    if fp & (fp - 1):
        raise ValueError("first piece's padded size must be a power of two")
    stack.append(first)
    for piece in piece_infos[1:]:
        while stack[-1].size < piece.size:
            shift_reduce(zero_padding(stack[-1].size))
        shift_reduce(piece)
    # pad with zero pieces until one entry spans the whole sector, so
    # comm_d always equals the tree_d root of the zero-filled sector
    while len(stack) > 1 or stack[-1].size < unpadded:
        shift_reduce(zero_padding(stack[-1].size))
    out = stack.pop()
    if out.size != unpadded:
        raise ValueError(
            f"pieces and padding do not fill the sector: {out.size} != {unpadded}"
        )
    return out.commitment


def verify_pieces(comm_d: bytes, piece_infos: list[PieceInfo], sector_size: int) -> bool:
    """reference: src/pieces.cpp:20-24."""
    return compute_comm_d(sector_size, piece_infos) == comm_d


# -- alignment math (reference: pieces.hpp get_piece_alignment etc.) --------


@dataclass
class PieceAlignment:
    left_bytes: int
    right_bytes: int


def get_piece_alignment(written_bytes: int, piece_bytes: int) -> PieceAlignment:
    """Zero-padding needed before/after a piece so it lands on a
    power-of-two boundary of its own size."""
    piece_bytes_needed = MIN_PIECE_SIZE
    while piece_bytes_needed < piece_bytes:
        piece_bytes_needed *= 2
    encroaching = written_bytes % piece_bytes_needed
    left_bytes = piece_bytes_needed - encroaching if encroaching else 0
    right_bytes = piece_bytes_needed - piece_bytes
    return PieceAlignment(left_bytes, right_bytes)


def sum_piece_bytes_with_alignment(pieces: list[int]) -> int:
    total = 0
    for p in pieces:
        a = get_piece_alignment(total, p)
        total += a.left_bytes + p + a.right_bytes
    return total


def get_piece_start_byte(existing_pieces: list[int], piece_bytes: int) -> int:
    written = sum_piece_bytes_with_alignment(existing_pieces)
    return written + get_piece_alignment(written, piece_bytes).left_bytes
