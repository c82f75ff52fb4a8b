"""Registered network constants and sector-shape tables.

Copied from crypto3_fil_proofs_tpu/constants.py, the PoRep and PoSt
parts of reference libs/filecoin/include/nil/filecoin/proofs/
constants.hpp: sector sizes (:43-52), PoRep challenge/partition/layer
tables (:65-78), the Winning / Window PoSt counts (:80-90), graph
degrees and sector tree shapes (:116-125) with their predicates.
"""
from __future__ import annotations

KIB = 1024
MIB = 1024 * KIB
GIB = 1024 * MIB

SECTOR_SIZE_2_KIB = 2 * KIB
SECTOR_SIZE_4_KIB = 4 * KIB
SECTOR_SIZE_16_KIB = 16 * KIB
SECTOR_SIZE_32_KIB = 32 * KIB
SECTOR_SIZE_8_MIB = 8 * MIB
SECTOR_SIZE_16_MIB = 16 * MIB
SECTOR_SIZE_512_MIB = 512 * MIB
SECTOR_SIZE_1_GIB = 1 * GIB
SECTOR_SIZE_32_GIB = 32 * GIB
SECTOR_SIZE_64_GIB = 64 * GIB

SUPPORTED_SECTOR_SIZES = [
    SECTOR_SIZE_2_KIB,
    SECTOR_SIZE_4_KIB,
    SECTOR_SIZE_16_KIB,
    SECTOR_SIZE_32_KIB,
    SECTOR_SIZE_8_MIB,
    SECTOR_SIZE_16_MIB,
    SECTOR_SIZE_512_MIB,
    SECTOR_SIZE_1_GIB,
    SECTOR_SIZE_32_GIB,
    SECTOR_SIZE_64_GIB,
]

WINNING_POST_CHALLENGE_COUNT = 66
WINNING_POST_SECTOR_COUNT = 1
WINDOW_POST_CHALLENGE_COUNT = 10

# minimum PoRep challenge totals per sector size (constants.hpp:65-68)
POREP_MINIMUM_CHALLENGES = {
    SECTOR_SIZE_2_KIB: 2,
    SECTOR_SIZE_4_KIB: 2,
    SECTOR_SIZE_16_KIB: 2,
    SECTOR_SIZE_32_KIB: 2,
    SECTOR_SIZE_8_MIB: 2,
    SECTOR_SIZE_16_MIB: 2,
    SECTOR_SIZE_512_MIB: 2,
    SECTOR_SIZE_1_GIB: 2,
    SECTOR_SIZE_32_GIB: 176,
    SECTOR_SIZE_64_GIB: 176,
}

# SNARK partitions per seal (constants.hpp:70-73)
POREP_PARTITIONS = {
    SECTOR_SIZE_2_KIB: 1,
    SECTOR_SIZE_4_KIB: 1,
    SECTOR_SIZE_16_KIB: 1,
    SECTOR_SIZE_32_KIB: 1,
    SECTOR_SIZE_8_MIB: 1,
    SECTOR_SIZE_16_MIB: 1,
    SECTOR_SIZE_512_MIB: 1,
    SECTOR_SIZE_1_GIB: 1,
    SECTOR_SIZE_32_GIB: 10,
    SECTOR_SIZE_64_GIB: 10,
}

# SDR layer counts (constants.hpp:75-78)
LAYERS = {
    SECTOR_SIZE_2_KIB: 2,
    SECTOR_SIZE_4_KIB: 2,
    SECTOR_SIZE_16_KIB: 2,
    SECTOR_SIZE_32_KIB: 2,
    SECTOR_SIZE_8_MIB: 2,
    SECTOR_SIZE_16_MIB: 2,
    SECTOR_SIZE_512_MIB: 2,
    SECTOR_SIZE_1_GIB: 2,
    SECTOR_SIZE_32_GIB: 11,
    SECTOR_SIZE_64_GIB: 11,
}

# window PoSt sectors per partition (constants.hpp:85-90; the comments
# there record circuit sizes 125,279,217 / 129,887,900 constraints)
WINDOW_POST_SECTOR_COUNT = {
    SECTOR_SIZE_2_KIB: 2,
    SECTOR_SIZE_4_KIB: 2,
    SECTOR_SIZE_16_KIB: 2,
    SECTOR_SIZE_32_KIB: 2,
    SECTOR_SIZE_8_MIB: 2,
    SECTOR_SIZE_16_MIB: 2,
    SECTOR_SIZE_512_MIB: 2,
    SECTOR_SIZE_1_GIB: 2,
    SECTOR_SIZE_32_GIB: 2349,
    SECTOR_SIZE_64_GIB: 2300,
}

NODE_SIZE = 32

DRG_DEGREE = 6
EXP_DEGREE = 8

# sector tree shapes (base, sub, top arity) — constants.hpp:116-125
SECTOR_SHAPES = {
    SECTOR_SIZE_2_KIB: (8, 0, 0),
    SECTOR_SIZE_4_KIB: (8, 2, 0),
    SECTOR_SIZE_16_KIB: (8, 8, 0),
    SECTOR_SIZE_32_KIB: (8, 8, 2),
    SECTOR_SIZE_8_MIB: (8, 0, 0),
    SECTOR_SIZE_16_MIB: (8, 2, 0),
    SECTOR_SIZE_512_MIB: (8, 0, 0),
    SECTOR_SIZE_1_GIB: (8, 2, 0),
    SECTOR_SIZE_32_GIB: (8, 8, 0),
    SECTOR_SIZE_64_GIB: (8, 8, 2),
}


def sector_shape(sector_size: int) -> tuple[int, int, int]:
    return SECTOR_SHAPES[sector_size]


def is_sector_shape_base(sector_size: int) -> bool:
    return SECTOR_SHAPES[sector_size][1] == 0


def is_sector_shape_sub2(sector_size: int) -> bool:
    return SECTOR_SHAPES[sector_size][1] == 2 and SECTOR_SHAPES[sector_size][2] == 0


def is_sector_shape_sub8(sector_size: int) -> bool:
    return SECTOR_SHAPES[sector_size][1] == 8 and SECTOR_SHAPES[sector_size][2] == 0


def is_sector_shape_top2(sector_size: int) -> bool:
    return SECTOR_SHAPES[sector_size][2] == 2
