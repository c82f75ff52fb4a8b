"""Insert-into-position gadget for arity>2 Merkle paths.

Fills the reference's empty `core/components/insertion.hpp` stub
(SURVEY.md §2.1: "insert-into-sorted-list for arity>2 paths" per
rust-fil-proofs insertion.rs): given `element`, the level's position
bits and the arity-1 siblings, produce the arity-wide child array with
`element` at the position.

Copied from crypto3_fil_proofs_tpu/zk/gadgets/insertion.py with its imports rewritten.
"""
from __future__ import annotations

from ..r1cs import ConstraintSystem, LinearCombination, lc_one
from .boolean import AllocatedBit, Boolean
from .num import AllocatedNum, pick


def position_equals(cs, index_bits: list[Boolean], k: int, n_bits: int) -> Boolean:
    """Boolean (index == k) from LE position bits (AND-fold)."""
    acc = None
    for b in range(n_bits):
        lit = index_bits[b] if (k >> b) & 1 else index_bits[b].not_()
        acc = lit if acc is None else Boolean.and_(cs, acc, lit)
    return acc


def insert(
    cs: ConstraintSystem,
    element: AllocatedNum,
    index_bits: list[Boolean],
    siblings: list[AllocatedNum],
) -> list[AllocatedNum]:
    """Arity-wide child array with `element` at position `index`.

    Slot k holds: element if k == index; siblings[k] if k < index;
    siblings[k-1] if k > index.
    """
    arity = len(siblings) + 1
    n_bits = (arity - 1).bit_length()
    assert 1 << n_bits == arity, "arity must be a power of two"
    if arity == 2:
        b = index_bits[0]
        return [
            pick(cs, b, siblings[0], element),
            pick(cs, b, element, siblings[0]),
        ]

    eqs = [position_equals(cs, index_bits, k, n_bits) for k in range(arity)]
    index_value = sum(b.value << i for i, b in enumerate(index_bits))
    out = []
    for k in range(arity):
        if k == 0:
            other = siblings[0]
        elif k == arity - 1:
            other = siblings[arity - 2]
        else:
            # gt = (index > k): 1 iff element lands after slot k
            gt_val = 1 if index_value > k else 0
            gt_bit = AllocatedBit.alloc_unchecked(cs, gt_val)
            lc = LinearCombination()
            for j in range(k + 1, arity):
                lc = lc + eqs[j].lc()
            cs.enforce(
                lc - gt_bit.lc(), lc_one(), LinearCombination(), "gt"
            )
            other = pick(
                cs, Boolean.from_bit(gt_bit), siblings[k], siblings[k - 1]
            )
        out.append(pick(cs, eqs[k], element, other))
    return out
