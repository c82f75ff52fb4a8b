"""The Poseidon witness replay of a seeded batch at each arity the
circuits use (2, 8, 11), summarised by SHA-256, and the frozen JAX
digests: tests/golden/torch_witness.json.

`batch(arity)` makes the preimages, [K, arity, 16] uint64 of plain
16-bit limbs (0 and r - 1 among them), with numpy from a seed;
`digest(witness)` is the SHA-256 of a replay's [K, n_int, 16] values as
little-endian 32-byte field elements. Neither needs JAX or the port, so
the smoke run on the card (chip_smoke.py phase 32) holds kernel K7 to
the golden, and tests/test_torch_poseidon.py the port's plain replay.

Run as a script, it replays each batch with the JAX package
(crypto3_fil_proofs_tpu/zk/gadgets/tiled.py `poseidon_witness_v`, whose
batches of 8 or more go to the XLA program `_poseidon_witness_jax_fn`),
checks that the package's numpy replay gives the same values, and writes
the golden (a few minutes on a CPU, mostly XLA compiles):
    JAX_PLATFORMS=cpu python tests/torch_witness_ref.py
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_witness.json")
ARITIES = (2, 8, 11)
K = 37  # instances per arity: a warp and five more
SEED = 0x57
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def batch(arity: int) -> np.ndarray:
    """K seeded preimages of `arity` elements, [K, arity, 16] uint64 of
    plain 16-bit limbs; the first element 0, the second and the last r - 1."""
    raw = np.random.default_rng(SEED + arity).integers(0, 256, (K * arity, 32), dtype=np.uint8)
    values = [int.from_bytes(r.tobytes(), "little") % R for r in raw]
    values[0], values[1], values[-1] = 0, R - 1, R - 1
    limbs = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in values), dtype="<u2")
    return limbs.astype(np.uint64).reshape(K, arity, 16)


def digest(witness: np.ndarray) -> str:
    """SHA-256 of [K, n_int, 16] plain 16-bit limbs as LE 32-byte elements."""
    return hashlib.sha256(np.ascontiguousarray(witness).astype("<u2").tobytes()).hexdigest()


def main() -> None:
    from crypto3_fil_proofs_tpu.zk.gadgets import tiled

    out = {}
    t0 = time.time()
    for arity in ARITIES:
        pre = batch(arity)
        got = tiled.poseidon_witness_v(pre, arity)
        if not np.array_equal(got, tiled._poseidon_witness_numpy(pre, arity)):
            raise RuntimeError(f"arity {arity}: the XLA replay != the numpy replay")
        out[str(arity)] = {"k": K, "n_int": got.shape[1], "sha256": digest(got)}
    total = time.time() - t0
    golden = {
        "description": (
            "The JAX package's (crypto3_fil_proofs_tpu) Poseidon witness replay, zk/gadgets/tiled.py "
            "poseidon_witness_v (its XLA program for these batches of 37; equal to its numpy replay), of the "
            "seeded batches of tests/torch_witness_ref.py `batch(arity)`: per arity the count, the values per "
            "instance and the SHA-256 of `digest(witness)`. Written by tests/torch_witness_ref.py on a CPU in "
            f"{total:.0f} s."
        ),
        "seed": SEED,
        "arities": out,
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
    print(f"wrote {GOLDEN} in {total:.0f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
