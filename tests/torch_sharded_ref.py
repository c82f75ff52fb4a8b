"""The JAX package's multi-device functions, frozen for the port's tests.

`inputs()` makes the inputs from a numpy seed, with numpy and the port's
host curve code only, so the port's CPU tests (tests/test_torch_sharded.py)
and the smoke run on the card (chip_smoke.py) rebuild them without JAX:
- tree: 512 leaves (Montgomery Fr), built with arity 8 over 8 shards;
- ntt: 2^12 Montgomery Fr values, transformed forward, and the forward
  output transformed back;
- msm: 32 G1 points g1_mul(G, k_i) and 32 scalars, n_buckets = 16.

Run as a script, it calls the JAX package's `build_tree_sharded`,
`ntt_sharded` and G1 `msm_sharded` (crypto3_fil_proofs_tpu/parallel/
sharded.py) on an 8-device virtual CPU mesh and writes
tests/golden/torch_sharded.json (a few minutes of XLA compiles):
    python tests/torch_sharded_ref.py
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "torch_sharded.json")
SEED = 0x5EED
SHARDS = 8
TREE_LEAVES, TREE_ARITY = 512, 8
NTT_LOG_N = 12
MSM_POINTS, MSM_BUCKETS = 32, 16
DESCRIPTION = (
    "The JAX package's (crypto3_fil_proofs_tpu) parallel/sharded.py on an 8-device virtual CPU mesh, on "
    "the inputs of tests/torch_sharded_ref.py `inputs()` (numpy seed 0x5EED): build_tree_sharded of 512 "
    "Montgomery leaves at arity 8 (sub-roots and top, Montgomery values as 32-byte LE hex), ntt_sharded "
    "at 2^12 forward and inverse (SHA-256 of the Montgomery outputs as 32-byte LE values), and G1 "
    "msm_sharded of 32 points with n_buckets=16 (the compressed affine result). Written by "
    "tests/torch_sharded_ref.py."
)


def _fr_values(rng: np.random.Generator, n: int) -> list[int]:
    from crypto3_fil_proofs_torch.ops.bls12_381 import R

    raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R for row in raw]


def to_mont(values: list[int]) -> list[int]:
    from crypto3_fil_proofs_torch.ops.bls12_381 import R

    return [v * (1 << 256) % R for v in values]


def inputs() -> dict:
    """Leaves and NTT values (Montgomery ints), MSM points (host Jacobian)
    and scalars (ints), from the seed."""
    from crypto3_fil_proofs_torch.ops.bls12_381 import G1_GEN, g1_from_affine, g1_mul

    rng = np.random.default_rng(SEED)
    leaves = to_mont(_fr_values(rng, TREE_LEAVES))
    ntt_in = to_mont(_fr_values(rng, 1 << NTT_LOG_N))
    logs = [k or 1 for k in _fr_values(rng, MSM_POINTS)]
    gen = g1_from_affine(G1_GEN)
    points = [g1_mul(gen, k) for k in logs]
    scalars = _fr_values(rng, MSM_POINTS)
    return {"leaves": leaves, "ntt": ntt_in, "points": points, "scalars": scalars}


def digest_values(values) -> str:
    """SHA-256 of ints as 32-byte LE values, in order."""
    return hashlib.sha256(b"".join(int(v).to_bytes(32, "little") for v in values)).hexdigest()


def _limbs16(values: list[int]) -> np.ndarray:
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in values], dtype=np.uint32)


def _ints16(arr) -> list[int]:
    arr = np.asarray(arr, dtype=np.uint64)
    return [sum(int(w) << (16 * i) for i, w in enumerate(row)) for row in arr.reshape(-1, arr.shape[-1])]


def jax_reference() -> dict:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + f" --xla_force_host_platform_device_count={SHARDS}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from crypto3_fil_proofs_tpu.ops import g1_jax
    from crypto3_fil_proofs_tpu.ops import msm as msm_mod
    from crypto3_fil_proofs_tpu.ops.bls12_381 import g1_to_compressed
    from crypto3_fil_proofs_tpu.parallel import sharded

    mesh = sharded.make_mesh(SHARDS)
    if len(mesh.devices.flat) != SHARDS:
        raise RuntimeError("the JAX mesh does not have 8 devices")
    inp = inputs()
    roots, top = sharded.build_tree_sharded(jnp.asarray(_limbs16(inp["leaves"])), TREE_ARITY, mesh)
    a = jnp.asarray(_limbs16(inp["ntt"]))
    fwd = sharded.ntt_sharded(a, NTT_LOG_N, mesh)
    inv = sharded.ntt_sharded(fwd, NTT_LOG_N, mesh, inverse=True)
    px, py, _ = g1_jax.points_to_device(inp["points"])
    out = sharded.msm_sharded((px, py), msm_mod.scalars_to_device(inp["scalars"]), mesh, n_buckets=MSM_BUCKETS)
    point = g1_jax.points_from_device(tuple(np.asarray(t)[None] for t in out))[0]
    return {
        "description": DESCRIPTION,
        "seed": SEED,
        "shards": SHARDS,
        "tree": {"leaves": TREE_LEAVES, "arity": TREE_ARITY,
                 "sub_roots": [v.to_bytes(32, "little").hex() for v in _ints16(roots)],
                 "top": _ints16(top)[0].to_bytes(32, "little").hex()},
        "ntt": {"log_n": NTT_LOG_N, "forward": digest_values(_ints16(fwd)),
                "inverse": digest_values(_ints16(inv))},
        "msm": {"points": MSM_POINTS, "n_buckets": MSM_BUCKETS, "curve": "g1",
                "result": g1_to_compressed(point).hex()},
    }


if __name__ == "__main__":
    import sys
    import time

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    t0 = time.time()
    ref = jax_reference()
    with open(GOLDEN, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {GOLDEN} in {time.time() - t0:.1f} s")
