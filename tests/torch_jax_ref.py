"""JAX-package references shared by the port's Groth16 tests
(test_torch_ntt.py, test_torch_groth16.py), computed once per process.

The cubic circuit is tests/test_groth16.py's: x^3 + x + 5 == out, x = 3,
out public (35); `prove_many` proves it for x = 3 and 4 as two
partitions under the same key. Its key is the JAX package's
`setup(cubic(3), seed=b"test-cubic")`, carried to numpy in the form
`crypto3_fil_proofs_torch.zk.groth16.proving_key_from_jax` takes. The
JAX package's `_compute_h` and `prove` are called here once and shared:
the first call compiles the XLA NTT chain (about 10-20 s on a CPU).

Run as a script, it writes tests/golden/torch_groth16_cubic.npz:
    python tests/torch_jax_ref.py
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "torch_groth16_cubic.npz")
RANDOMNESS = (b"fixed", b"other")
MANY_X, MANY_RANDOMNESS = (3, 4), b"many"  # prove_many's partitions: cubic(x), one key
DESCRIPTION = (
    "JAX package (crypto3_fil_proofs_tpu) Groth16 key and proofs of the cubic circuit of "
    "tests/test_groth16.py (x^3 + x + 5 == out, x = 3, public out = 35): the key of "
    "zk.groth16.setup(cubic(3), seed=b'test-cubic') as numpy arrays in the form of "
    "crypto3_fil_proofs_torch.zk.groth16.proving_key_from_jax (vk compressed, beta_g1 and "
    "delta_g1 compressed, queries as 16-bit Montgomery limbs), and the 192-byte proofs of "
    "zk.groth16.prove with randomness b'fixed' and b'other'. Written by tests/torch_jax_ref.py."
)


def cubic_circuit(cs_cls, lc_cls, lc_one, num_cls, x: int = 3):
    """tests/test_groth16.py `_cubic_circuit`, over either package's types."""
    from crypto3_fil_proofs_torch.ops.bls12_381 import R

    cs = cs_cls()
    xn = num_cls.alloc(cs, x)
    x2 = xn.square(cs)
    x3 = x2.mul(cs, xn)
    out = num_cls.alloc_input(cs, (x3.value + xn.value + 5) % R)
    cs.enforce(x3.lc() + xn.lc() + lc_cls.constant(5), lc_one(), out.lc(), "out")
    return cs


def jax_cubic_cs(x: int = 3):
    from crypto3_fil_proofs_tpu.zk.gadgets.num import AllocatedNum
    from crypto3_fil_proofs_tpu.zk.r1cs import ConstraintSystem, LinearCombination, lc_one

    return cubic_circuit(ConstraintSystem, LinearCombination, lc_one, AllocatedNum, x)


def port_cubic_cs(x: int = 3):
    from crypto3_fil_proofs_torch.zk.gadgets.num import AllocatedNum
    from crypto3_fil_proofs_torch.zk.r1cs import ConstraintSystem, LinearCombination, lc_one

    return cubic_circuit(ConstraintSystem, LinearCombination, lc_one, AllocatedNum, x)


def key_arrays(pk) -> dict:
    """A JAX ProvingKey as the numpy arrays proving_key_from_jax takes."""
    from crypto3_fil_proofs_tpu.ops.bls12_381 import g1_to_compressed

    d = dict(pk.vk.to_npz_dict())
    d["beta_g1"] = np.frombuffer(g1_to_compressed(pk.beta_g1), np.uint8)
    d["delta_g1"] = np.frombuffer(g1_to_compressed(pk.delta_g1), np.uint8)
    d["log_n"] = np.asarray(pk.log_n)
    for q, k in (("a_query", "a"), ("b_g1_query", "b_g1"), ("h_query", "h"), ("l_query", "l")):
        x, y, valid = getattr(pk, q)
        d[f"{k}_x"], d[f"{k}_y"], d[f"{k}_valid"] = np.asarray(x), np.asarray(y), np.asarray(valid)
    ((x0, x1), (y0, y1)), valid = pk.b_g2_query
    for name, t in (("x0", x0), ("x1", x1), ("y0", y0), ("y1", y1), ("valid", valid)):
        d[f"b_g2_{name}"] = np.asarray(t)
    return d


@lru_cache(maxsize=None)
def jax_cubic() -> dict:
    """The JAX package's key (as arrays), h coefficients and proofs."""
    from crypto3_fil_proofs_tpu.zk import groth16

    cs = jax_cubic_cs()
    pk = groth16.setup(cs, seed=b"test-cubic")
    fin = cs.finalize()
    n_in, _, _, inputs, aux = fin
    h = groth16._compute_h(fin, inputs + aux, pk.log_n)
    proofs = {rnd: groth16.prove(pk, cs, randomness=rnd).to_bytes() for rnd in RANDOMNESS}
    # prove_many of the partitions MANY_X on one device: no XLA compile
    # for another device, and the bytes do not depend on the devices
    import jax

    many = groth16.prove_many(pk, [jax_cubic_cs(x) for x in MANY_X], randomness=MANY_RANDOMNESS,
                              devices=jax.devices()[:1])
    return {"pk": pk, "arrays": key_arrays(pk), "h": h, "proofs": proofs, "public": inputs[1:n_in],
            "many": [p.to_bytes() for p in many]}


def golden_arrays() -> dict:
    ref = jax_cubic()
    out = dict(ref["arrays"])
    for rnd in RANDOMNESS:
        out[f"proof_{rnd.decode()}"] = np.frombuffer(ref["proofs"][rnd], np.uint8)
    out["public_output"] = np.asarray(ref["public"][0])
    out["description"] = np.asarray(DESCRIPTION)
    return out


if __name__ == "__main__":
    np.savez(GOLDEN, **golden_arrays())
    print(f"wrote {GOLDEN}")
