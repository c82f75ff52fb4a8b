"""phase2: Groth16 MPC ceremony tool (delta re-randomization).

Counterpart of crypto3_fil_proofs_tpu/cli/phase2.py, which
re-implements reference bin/phase2/src/main.cpp (822 LoC) subcommands:
- `new` (:131-210): blank PoRep / Winning / Window PoSt circuit ->
  initial parameters file, made by the port's setup on `--device`.
- `contribute`: add participant randomness d — delta' = d*delta,
  l_query and h_query scaled by d^{-1} (the standard Groth16 phase-2
  update), plus a chained contribution digest. The queries are rescaled
  on `--device` (ops/g1_scale.py: kernels K4 and K1 on cuda), both in
  one pass over their lanes; the file equals the JAX package's, array
  for array, for the same key and `--seed`.
- `verify`: recheck the contribution chain — delta G1/G2 consistency
  via pairings and h query consistency against the previous file via
  a random-combination pairing check (host, as in the JAX package).
- `small`, `convert`, `merge`, `split-keys`, `verifyd`: host work on the
  parameter files, as in the JAX package.

Only `contribute` loads a whole key. `verify`, `merge`, `small`,
`split-keys` and `verifyd` read what they check from the file, one
array at a time (`load_key_head`: the vk, delta_g1 and h_query's first
rows; the query digest over the file's arrays), and `split-keys` copies
the file into the cache: on a 512 MiB key (8.2 GB) a whole load takes
seconds to tens of seconds. `contribute` and `verify_contribution` also
take keys in memory. Files are the parameter cache's npz layout
(core/parameter_cache.py), which both packages read and write.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import secrets
import shutil
import sys
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..api.seal import check_device
from ..constants import SECTOR_SHAPES
from ..core.parameter_cache import _load_pk, _save_pk, _save_vk, meta_path, params_path, vk_path
from ..ops import field as F
from ..ops.bls12_381 import (
    FQ12_ONE,
    G1_GEN,
    G1_INF,
    G2_GEN_X,
    G2_GEN_Y,
    R,
    g1_add,
    g1_from_affine,
    g1_from_compressed,
    g1_mul,
    g1_neg,
    g1_to_compressed,
    g2_from_affine,
    g2_mul,
    g2_to_compressed,
    multi_pairing,
)
from ..ops.fixed_base import host_points
from ..ops.g1_scale import scale_g1
from ..ops.g1_torch import G1
from ..zk import groth16


def _build_blank(proof: str, sector_size: int):
    if proof == "sdr":
        from ..models.porep.stacked.circuit.compound import StackedCompound
        from ..parameters import public_params
        from ..types import PoRepConfig

        config = PoRepConfig.for_sector_size(sector_size)
        pp = public_params(config)
        return StackedCompound(shape=SECTOR_SHAPES[sector_size]).blank_circuit(pp)
    from ..models.post.fallback.compound import FallbackPoStCompound
    from ..parameters import (
        window_post_public_params,
        winning_post_public_params,
    )
    from ..types import PoStConfig

    if proof == "winning":
        pp = winning_post_public_params(PoStConfig.winning(sector_size))
    elif proof == "window":
        pp = window_post_public_params(PoStConfig.window(sector_size))
    else:
        raise ValueError(f"unknown proof kind {proof}")
    return FallbackPoStCompound(shape=SECTOR_SHAPES[sector_size]).blank_circuit(pp)


def cmd_new(args) -> int:
    check_device(args.device)
    cs = _build_blank(args.proof, args.sector_size)
    pk = groth16.setup(cs, seed=f"phase2-{args.proof}-{args.sector_size}".encode(), device=args.device)
    out = args.out or f"{args.proof}_poseidon_{args.sector_size}_0"
    _save_pk(out, pk)
    print(f"wrote initial params: {out}")
    return 0


def contribution_scalar(seed: str | None) -> int:
    """d: random in [1, r), or SHA-256 of `seed` mod r (deterministic)."""
    if seed is None:
        return secrets.randbelow(R - 1) + 1
    return int.from_bytes(hashlib.sha256(seed.encode()).digest(), "big") % R


def contribute(pk: groth16.ProvingKey, d: int, device="cuda") -> tuple[groth16.ProvingKey, str]:
    """The key with delta scaled by d and l_query, h_query by d^-1 (one
    scale_g1 pass over both queries' lanes, on `device`; the queries stay
    where they lie), and the contribution digest."""
    d_inv = pow(d, R - 2, R)
    old_delta = g1_to_compressed(pk.delta_g1)
    (lp, lv), (hp, hv) = pk.l_query, pk.h_query
    pts, valid = torch.cat([lp, hp]), torch.cat([lv, hv])
    scaled, ok = scale_g1(pts[:, 0], pts[:, 1], valid, d_inv, device=device)
    n = lp.shape[0]
    new = replace(
        pk,
        vk=replace(pk.vk, delta_g2=g2_mul(pk.vk.delta_g2, d)),
        delta_g1=g1_mul(pk.delta_g1, d),
        l_query=(scaled[:n], ok[:n]),
        h_query=(scaled[n:], ok[n:]),
    )
    digest = hashlib.sha256(old_delta + g1_to_compressed(new.delta_g1)).hexdigest()
    return new, digest


def cmd_contribute(args) -> int:
    check_device(args.device)
    t0 = time.time()
    pk = _load_pk(args.path)
    t1 = time.time()
    new, digest = contribute(pk, contribution_scalar(args.seed), device=args.device)
    del pk
    t2 = time.time()
    base, _, n = args.path.rpartition("_")
    out = args.out or f"{base}_{int(n) + 1 if n.isdigit() else 1}"
    _save_pk(out, new)
    lanes = new.l_query[1].shape[0] + new.h_query[1].shape[0]
    print(f"contribution digest: {digest}")
    print(f"rescaled {lanes} lanes on {args.device}: load {t1 - t0:.3f} s, rescale {t2 - t1:.3f} s, "
          f"save {time.time() - t2:.3f} s")
    print(f"wrote contributed params: {out}")
    return 0


@dataclass
class KeyHead:
    """What verify reads of a key: its vk, delta_g1 and the first rows of
    h_query (in the working form)."""

    vk: groth16.VerifyingKey
    delta_g1: tuple
    h_query: tuple


def _head(npz, name: str, rows: int) -> np.ndarray:
    """The first `rows` rows of one array of an npz, read alone."""
    with npz.zip.open(name + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
        shape, _, dtype = read(f)
        n = min(rows, shape[0])
        count = n * int(np.prod(shape[1:], dtype=np.int64))
        return np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype).reshape((n,) + tuple(shape[1:]))


def load_key_head(path: str, rows: int = 8) -> KeyHead:
    with np.load(path) as d:
        vk = groth16.VerifyingKey.from_npz_dict(d)
        delta_g1 = g1_from_compressed(bytes(d["delta_g1"]))
        x, y, valid = (_head(d, f"h_query_{c}", rows) for c in ("x", "y", "valid"))
    pts = torch.stack([F.from_jax_limbs(x), F.from_jax_limbs(y)], dim=1)
    return KeyHead(vk, delta_g1, (pts, torch.from_numpy(valid.astype(bool))))


def _combine(query, coeffs):
    acc = G1_INF
    for pt, c in zip(host_points(G1, *query), coeffs):
        if pt != G1_INF:
            acc = g1_add(acc, g1_mul(pt, int(c)))
    return acc


def verify_contribution(old, new) -> int:
    """Check new params against old (keys or KeyHeads): delta
    consistency + query scaling."""
    g1 = g1_from_affine(G1_GEN)
    g2 = g2_from_affine((G2_GEN_X, G2_GEN_Y))
    # 1. e(delta1', g2) == e(g1, delta2')  (G1/G2 delta agree)
    ok = multi_pairing([(new.delta_g1, g2), (g1_neg(g1), new.vk.delta_g2)]) == FQ12_ONE
    if not ok:
        print("FAIL: delta G1/G2 mismatch")
        return 1
    # 2. random-combination consistency of h_query scaling:
    #    e(sum r_i h_i', delta2') == e(sum r_i h_i, delta2)
    rng = np.random.default_rng(0)
    n = min(old.h_query[1].shape[0], 8)
    coeffs = rng.integers(1, 1 << 30, size=n)
    h_old = _combine(tuple(q[:n] for q in old.h_query), coeffs)
    h_new = _combine(tuple(q[:n] for q in new.h_query), coeffs)
    ok = multi_pairing([(h_new, new.vk.delta_g2), (g1_neg(h_old), old.vk.delta_g2)]) == FQ12_ONE
    if not ok:
        print("FAIL: h_query not consistently rescaled")
        return 1
    print("contribution verified")
    return 0


def cmd_verify(args) -> int:
    return verify_contribution(load_key_head(args.old), load_key_head(args.new))


def cmd_small(args) -> int:
    """Summarize a params file; with --out, write a small companion
    file (delta pair + query digest) for cheap chain verification
    (reference main.cpp `small` subcommand)."""
    with np.load(args.path) as d:
        log_n = int(d["log_n"])
        print(f"log_n: {log_n}")
        for name in ("a_query", "b_g1_query", "h_query", "l_query"):
            print(f"{name}: {d[f'{name}_valid'].shape[0]} points")
        vk = groth16.VerifyingKey.from_npz_dict(d)
        delta_g1 = g1_to_compressed(g1_from_compressed(bytes(d["delta_g1"])))
        print(f"ic: {len(vk.ic)} inputs")
        print(f"delta_g1: {delta_g1.hex()[:32]}...")
        print(f"delta_g2: {g2_to_compressed(vk.delta_g2).hex()[:32]}...")
        if getattr(args, "out", None):
            small = {
                "delta_g1": delta_g1.hex(),
                "delta_g2": g2_to_compressed(vk.delta_g2).hex(),
                "query_digest": file_query_digest(d),
                "log_n": log_n,
            }
            with open(args.out, "w") as f:
                json.dump(small, f, indent=2)
            print(f"wrote small params: {args.out}")
    return 0


def file_query_digest(npz) -> str:
    """SHA-256 over the staged query tables of a key file (its [N, 24]
    uint32 limb arrays; order-stable), one array at a time."""
    h = hashlib.sha256()
    for name in ("a_query", "b_g1_query", "h_query", "l_query"):
        for coord in "xy":
            h.update(np.ascontiguousarray(npz[f"{name}_{coord}"]))
    return h.hexdigest()


def cmd_convert(args) -> int:
    """Convert a params file between compressed and raw npz container
    (reference main.cpp `convert`: raw <-> non-raw serialization — raw
    trades disk for mmap-speed loading)."""
    with np.load(args.path) as d:
        payload = {k: d[k] for k in d.files}
    tmp = args.path + ".conv.npz"
    if args.to == "raw":
        np.savez(tmp, **payload)
    else:
        np.savez_compressed(tmp, **payload)
    os.replace(tmp, args.out or args.path)
    print(f"converted to {args.to}: {args.out or args.path}")
    return 0


def cmd_merge(args) -> int:
    """Merge a verified small-file contribution chain into the large
    params for publishing (reference main.cpp `merge`): checks the
    large file's delta matches the small chain head and (with
    --original) that its queries are consistently d^-1-rescaled, then
    stamps the contribution log into the large file's meta json."""
    with open(args.small) as f:
        small = json.load(f)
    large = load_key_head(args.large)
    if g1_to_compressed(large.delta_g1).hex() != small["delta_g1"]:
        print("FAIL: large params delta_g1 does not match small chain")
        return 1
    if g2_to_compressed(large.vk.delta_g2).hex() != small["delta_g2"]:
        print("FAIL: large params delta_g2 does not match small chain")
        return 1
    if args.original and verify_contribution(load_key_head(args.original), large) != 0:
        return 1
    meta = {
        "merged_small": os.path.basename(args.small),
        "delta_g1": small["delta_g1"],
        "contributions": small.get("contributions", []),
    }
    with open(args.large + ".meta", "w") as f:
        json.dump(meta, f, indent=2)
    print(f"merged; wrote {args.large}.meta")
    return 0


def cmd_split_keys(args) -> int:
    """Split a finished params file into the published
    v28-<id>.params/.vk/.meta triple in the parameter cache (reference
    main.cpp `split-keys`: emits the .params/.vk/.info/.contribs files
    parampublish ships). The .params file is a copy of the input."""
    prefix = args.prefix
    tmp = params_path(prefix) + ".tmp"
    shutil.copyfile(args.path, tmp)
    os.replace(tmp, params_path(prefix))
    with np.load(args.path) as d:
        _save_vk(vk_path(prefix), groth16.VerifyingKey.from_npz_dict(d))
        digest = file_query_digest(d)
    with open(meta_path(prefix), "w") as f:
        json.dump({"prefix": prefix, "source": os.path.basename(args.path), "query_digest": digest}, f)
    print(f"wrote {params_path(prefix)}")
    print(f"wrote {vk_path(prefix)}")
    print(f"wrote {meta_path(prefix)}")
    return 0


def cmd_verifyd(args) -> int:
    """Continuous verification daemon (reference main.cpp
    `verifyd` / verify_param_transistions_daemon :416-560): watch for
    successive params files `<base>_<n>` and verify each n -> n+1
    transition as the files appear, sleeping between polls. `--rounds`
    bounds the number of transitions (0 = run forever, the reference
    daemon's behavior); `--sleep` mirrors its SLEEP_SECS=10."""
    base, _, n0 = args.base.rpartition("_")
    if not n0.isdigit():
        base, n0 = args.base, "0"
    param_number = int(n0)
    verified = 0

    def _wait(path: str) -> None:
        while not os.path.exists(path):
            print(f"waiting for params file: {path}", flush=True)
            time.sleep(args.sleep)

    while args.rounds == 0 or verified < args.rounds:
        before = f"{base}_{param_number}"
        after = f"{base}_{param_number + 1}"
        _wait(before)
        _wait(after)
        rc = verify_contribution(load_key_head(before), load_key_head(after))
        if rc != 0:
            print(f"FAIL: transition {before} -> {after}")
            return rc
        print(f"verified transition {before} -> {after}", flush=True)
        param_number += 1
        verified += 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phase2")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_new = sub.add_parser("new")
    p_new.add_argument("--proof", choices=["sdr", "winning", "window"], required=True)
    p_new.add_argument("--sector-size", type=int, default=2048)
    p_new.add_argument("--out")
    p_new.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    p_new.set_defaults(fn=cmd_new)

    p_con = sub.add_parser("contribute")
    p_con.add_argument("path")
    p_con.add_argument("--seed", help="deterministic contribution (tests)")
    p_con.add_argument("--out")
    p_con.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    p_con.set_defaults(fn=cmd_contribute)

    p_ver = sub.add_parser("verify")
    p_ver.add_argument("old")
    p_ver.add_argument("new")
    p_ver.set_defaults(fn=cmd_verify)

    p_small = sub.add_parser("small")
    p_small.add_argument("path")
    p_small.add_argument("--out")
    p_small.set_defaults(fn=cmd_small)

    p_conv = sub.add_parser("convert")
    p_conv.add_argument("path")
    p_conv.add_argument("--to", choices=["raw", "compressed"], required=True)
    p_conv.add_argument("--out")
    p_conv.set_defaults(fn=cmd_convert)

    p_merge = sub.add_parser("merge")
    p_merge.add_argument("small")
    p_merge.add_argument("large")
    p_merge.add_argument("--original", help="pre-contribution large file")
    p_merge.set_defaults(fn=cmd_merge)

    p_split = sub.add_parser("split-keys")
    p_split.add_argument("path")
    p_split.add_argument("--prefix", required=True)
    p_split.set_defaults(fn=cmd_split_keys)

    p_vd = sub.add_parser("verifyd")
    p_vd.add_argument("base", help="first params file of the chain (…_0)")
    p_vd.add_argument("--sleep", type=float, default=10.0)
    p_vd.add_argument(
        "--rounds", type=int, default=0,
        help="stop after N verified transitions (0 = daemon forever)",
    )
    p_vd.set_defaults(fn=cmd_verifyd)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
