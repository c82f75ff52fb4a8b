"""paramcache: pre-generate Groth16 params + vks for registered circuits.

Counterpart of crypto3_fil_proofs_tpu/cli/paramcache.py, which
re-implements reference bin/paramcache/src/main.cpp (224 LoC):
`cache_porep_params` (:27-52), `cache_winning_post_params` (:55-86),
`cache_window_post_params` (:88-113); flags `--only-post`,
`--params-for-sector-sizes`. The keys are made by the port's setup on
`--device` ("cuda" by default; "cpu" runs the kernels' plain versions)
into the parameter cache (`FIL_PROOFS_PARAMETER_CACHE`); each function
returns its proving key. `cache_porep_params` takes the porep id, which
the circuit's cache prefix holds (32 zero bytes, as the CLI and the JAX
package use, unless given).

Usage: python -m crypto3_fil_proofs_torch.cli.paramcache \
           --params-for-sector-sizes 2048 [--only-post] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

from ..api.seal import check_device
from ..constants import SECTOR_SHAPES, SUPPORTED_SECTOR_SIZES
from ..core.compound import CompoundProof
from ..models.porep.stacked.circuit.compound import StackedCompound
from ..models.post.fallback.compound import FallbackPoStCompound
from ..parameters import (
    public_params,
    window_post_public_params,
    winning_post_public_params,
)
from ..types import PoRepConfig, PoStConfig


def cache_porep_params(sector_size: int, porep_id: bytes = bytes(32), device="cuda"):
    check_device(device)
    config = PoRepConfig.for_sector_size(sector_size, porep_id)
    pp = public_params(config)
    compound = CompoundProof(StackedCompound(shape=SECTOR_SHAPES[sector_size]))
    print(f"generating PoRep params for {sector_size} bytes...", flush=True)
    pk = compound.get_params(pp, device=device)
    print(f"  done ({pk.log_n=} domain)")
    return pk


def _cache_post_params(kind: str, config: PoStConfig, pp, device):
    check_device(device)
    compound = CompoundProof(FallbackPoStCompound(shape=SECTOR_SHAPES[config.sector_size]))
    print(f"generating {kind} PoSt params for {config.sector_size} bytes...", flush=True)
    pk = compound.get_params(pp, device=device)
    print("  done")
    return pk


def cache_winning_post_params(sector_size: int, device="cuda"):
    config = PoStConfig.winning(sector_size)
    return _cache_post_params("Winning", config, winning_post_public_params(config), device)


def cache_window_post_params(sector_size: int, device="cuda"):
    config = PoStConfig.window(sector_size)
    return _cache_post_params("Window", config, window_post_public_params(config), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paramcache",
        description="Generate and cache Groth16 parameters "
        "(reference bin/paramcache)",
    )
    ap.add_argument(
        "--params-for-sector-sizes",
        type=lambda s: [int(x) for x in s.split(",")],
        default=SUPPORTED_SECTOR_SIZES,
        help="comma-separated sector sizes in bytes",
    )
    ap.add_argument(
        "--only-post", action="store_true", help="skip PoRep parameters"
    )
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    for size in args.params_for_sector_sizes:
        if size not in SUPPORTED_SECTOR_SIZES:
            print(f"unsupported sector size {size}", file=sys.stderr)
            return 1
        cache_winning_post_params(size, device=args.device)
        cache_window_post_params(size, device=args.device)
        if not args.only_post:
            cache_porep_params(size, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
