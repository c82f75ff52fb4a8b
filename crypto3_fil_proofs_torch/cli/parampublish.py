"""parampublish: publish cached params to IPFS + write parameters.json.

Copied from crypto3_fil_proofs_tpu/cli/parampublish.py, which
re-implements reference bin/parampublish/src/main.cpp (327 LoC):
`publish` (:57-) walks the parameter cache, filters by version/extension,
adds each file via `ipfs add -Q` (or a stand-in binary), records
Blake2b digests, and writes the parameters.json manifest (:283-291).

Usage: python -m crypto3_fil_proofs_torch.cli.parampublish \
           --json parameters.json [--ipfs-bin ...] [--all]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..core.parameter_cache import VERSION, parameter_cache_dir
from ..param import (
    ParameterData,
    cached_parameter_files,
    get_digest_for_file_within_cache,
    has_extension,
    parameter_id,
    write_parameter_map,
)


def publish_parameter_file(ipfs_bin: str, filename: str) -> str:
    """`ipfs add -Q <file>` -> CID (reference :283)."""
    path = os.path.join(parameter_cache_dir(), filename)
    out = subprocess.run(
        [ipfs_bin, "add", "-Q", path], capture_output=True, text=True, check=True
    )
    return out.stdout.strip()


def publish(ipfs_bin: str, json_path: str, publish_all: bool) -> dict:
    files = cached_parameter_files(("params", "vk"))
    files = [f for f in files if f.startswith(f"v{VERSION}-")]
    if not publish_all:
        # only .params/.vk pairs whose id appears with both extensions
        ids = {parameter_id(f) for f in files if has_extension(f, "params")}
        files = [f for f in files if parameter_id(f) in ids]
    manifest: dict[str, ParameterData] = {}
    for f in files:
        cid = publish_parameter_file(ipfs_bin, f)
        digest = get_digest_for_file_within_cache(f)
        manifest[f] = ParameterData(cid=cid, digest=digest, sector_size=0)
        print(f"published {f}: {cid}")
    write_parameter_map(json_path, manifest)
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parampublish")
    ap.add_argument("--json", default="parameters.json")
    ap.add_argument("--ipfs-bin", default="ipfs")
    ap.add_argument("--all", action="store_true", dest="publish_all")
    args = ap.parse_args(argv)
    publish(args.ipfs_bin, args.json, args.publish_all)
    return 0


if __name__ == "__main__":
    sys.exit(main())
