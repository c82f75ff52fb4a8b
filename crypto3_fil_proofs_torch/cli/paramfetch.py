"""paramfetch: fetch parameter files listed in parameters.json.

Copied from crypto3_fil_proofs_tpu/cli/paramfetch.py, which
re-implements reference bin/paramfetch/src/main.cpp (433 LoC): reads the
manifest, skips files already cached with a matching Blake2b digest,
downloads missing ones via an `ipget` binary with retries, verifies
digests after download; flags --json --retry --all
--params-for-sector-sizes --ipget-bin.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..core.parameter_cache import parameter_cache_dir
from ..param import get_digest_for_file_within_cache, read_parameter_map


def fetch_parameter_file(
    ipget_bin: str, cid: str, filename: str, retries: int
) -> bool:
    target = os.path.join(parameter_cache_dir(), filename)
    for attempt in range(1, retries + 1):
        try:
            subprocess.run(
                [ipget_bin, "-o", target, cid], check=True, capture_output=True
            )
            return True
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"  attempt {attempt}/{retries} failed: {e}", file=sys.stderr)
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paramfetch")
    ap.add_argument("--json", default="parameters.json")
    ap.add_argument("--retry", type=int, default=3)
    ap.add_argument("--all", action="store_true", dest="fetch_all")
    ap.add_argument(
        "--params-for-sector-sizes",
        type=lambda s: {int(x) for x in s.split(",")},
        default=None,
    )
    ap.add_argument("--ipget-bin", default="ipget")
    args = ap.parse_args(argv)

    manifest = read_parameter_map(args.json)
    failures = 0
    for filename, data in sorted(manifest.items()):
        if (
            args.params_for_sector_sizes is not None
            and data.sector_size not in args.params_for_sector_sizes
            and not filename.endswith(".vk")
        ):
            continue
        path = os.path.join(parameter_cache_dir(), filename)
        if os.path.exists(path):
            if get_digest_for_file_within_cache(filename) == data.digest:
                print(f"{filename}: cached, digest ok")
                continue
            print(f"{filename}: cached but digest mismatch, refetching")
        if not fetch_parameter_file(args.ipget_bin, data.cid, filename, args.retry):
            failures += 1
            continue
        got = get_digest_for_file_within_cache(filename)
        if got != data.digest:
            print(f"{filename}: digest mismatch after fetch", file=sys.stderr)
            os.remove(path)
            failures += 1
        else:
            print(f"{filename}: fetched, digest ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
