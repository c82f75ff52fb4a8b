"""fakeipfsadd: test stand-in for `ipfs add -Q`.

Copied from crypto3_fil_proofs_tpu/cli/fakeipfsadd.py, which
re-implements reference bin/fakeipfsadd/src/main.cpp:30-58: copies the
file aside and prints a deterministic fake CID derived from content.
"""
from __future__ import annotations

import argparse
import hashlib
import shutil
import sys
import tempfile


def fake_cid(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "Qmfake" + h.hexdigest()[:40]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fakeipfsadd")
    ap.add_argument("add", choices=["add"])
    ap.add_argument("-Q", action="store_true")
    ap.add_argument("path")
    args = ap.parse_args(argv)
    shutil.copy(args.path, tempfile.mkdtemp(prefix="fakeipfs-"))
    print(fake_cid(args.path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
