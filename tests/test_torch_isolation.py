"""The port stands alone: no module of crypto3_fil_proofs_torch, and not
chip_smoke.py or kernel_times.py, imports jax or the JAX package, and an entry point asked
for CUDA on a machine without it raises instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import crypto3_fil_proofs_torch
from crypto3_fil_proofs_torch.api import post as api_post
from crypto3_fil_proofs_torch.api import seal as api_seal
from crypto3_fil_proofs_torch.ops import poseidon_torch as PT
from crypto3_fil_proofs_torch.ops.cuda import field as k1
from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2
from crypto3_fil_proofs_torch.types import PoRepConfig, PoStConfig

PKG = os.path.dirname(crypto3_fil_proofs_torch.__file__)
REPO = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "crypto3_fil_proofs_tpu")


def _sources():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py", "kernel_times.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_import_statement_names_jax():
    """Every import in every port module, top level or inside a function."""
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_the_multi_device_layer_is_walked():
    """parallel/ (the mesh, the sharded functions, the pipeline) is among
    the modules checked above."""
    walked = {os.path.relpath(p, PKG) for p in _sources()}
    assert {os.path.join("parallel", f) for f in ("__init__.py", "sharded.py", "pipeline.py")} <= walked


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import crypto3_fil_proofs_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = PoRepConfig.for_sector_size(2048, bytes(32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api_seal.seal_pre_commit_phase1(
            config, str(tmp_path / "c"), str(tmp_path / "in"), str(tmp_path / "out"),
            bytes(32), 1, bytes(32), [],
        )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api_seal.seal_pre_commit_phase2(config, None, str(tmp_path / "c"), str(tmp_path / "out"))


def test_post_default_device_raises_without_cuda(monkeypatch):
    """generate_winning_post and generate_window_post take device="cuda"
    by default and raise before any work where there is no CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for generate, config in ((api_post.generate_winning_post, PoStConfig.winning(2048)),
                             (api_post.generate_window_post, PoStConfig.window(2048))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate(config, bytes(32), {}, bytes(32))


def test_wrappers_take_no_other_device():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused, not quietly computed by the plain version."""
    a = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k1.montmul(a, a)
    with pytest.raises(ValueError):
        k2.poseidon_hash(a.reshape(2, 2, PT.L), 2)


def test_param_lifecycle_default_device_raises_without_cuda(monkeypatch, tmp_path):
    """paramcache, phase2 new / contribute and scale_g1 take device="cuda"
    by default and raise before any work where there is no CUDA; the
    parameter-file modules and CLIs are among the modules checked above."""
    from crypto3_fil_proofs_torch.cli import paramcache, phase2
    from crypto3_fil_proofs_torch.ops.g1_scale import scale_g1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(tmp_path / "cache"))
    for fn in (lambda: paramcache.main(["--params-for-sector-sizes", "2048", "--only-post"]),
               lambda: paramcache.cache_porep_params(2048),
               lambda: phase2.main(["contribute", str(tmp_path / "absent_0"), "--seed", "x"]),
               lambda: phase2.main(["new", "--proof", "winning", "--out", str(tmp_path / "new_0")]),
               lambda: scale_g1(torch.zeros((1, 12), dtype=torch.int32), torch.zeros((1, 12), dtype=torch.int32),
                                torch.ones(1, dtype=torch.bool), 3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
