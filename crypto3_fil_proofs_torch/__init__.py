"""crypto3-fil-proofs-torch: the Filecoin proving stack on PyTorch and CUDA.

A port of the JAX package `crypto3_fil_proofs_tpu` to PyTorch, with its
TPU kernels written again by hand in CUDA C++ for Hopper (`csrc/`). The
port imports nothing of the JAX package; each module keeps the name of
its counterpart there. It covers sealing (pre-commit, commit, verify),
unseal, Winning and Window PoSt, Groth16 setup / prove / verify, and the
parameter lifecycle (paramcache, the phase-2 ceremony, the parameter
files and their CLIs); ROADMAP.md lists what is still to port.

Entry points run on the GPU (`device="cuda"`) unless the caller asks for
the CPU, where the kernels' plain PyTorch versions run instead.
"""
from __future__ import annotations

import os

# native objects (the C labeling engine, the CUDA kernels) are built here
# at first use; the directory is not part of the source tree
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build"
)
