"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

The library is compiled at first use into ``csrc/build/<hash>/``, keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once; callers load it once per process.  nvcc is
found through ``CUDA_HOME``, then PyTorch's ``CUDA_HOME``, then ``PATH``.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ...utils.trace import span

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cands.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "torch's CUDA_HOME and PATH); the CUDA kernels "
                           "cannot be built")
    return found


def library(name: str, sources, headers=()) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) into lib<name>.so
    unless a build of the same content exists, and load it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*sources, *headers):
        h.update((CSRC / f).read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # Compile to a private name, then rename: a concurrent build never
        # loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / s) for s in sources)]
        with span("hipims.kernels.build"):
            res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, lib_path)
    with span("hipims.kernels.load"):
        return ctypes.CDLL(str(lib_path))
