"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``ray_tpu_torch/csrc/`` becomes one shared library with
a plain C interface, compiled for Hopper (``sm_90a``) on first use into
``build/ray_tpu_torch/`` at the root of the checkout.  The library's name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"

# No --use_fast_math and no FMA contraction: the kernels must round every
# division and every multiply-add exactly as the plain PyTorch versions do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                       "are built from source on first use")


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        src = CSRC / source
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{src.stem}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (rc={proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[source] = lib
        return lib
