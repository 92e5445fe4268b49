"""Builds and loads the port's hand-written CUDA kernels.

The sources in `voxtral_tpu_torch/csrc/*.cu` expose plain C entry points.
On first use they are compiled with `nvcc` for `sm_90a` (Hopper) into one
shared library under `voxtral_tpu_torch/build/<source hash>/` (ignored by
git) and loaded with ctypes; a later process with the same sources reuses
the library.  Nothing here runs at import time: the CPU tests import every
module of the package on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "build")
SOURCES = ("banded_attention.cu", "flash_decode.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source on first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels unless this source set is already built; returns
    the library path.  The compiler's register/shared-memory report goes to
    `build.log` beside the library."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    lib_path = os.path.join(out_dir, "libvoxtral_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    os.replace(tmp, lib_path)   # atomic: a concurrent builder sees all or nothing
    return lib_path


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.vt_banded_attention.restype = i
            lib.vt_banded_attention.argtypes = [
                p, p, p, p, p, i, i, i, i, i, i, i, p,
            ]
            lib.vt_flash_decode.restype = i
            lib.vt_flash_decode.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p,
            ]
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on `device` (kernels launch
    there and never synchronize)."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
