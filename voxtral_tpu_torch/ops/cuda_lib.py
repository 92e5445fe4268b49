"""Builds and loads the port's hand-written CUDA kernels.

The sources in `voxtral_tpu_torch/csrc/*.cu` expose plain C entry points;
headers there (`*.cuh`, e.g. `attn_tile.cuh`, the attention tile shared by
the banded and flash-encode kernels) are included, not linked.  On first
use each `.cu` is compiled with `nvcc` for `sm_90a` (Hopper) into its own
object, all at once in parallel, and linked into one shared library under
`voxtral_tpu_torch/build/<digest>/` (ignored by git), then loaded with
ctypes; a later process with the same sources reuses the library.  The
digest covers every `.cu` and `.cuh` file under `csrc/` and the flags, so
an edit to a shared header rebuilds every kernel.  Nothing
here runs at import time: the CPU tests import every module of the package
on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def sources(csrc: str = CSRC) -> list[str]:
    """The compiled sources: every `.cu` file under `csrc`, sorted."""
    return sorted(n for n in os.listdir(csrc) if n.endswith(".cu"))


def _digest(csrc: str = CSRC) -> str:
    """Hash of the flags and of every `.cu` and `.cuh` file under `csrc`
    (names and contents), which names the build directory."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(n for n in os.listdir(csrc)
                       if n.endswith((".cu", ".cuh"))):
        with open(os.path.join(csrc, name), "rb") as f:
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
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    srcs = sources()
    objs = [os.path.join(out_dir, f"{s}.{tag}.o") for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]                  # one nvcc per source, together
    outs = [p.communicate()[0] for p in procs]
    tmp = f"{lib_path}.{tag}"
    link = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
    link_out = ""
    if all(p.returncode == 0 for p in procs):
        lp = subprocess.run(link, capture_output=True, text=True)
        link_out = lp.stdout + lp.stderr
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    log += " ".join(link) + "\n" + link_out
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if not os.path.exists(tmp):
        sys.stderr.write(log)
        raise RuntimeError(f"nvcc failed building {out_dir} (build.log)")
    os.replace(tmp, lib_path)   # atomic: a concurrent builder sees all or nothing
    return lib_path


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.vt_banded_attention.restype = i
            lib.vt_banded_attention.argtypes = [
                p, p, p, p, p, i, i, i, i, i, i, i, p,
            ]
            lib.vt_flash_decode.restype = i
            lib.vt_flash_decode.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i,
                ll, ll, i, p,
            ]
            lib.vt_flash_encode.restype = i
            lib.vt_flash_encode.argtypes = [
                p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, i, i, i, i,
                p,
            ]
            lib.vt_int4_mm.restype = i
            lib.vt_int4_mm.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
            lib.vt_int4_mm_occupancy.restype = i
            lib.vt_int4_mm_occupancy.argtypes = [i, i]
            lib.vt_ring_rows_write.restype = i
            lib.vt_ring_rows_write.argtypes = [
                p, p, p, p, p, i, i, i, i, i, i, i, p,
            ]
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of the card `device` (read once per
    device: kernels that size their grid by it are on host-bound paths)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on `device` (kernels launch
    there and never synchronize)."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
