"""ctypes bindings for the native host runtime (csrc/voxhost.cpp).

Builds the shared library on first use if a toolchain is available; all
callers fall back to the pure-Python implementations when it isn't, so the
package works everywhere and the native path is an accelerator, not a
dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libvoxhost.so")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-C", _CSRC], check=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
        lib = ctypes.CDLL(_LIB_PATH)
    except Exception:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    s16p = ctypes.POINTER(ctypes.c_int16)
    lib.vox_mel_ctx_new.restype = ctypes.c_void_p
    lib.vox_mel_ctx_new.argtypes = [ctypes.c_int]
    lib.vox_mel_ctx_free.argtypes = [ctypes.c_void_p]
    lib.vox_mel_feed.restype = ctypes.c_int64
    lib.vox_mel_feed.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.vox_mel_finish.restype = ctypes.c_int64
    lib.vox_mel_finish.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.vox_mel_n_frames.restype = ctypes.c_int64
    lib.vox_mel_n_frames.argtypes = [ctypes.c_void_p]
    lib.vox_mel_frame_offset.restype = ctypes.c_int64
    lib.vox_mel_frame_offset.argtypes = [ctypes.c_void_p]
    lib.vox_mel_copy.argtypes = [ctypes.c_void_p, f32p]
    lib.vox_mel_discard_before.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.vox_mel_batch.restype = ctypes.c_int64
    lib.vox_mel_batch.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64]
    lib.vox_s16_to_f32.argtypes = [s16p, f32p, ctypes.c_int64]
    lib.vox_resample_linear.restype = ctypes.c_int64
    lib.vox_resample_linear.argtypes = [f32p, ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, f32p]
    if lib.vox_host_abi_version() != 1:
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeMelContext:
    """C++ incremental mel context; drop-in for audio.mel.MelContext."""

    def __init__(self, left_pad_samples: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native voxhost unavailable")
        self._lib = lib
        self._ctx = lib.vox_mel_ctx_new(left_pad_samples)
        self.finished = False

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.vox_mel_ctx_free(self._ctx)
            self._ctx = None

    @property
    def mel_frame_offset(self) -> int:
        return self._lib.vox_mel_frame_offset(self._ctx)

    @property
    def n_frames(self) -> int:
        return self._lib.vox_mel_n_frames(self._ctx)

    def feed(self, samples: np.ndarray) -> int:
        if self.finished:
            return 0
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        if samples.size == 0:
            return 0
        return self._lib.vox_mel_feed(self._ctx, _fp(samples), samples.size)

    def finish(self, right_pad_samples: int = 0) -> int:
        if self.finished:
            return self.n_frames
        n = self._lib.vox_mel_finish(self._ctx, right_pad_samples)
        self.finished = True
        return n

    def data(self) -> np.ndarray:
        n = self.n_frames
        out = np.empty((n, 128), dtype=np.float32)
        if n:
            self._lib.vox_mel_copy(self._ctx, _fp(out))
        return out

    def discard_before(self, keep_from_frame: int):
        self._lib.vox_mel_discard_before(self._ctx, keep_from_frame)


def mel_spectrogram(samples: np.ndarray) -> Optional[np.ndarray]:
    """Native batch mel; returns None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    max_frames = (len(samples) + 400) // 160 + 2
    out = np.empty((max_frames, 128), dtype=np.float32)
    n = lib.vox_mel_batch(_fp(samples), len(samples), _fp(out), out.size)
    if n < 0:
        return None
    return out[:n].copy()


def s16_to_f32(pcm: np.ndarray) -> np.ndarray:
    lib = _load()
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    if lib is None:
        return pcm.astype(np.float32) / 32768.0
    out = np.empty(pcm.size, dtype=np.float32)
    lib.vox_s16_to_f32(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fp(out), pcm.size
    )
    return out


def make_mel_context(left_pad_samples: int):
    """NativeMelContext when available (and not disabled via
    VOXTRAL_NO_NATIVE), else the Python MelContext."""
    if not os.environ.get("VOXTRAL_NO_NATIVE") and available():
        return NativeMelContext(left_pad_samples)
    from ..audio.mel import MelContext

    return MelContext(left_pad_samples)
