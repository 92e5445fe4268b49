"""Zero-copy safetensors reader: mmap -> numpy views -> torch tensors.

Mirror of voxtral_safetensors.c semantics (header parse :156, open :204,
bounds validation :271-281, zero-copy bf16 views :424) built on np.memmap.
numpy has no bfloat16, and the port does not depend on `ml_dtypes`: BF16
tensors are read as their raw uint16 bits and viewed as `torch.bfloat16`
(`get_tensor`), or widened to float32 by a 16-bit shift (`get_f32`).
"""

from __future__ import annotations

import json
import struct
from typing import Iterable

import numpy as np
import torch

# safetensors dtype -> (numpy storage dtype, torch dtype)
_DTYPES = {
    "BF16": (np.dtype(np.uint16), torch.bfloat16),
    "F16": (np.dtype(np.float16), torch.float16),
    "F32": (np.dtype(np.float32), torch.float32),
    "F64": (np.dtype(np.float64), torch.float64),
    "I8": (np.dtype(np.int8), torch.int8),
    "U8": (np.dtype(np.uint8), torch.uint8),
    "I16": (np.dtype(np.int16), torch.int16),
    "I32": (np.dtype(np.int32), torch.int32),
    "I64": (np.dtype(np.int64), torch.int64),
    "BOOL": (np.dtype(np.bool_), torch.bool),
}


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bfloat16 bits (uint16) -> float32 (exact: bf16 is the top half of
    an f32)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


class SafetensorsFile:
    """Read-only safetensors file backed by an OS page-cache mmap."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header_len = struct.unpack("<Q", f.read(8))[0]
            header = json.loads(f.read(header_len))
        self._data_start = 8 + header_len
        self._meta = {k: v for k, v in header.items() if k != "__metadata__"}
        self.metadata = header.get("__metadata__", {})
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        data_len = len(self._mm) - self._data_start
        # Bounds validation (voxtral_safetensors.c:271-281)
        for name, info in self._meta.items():
            lo, hi = info["data_offsets"]
            if not (0 <= lo <= hi <= data_len):
                raise ValueError(f"tensor {name!r}: offsets out of bounds")

    def names(self) -> Iterable[str]:
        return self._meta.keys()

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._meta[name]["shape"])

    def dtype(self, name: str) -> torch.dtype:
        return _DTYPES[self._meta[name]["dtype"]][1]

    def __contains__(self, name: str) -> bool:
        return name in self._meta

    def get(self, name: str) -> np.ndarray:
        """Zero-copy numpy view of a tensor (BF16 as raw uint16 bits)."""
        info = self._meta[name]
        dt = _DTYPES[info["dtype"]][0]
        lo, hi = info["data_offsets"]
        lo += self._data_start
        hi += self._data_start
        n = int(np.prod(info["shape"])) if info["shape"] else 1
        if hi - lo != n * dt.itemsize:
            raise ValueError(f"tensor {name!r}: size mismatch")
        return self._mm[lo:hi].view(dt).reshape(info["shape"])

    def get_tensor(self, name: str) -> torch.Tensor:
        """CPU torch tensor in the file's dtype (a copy of the mmap pages;
        BF16 bits are reinterpreted, not converted)."""
        arr = np.array(self.get(name))   # own the memory: mmap is read-only
        t = torch.from_numpy(arr)
        tdt = self.dtype(name)
        return t.view(tdt) if tdt == torch.bfloat16 else t

    def get_f32(self, name: str) -> np.ndarray:
        """Tensor converted to float32 (copies — for norms/biases)."""
        arr = self.get(name)
        if self._meta[name]["dtype"] == "BF16":
            return bf16_bits_to_f32(arr)
        return arr.astype(np.float32)


def write_safetensors(path: str, tensors: dict):
    """Minimal writer (for test fixtures and weight export).  Values are
    numpy arrays or CPU torch tensors; a torch.bfloat16 tensor is stored as
    BF16 from its raw bits."""
    np_inv = {v[0]: k for k, v in _DTYPES.items() if k != "BF16"}
    meta = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            t = arr.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                code, arr = "BF16", t.view(torch.uint16).numpy()
            else:
                arr = t.numpy()
                code = np_inv[arr.dtype]
        else:
            arr = np.ascontiguousarray(arr)
            code = np_inv[arr.dtype]
        blob = np.ascontiguousarray(arr).tobytes()
        meta[name] = {
            "dtype": code,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        offset += len(blob)
        blobs.append(blob)
    header = json.dumps(meta).encode("utf-8")
    pad = (-len(header)) % 8
    header += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for blob in blobs:
            f.write(blob)
