"""Device-side log-mel spectrogram: the STFT as two matrix products.

PyTorch counterpart of voxtral_tpu/audio/mel_device.py.  The streaming
engine computes mel on the host (audio/mel.py, or the native C++ variant)
because a feed's frame count is tiny; this is the batch path for whole
clips, batched over any leading axes: reflect padding, frames by
`unfold`, the Hann window, the 201-bin DFT as two float32 products, the
Slaney filterbank product and the log/clamp epilogue, with the tables of
audio/mel.py.  Nothing on the serving path calls it.

The products are plain dense matmuls (XLA lowered them on the TPU), so
`torch.matmul` is the right tool.  They run in true float32 whatever the
process-wide TF32 setting: TF32's 10-bit mantissa would move the log-mel
by more than the 3e-4 it is held to.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import GLOBAL_LOG_MEL_MAX, HOP_LENGTH, N_FFT, NUM_MEL_BINS
from .mel import _MelTables

_REFLECT_PAD = N_FFT // 2
_tables: dict = {}


def _device_tables(device: torch.device):
    """(window [400], dft_cos [400, 201], dft_sin [400, 201], filters
    [201, 128]) as float32 tensors on `device`, made once per device."""
    key = str(device)
    if key not in _tables:
        t = _MelTables.get()
        _tables[key] = tuple(
            torch.as_tensor(a, dtype=torch.float32).to(device)
            for a in (t.window, t.dft_cos, t.dft_sin, t.filters))
    return _tables[key]


@contextlib.contextmanager
def _true_f32():
    """float32 products in full precision (no TF32) for the duration."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _reflect_index(n: int, device) -> torch.Tensor:
    """Indices of numpy's mode="reflect" padding by N_FFT // 2 on each side
    of a length-n signal (repeated reflection when the pad exceeds n - 1)."""
    j = torch.arange(-_REFLECT_PAD, n + _REFLECT_PAD, device=device)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * (n - 1)
    j = torch.remainder(j, period)
    return torch.where(j >= n, period - j, j)


def mel_spectrogram_device(samples: torch.Tensor) -> torch.Tensor:
    """samples [..., n] float32 -> [..., frames, 128] float32 on the same
    device, with center=True reflect padding and the last frame dropped
    (the exact recipe of audio/mel.py: frames = n // 160)."""
    samples = torch.as_tensor(samples, dtype=torch.float32)
    n = samples.shape[-1]
    n_frames = n // HOP_LENGTH
    if n_frames <= 0:
        return torch.zeros((*samples.shape[:-1], 0, NUM_MEL_BINS),
                           dtype=torch.float32, device=samples.device)
    window, dft_cos, dft_sin, filters = _device_tables(samples.device)
    padded = samples[..., _reflect_index(n, samples.device)]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[..., :n_frames, :]
    w = frames * window                                  # [..., T, 400]
    with _true_f32():
        re = torch.matmul(w, dft_cos)
        im = torch.matmul(w, dft_sin)
        mel = torch.matmul(re * re + im * im, filters)   # [..., T, 128]
    log = torch.log10(torch.clamp_min(mel, 1e-10))
    log = torch.clamp_min(log, GLOBAL_LOG_MEL_MAX - 8.0)
    return (log + 4.0) / 4.0
