"""WAV ingest: 16-bit PCM parse, downmix, linear resample to 16 kHz.

Mirrors the reference's parser semantics (voxtral_audio.c:49-141 and the
stdin path voxtral.c:1381-1475): RIFF chunk walk, format 1 (PCM) s16le only,
multichannel averaged to mono, linear-interpolation resample.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..config import SAMPLE_RATE


class WavError(ValueError):
    pass


def parse_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Parse a WAV byte buffer -> (float32 mono samples in [-1, 1), rate)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    end = len(data)
    while pos + 8 <= end:
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + csize > end:
            csize = end - pos - 8
        body = data[pos + 8 : pos + 8 + csize]
        if cid == b"fmt " and csize >= 16:
            audio_format, channels, rate = struct.unpack_from("<HHI", body, 0)
            bits = struct.unpack_from("<H", body, 14)[0]
            fmt = (audio_format, channels, rate, bits)
        elif cid == b"data":
            pcm = body
        pos += 8 + csize + (csize & 1)
    if fmt is None or pcm is None:
        raise WavError("missing fmt/data chunk")
    audio_format, channels, rate, bits = fmt
    if audio_format != 1 or bits != 16 or channels < 1:
        raise WavError(
            f"unsupported WAV: format={audio_format} bits={bits} ch={channels}"
        )
    n_frames = len(pcm) // (channels * 2)
    raw = np.frombuffer(pcm[: n_frames * channels * 2], dtype="<i2")
    raw = raw.reshape(n_frames, channels).astype(np.float32)
    mono = raw.mean(axis=1) / 32768.0
    return mono.astype(np.float32), rate


def resample_linear(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resample (voxtral.c:1459-1475 semantics)."""
    if src_rate == dst_rate:
        return samples
    n = len(samples)
    new_n = int(n * dst_rate // src_rate)
    src_pos = np.arange(new_n, dtype=np.float64) * src_rate / dst_rate
    idx = src_pos.astype(np.int64)
    frac = (src_pos - idx).astype(np.float32)
    nxt = np.minimum(idx + 1, n - 1)
    out = samples[idx] * (1.0 - frac) + samples[nxt] * frac
    # Match the C tail behavior: positions whose idx+1 runs past the end keep
    # samples[idx] (handled above by clamping nxt), idx past end is impossible
    # for new_n computed by floor.
    return out.astype(np.float32)


def load_wav(path: str) -> np.ndarray:
    """Load a WAV file -> float32 mono 16 kHz samples."""
    with open(path, "rb") as f:
        data = f.read()
    samples, rate = parse_wav_bytes(data)
    return resample_linear(samples, rate, SAMPLE_RATE)


def write_wav(path: str, samples: np.ndarray, rate: int = SAMPLE_RATE):
    """Write mono float32 samples as 16-bit PCM (test/bench helper)."""
    pcm = np.clip(samples * 32768.0, -32768, 32767).astype("<i2").tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(pcm)))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(pcm)))
    buf.write(pcm)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
