"""Log-mel spectrogram frontend — batch and incremental.

Exactness contract (MODEL.md:34-42, voxtral_audio.c:294-399,
python_simple_implementation.py:105-157):

  periodic Hann(400) -> STFT(n_fft=400, hop=160, center=True reflect)
  -> drop last frame -> |.|^2 -> Slaney mel filterbank (128 bins, 0-8 kHz)
  -> log10(clamp(x, 1e-10)) -> max(., 1.5-8) -> (x+4)/4

The DFT is computed as a GEMM (frames @ dft matrix) in float32 — the exact
direct-DFT strategy of voxtral_audio.c:339-374 vectorized.  The per-call cost
(~hundreds of frames x 400x201 MACs) is far below a device round-trip, so the
incremental path runs on host numpy; a jnp variant is provided for fused
offline use on device.

The incremental context mirrors vox_mel_ctx semantics exactly
(voxtral_audio.c:405-672): a growing padded sample buffer with global offsets,
frames computed as soon as their 400-sample window fits, consumed samples and
frames compacted away, and the vLLM drop-last-frame convention at finish.
"""

from __future__ import annotations

import numpy as np

from ..config import (
    GLOBAL_LOG_MEL_MAX,
    HOP_LENGTH,
    N_FFT,
    N_FREQ,
    NUM_MEL_BINS,
    SAMPLE_RATE,
    WINDOW_SIZE,
)

_REFLECT_PAD = N_FFT // 2  # 200, center=True


def hertz_to_mel(freq):
    """Slaney scale (python_simple_implementation.py:105-115)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, 1e-30) / min_log_hertz) * logstep,
        mels,
    )
    return mels


def mel_to_hertz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(
        log_region, min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq
    )
    return freq


def mel_filterbank() -> np.ndarray:
    """[N_FREQ, NUM_MEL_BINS] float32 Slaney filterbank
    (python_simple_implementation.py:126-140, voxtral_audio.c:248-285)."""
    fft_freqs = np.linspace(0, SAMPLE_RATE // 2, N_FREQ)
    mel_min = hertz_to_mel(0.0)
    mel_max = hertz_to_mel(8000.0)
    mel_freqs = np.linspace(mel_min, mel_max, NUM_MEL_BINS + 2)
    filter_freqs = mel_to_hertz(mel_freqs)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (filter_freqs[2 : NUM_MEL_BINS + 2] - filter_freqs[:NUM_MEL_BINS])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def hann_window() -> np.ndarray:
    """Periodic Hann(400) float32 (voxtral_audio.c:332-336)."""
    i = np.arange(WINDOW_SIZE, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / WINDOW_SIZE))).astype(np.float32)


def dft_matrices():
    """(cos, sin) each [N_FFT, N_FREQ] float32 so that for a windowed frame f:
    re = f @ cos, im = f @ sin (voxtral_audio.c:338-347, transposed for GEMM)."""
    k = np.arange(N_FREQ, dtype=np.float64)
    n = np.arange(N_FFT, dtype=np.float64)
    angles = 2.0 * np.pi * np.outer(n, k) / N_FFT
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


class _MelTables:
    """Precomputed constants shared by all contexts (built once)."""

    _instance = None

    def __init__(self):
        self.filters = mel_filterbank()        # [201, 128]
        self.window = hann_window()            # [400]
        self.dft_cos, self.dft_sin = dft_matrices()  # [400, 201] each

    @classmethod
    def get(cls) -> "_MelTables":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


def _frames_to_mel(frames: np.ndarray, tables: _MelTables) -> np.ndarray:
    """frames: [T, 400] float32 raw (unwindowed) -> [T, 128] log-mel."""
    w = frames * tables.window[None, :]
    re = w @ tables.dft_cos
    im = w @ tables.dft_sin
    power = re * re + im * im                   # [T, 201]
    mel = power @ tables.filters                # [T, 128]
    log = np.log10(np.maximum(mel, 1e-10))
    log = np.maximum(log, GLOBAL_LOG_MEL_MAX - 8.0)
    return ((log + 4.0) / 4.0).astype(np.float32)


def mel_spectrogram(samples: np.ndarray) -> np.ndarray:
    """Batch log-mel: [n] float32 -> [frames, 128] (drops the last STFT frame,
    vLLM convention — voxtral_audio.c:316-318)."""
    samples = np.asarray(samples, dtype=np.float32)
    padded = np.pad(samples, (_REFLECT_PAD, _REFLECT_PAD), mode="reflect")
    n_frames = (len(padded) - N_FFT) // HOP_LENGTH + 1 - 1
    if n_frames <= 0:
        return np.zeros((0, NUM_MEL_BINS), dtype=np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(padded, N_FFT)[
        :: HOP_LENGTH
    ][:n_frames]
    return _frames_to_mel(np.ascontiguousarray(frames), _MelTables.get())


class MelContext:
    """Incremental log-mel over a live PCM stream (vox_mel_ctx_* analog).

    Frames are indexed globally: frame t covers padded samples
    [t*160, t*160+400).  The padded stream starts with 200 zeros (center=True
    reflect of leading silence) + `left_pad_samples` zeros
    (voxtral_audio.c:544-555).
    """

    COMPACT_MIN = 16000  # compact after ~1s of progress (voxtral_audio.c:429)

    def __init__(self, left_pad_samples: int):
        self._t = _MelTables.get()
        self.left_pad = _REFLECT_PAD + left_pad_samples
        self._buf = np.zeros(self.left_pad + SAMPLE_RATE, dtype=np.float32)
        self.n_samples = self.left_pad
        self.sample_offset = 0      # global index of _buf[0]
        self._mel = np.zeros((0, NUM_MEL_BINS), dtype=np.float32)
        self.mel_frame_offset = 0   # global frame index of _mel[0]
        self.finished = False

    # -- internals ---------------------------------------------------------
    def _ensure(self, needed: int):
        if needed > len(self._buf):
            cap = len(self._buf)
            while cap < needed:
                cap *= 2
            buf = np.zeros(cap, dtype=np.float32)
            buf[: self.n_samples] = self._buf[: self.n_samples]
            self._buf = buf

    def _append(self, samples: np.ndarray):
        n = len(samples)
        self._ensure(self.n_samples + n)
        self._buf[self.n_samples : self.n_samples + n] = samples
        self.n_samples += n

    def _compute_available(self):
        """Compute every frame whose window fits (voxtral_audio.c:452-513)."""
        t0 = self.mel_frame_offset + len(self._mel)   # next global frame
        start0 = t0 * HOP_LENGTH - self.sample_offset
        n_new = (self.n_samples - start0 - N_FFT) // HOP_LENGTH + 1
        if n_new <= 0:
            return 0
        view = np.lib.stride_tricks.sliding_window_view(
            self._buf[start0 : start0 + (n_new - 1) * HOP_LENGTH + N_FFT], N_FFT
        )[:: HOP_LENGTH]
        new_mel = _frames_to_mel(np.ascontiguousarray(view), self._t)
        self._mel = np.concatenate([self._mel, new_mel], axis=0)
        return n_new

    def _compact_samples(self):
        """Drop samples no future frame needs (voxtral_audio.c:432-450)."""
        next_frame = self.mel_frame_offset + len(self._mel)
        needed_from = next_frame * HOP_LENGTH
        discard = min(needed_from - self.sample_offset, self.n_samples)
        if discard < self.COMPACT_MIN:
            return
        self._buf[: self.n_samples - discard] = self._buf[discard : self.n_samples]
        self.n_samples -= discard
        self.sample_offset += discard

    # -- public API ----------------------------------------------------------
    def feed(self, samples: np.ndarray) -> int:
        """Append PCM float32 samples; returns the number of new frames."""
        if self.finished:
            return 0
        samples = np.asarray(samples, dtype=np.float32)
        if samples.size == 0:
            return 0
        self._append(samples)
        n = self._compute_available()
        self._compact_samples()
        return n

    def finish(self, right_pad_samples: int = 0) -> int:
        """Append right padding + 200-sample right reflect, compute remaining
        frames, and drop the last one (voxtral_audio.c:584-633)."""
        if self.finished:
            return len(self._mel)
        if right_pad_samples > 0:
            self._append(np.zeros(right_pad_samples, dtype=np.float32))
        real_end = self.n_samples - right_pad_samples
        reflect = np.zeros(_REFLECT_PAD, dtype=np.float32)
        for i in range(_REFLECT_PAD):
            src = real_end - 2 - i
            if src >= 0:
                reflect[i] = self._buf[src]
        self._append(reflect)
        self._compute_available()
        if len(self._mel) > 0:
            self._mel = self._mel[:-1]
        self.finished = True
        return len(self._mel)

    @property
    def n_frames(self) -> int:
        return len(self._mel)

    def data(self) -> np.ndarray:
        """Current frame buffer [n_frames, 128]; index 0 is global frame
        `mel_frame_offset`."""
        return self._mel

    def discard_before(self, keep_from_frame: int):
        """Drop frames the encoder has consumed (voxtral_audio.c:645-662)."""
        discard = min(
            max(keep_from_frame - self.mel_frame_offset, 0), len(self._mel)
        )
        if discard <= 0:
            return
        self._mel = self._mel[discard:]
        self.mel_frame_offset += discard
        self._compact_samples()
