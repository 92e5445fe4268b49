"""audio/mel_device.py of the port (the batched device log-mel: reflect
pad, unfold, the DFT and filterbank as float32 products) against the
port's host mel_spectrogram and the JAX package's mel_spectrogram_device,
within 3e-4 (tests/test_mel.py's tolerance for JAX's), batched and
unbatched, on clips too short for one frame and with a pad longer than
the clip."""

import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.audio.mel_device import mel_spectrogram_device as jax_mel
from voxtral_tpu_torch.audio.mel import mel_spectrogram
from voxtral_tpu_torch.audio.mel_device import mel_spectrogram_device

torch.set_num_threads(1)

TOL = 3e-4


def test_matches_host_and_jax():
    audio = make_audio(1.2, seed=9)
    ref = mel_spectrogram(audio)
    got = mel_spectrogram_device(torch.from_numpy(audio))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mel(audio)),
                               atol=TOL, rtol=TOL)


def test_batched_leading_axes():
    a, b = make_audio(1.2, seed=9), make_audio(1.2, seed=3)
    batch = np.stack([np.stack([a, a * 0.5]), np.stack([b, b * 2.0])])
    got = mel_spectrogram_device(torch.from_numpy(batch)).numpy()
    assert got.shape == (2, 2) + mel_spectrogram(a).shape
    for i, j in np.ndindex(2, 2):
        np.testing.assert_allclose(got[i, j], mel_spectrogram(batch[i, j]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[0], np.asarray(jax_mel(batch[0])),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [0, 1, 100, 159])
def test_too_short_for_a_frame(n):
    audio = make_audio(1.0, seed=1)[:n]
    got = mel_spectrogram_device(torch.from_numpy(audio))
    assert tuple(got.shape) == (0, 128)
    if n:    # numpy cannot reflect-pad an empty clip
        assert mel_spectrogram(audio).shape == (0, 128)
    both = torch.from_numpy(np.stack([audio, audio]))
    assert tuple(mel_spectrogram_device(both).shape) == (2, 0, 128)


@pytest.mark.parametrize("n", [160, 180, 200, 401])
def test_pad_longer_than_the_clip(n):
    """The 200-sample reflect pad reflects again off a shorter clip, as
    numpy's and JAX's reflect padding do."""
    audio = make_audio(1.0, seed=2)[:n]
    got = mel_spectrogram_device(torch.from_numpy(audio)).numpy()
    ref = mel_spectrogram(audio)
    assert got.shape == ref.shape == (n // 160, 128)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(jax_mel(audio)), atol=TOL,
                               rtol=TOL)


def test_true_f32_whatever_the_process_setting():
    """The products run at "highest" float32 precision inside the call and
    leave the process-wide setting as they found it."""
    audio = torch.from_numpy(make_audio(0.5, seed=4))
    want = mel_spectrogram_device(audio)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = mel_spectrogram_device(audio)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
