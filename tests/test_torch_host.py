"""Host layer of the port (wav, safetensors, tokenizer, mel) against the JAX
package's: the same inputs give the same outputs."""

import base64
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.audio import mel as jmel
from voxtral_tpu.io import safetensors as jst
from voxtral_tpu.io import wav as jwav
from voxtral_tpu.tokenizer import TekkenTokenizer as JTok
from voxtral_tpu_torch.audio import mel as tmel
from voxtral_tpu_torch.io import safetensors as tst
from voxtral_tpu_torch.io import wav as twav
from voxtral_tpu_torch.tokenizer import TekkenTokenizer as TTok

torch.set_num_threads(1)


def test_wav_both_ways(tmp_path):
    samples = make_audio(0.7, seed=2)
    twav.write_wav(str(tmp_path / "t.wav"), samples)
    jwav.write_wav(str(tmp_path / "j.wav"), samples)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    np.testing.assert_array_equal(twav.load_wav(str(tmp_path / "j.wav")),
                                  jwav.load_wav(str(tmp_path / "j.wav")))
    x = np.random.default_rng(0).standard_normal(999).astype(np.float32)
    for src, dst in ((8000, 16000), (44100, 16000), (16000, 16000)):
        np.testing.assert_array_equal(twav.resample_linear(x, src, dst),
                                      jwav.resample_linear(x, src, dst))


def test_safetensors_bf16_roundtrip_without_ml_dtypes(tmp_path):
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    bf = torch.from_numpy(f32).to(torch.bfloat16)
    i64 = np.arange(4, dtype=np.int64)
    path = str(tmp_path / "t.safetensors")
    tst.write_safetensors(path, {"bf": bf, "f": f32, "i": i64})

    # the port reads its own file back bit for bit
    sf = tst.SafetensorsFile(path)
    assert sf.dtype("bf") == torch.bfloat16 and sf.shape("bf") == (5, 7)
    assert torch.equal(sf.get_tensor("bf").view(torch.int16),
                       bf.view(torch.int16))
    np.testing.assert_array_equal(sf.get_f32("bf"), bf.float().numpy())
    np.testing.assert_array_equal(sf.get("f"), f32)
    np.testing.assert_array_equal(sf.get("i"), i64)

    # the JAX reader (ml_dtypes) sees the same values
    jf = jst.SafetensorsFile(path)
    np.testing.assert_array_equal(jf.get("bf").astype(np.float32),
                                  bf.float().numpy())
    np.testing.assert_array_equal(jf.get("f"), f32)

    # and the port reads a file the JAX writer made
    jpath = str(tmp_path / "j.safetensors")
    jst.write_safetensors(jpath, {"bf": f32.astype(ml_dtypes.bfloat16)})
    got = tst.SafetensorsFile(jpath).get_tensor("bf")
    assert torch.equal(got.view(torch.int16), bf.view(torch.int16))


def test_tokenizer_equal(tmp_path):
    pieces = [b"\x00", b"Hello", b" world", b"\xc3\xa9", b"\xc3", b"\xa9",
              b"x" * 3]
    data = {
        "config": {"default_num_special_tokens": 1000},
        "vocab": [{"token_bytes": base64.b64encode(b).decode()}
                  for b in pieces],
        "special_tokens": [{"rank": 0}, {"rank": 1}, {"rank": 2}],
    }
    path = str(tmp_path / "tekken.json")
    with open(path, "w") as f:
        json.dump(data, f)
    j, t = JTok.load(path), TTok.load(path)
    assert t.vocab_size == j.vocab_size
    for tid in list(range(0, 5)) + list(range(998, 1010)):
        assert t.decode(tid) == j.decode(tid)
        assert t.classify(tid) == j.classify(tid)
    seq = [1001, 1002, 1004, 1005, 2, 1006]
    assert t.decode_seq(seq) == j.decode_seq(seq)


@pytest.mark.parametrize("seconds,seed", [(0.5, 0), (1.37, 4)])
def test_mel_equal(seconds, seed):
    audio = make_audio(seconds, seed=seed)
    np.testing.assert_array_equal(tmel.mel_spectrogram(audio),
                                  jmel.mel_spectrogram(audio))
    jc, tc = jmel.MelContext(1280), tmel.MelContext(1280)
    for lo in range(0, len(audio), 3001):
        jc.feed(audio[lo: lo + 3001])
        tc.feed(audio[lo: lo + 3001])
    jc.finish(640)
    tc.finish(640)
    np.testing.assert_array_equal(tc.data(), jc.data())
