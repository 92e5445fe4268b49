"""The port's offline path against the JAX package's on tiny_config()
float32 with the same weights: padded mel, transcribe_offline_ids (exact
ids) and the CLI's -i --bulk-encode path on a small model directory."""

import base64
import json

import numpy as np
import pytest
import torch

from conftest import make_audio
from test_io import _torch_layout_checkpoint
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.io.safetensors import write_safetensors
from voxtral_tpu.io.wav import write_wav
from voxtral_tpu.models.params import load_params as jax_load
from voxtral_tpu.runtime import engine as jeng
from voxtral_tpu.runtime import offline as joff
from voxtral_tpu.tokenizer import TekkenTokenizer as JTok
from voxtral_tpu_torch import cli
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime import offline as toff

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tengine(params_np):
    """The port's engine shaped like the JAX `engine` fixture."""
    return teng.VoxtralEngine(tiny_config(), from_jax_numpy(params_np),
                              buckets=(16, 4, 1), dec_kv_ring=64)


def test_padded_mel_equal(engine, tengine):
    for n in (16000, 16001, 12345):
        audio = make_audio(n / 16000.0, seed=1)
        np.testing.assert_array_equal(toff.padded_clip_mel(tengine, audio),
                                      joff.padded_clip_mel(engine, audio))


@pytest.mark.parametrize("seconds,seed", [(1.6, 23), (1.2, 5), (3.0, 7)])
def test_transcribe_offline_ids_equal(engine, tengine, seconds, seed):
    audio = make_audio(seconds, seed=seed)
    want = joff.transcribe_offline_ids(engine, audio)
    stats = {}
    got = toff.transcribe_offline_ids(tengine, audio, timings=stats)
    assert len(want) > 10
    assert got == want
    assert stats["adapter_finite"]
    assert stats["decode_steps"] >= len(got)


def test_adaptive_ring_and_decompose_equal():
    jc, tc = jax_tiny(), tiny_config()
    for n in (16000, 100_000, 480_000):
        assert teng.adaptive_dec_ring(tc, n) == jeng.adaptive_dec_ring(jc, n)
    for n in (0, 1, 37, 300):
        assert teng.decompose(n, teng.DEFAULT_BUCKETS) == \
            jeng.decompose(n, jeng.DEFAULT_BUCKETS)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """consolidated.safetensors in the reference layout + a byte tokenizer."""
    d = tmp_path_factory.mktemp("tiny_model")
    tensors = _torch_layout_checkpoint(jax_tiny(), np.random.default_rng(12))
    # zero the special ids' embedding rows: their logits are then 0 and the
    # greedy tokens land on text ids, so the transcript is not empty
    emb = "mm_streams_embeddings.embedding_module.tok_embeddings.weight"
    tensors[emb][:1000] = 0
    write_safetensors(str(d / "consolidated.safetensors"), tensors)
    vocab = [{"token_bytes": base64.b64encode(bytes([i])).decode()}
             for i in range(256)]
    (d / "tekken.json").write_text(json.dumps(
        {"config": {"default_num_special_tokens": 1000}, "vocab": vocab}))
    write_wav(str(d / "clip.wav"), make_audio(2.0, seed=31))
    return d


def test_cli_prints_the_jax_transcript(model_dir, capsys):
    from voxtral_tpu.io.wav import load_wav

    wav = str(model_dir / "clip.wav")
    samples = load_wav(wav)
    jcfg = jax_tiny()
    jengine = jeng.VoxtralEngine(
        jcfg, jax_load(str(model_dir), jcfg),
        tokenizer=JTok.load(str(model_dir / "tekken.json")),
        buckets=(64, 16, 4, 1), enc_kv_ring=128,   # the offline path has no
        dec_kv_ring=jeng.adaptive_dec_ring(jcfg, len(samples)))  # enc ring
    want = joff.transcribe_offline(jengine, samples)
    assert want

    rc = cli.main(["-d", str(model_dir), "-i", wav, "--bulk-encode"],
                  cfg=tiny_config())
    out = capsys.readouterr()
    assert rc == 0
    assert out.out == want + "\n"
    assert "Offline transcription:" in out.err
    assert "sequential" in out.err


@pytest.mark.parametrize("flag,quantize", [("--int8", True),
                                           ("--int4", "int4")])
def test_cli_quantized_prints_the_jax_transcript(model_dir, capsys, flag,
                                                 quantize):
    """-i --bulk-encode with --int8 / --int4: the transcript of the JAX
    package's engine quantized the same way (its CLI passes these flags to
    VoxtralEngine(quantize=...))."""
    from voxtral_tpu.io.wav import load_wav

    wav = str(model_dir / "clip.wav")
    samples = load_wav(wav)
    jcfg = jax_tiny()
    jengine = jeng.VoxtralEngine(
        jcfg, jax_load(str(model_dir), jcfg),
        tokenizer=JTok.load(str(model_dir / "tekken.json")),
        buckets=(64, 16, 4, 1), enc_kv_ring=128,
        dec_kv_ring=jeng.adaptive_dec_ring(jcfg, len(samples)),
        quantize=quantize)
    want = joff.transcribe_offline(jengine, samples)
    assert want

    rc = cli.main(["-d", str(model_dir), "-i", wav, "--bulk-encode", flag],
                  cfg=tiny_config())
    out = capsys.readouterr()
    assert rc == 0
    assert out.out == want + "\n"


@pytest.mark.parametrize("extra", [["--stdin"], ["-i", "x.wav"],
                                   ["-i", "x.wav", "--bulk-encode", "--alt",
                                    "0.5"],
                                   ["-i", "x.wav", "--bulk-encode", "--jacobi"]])
def test_cli_unported_modes_exit_2(model_dir, capsys, extra):
    assert cli.main(["-d", str(model_dir)] + extra, cfg=tiny_config()) == 2
    assert "not ported" in capsys.readouterr().err
