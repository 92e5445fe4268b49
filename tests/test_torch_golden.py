"""The port's make_golden (voxtral_tpu_torch/tools/make_golden.py) on a tiny
checkpoint on the CPU: record then check round-trips with equal ids, the
fingerprint and audio gating skips (as tests/test_tools.py holds the JAX
tool's), the port's fixtures live beside the JAX engine's, and the ids it
records equal the JAX tool's `_transcribe` on the same checkpoint and
clip."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import make_audio
from test_io import _torch_layout_checkpoint
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.io.safetensors import write_safetensors
from voxtral_tpu.models.params import load_params as jax_load
from voxtral_tpu.runtime.engine import VoxtralEngine as JEngine
from voxtral_tpu.runtime.engine import adaptive_dec_ring as j_ring
from voxtral_tpu.tokenizer import TekkenTokenizer as JaxTok
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.io.wav import write_wav
from voxtral_tpu_torch.tools import make_fake_ckpt, make_golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_golden as jax_mg  # noqa: E402  (the JAX package's tool)

torch.set_num_threads(1)

# the tool's engine takes the default buckets (up to 256): the encoder ring
# holds the window (24) plus 256
ENC_RING = 512


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_golden_model")
    write_safetensors(str(d / "consolidated.safetensors"),
                      _torch_layout_checkpoint(jax_tiny(),
                                               np.random.default_rng(21)))
    make_fake_ckpt.write_tekken(str(d / "tekken.json"),
                                jax_tiny().decoder.vocab_size)
    wavs = d / "wavs"
    wavs.mkdir()
    write_wav(str(wavs / "clip.wav"), make_audio(4.0, seed=22))
    return d


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = make_golden.main(argv, cfg=tiny_config(enc_kv_ring=ENC_RING))
    return rc, out.getvalue()


def test_record_then_check_round_trips(model_dir, tmp_path):
    fix = tmp_path / "golden"
    wav = str(model_dir / "wavs" / "clip.wav")
    rc, out = _main(["record", "-d", str(model_dir), "--fixtures", str(fix),
                     "--device", "cpu", wav])
    assert rc == 0 and "clip.torch_engine.json" in out
    fx = json.loads((fix / "clip.torch_engine.json").read_text())
    assert fx["engine"] == "voxtral_tpu_torch" and fx["quant"] == "bf16"
    assert fx["token_ids"] and fx["weights_fingerprint"] == \
        make_golden.weights_fingerprint(str(model_dir))
    rc, out = _main(["check", "-d", str(model_dir), "--fixtures", str(fix),
                     "--wav-dir", str(model_dir / "wavs"), "--device", "cpu"])
    n = len(fx["token_ids"])
    assert rc == 0
    assert f"OK   clip.torch_engine.json: {n}/{n} token IDs match" in out
    # another rung against the bf16 fixture: a delta report, not a verdict
    rc, out = _main(["check", "-d", str(model_dir), "--fixtures", str(fix),
                     "--wav-dir", str(model_dir / "wavs"), "--device", "cpu",
                     "--quant", "int8"])
    assert rc == 0 and "voxtral_tpu_torch/bf16 vs voxtral_tpu_torch/int8" \
        in out and "word-level similarity" in out
    # a changed fixture fails the exact check
    fx["token_ids"][0] += 1
    (fix / "clip.torch_engine.json").write_text(json.dumps(fx))
    rc, out = _main(["check", "-d", str(model_dir), "--fixtures", str(fix),
                     "--wav-dir", str(model_dir / "wavs"), "--device", "cpu"])
    assert rc == 1 and f"FAIL clip.torch_engine.json: {n - 1}/{n}" in out


def test_fingerprint_gating(tmp_path, monkeypatch):
    """`check` skips (never fails, and loads no engine) a fixture recorded
    on another checkpoint or against a wav of other content; the
    fingerprint is the JAX tool's."""
    cfg = jax_tiny()
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_safetensors(str(ckpt / "consolidated.safetensors"),
                      _torch_layout_checkpoint(cfg, np.random.default_rng(0)))
    fp = make_golden.weights_fingerprint(str(ckpt))
    assert fp == make_golden.weights_fingerprint(str(ckpt))  # stable
    assert fp == jax_mg.weights_fingerprint(str(ckpt))
    ckpt2 = tmp_path / "ckpt2"
    ckpt2.mkdir()
    write_safetensors(str(ckpt2 / "consolidated.safetensors"),
                      _torch_layout_checkpoint(cfg, np.random.default_rng(1)))
    assert make_golden.weights_fingerprint(str(ckpt2)) != fp

    fixdir = tmp_path / "golden"
    fixdir.mkdir()
    wavdir = tmp_path / "wavs"
    wavdir.mkdir()
    (wavdir / "clip.wav").write_bytes(b"RIFF-not-really-the-same-audio")

    def write_fixture(**kw):
        fx = {"name": "clip", "engine": "voxtral_tpu_torch", "quant": "bf16",
              "token_ids": [1, 2, 3], "text": "abc", **kw}
        (fixdir / "clip.torch_engine.json").write_text(json.dumps(fx))

    def no_engine(*a, **k):
        raise AssertionError("a skipped fixture loaded an engine")

    monkeypatch.setattr(make_golden, "_load_engine", no_engine)
    argv = ["check", "-d", str(ckpt), "--fixtures", str(fixdir),
            "--wav-dir", str(wavdir), "--device", "cpu"]
    write_fixture(weights_fingerprint="0" * 64, audio_sha256="1" * 64)
    rc, out = _main(argv)
    assert rc == 0 and "SKIP clip.torch_engine.json: recorded on a " \
        "different checkpoint" in out
    write_fixture(weights_fingerprint=fp, audio_sha256="1" * 64)
    rc, out = _main(argv)
    assert rc == 0 and "content does not match" in out
    rc, out = _main(["check", "-d", str(ckpt), "--fixtures",
                     str(tmp_path / "none"), "--device", "cpu"])
    assert rc == 0 and out.startswith("SKIP: no fixtures under")


def test_ingest_writes_a_reference_fixture(tmp_path):
    text = tmp_path / "ref.txt"
    text.write_text("  hello world \n")
    rc, out = _main(["ingest", "--name", "clip", "--text-file", str(text),
                     "--fixtures", str(tmp_path)])
    fx = json.loads((tmp_path / "clip.reference.json").read_text())
    assert rc == 0 and fx == {"name": "clip", "engine": "reference",
                              "quant": "bf16", "token_ids": None,
                              "text": "hello world"}


def test_recorded_ids_equal_the_jax_tools(model_dir, tmp_path):
    """The ids the port records for a clip equal those the JAX tool's
    `_transcribe` gives on the same checkpoint (f32, its `_load_engine`'s
    engine at the tiny config)."""
    wav = str(model_dir / "wavs" / "clip.wav")
    rc, _ = _main(["record", "-d", str(model_dir), "--fixtures",
                   str(tmp_path), "--device", "cpu", wav])
    assert rc == 0
    port = json.loads((tmp_path / "clip.torch_engine.json").read_text())
    cfg = jax_tiny(enc_kv_ring=ENC_RING)
    engine = JEngine(cfg, jax_load(str(model_dir), cfg),
                     tokenizer=JaxTok.load(str(model_dir / "tekken.json")),
                     dec_kv_ring=j_ring(cfg, 16000 * 120))
    ids, text = jax_mg._transcribe(engine, wav)
    assert len(ids) > 20
    assert port["token_ids"] == ids and port["text"] == text
