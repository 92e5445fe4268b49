"""The port's A/B and measuring tools against the JAX package's on one
tiny checkpoint on the CPU: int8_ab (int8, AB_BITS=4 through the int4
path, AB_KV=float8_e4m3fn) and window_ab report the JAX tools' deltas
line for line; the port CLI's stderr metric lines parse with
tools/benchmark.py's regexes in the streaming mode, and the offline mode's
with the port's benchmark; runtest.sh skips without a model and runs its
fixture phase on a synthetic one; the tools refuse without a CUDA device
unless given --device cpu."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import voxtral_tpu.config as jax_config
from conftest import make_audio
from test_io import _torch_layout_checkpoint
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.io.safetensors import write_safetensors
from voxtral_tpu_torch import cli
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.io.wav import write_wav
from voxtral_tpu_torch.tools import (
    benchmark,
    int8_ab,
    make_fake_ckpt,
    window_ab,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import benchmark as jax_bench  # noqa: E402  (the JAX package's tools)
import int8_ab as jax_int8_ab  # noqa: E402
import window_ab as jax_window_ab  # noqa: E402

torch.set_num_threads(1)

# the tools' engines take buckets (64, 16, 4, 1): the encoder ring holds
# the window (24) plus 64
RING = 128


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_ab_model")
    write_safetensors(str(d / "consolidated.safetensors"),
                      _torch_layout_checkpoint(jax_tiny(),
                                               np.random.default_rng(31)))
    make_fake_ckpt.write_tekken(str(d / "tekken.json"),
                                jax_tiny().decoder.vocab_size)
    write_wav(str(d / "clip.wav"), make_audio(5.0, seed=32))
    return d


def _jax_main(module, argv, monkeypatch, capsys):
    """A JAX tool's main() at the tiny config: its stdout."""
    monkeypatch.setattr(jax_config, "full_config",
                        lambda: jax_tiny(enc_kv_ring=RING))
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    capsys.readouterr()
    assert module.main() == 0
    return capsys.readouterr().out


def _port_main(module, argv, capsys):
    capsys.readouterr()
    assert module.main(argv + ["--device", "cpu"],
                       cfg=tiny_config(enc_kv_ring=RING)) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("env", [{}, {"AB_BITS": "4"},
                                 {"AB_KV": "float8_e4m3fn"}])
def test_int8_ab_reports_the_jax_tools_delta(model_dir, monkeypatch, capsys,
                                             env):
    for k in ("AB_BITS", "AB_KV"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = [str(model_dir), str(model_dir / "clip.wav")]
    port = _port_main(int8_ab, argv, capsys)
    ref = _jax_main(jax_int8_ab, argv, monkeypatch, capsys)
    assert port.startswith("QUANT-AB: bf16 ")
    assert port == ref


def test_window_ab_reports_the_jax_tools_deltas(model_dir, monkeypatch,
                                                capsys):
    """Two clips (the WAV and a rotated copy), extras 0 and 1: every
    WINDOW-AB line equal to the JAX tool's but for its wall seconds."""
    for k, v in (("AB_SECONDS", "6"), ("AB_CLIPS", "2"), ("AB_EXTRAS", "0,1"),
                 ("AB_INTERVAL", "2.0"), ("AB_RING", "256")):
        monkeypatch.setenv(k, v)
    argv = [str(model_dir), str(model_dir / "clip.wav")]

    def lines(out):
        return [ln.split(", +")[0] for ln in out.splitlines()
                if ln.startswith("WINDOW-AB")]

    port = lines(_port_main(window_ab, argv, capsys))
    ref = lines(_jax_main(jax_window_ab, argv, monkeypatch, capsys))
    assert len(port) == 2 * 2 + 2 and port == ref


def _cli_stderr(model_dir, extra):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-d", str(model_dir), "-i", str(model_dir / "clip.wav"),
                       "--device", "cpu"] + extra,
                      cfg=tiny_config(enc_kv_ring=RING))
    assert rc == 0
    return err.getvalue()


def test_cli_metric_lines_parse_with_the_benchmark_regexes(model_dir):
    """Streaming: the JAX tool's AUDIO_RE, ENCODER_RE and DECODER_RE all
    match the port CLI's lines.  Offline (--bulk-encode): the audio line
    and the offline timing line only, as the JAX CLI prints."""
    err = _cli_stderr(model_dir, [])
    audio = jax_bench.AUDIO_RE.search(err)
    dec = jax_bench.DECODER_RE.search(err)
    enc = jax_bench.ENCODER_RE.search(err)
    assert audio and dec and enc, err
    assert float(audio.group(1)) == 5.0 and int(dec.group(1)) > 0
    m = benchmark.parse_metrics(err)
    assert m["mode"] == "stream" and m["steps"] == int(dec.group(1))
    err = _cli_stderr(model_dir, ["--bulk-encode"])
    assert jax_bench.AUDIO_RE.search(err)
    assert not jax_bench.DECODER_RE.search(err)
    assert not jax_bench.ENCODER_RE.search(err)
    m = benchmark.parse_metrics(err)
    assert m["mode"] == "offline" and m["decoder_ms"] > 0 and m["steps"] == 0


def test_benchmark_runs_both_modes(model_dir, capsys):
    """Two runs of the clip in each mode: the summary lines the mode's
    metric lines allow."""
    for extra, step_lines in (([], True), (["--cli-arg=--bulk-encode"], False)):
        assert benchmark.main(["-d", str(model_dir), "-n", "2",
                               str(model_dir / "clip.wav"),
                               "--cli-arg=--device", "--cli-arg=cpu"] + extra,
                              cfg=tiny_config(enc_kv_ring=RING)) == 0
        cap = capsys.readouterr()
        assert "=== Summary ===" in cap.out and "overall_rtf" in cap.out
        assert ("weighted_step_ms" in cap.out) == step_lines
        assert ("short_clip_step_ms" in cap.out) == step_lines
        assert cap.err.count("clip.wav: 5.0s audio") == 2


def test_runtest_skips_without_a_model():
    out = subprocess.run(
        ["bash", os.path.join(REPO, "voxtral_tpu_torch", "tools",
                              "runtest.sh")],
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "VOXTRAL_MODEL_DIR": ""})
    assert out.returncode == 0
    assert out.stderr.startswith("SKIP: set VOXTRAL_MODEL_DIR")


def test_runtest_fixture_phase_on_a_synthetic_checkpoint(tmp_path):
    """A checkpoint with the SYNTHETIC marker skips the phrase phases and
    runs make_golden check over the repo's fixtures, which were recorded
    on another checkpoint (the JAX engine's): each is skipped, none
    fails, and no engine is loaded."""
    assert make_fake_ckpt.main([str(tmp_path), "0"],
                               cfg=tiny_config(enc_kv_ring=RING)) == 0
    out = subprocess.run(
        ["bash", os.path.join(REPO, "voxtral_tpu_torch", "tools",
                              "runtest.sh")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "VOXTRAL_MODEL_DIR": str(tmp_path),
             "VOXTRAL_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NOTE: synthetic checkpoint" in out.stderr
    assert "SKIP jfk.engine.json: recorded on a different checkpoint" \
        in out.stdout
    assert "all fixture comparisons passed" in out.stdout
    assert out.stdout.rstrip().endswith("OK: fixture phase complete "
                                        "(phrase phases need a real "
                                        "checkpoint)")


@pytest.mark.parametrize("tool", ["int8_ab", "window_ab", "make_golden"])
def test_tools_refuse_without_cuda(model_dir, capsys, monkeypatch, tool):
    from voxtral_tpu_torch.tools import make_golden

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"int8_ab": [str(model_dir)], "window_ab": [str(model_dir)],
            "make_golden": ["check", "-d", str(model_dir)]}[tool]
    mod = {"int8_ab": int8_ab, "window_ab": window_ab,
           "make_golden": make_golden}[tool]
    assert mod.main(argv, cfg=tiny_config(enc_kv_ring=RING)) == 1
    err = capsys.readouterr().err
    assert "no CUDA device; pass --device cpu to run on the CPU" in err
    assert "weights" not in err
