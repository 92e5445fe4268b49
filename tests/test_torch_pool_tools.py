"""The port's three pool and Jacobi tools (voxtral_tpu_torch/tools) on a tiny
synthetic checkpoint written here, with --device cpu: each runs to its
end and prints its report; without a CUDA device and without that flag,
each refuses before it loads anything."""

import base64
import json

import numpy as np
import pytest
import torch

from conftest import make_audio
from test_io import _torch_layout_checkpoint
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.io.safetensors import write_safetensors
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.io.wav import write_wav
from voxtral_tpu_torch.tools import jacobi_settle, pool_soak, tick_probe

torch.set_num_threads(1)

# the tools' engines take buckets (64, 16, 4, 1): the encoder ring holds the
# window (24) plus 64
CFG = dict(enc_kv_ring=128)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """consolidated.safetensors in the reference layout, a byte tokenizer
    and a 3 s WAV."""
    d = tmp_path_factory.mktemp("tiny_tools_model")
    tensors = _torch_layout_checkpoint(jax_tiny(), np.random.default_rng(5))
    write_safetensors(str(d / "consolidated.safetensors"), tensors)
    vocab = [{"token_bytes": base64.b64encode(bytes([i])).decode()}
             for i in range(256)]
    (d / "tekken.json").write_text(json.dumps(
        {"config": {"default_num_special_tokens": 1000}, "vocab": vocab}))
    write_wav(str(d / "clip.wav"), make_audio(3.0, seed=8))
    return d


def test_jacobi_settle_runs(capsys):
    assert jacobi_settle.main(["16", "8", "--device", "cpu"],
                              cfg=tiny_config(**CFG)) == 0
    out = capsys.readouterr().out
    assert "adversarial(random): 16 tokens, window 8:" in out
    assert "favorable(token-independent)" in out
    assert "sequential:" in out and "ms/token" in out
    # f32 on the CPU: the Jacobi ids are the sequential ones
    assert "jacobi==sequential: exact" in out


def test_tick_probe_runs(model_dir, capsys, monkeypatch):
    monkeypatch.setenv("PROBE_WAV", str(model_dir / "clip.wav"))
    monkeypatch.setenv("PROBE_ENC_RING", "128")
    monkeypatch.setenv("PROBE_SPLIT", "1")
    assert tick_probe.main([str(model_dir), "2", "4", "--device", "cpu"],
                           cfg=tiny_config(**CFG)) == 0
    out = capsys.readouterr().out
    assert "TICKPROBE n=2 interval=0.5 gate=0.4 enc_ring=128 ticks=4" in out
    for name in ("tick", "enc", "dec", "bursts", "rows", "fetch"):
        assert f"  {name}" in out
    assert out.count("worst:") == 4


def test_pool_soak_runs(model_dir, capsys, monkeypatch):
    """A short window-mode soak on synthetic audio: the summary line, and
    PASS or FAIL with the matching exit code (the verdict is a wall-clock
    measurement)."""
    for k, v in (("SOAK_STREAMS", "2"), ("SOAK_MINUTES", "0.03"),
                 ("SOAK_ENC_MODE", "window"), ("SOAK_ENC_RING", "128"),
                 ("SOAK_DEC_RING", "64"), ("SOAK_TICK_LOG", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("SOAK_WAV", raising=False)
    rc = pool_soak.main([str(model_dir), "--device", "cpu"],
                        cfg=tiny_config(**CFG))
    cap = capsys.readouterr()
    assert "SOAK 2 streams x" in cap.out and "streams alive" in cap.out
    assert "2/2 streams alive" in cap.out
    assert ("SOAK PASS" in cap.out) == (rc == 0)
    assert ("SOAK FAIL" in cap.out) == (rc == 1)
    assert "[soak] tick 0:" in cap.err


@pytest.mark.parametrize("tool,argv", [
    (jacobi_settle, ["16", "8"]),
    (tick_probe, ["MODEL", "2", "4"]),
    (pool_soak, ["MODEL"])])
def test_tools_refuse_without_cuda(model_dir, capsys, monkeypatch, tool,
                                   argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(model_dir) if a == "MODEL" else a for a in argv]
    assert tool.main(argv, cfg=tiny_config(**CFG)) == 1
    err = capsys.readouterr().err
    assert "no CUDA device; pass --device cpu to run on the CPU" in err
    assert "weights" not in err and "building" not in err
