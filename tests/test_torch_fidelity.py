"""The port's fidelity check (voxtral_tpu_torch/tools fidelity_check and its
oracle) against the JAX package's: the oracle's blocks within 1e-6 of
tests/oracle.py on one tree, the two checkpoint -> oracle-tree mappings
bit-equal, and the check itself on a tiny checkpoint on the CPU: PASS
through the real loader, FAIL when the loader is mis-wired."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from oracle import OracleDecoder as JOracleDecoder
from oracle import oracle_adapter as j_adapter
from oracle import oracle_conv_stem as j_conv_stem
from oracle import oracle_encoder as j_encoder
from test_io import _torch_layout_checkpoint
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.io.safetensors import write_safetensors
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import params as params_mod
from voxtral_tpu_torch.tools import fidelity_check, make_fake_ckpt, oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import fidelity_check as jax_fc  # noqa: E402  (the JAX package's tool)

torch.set_num_threads(1)

# the tool's engine takes buckets (64, 16, 4, 1): the encoder ring holds the
# window (24) plus 64
CFG = dict(enc_kv_ring=128)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny checkpoint in the reference layout (weights 0.1 N(0, 1)) and
    the synthetic tokenizer for its vocabulary."""
    d = tmp_path_factory.mktemp("tiny_fidelity_model")
    cfg = jax_tiny()
    write_safetensors(str(d / "consolidated.safetensors"),
                      _torch_layout_checkpoint(cfg, np.random.default_rng(11)))
    make_fake_ckpt.write_tekken(str(d / "tekken.json"), cfg.decoder.vocab_size)
    return d


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def test_oracle_equals_the_jax_packages_oracle(params_np):
    """Conv stem, encoder, adapter, and a decoder prefill + steps with its
    logits: the port's oracle within 1e-6 of tests/oracle.py on the same
    float32 tree (both are float32 PyTorch; the port's takes the tree as
    tensors)."""
    cfg, jcfg = tiny_config(), jax_tiny()

    def to_torch(t):
        if isinstance(t, dict):
            return {k: to_torch(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, dtype=np.float32))

    tree = to_torch(params_np)
    mel = np.random.default_rng(2).standard_normal((96, 128)).astype(np.float32)
    conv = j_conv_stem(params_np["encoder"], jcfg, mel)
    assert np.abs(_np(oracle.oracle_conv_stem(tree["encoder"], cfg, mel))
                  - conv).max() <= 1e-6
    enc = j_encoder(params_np["encoder"], jcfg, conv)
    assert np.abs(_np(oracle.oracle_encoder(tree["encoder"], cfg, conv))
                  - enc).max() <= 1e-6
    ada = j_adapter(params_np["adapter"], jcfg, enc)
    assert np.abs(_np(oracle.oracle_adapter(tree["adapter"], cfg, enc))
                  - ada).max() <= 1e-6

    jdec, pdec = JOracleDecoder(params_np["decoder"], jcfg), \
        oracle.OracleDecoder(tree["decoder"], cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (20, cfg.decoder.dim)).astype(np.float32))
    with torch.no_grad():
        for pos, rows in ((0, x[:12]), (12, x[12:13]), (13, x[13:14]),
                          (14, x[14:20])):
            hj, hp = jdec.forward(rows, pos), pdec.forward(rows, pos)
            assert (hp - hj).abs().max().item() <= 1e-6
            lj, lp = jdec.logits(hj[-1:]), pdec.logits(hp[-1:])
            assert (lp - lj).abs().max().item() <= 1e-6


def test_oracle_trees_bit_equal(model_dir):
    """The port's checkpoint -> oracle-tree mapping gives the JAX tool's
    tree leaf for leaf, bit for bit."""
    cfg = jax_tiny()
    ref = jax_fc.oracle_tree_from_checkpoint(
        str(model_dir), cfg.encoder.n_layers, cfg.decoder.n_layers)
    port = oracle.oracle_tree_from_checkpoint(
        str(model_dir), cfg.encoder.n_layers, cfg.decoder.n_layers)

    def walk(a, b, path=""):
        assert isinstance(a, dict) == isinstance(b, dict), path
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            a = a.numpy()
            assert a.dtype == b.dtype == np.float32, path
            assert a.shape == b.shape and np.array_equal(a, b), path

    walk(port, ref)


def _run(argv, cfg):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fidelity_check.main(argv, cfg=cfg)
    return rc, out.getvalue(), err.getvalue()


def test_fidelity_passes_on_a_sound_checkpoint(model_dir):
    """float32 on both sides: every one of the >= 50 steps agrees, the
    adapter rows within the gate; exit 0."""
    rc, out, err = _run([str(model_dir), "7", "--device", "cpu"],
                        tiny_config(**CFG))
    assert rc == 0, err[-2000:]
    line = out.strip().splitlines()[-1]
    assert line.startswith("FIDELITY PASS: ") and line.endswith(
        " exact, 0 near-tie flips")
    agree, n = map(int, line.split(": ")[1].split(" ")[0].split("/"))
    assert agree == n >= fidelity_check.MIN_STEPS
    assert "adapter rel err: max" in err


def test_fidelity_fails_when_the_loader_swaps_two_layers_wo(model_dir,
                                                            monkeypatch):
    """The fault the check exists for: the engine's loader puts decoder
    layer 0's attention.wo where layer 1's belongs and the reverse.  The
    oracle maps the checkpoint on its own, so the argmaxes part: FAIL under
    the unchanged gates (81 of 99 steps agree, 18 flips that are not
    near-ties), exit 1.  (On this random tiny model the attention scores
    are near-uniform, so a swap of wq alone, or of the FFN matrices, moves
    no argmax; wo and the whole wqkv do.)"""
    real = params_mod.load_params

    def miswired(*a, **k):
        p = real(*a, **k)
        wo = p["decoder"]["layers"]["wo"]
        wo[[0, 1]] = wo[[1, 0]].clone()
        return p

    monkeypatch.setattr(params_mod, "load_params", miswired)
    rc, out, err = _run([str(model_dir), "7", "--device", "cpu"],
                        tiny_config(**CFG))
    assert rc == 1
    line = out.strip().splitlines()[-1]
    assert line.startswith("FIDELITY FAIL: ")
    agree, n = map(int, line.split(": ")[1].split(" ")[0].split("/"))
    assert n >= fidelity_check.MIN_STEPS
    assert agree / n < fidelity_check.MIN_EXACT_AGREE
    assert "flip @step" in err


def test_fidelity_check_refuses_without_cuda(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run([str(model_dir)], tiny_config(**CFG))
    assert rc == 1 and out == ""
    assert "no CUDA device; pass --device cpu to run on the CPU" in err


def test_exact_f32_restores_the_tf32_flags():
    """The oracle's TF32 switch is scoped: inside exact_f32("cuda") both
    process-wide flags are off (and the oracle's check passes), on exit
    they are what they were; outside it the check refuses TF32.  The flags
    are plain settings, so this runs without a card."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    try:
        mm.allow_tf32 = dnn.allow_tf32 = True
        with oracle.exact_f32("cuda"):
            assert not mm.allow_tf32 and not dnn.allow_tf32
            oracle._check_f32("cuda")
        assert mm.allow_tf32 and dnn.allow_tf32
        with pytest.raises(RuntimeError, match="TF32"):
            oracle._check_f32("cuda")
        oracle._check_f32("cpu")
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved
