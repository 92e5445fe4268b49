"""The port's checkpoint tools (voxtral_tpu_torch/tools make_fake_ckpt and
inspect_weights) against the JAX package's (tools/): the same tensor specs
at tiny and full width, the same file bytes at one seed, bf16 bits equal
to ml_dtypes', trees loaded bit-equal by both loaders, the tekken.json
read alike by both tokenizers, and the same inspect_weights report."""

import contextlib
import io
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from voxtral_tpu.config import full_config as jax_full
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.models.params import load_params as jax_load
from voxtral_tpu.tokenizer import TekkenTokenizer as JaxTok
from voxtral_tpu_torch.config import full_config, tiny_config
from voxtral_tpu_torch.models.params import load_params
from voxtral_tpu_torch.tokenizer import TekkenTokenizer
from voxtral_tpu_torch.tools import inspect_weights, make_fake_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_fake_ckpt as jax_mk  # noqa: E402  (the JAX package's tool)

torch.set_num_threads(1)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_tensor_specs_equal_jax(which):
    """Names, shapes and dtypes in the reference checkpoint's order."""
    cfg, jcfg = ((tiny_config(), jax_tiny()) if which == "tiny"
                 else (full_config(), jax_full()))
    port = make_fake_ckpt.tensor_specs(cfg)
    ref = jax_mk.tensor_specs(jcfg)
    assert [(n, tuple(s), d) for n, s, d in port] == \
        [(n, tuple(s), np.dtype(d).name) for n, s, d in ref]
    if which == "full":
        # 8.9 GB of tensor data, the figure the tools print
        assert make_fake_ckpt.checkpoint_bytes(port) == sum(
            int(np.prod(s)) * np.dtype(d).itemsize for _, s, d in ref)


def test_bf16_bits_equal_ml_dtypes():
    """Round to nearest even, ties both ways, subnormals, signed zeros,
    the largest finite values, infinities: the bits equal ml_dtypes'."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32) * 0.02,
        rng.standard_normal(10_000).astype(np.float32) * 1e30,
        (rng.integers(0, 2**32, 100_000, dtype=np.uint64)
         .astype(np.uint32).view(np.float32)),
        np.array([0.0, -0.0, np.inf, -np.inf, 3.4e38, -3.4e38, 1e-40, -1e-45],
                 np.float32),
        # exact ties at the bf16 rounding point, even and odd mantissas
        (np.arange(0x3F800000, 0x3F800000 + 2**18, 2**15, dtype=np.uint32)
         + 0x8000).view(np.float32),
    ])
    x = x[~np.isnan(x)]                        # NaN payloads aside
    assert np.array_equal(make_fake_ckpt.bf16_bits(x),
                          x.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_written_checkpoint_equals_jax_bytes(tmp_path):
    """One seed, one stream of draws, one rounding: the port writes the
    JAX tool's file byte for byte."""
    specs = make_fake_ckpt.tensor_specs(tiny_config())
    make_fake_ckpt.write_streaming(str(tmp_path / "port.safetensors"),
                                   specs, seed=3)
    jax_mk.write_streaming(str(tmp_path / "jax.safetensors"),
                           jax_mk.tensor_specs(jax_tiny()), seed=3)
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "jax.safetensors").read_bytes()


def _np_bits(x):
    """A leaf as comparable numpy bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return (x.view(torch.uint16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_bit_equal_in_both_packages(tmp_path,
                                                          compute_dtype):
    """The port's main() writes the marker, tokenizer and tensors; the
    tensors load through the JAX package's loader and the port's into
    trees with the same leaves, bit for bit."""
    cfg = tiny_config(compute_dtype=compute_dtype)
    jcfg = jax_tiny(compute_dtype=compute_dtype)
    assert make_fake_ckpt.main([str(tmp_path), "5"], cfg=cfg) == 0
    assert sorted(os.listdir(tmp_path)) == [
        "SYNTHETIC", "consolidated.safetensors", "tekken.json"]
    port = dict(_leaves(load_params(str(tmp_path), cfg, device="cpu")))
    ref = dict(_leaves(jax_load(str(tmp_path), jcfg)))
    assert port.keys() == ref.keys()
    for k in ref:
        a, b = _np_bits(port[k]), _np_bits(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def test_tekken_json_round_trips_through_both_tokenizers(tmp_path):
    """The full 131072-token vocabulary the tool writes: both tokenizers
    read it alike (sizes, every token's bytes, decoded text)."""
    path = str(tmp_path / "tekken.json")
    make_fake_ckpt.write_tekken(path, full_config().decoder.vocab_size)
    port, ref = TekkenTokenizer.load(path), JaxTok.load(path)
    assert port.vocab_size == ref.vocab_size == 131072
    for tid in list(range(1000, 1300)) + list(range(131000, 131072)):
        assert port.token_bytes(tid) == ref.token_bytes(tid), tid
        assert port.decode(tid) == ref.decode(tid), tid
    ids = list(np.random.default_rng(1).integers(1000, 131072, 200))
    assert port.decode_seq(ids) == ref.decode_seq(ids)
    assert port.token_bytes(1000 + 65) == b"A"


def test_inspect_weights_prints_as_the_jax_tool(tmp_path):
    """The same stdout and stderr, on the whole file and with --prefix."""
    cfg = tiny_config()
    make_fake_ckpt.write_streaming(str(tmp_path / "consolidated.safetensors"),
                                   make_fake_ckpt.tensor_specs(cfg), seed=0)
    for extra in ([], ["--prefix", "layers.1."]):
        ref = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "inspect_weights.py"),
             str(tmp_path)] + extra,
            capture_output=True, text=True, timeout=120)
        assert ref.returncode == 0, ref.stderr[-500:]
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert inspect_weights.main([str(tmp_path)] + extra) == 0
        assert out.getvalue() == ref.stdout
        assert err.getvalue() == ref.stderr
        assert "bfloat16" in out.getvalue() and "TOTAL" in err.getvalue()
