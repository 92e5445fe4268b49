"""Parameter trees: seeded random init, conversion from the JAX package's
tree, and safetensors loading (real model).

Layout (the engine's, shared with voxtral_tpu/models/params.py):
  - Linear weights keep the checkpoint's [out_dim, in_dim] layout.
  - Per-layer weights are stacked on axis 0 ([L, ...]).
  - QKV is merged into one [q+k+v, in] matrix; the encoder's merged bias
    holds zeros in the k segment (the checkpoint has q and v biases only).
  - w1/w3 are merged into [2*hidden, in] ([gate; up]).
  - Conv stem weights are im2col matrices [K*C_in, C_out].
  - Norm weights and biases stay float32.

Parameters are a plain nested dict of tensors on one device.

Reference tensor names: voxtral_encoder.c:50-117, voxtral_decoder.c:49-108,
voxtral.c:102-110, python_simple_implementation.py:355-513.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Any

import numpy as np
import torch

from ..config import VoxtralConfig
from ..io.safetensors import SafetensorsFile

PyTree = Any

ENC_PREFIX = "mm_streams_embeddings.embedding_module.whisper_encoder"
MM_PREFIX = "mm_streams_embeddings.embedding_module"


# ---------------------------------------------------------------------------
# Random init (tests / benchmarks without the real checkpoint)
# ---------------------------------------------------------------------------

def _rand(gen, shape, dtype, device, scale=None):
    """N(0, 1/fan_in) (fan-in is the last axis of an [out, in] weight)."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-1])
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def _rand_stack(gen, n, shape, dtype, device, scale=None):
    """[n, *shape] filled one layer at a time, so the f32 temporary is one
    layer (a whole full-width decoder w13 stack in f32 would be 5.9 GB)."""
    out = torch.empty((n, *shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = _rand(gen, shape, dtype, device, scale)
    return out


def init_encoder_params(cfg: VoxtralConfig, gen, device) -> PyTree:
    e = cfg.encoder
    pd = cfg.pdtype
    L = e.n_layers
    qkv = 3 * e.qkv_dim
    f32 = dict(dtype=torch.float32, device=device)
    bqkv = torch.zeros((L, qkv), **f32)
    bqkv[:, : e.qkv_dim] = 0.01            # q bias
    bqkv[:, 2 * e.qkv_dim:] = -0.01        # v bias (k segment stays zero)
    return {
        "conv0_w": _rand(gen, (e.conv_kernel * e.n_mel, e.dim), pd, device),
        "conv0_b": torch.zeros((e.dim,), **f32),
        "conv1_w": _rand(gen, (e.conv_kernel * e.dim, e.dim), pd, device),
        "conv1_b": torch.zeros((e.dim,), **f32),
        "layers": {
            "attn_norm": torch.ones((L, e.dim), **f32),
            "wqkv": _rand_stack(gen, L, (qkv, e.dim), pd, device),
            "bqkv": bqkv,
            "wo": _rand_stack(gen, L, (e.dim, e.qkv_dim), pd, device),
            "bo": torch.zeros((L, e.dim), **f32),
            "ffn_norm": torch.ones((L, e.dim), **f32),
            "w13": _rand_stack(gen, L, (2 * e.hidden, e.dim), pd, device),
            "w2": _rand_stack(gen, L, (e.dim, e.hidden), pd, device),
            "b2": torch.zeros((L, e.dim), **f32),
        },
        "final_norm": torch.ones((e.dim,), **f32),
    }


def init_adapter_params(cfg: VoxtralConfig, gen, device) -> PyTree:
    e, d = cfg.encoder, cfg.decoder
    return {
        "w0": _rand(gen, (cfg.adapter_hidden, 4 * e.dim), cfg.pdtype, device),
        "w1": _rand(gen, (d.dim, cfg.adapter_hidden), cfg.pdtype, device),
    }


def init_decoder_params(cfg: VoxtralConfig, gen, device) -> PyTree:
    d = cfg.decoder
    pd = cfg.pdtype
    L = d.n_layers
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "tok_embeddings": _rand(gen, (d.vocab_size, d.dim), pd, device,
                                scale=0.02),
        "layers": {
            "attn_norm": torch.ones((L, d.dim), **f32),
            "wqkv": _rand_stack(gen, L, (d.q_dim + 2 * d.kv_dim, d.dim), pd,
                                device),
            "wo": _rand_stack(gen, L, (d.dim, d.q_dim), pd, device),
            "ffn_norm": torch.ones((L, d.dim), **f32),
            "w13": _rand_stack(gen, L, (2 * d.hidden, d.dim), pd, device),
            "w2": _rand_stack(gen, L, (d.dim, d.hidden), pd, device),
            "ada_down": _rand_stack(gen, L, (d.ada_dim, d.dim), pd, device),
            "ada_up": _rand_stack(gen, L, (d.dim, d.ada_dim), pd, device,
                                  scale=0.02),
        },
        "final_norm": torch.ones((d.dim,), **f32),
    }


@torch.no_grad()
def init_params(cfg: VoxtralConfig, seed: int = 0, device="cpu") -> PyTree:
    """Seeded random weights in the engine layout, made on `device` with a
    torch.Generator (they differ from the JAX package's init_params; use
    from_jax_numpy to run both packages on the same weights)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "encoder": init_encoder_params(cfg, gen, device),
        "adapter": init_adapter_params(cfg, gen, device),
        "decoder": init_decoder_params(cfg, gen, device),
    }


# ---------------------------------------------------------------------------
# From the JAX package's tree (tests)
# ---------------------------------------------------------------------------

def _np_to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes, as JAX hands it out
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_numpy(tree: PyTree, device="cpu") -> PyTree:
    """The JAX parameter tree with numpy leaves (e.g. `jax.tree.map(
    np.asarray, params)`) -> the same nested dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    return _np_to_torch(np.asarray(tree)).to(device)


# ---------------------------------------------------------------------------
# Safetensors loading
# ---------------------------------------------------------------------------

def _linear(sf: SafetensorsFile, name: str, dtype) -> torch.Tensor:
    """torch Linear [out, in] — kept as-is."""
    return sf.get_tensor(name).to(dtype)


def _conv_im2col(w: torch.Tensor, dtype) -> torch.Tensor:
    """torch Conv1d [C_out, C_in, K] -> [K*C_in, C_out] so a window flattened
    as (k-major, channel-minor) left-multiplies it."""
    c_out, c_in, k = w.shape
    return w.float().permute(2, 1, 0).reshape(k * c_in, c_out).contiguous().to(dtype)


def _f32(sf: SafetensorsFile, name: str) -> torch.Tensor:
    return torch.from_numpy(np.array(sf.get_f32(name), dtype=np.float32))


class _Stacker:
    """Fills preallocated [L, ...] device tensors one checkpoint tensor at a
    time (host peak stays one tensor)."""

    def __init__(self, n_layers: int, device):
        self.n = n_layers
        self.device = device
        self.bufs: dict[str, torch.Tensor] = {}

    def put(self, name: str, i: int, *parts: torch.Tensor, dtype=None):
        """Copy `parts` (concatenated on axis 0) into slot i of `name`."""
        total0 = sum(p.shape[0] for p in parts)
        buf = self.bufs.get(name)
        if buf is None:
            buf = torch.empty((self.n, total0, *parts[0].shape[1:]),
                              dtype=dtype or parts[0].dtype, device=self.device)
            self.bufs[name] = buf
        o = 0
        for part in parts:
            buf[i, o: o + part.shape[0]] = part.to(self.device)
            o += part.shape[0]


def load_encoder_params(sf: SafetensorsFile, cfg: VoxtralConfig, device) -> PyTree:
    e = cfg.encoder
    pd = cfg.pdtype
    p = ENC_PREFIX
    st = _Stacker(e.n_layers, device)
    for i in range(e.n_layers):
        lp = f"{p}.transformer.layers.{i}"
        st.put(
            "wqkv", i,
            _linear(sf, f"{lp}.attention.wq.weight", pd),
            _linear(sf, f"{lp}.attention.wk.weight", pd),
            _linear(sf, f"{lp}.attention.wv.weight", pd),
        )
        bq = _f32(sf, f"{lp}.attention.wq.bias")
        st.put("bqkv", i, bq, torch.zeros_like(bq),
               _f32(sf, f"{lp}.attention.wv.bias"))
        st.put("wo", i, _linear(sf, f"{lp}.attention.wo.weight", pd))
        st.put("bo", i, _f32(sf, f"{lp}.attention.wo.bias"))
        st.put("attn_norm", i, _f32(sf, f"{lp}.attention_norm.weight"))
        st.put("ffn_norm", i, _f32(sf, f"{lp}.ffn_norm.weight"))
        st.put(
            "w13", i,
            _linear(sf, f"{lp}.feed_forward.w1.weight", pd),
            _linear(sf, f"{lp}.feed_forward.w3.weight", pd),
        )
        st.put("w2", i, _linear(sf, f"{lp}.feed_forward.w2.weight", pd))
        st.put("b2", i, _f32(sf, f"{lp}.feed_forward.w2.bias"))
    return {
        "conv0_w": _conv_im2col(
            sf.get_tensor(f"{p}.conv_layers.0.conv.weight"), pd).to(device),
        "conv0_b": _f32(sf, f"{p}.conv_layers.0.conv.bias").to(device),
        "conv1_w": _conv_im2col(
            sf.get_tensor(f"{p}.conv_layers.1.conv.weight"), pd).to(device),
        "conv1_b": _f32(sf, f"{p}.conv_layers.1.conv.bias").to(device),
        "layers": st.bufs,
        "final_norm": _f32(sf, f"{p}.transformer.norm.weight").to(device),
    }


def load_adapter_params(sf: SafetensorsFile, cfg: VoxtralConfig, device) -> PyTree:
    pd = cfg.pdtype
    return {
        "w0": _linear(sf, f"{MM_PREFIX}.audio_language_projection.0.weight",
                      pd).to(device),
        "w1": _linear(sf, f"{MM_PREFIX}.audio_language_projection.2.weight",
                      pd).to(device),
    }


def load_decoder_params(sf: SafetensorsFile, cfg: VoxtralConfig, device) -> PyTree:
    d = cfg.decoder
    pd = cfg.pdtype
    st = _Stacker(d.n_layers, device)
    for i in range(d.n_layers):
        lp = f"layers.{i}"
        st.put(
            "wqkv", i,
            _linear(sf, f"{lp}.attention.wq.weight", pd),
            _linear(sf, f"{lp}.attention.wk.weight", pd),
            _linear(sf, f"{lp}.attention.wv.weight", pd),
        )
        st.put("wo", i, _linear(sf, f"{lp}.attention.wo.weight", pd))
        st.put("attn_norm", i, _f32(sf, f"{lp}.attention_norm.weight"))
        st.put("ffn_norm", i, _f32(sf, f"{lp}.ffn_norm.weight"))
        st.put(
            "w13", i,
            _linear(sf, f"{lp}.feed_forward.w1.weight", pd),
            _linear(sf, f"{lp}.feed_forward.w3.weight", pd),
        )
        st.put("w2", i, _linear(sf, f"{lp}.feed_forward.w2.weight", pd))
        st.put("ada_down", i, _linear(sf, f"{lp}.ada_rms_norm_t_cond.0.weight", pd))
        st.put("ada_up", i, _linear(sf, f"{lp}.ada_rms_norm_t_cond.2.weight", pd))
    return {
        "tok_embeddings": _linear(sf, f"{MM_PREFIX}.tok_embeddings.weight",
                                  pd).to(device),
        "layers": st.bufs,
        "final_norm": _f32(sf, "norm.weight").to(device),
    }


@torch.no_grad()
def load_params(model_dir: str, cfg: VoxtralConfig, device="cpu",
                verbose: bool = False) -> PyTree:
    """consolidated.safetensors (the reference's names and layouts) -> the
    engine tree on `device`, one stacked tensor at a time."""
    device = torch.device(device)
    t0 = time.monotonic()

    def log(msg):
        if verbose:
            print(f"  load: {msg} (+{time.monotonic() - t0:.1f}s)",
                  file=sys.stderr)

    sf = SafetensorsFile(os.path.join(model_dir, "consolidated.safetensors"))
    log("header parsed")
    enc = load_encoder_params(sf, cfg, device)
    log(f"encoder on {device}")
    ada = load_adapter_params(sf, cfg, device)
    dec = load_decoder_params(sf, cfg, device)
    log(f"decoder on {device}")
    return {"encoder": enc, "adapter": ada, "decoder": dec}
