"""Seeded weights of a configuration, made on the device in the program's
parameter layout.

The benchmark makes the weights itself and hands the same tensors to the
program and (made again from the seed, once the program is gone) to the
reference.  Layout: linear weights [out, in], per-layer weights stacked on
axis 0, QKV merged into one [q + k + v, in] matrix (the encoder's merged
bias zero on its k part), w1 and w3 merged as [gate; up], the conv stem as
im2col matrices [kernel * in, out], norms and biases float32.

Each tensor is one normal draw in the serving dtype on the device from one
torch.Generator: N(0, 1 / fan_in), the tied embedding table and ada_up at
0.02.  Norm weights are ones; the encoder's q bias 0.01 and v bias -0.01,
the other biases zero (the distributions of the program's own seeded
init, `voxtral_tpu_torch/models/params.py`, drawn in fewer calls).
"""

from __future__ import annotations

import math

import torch


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@torch.no_grad()
def make_params(model: dict, seed: int, device) -> dict:
    """The weight tree of `model` (a configuration file's dict) drawn from
    `seed` on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pd = _dtype(model["param_dtype"])
    f32 = dict(dtype=torch.float32, device=device)

    def normal(shape, fan_in, std=None):
        x = torch.empty(shape, dtype=pd, device=device)
        return x.normal_(0.0, std or 1.0 / math.sqrt(fan_in), generator=gen)

    e, d = model["encoder"], model["decoder"]
    le, ld = e["n_layers"], d["n_layers"]
    qkv = e["n_heads"] * e["head_dim"]
    k = e["conv_kernel"]
    bqkv = torch.zeros((le, 3 * qkv), **f32)
    bqkv[:, :qkv] = 0.01
    bqkv[:, 2 * qkv:] = -0.01
    enc = {
        "conv0_w": normal((k * e["n_mel"], e["dim"]), k * e["n_mel"]),
        "conv0_b": torch.zeros((e["dim"],), **f32),
        "conv1_w": normal((k * e["dim"], e["dim"]), k * e["dim"]),
        "conv1_b": torch.zeros((e["dim"],), **f32),
        "layers": {
            "attn_norm": torch.ones((le, e["dim"]), **f32),
            "wqkv": normal((le, 3 * qkv, e["dim"]), e["dim"]),
            "bqkv": bqkv,
            "wo": normal((le, e["dim"], qkv), qkv),
            "bo": torch.zeros((le, e["dim"]), **f32),
            "ffn_norm": torch.ones((le, e["dim"]), **f32),
            "w13": normal((le, 2 * e["hidden"], e["dim"]), e["dim"]),
            "w2": normal((le, e["dim"], e["hidden"]), e["hidden"]),
            "b2": torch.zeros((le, e["dim"]), **f32),
        },
        "final_norm": torch.ones((e["dim"],), **f32),
    }
    ah = model["adapter_hidden"]
    down = model["downsample"] * e["dim"]
    adapter = {"w0": normal((ah, down), down),
               "w1": normal((d["dim"], ah), ah)}
    q = d["n_heads"] * d["head_dim"]
    kv = d["n_kv_heads"] * d["head_dim"]
    dec = {
        "tok_embeddings": normal((d["vocab_size"], d["dim"]), 0, std=0.02),
        "layers": {
            "attn_norm": torch.ones((ld, d["dim"]), **f32),
            "wqkv": normal((ld, q + 2 * kv, d["dim"]), d["dim"]),
            "wo": normal((ld, d["dim"], q), q),
            "ffn_norm": torch.ones((ld, d["dim"]), **f32),
            "w13": normal((ld, 2 * d["hidden"], d["dim"]), d["dim"]),
            "w2": normal((ld, d["dim"], d["hidden"]), d["hidden"]),
            "ada_down": normal((ld, d["ada_dim"], d["dim"]), d["dim"]),
            "ada_up": normal((ld, d["dim"], d["ada_dim"]), 0, std=0.02),
        },
        "final_norm": torch.ones((d["dim"],), **f32),
    }
    return {"encoder": enc, "adapter": adapter, "decoder": dec}
