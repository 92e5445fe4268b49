"""Independent float32 oracle of the model, for the fidelity check.

The port's own copy of tests/oracle.py (whose module the port cannot
import: it reads the JAX package's config) and of
tools/fidelity_check.py's checkpoint mapping, on the port's config.  It is
written from the model spec as a straightforward full-sequence
implementation: naive concatenated KV truncated to the window, dense
masks, conv1d for the stem.  It shares no code with the engine
(voxtral_tpu_torch/models, voxtral_tpu_torch/ops): its value is that a
wiring or numerics fault of the engine is not mirrored here.  Only the
safetensors reader (io/safetensors.py) is shared, as in the JAX tool.

Parameters are the engine's tree layout ([out, in] matrices, merged QKV
and w13, stacked layers), built from the checkpoint by
`oracle_tree_from_checkpoint`'s own name mapping.  Everything runs in
float32 on the device of the tree; on a CUDA device every computation
checks that TF32 is off for cuBLAS and cuDNN (the conv stem runs through
F.conv1d): its caller runs it inside `exact_f32`, which switches both off
and back.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DOWNSAMPLE_FACTOR, VoxtralConfig

ENC_PREFIX = "mm_streams_embeddings.embedding_module.whisper_encoder"
MM_PREFIX = "mm_streams_embeddings.embedding_module"


@contextlib.contextmanager
def exact_f32(device):
    """float32 products stay float32 on `device` for the duration: on CUDA,
    TF32 off for cuBLAS and cuDNN, checked off, and both process-wide flags
    set back to what they were on exit.  Every oracle computation on CUDA
    runs inside it (`_check_f32`)."""
    if torch.device(device).type != "cuda":
        yield
        return
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        _check_f32(device)
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def _check_f32(device) -> None:
    """Raise unless TF32 is off for cuBLAS and cuDNN (on CUDA)."""
    if torch.device(device).type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("oracle: TF32 is on for cuBLAS or cuDNN (run the "
                           "oracle inside exact_f32)")


def _device(tree) -> torch.device:
    """The device of the first tensor leaf of `tree` (CPU for numpy)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device if isinstance(tree, torch.Tensor) else torch.device("cpu")


def t32(x, device) -> torch.Tensor:
    """`x` (a tensor or an array) as a float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


# ---------------------------------------------------------------------------
# Common blocks
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    rms = torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return x * rms * w


def rope_apply(x, positions, n_heads, head_dim, theta):
    """Interleaved RoPE. x: [T, n_heads*head_dim]."""
    t = x.shape[0]
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=x.device)
                             .float() / head_dim))
    angles = positions.float().unsqueeze(-1) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)      # [T, hd/2]
    x = x.view(t, n_heads, head_dim)
    x1, x2 = x[..., ::2], x[..., 1::2]
    c, s = cos.unsqueeze(1), sin.unsqueeze(1)
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.stack([o1, o2], dim=-1).flatten(-2).view(t, n_heads * head_dim)


def windowed_attention(q, k, v, n_heads, n_kv_heads, head_dim, window,
                       q_start, kv_start):
    sq, skv = q.shape[0], k.shape[0]
    g = n_heads // n_kv_heads
    q = q.view(sq, n_heads, head_dim).transpose(0, 1)
    k = k.view(skv, n_kv_heads, head_dim).transpose(0, 1)
    v = v.view(skv, n_kv_heads, head_dim).transpose(0, 1)
    if g > 1:
        k = k.repeat_interleave(g, dim=0)
        v = v.repeat_interleave(g, dim=0)
    qi = (q_start + torch.arange(sq, device=q.device)).unsqueeze(1)
    kj = (kv_start + torch.arange(skv, device=q.device)).unsqueeze(0)
    mask = (kj <= qi) & (kj >= qi - (window - 1))
    scores = (q @ k.transpose(1, 2)) / math.sqrt(head_dim)
    scores = scores.masked_fill(~mask.unsqueeze(0), float("-inf"))
    probs = scores.softmax(dim=-1)
    out = probs @ v                                       # [nh, sq, hd]
    return out.transpose(0, 1).reshape(sq, n_heads * head_dim)


# ---------------------------------------------------------------------------
# Conv stem, encoder, adapter
# ---------------------------------------------------------------------------

@torch.no_grad()
def oracle_conv_stem(enc_params, cfg: VoxtralConfig, mel) -> torch.Tensor:
    """mel [F, 128] -> [F // 2, 1280] through conv1d with causal padding.
    The tree's conv weights are im2col [K*C_in, C_out]; unpacked here."""
    e = cfg.encoder
    k = e.conv_kernel
    dev = _device(enc_params)
    _check_f32(dev)

    def unpack(w_im2col, c_in, c_out):
        w = t32(w_im2col, dev).view(k, c_in, c_out)      # [K, Cin, Cout]
        return w.permute(2, 1, 0)                         # [Cout, Cin, K]

    w0 = unpack(enc_params["conv0_w"], e.n_mel, e.dim)
    b0 = t32(enc_params["conv0_b"], dev)
    w1 = unpack(enc_params["conv1_w"], e.dim, e.dim)
    b1 = t32(enc_params["conv1_b"], dev)

    x = t32(mel, dev).T.unsqueeze(0)                      # [1, 128, F]
    x = F.pad(x, (k - 1, 0))
    h = F.gelu(F.conv1d(x, w0, b0, stride=1))
    h = F.pad(h, (k - 2, 0))
    h = F.gelu(F.conv1d(h, w1, b1, stride=2))
    return h.squeeze(0).T                                 # [F//2, 1280]


@torch.no_grad()
def oracle_encoder(enc_params, cfg: VoxtralConfig, x) -> torch.Tensor:
    """Full-sequence encoder transformer on post-conv positions [S, dim]."""
    e = cfg.encoder
    dev = _device(enc_params)
    _check_f32(dev)
    h = t32(x, dev)
    s = h.shape[0]
    positions = torch.arange(s, device=dev)
    lp = enc_params["layers"]
    qkv_dim = e.qkv_dim
    for i in range(e.n_layers):
        xn = rms_norm(h, t32(lp["attn_norm"][i], dev), e.norm_eps)
        qkv = F.linear(xn, t32(lp["wqkv"][i], dev), t32(lp["bqkv"][i], dev))
        q, k, v = (qkv[:, :qkv_dim], qkv[:, qkv_dim:2 * qkv_dim],
                   qkv[:, 2 * qkv_dim:])
        q = rope_apply(q, positions, e.n_heads, e.head_dim, e.rope_theta)
        k = rope_apply(k, positions, e.n_kv_heads, e.head_dim, e.rope_theta)
        attn = windowed_attention(
            q, k, v, e.n_heads, e.n_kv_heads, e.head_dim, e.window, 0, 0
        )
        h = h + F.linear(attn, t32(lp["wo"][i], dev), t32(lp["bo"][i], dev))
        hn = rms_norm(h, t32(lp["ffn_norm"][i], dev), e.norm_eps)
        g13 = F.linear(hn, t32(lp["w13"][i], dev))
        gate = F.silu(g13[:, : e.hidden]) * g13[:, e.hidden:]
        h = h + F.linear(gate, t32(lp["w2"][i], dev), t32(lp["b2"][i], dev))
    return rms_norm(h, t32(enc_params["final_norm"], dev), e.norm_eps)


@torch.no_grad()
def oracle_adapter(adapter_params, cfg: VoxtralConfig, enc_out) -> torch.Tensor:
    dev = _device(adapter_params)
    _check_f32(dev)
    x = t32(enc_out, dev)
    s = x.shape[0]
    ds = x.reshape(s // DOWNSAMPLE_FACTOR, DOWNSAMPLE_FACTOR * cfg.encoder.dim)
    h = F.gelu(F.linear(ds, t32(adapter_params["w0"], dev)))
    return F.linear(h, t32(adapter_params["w1"], dev))


# ---------------------------------------------------------------------------
# Decoder (naive concatenated KV truncated to the window)
# ---------------------------------------------------------------------------

class OracleDecoder:
    def __init__(self, dec_params, cfg: VoxtralConfig):
        self.p = dec_params
        self.cfg = cfg
        self.kv = {}
        self.dev = dev = _device(dec_params)
        _check_f32(dev)
        d = cfg.decoder
        half = d.dim // 2
        inv = torch.exp(-math.log(d.ada_theta)
                        * torch.arange(half, device=dev).float() / half)
        emb = float(cfg.delay_tokens) * inv
        t_cond = torch.cat([emb.cos(), emb.sin()])
        lp = dec_params["layers"]
        self.ada = []
        for i in range(d.n_layers):
            hidden = F.gelu(F.linear(t_cond, t32(lp["ada_down"][i], dev)))
            self.ada.append(F.linear(hidden, t32(lp["ada_up"][i], dev)))

    @torch.no_grad()
    def forward(self, embeds: torch.Tensor, pos: int) -> torch.Tensor:
        d = self.cfg.decoder
        dev = self.dev
        _check_f32(dev)
        lp = self.p["layers"]
        h = t32(embeds, dev)
        seq = h.shape[0]
        positions = torch.arange(pos, pos + seq, device=dev)
        for i in range(d.n_layers):
            xn = rms_norm(h, t32(lp["attn_norm"][i], dev), d.norm_eps)
            qkv = F.linear(xn, t32(lp["wqkv"][i], dev))
            q = qkv[:, : d.q_dim]
            k = qkv[:, d.q_dim: d.q_dim + d.kv_dim]
            v = qkv[:, d.q_dim + d.kv_dim:]
            q = rope_apply(q, positions, d.n_heads, d.head_dim, d.rope_theta)
            k = rope_apply(k, positions, d.n_kv_heads, d.head_dim,
                           d.rope_theta)
            if i in self.kv:
                kc, vc = self.kv[i]
                kc = torch.cat([kc, k], dim=0)
                vc = torch.cat([vc, v], dim=0)
            else:
                kc, vc = k, v
            if kc.shape[0] > d.window:
                kc, vc = kc[-d.window:], vc[-d.window:]
            self.kv[i] = (kc, vc)
            kv_start = (pos + seq - 1) - (kc.shape[0] - 1)
            attn = windowed_attention(
                q, kc, vc, d.n_heads, d.n_kv_heads, d.head_dim, d.window,
                pos, kv_start,
            )
            h = h + F.linear(attn, t32(lp["wo"][i], dev))
            hn = rms_norm(h, t32(lp["ffn_norm"][i], dev), d.norm_eps)
            hn = hn * (1.0 + self.ada[i])
            g13 = F.linear(hn, t32(lp["w13"][i], dev))
            gate = F.silu(g13[:, : d.hidden]) * g13[:, d.hidden:]
            h = h + F.linear(gate, t32(lp["w2"][i], dev))
        return h

    @torch.no_grad()
    def logits(self, h_last: torch.Tensor) -> torch.Tensor:
        d = self.cfg.decoder
        _check_f32(self.dev)
        xn = rms_norm(h_last, t32(self.p["final_norm"], self.dev), d.norm_eps)
        return xn @ t32(self.p["tok_embeddings"], self.dev).T


# ---------------------------------------------------------------------------
# The checkpoint's names -> the oracle's tree (independent of models/params)
# ---------------------------------------------------------------------------

def oracle_tree_from_checkpoint(model_dir: str, n_enc: int = 32,
                                n_dec: int = 26, device="cpu") -> dict:
    """float32 tree in the engine layout on `device`, mapped from the
    checkpoint's names on its own (names per voxtral_encoder.c:50-117,
    voxtral_decoder.c:49-108, voxtral.c:102-110), one tensor at a time
    (host memory holds one tensor, not the tree).  Layer counts are
    parameters so that tests and cut-depth runs read smaller checkpoints."""
    from ..io.safetensors import SafetensorsFile

    dev = torch.device(device)
    sf = SafetensorsFile(os.path.join(model_dir, "consolidated.safetensors"))
    enc_p, mm_p = ENC_PREFIX, MM_PREFIX

    def f32(name):
        return torch.from_numpy(
            np.ascontiguousarray(sf.get_f32(name))).to(dev)

    def stack(fmt, n, merge=(None,)):
        out = None
        for i in range(n):
            parts = [f32(fmt.format(i=i, part=p)) for p in merge]
            x = torch.cat(parts) if len(parts) > 1 else parts[0]
            if out is None:
                out = torch.empty((n, *x.shape), dtype=torch.float32,
                                  device=dev)
            out[i] = x
        return out

    def conv_im2col(name):
        w = f32(name)                       # [C_out, C_in, K]
        c_out, c_in, k = w.shape
        return w.permute(2, 1, 0).reshape(k * c_in, c_out).contiguous()

    el = f"{enc_p}.transformer.layers.{{i}}"
    bq = stack(f"{el}.attention.wq.bias", n_enc)
    bv = stack(f"{el}.attention.wv.bias", n_enc)
    enc = {
        "conv0_w": conv_im2col(f"{enc_p}.conv_layers.0.conv.weight"),
        "conv0_b": f32(f"{enc_p}.conv_layers.0.conv.bias"),
        "conv1_w": conv_im2col(f"{enc_p}.conv_layers.1.conv.weight"),
        "conv1_b": f32(f"{enc_p}.conv_layers.1.conv.bias"),
        "layers": {
            "attn_norm": stack(f"{el}.attention_norm.weight", n_enc),
            "wqkv": stack(f"{el}.attention.{{part}}.weight", n_enc,
                          merge=("wq", "wk", "wv")),
            "bqkv": torch.cat([bq, torch.zeros_like(bq), bv], dim=1),
            "wo": stack(f"{el}.attention.wo.weight", n_enc),
            "bo": stack(f"{el}.attention.wo.bias", n_enc),
            "ffn_norm": stack(f"{el}.ffn_norm.weight", n_enc),
            "w13": stack(f"{el}.feed_forward.{{part}}.weight", n_enc,
                         merge=("w1", "w3")),
            "w2": stack(f"{el}.feed_forward.w2.weight", n_enc),
            "b2": stack(f"{el}.feed_forward.w2.bias", n_enc),
        },
        "final_norm": f32(f"{enc_p}.transformer.norm.weight"),
    }
    adapter = {
        "w0": f32(f"{mm_p}.audio_language_projection.0.weight"),
        "w1": f32(f"{mm_p}.audio_language_projection.2.weight"),
    }
    dl = "layers.{i}"
    dec = {
        "tok_embeddings": f32(f"{mm_p}.tok_embeddings.weight"),
        "layers": {
            "attn_norm": stack(f"{dl}.attention_norm.weight", n_dec),
            "wqkv": stack(f"{dl}.attention.{{part}}.weight", n_dec,
                          merge=("wq", "wk", "wv")),
            "wo": stack(f"{dl}.attention.wo.weight", n_dec),
            "ffn_norm": stack(f"{dl}.ffn_norm.weight", n_dec),
            "w13": stack(f"{dl}.feed_forward.{{part}}.weight", n_dec,
                         merge=("w1", "w3")),
            "w2": stack(f"{dl}.feed_forward.w2.weight", n_dec),
            "ada_down": stack(f"{dl}.ada_rms_norm_t_cond.0.weight", n_dec),
            "ada_up": stack(f"{dl}.ada_rms_norm_t_cond.2.weight", n_dec),
        },
        "final_norm": f32("norm.weight"),
    }
    return {"encoder": enc, "adapter": adapter, "decoder": dec}
