"""Interleaved (GPT-J style) rotary position embeddings.

Mistral safetensors store Q/K weights in interleaved format per head, so
interleaved RoPE applied to *unpermuted* weights is exact
(python_simple_implementation.py:494-496, MODEL.md:223-227).

RoPE is always computed in float32 (an f32 island inside the bf16 model,
mirroring python_simple_implementation.py:552-559).

`qkv_rope` is the attention layers' whole epilogue of the qkv product in
one call: the bias add, the q/k/v split, the rotation of q and k and the
casts.  On CUDA tensors it is one launch of
`voxtral_tpu_torch/csrc/qkv_rope.cu`; CPU tensors take `qkv_rope_plain`,
the torch sequence the layers ran before, which the kernel equals bit for
bit.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for integer positions.

    positions: int [...], returns (cos, sin) each float32 [..., head_dim//2].
    (python_simple_implementation.py:243-247)
    """
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (0,1),(2,3),... of the last axis.

    x: [..., seq, n_heads, head_dim] (any float dtype; computed in f32)
    cos/sin: [..., seq, head_dim//2] (broadcast over the heads axis)
    (python_simple_implementation.py:249-275, is_neox_style=False branch)
    """
    orig_dtype = x.dtype
    xf = x.float()
    shape = xf.shape
    xf = xf.reshape(*shape[:-1], shape[-1] // 2, 2)
    x1 = xf[..., 0]
    x2 = xf[..., 1]
    c = cos[..., None, :]  # broadcast over heads axis
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(shape)
    return out.to(orig_dtype)


def qkv_rope_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   *, n_heads: int, n_kv_heads: int, head_dim: int,
                   bias: torch.Tensor | None = None, q_dtype: torch.dtype,
                   kv_dtype: torch.dtype):
    """The sequence `qkv_rope` computes, in torch: qkv (+ bias) in f32,
    split into q, k, v, q and k rotated by `apply_rope_interleaved`, q cast
    to q_dtype and k, v to kv_dtype.  Returns (q [B, T, n_heads, D],
    k, v [B, T, n_kv_heads, D]); v without bias in f32 is a view of qkv."""
    bsz, t, _ = qkv.shape
    if bias is not None:
        qkv = qkv + bias
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
    q = qkv[..., :q_dim].reshape(bsz, t, n_heads, head_dim)
    k = qkv[..., q_dim: q_dim + kv_dim].reshape(bsz, t, n_kv_heads, head_dim)
    v = qkv[..., q_dim + kv_dim:].reshape(bsz, t, n_kv_heads, head_dim)
    return (apply_rope_interleaved(q, cos, sin).to(q_dtype),
            apply_rope_interleaved(k, cos, sin).to(kv_dtype), v.to(kv_dtype))


# (q, k/v) out dtypes the kernel has instances for: the bulk encoder's,
# the decoder's and ring encoder's (f32 k, v for the ring writes), the f32
# configurations'
_KERNEL_DTYPES = ((torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32),
                  (torch.float32, torch.float32))
_KERNEL_HEAD_DIMS = (64, 128)
# blocks of the kernel's grid a streaming multiprocessor holds at once
_BLOCKS_PER_SM = 8


def _aligned(t: torch.Tensor | None) -> bool:
    return t is None or t.data_ptr() % 16 == 0


def qkv_rope(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
             n_heads: int, n_kv_heads: int, head_dim: int,
             bias: torch.Tensor | None = None, q_dtype: torch.dtype,
             kv_dtype: torch.dtype):
    """The qkv product's epilogue -> (q, k, v).

    qkv: the product's f32 output [B, T, n_heads * D + 2 * n_kv_heads * D]
    (this rank's heads on a tp mesh); cos, sin: `rope_cos_sin`'s f32
    tables, a row's own [B, T, D/2] or one [T, D/2] shared by the batch;
    bias: f32 [width] or None, added first.  Returns q [B, T, n_heads, D]
    in q_dtype, rotated, and k, v [B, T, n_kv_heads, D] in kv_dtype, k
    rotated; without bias an f32 v is a view of qkv's v columns (no copy).
    On CUDA tensors one kernel launch (the out dtypes of _KERNEL_DTYPES,
    head_dim 64 or 128, 16-byte aligned tensors: the wrapper refuses the
    rest), which may
    start before the stream's previous kernel ends and reads qkv only once
    that kernel's writes are visible; bit-equal to `qkv_rope_plain`, which
    CPU tensors take."""
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
              bias=bias, q_dtype=q_dtype, kv_dtype=kv_dtype)
    if qkv.device.type == "cpu":
        return qkv_rope_plain(qkv, cos, sin, **kw)
    if qkv.device.type != "cuda":
        raise NotImplementedError(f"qkv_rope on {qkv.device}")
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"qkv_rope kernel: head_dim {head_dim} (takes "
                         f"{_KERNEL_HEAD_DIMS})")
    if (q_dtype, kv_dtype) not in _KERNEL_DTYPES:
        raise ValueError(f"qkv_rope kernel: out dtypes {q_dtype}, {kv_dtype} "
                         f"(takes q, k/v in {_KERNEL_DTYPES})")
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
    width = q_dim + 2 * kv_dim
    if (qkv.dtype != torch.float32 or qkv.dim() != 3
            or qkv.shape[-1] != width or not qkv.is_contiguous()):
        raise ValueError(f"qkv_rope kernel: qkv {qkv.dtype} "
                         f"{tuple(qkv.shape)} (needs contiguous f32 [B, T, "
                         f"{width}])")
    bsz, t, _ = qkv.shape
    half = head_dim // 2
    for name, tab in (("cos", cos), ("sin", sin)):
        if (tab.dtype != torch.float32 or tab.device != qkv.device
                or tab.shape not in ((bsz, t, half), (t, half))
                or not tab.is_contiguous()):
            raise ValueError(f"qkv_rope kernel: {name} {tab.dtype} "
                             f"{tuple(tab.shape)} on {tab.device} (needs "
                             f"contiguous f32 [{bsz}, {t}, {half}] or "
                             f"[{t}, {half}] on {qkv.device})")
    if cos.shape != sin.shape:
        raise ValueError(f"qkv_rope kernel: cos {tuple(cos.shape)} and sin "
                         f"{tuple(sin.shape)} differ")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.shape != (width,)
                or bias.device != qkv.device):
            raise ValueError(f"qkv_rope kernel: bias {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device} (needs "
                             f"f32 [{width}] on {qkv.device})")
        bias = bias.contiguous()
    if not all(map(_aligned, (qkv, cos, sin, bias))):
        raise ValueError("qkv_rope kernel: qkv, cos, sin and bias must be "
                         "16-byte aligned")
    dev = qkv.device
    q = torch.empty((bsz, t, n_heads, head_dim), dtype=q_dtype, device=dev)
    k = torch.empty((bsz, t, n_kv_heads, head_dim), dtype=kv_dtype,
                    device=dev)
    if bias is None and kv_dtype == torch.float32:
        v, v_out = qkv[..., q_dim + kv_dim:].reshape(
            bsz, t, n_kv_heads, head_dim), None
    else:
        v = v_out = torch.empty_like(k)
    if bsz * t == 0:
        return q, k, v
    ptr = (lambda x: None if x is None else x.data_ptr())
    err = cuda_lib.kernels().vt_qkv_rope(
        qkv.data_ptr(), ptr(bias), cos.data_ptr(), sin.data_ptr(),
        q.data_ptr(), k.data_ptr(), ptr(v_out), bsz * t, t,
        int(cos.dim() == 2), n_heads, n_kv_heads, head_dim,
        int(q_dtype == torch.bfloat16), int(kv_dtype == torch.bfloat16),
        _BLOCKS_PER_SM * cuda_lib.sm_count(dev), cuda_lib.stream_handle(dev))
    cuda_lib.check(err, "qkv_rope")
    qkv_rope.launches += 1
    return q, k, v


# kernel launches since the last reset (CPU calls never count)
qkv_rope.launches = 0
