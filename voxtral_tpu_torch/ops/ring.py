"""Ring-buffer KV cache + sliding-window GQA attention (the plain path).

The C reference keeps rolling KV caches it compacts with memmove when full
(voxtral_decoder.c:317-347).  Here, as in the JAX package, a fixed-capacity
ring holds position p in slot p % cap.  The logical position of slot s,
given that the last written position is p_end, is

    l(s) = p_end - ((p_end - s) mod cap)        (in (p_end - cap, p_end])

so the sliding-window causal mask for a query at position q is simply

    valid(s) = 0 <= l(s) <= q  and  l(s) > q - window.

RoPE is applied at *logical* positions before the write, so cached K never
needs re-rotation (voxtral_decoder.c:313-316).

Everything is batched-first: rings are [B, KH, cap, D] (one layer) or the
stacked [B, L, KH, cap, D]; positions are int tensors [B], one per stream.
Writes are in-place index writes at modular slots (the JAX package rotates
with concat + dynamic_slice to suit the TPU compiler; that is not needed
here).  The single-row write of a decode step, `ring_rows_write`, is the
hand-written CUDA kernel on CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib


def to_ring_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """Cast rows to a ring dtype, rounding to nearest even; fp8 e4m3fn
    saturates at +-448, as the kernel's __NV_SATFINITE cast does.  The clamp
    keeps that on every torch version: torch 2.13 saturates by itself, but
    torch 2.11's CUDA cast (and the JAX package, through ml_dtypes) turns a
    value past 464 into NaN."""
    if x.dtype == dtype:
        return x
    if dtype == torch.float8_e4m3fn:
        x = x.clamp(-448.0, 448.0)
    return x.to(dtype)


def ring_write(ring: torch.Tensor, vals: torch.Tensor,
               pos0: torch.Tensor) -> torch.Tensor:
    """Write T rows per stream into the ring at slots (pos0 .. pos0+T-1) mod
    cap, IN PLACE (a view of a stacked cache writes through to it).

    ring: [B, KH, cap, D]; vals: [B, T, KH, D]; pos0: int [B] (logical
    position of vals[:, 0]).  When T >= cap only the last cap rows survive,
    as in the JAX ring_write.  Returns `ring`.
    """
    bsz, _, cap, _ = ring.shape
    t = vals.shape[1]
    vals = to_ring_dtype(vals, ring.dtype)
    if t > cap:
        vals = vals[:, t - cap:]
        pos0 = pos0 + (t - cap)
        t = cap
    slots = torch.remainder(
        pos0.reshape(bsz, 1) + torch.arange(t, device=ring.device), cap
    )                                                        # [B, T]
    bidx = torch.arange(bsz, device=ring.device)[:, None].expand(bsz, t)
    ring[bidx, :, slots, :] = vals        # in place; indexed view is [B,T,KH,D]
    return ring


def ring_chunk_write(k_all: torch.Tensor, v_all: torch.Tensor,
                     k_chunk: torch.Tensor, v_chunk: torch.Tensor, li: int,
                     pos0: torch.Tensor):
    """Write a T-row chunk per stream into layer li of the stacked
    [B, L, KH, cap, D] caches at slots (pos0 .. pos0+T-1) mod cap, IN PLACE.

    k_chunk/v_chunk: [B, T, KH, D]; pos0: int [B].  Returns (k_all, v_all,
    k_ring, v_ring), the last two the layer's rings [B, KH, cap, D] as views
    (what attention reads next).  The JAX package's batched form is a
    one-hot matmul blend, a TPU workaround for a per-stream rotate; the
    modular index write gives the same rings bit for bit, T > cap included
    (only the last cap rows survive)."""
    k_ring, v_ring = k_all[:, li], v_all[:, li]
    ring_write(k_ring, k_chunk, pos0)
    ring_write(v_ring, v_chunk, pos0)
    return k_all, v_all, k_ring, v_ring


def ring_rows_write_plain(k_all: torch.Tensor, v_all: torch.Tensor,
                          k_rows: torch.Tensor, v_rows: torch.Tensor, li: int,
                          pos: torch.Tensor):
    """Plain PyTorch `ring_rows_write`: one in-place index write per cache."""
    bsz, _, _, cap, _ = k_all.shape
    slots = torch.remainder(pos, cap)
    bidx = torch.arange(bsz, device=k_all.device)
    k_all[bidx, li, :, slots, :] = to_ring_dtype(k_rows, k_all.dtype)
    v_all[bidx, li, :, slots, :] = to_ring_dtype(v_rows, v_all.dtype)
    return k_all, v_all


# ring dtype -> ring_kind of csrc/ring_rows_write.cu and csrc/flash_decode.cu
RING_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def ring_rows_write(k_all: torch.Tensor, v_all: torch.Tensor,
                    k_rows: torch.Tensor, v_rows: torch.Tensor, li: int,
                    pos: torch.Tensor):
    """Write one K/V row per stream IN PLACE into the stacked
    [B, L, KH, cap, D] caches at (b, li, :, pos[b] % cap, :).

    k_rows/v_rows: [B, KH, D] (cast to the ring dtype); pos: int [B].
    Returns (k_all, v_all).  CPU tensors take `ring_rows_write_plain`; CUDA
    tensors launch `csrc/ring_rows_write.cu` (it replaces the Pallas kernel
    voxtral_tpu/ops/ring.py:_rows_write_kernel), which takes f32, bf16 or
    fp8 e4m3fn rings, contiguous, and f32 rows, and raises on anything
    else.  Both cast as `to_ring_dtype` does: fp8 saturates at +-448 (the
    JAX cast makes NaN there: ROADMAP.md section 3)."""
    if k_all.device.type == "cpu":
        return ring_rows_write_plain(k_all, v_all, k_rows, v_rows, li, pos)
    if k_all.device.type != "cuda":
        raise NotImplementedError(f"ring_rows_write on {k_all.device}")
    bsz, n_layers, kh, cap, d = k_all.shape
    kind = RING_KINDS.get(k_all.dtype)
    if kind is None or v_all.dtype != k_all.dtype:
        raise ValueError("rows-write kernel takes f32, bf16 or fp8 e4m3fn "
                         f"rings, got {k_all.dtype}, {v_all.dtype}")
    if v_all.shape != k_all.shape:
        raise ValueError("rows-write kernel: cache shapes differ")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError("rows-write kernel: caches must be contiguous "
                         "(they are written in place)")
    if not 0 <= li < n_layers:
        raise ValueError(f"rows-write kernel: layer {li} of {n_layers}")
    if d % 8 or kh * d > 4096:
        raise ValueError(f"rows-write kernel: [{kh}, {d}] rows (needs "
                         "head_dim % 8 == 0 and heads x head_dim <= 4096)")
    if k_all.data_ptr() % 16 or v_all.data_ptr() % 16:
        raise ValueError("rows-write kernel: caches not 16-byte aligned")
    for name, r in (("k_rows", k_rows), ("v_rows", v_rows)):
        if r.dtype != torch.float32 or r.shape != (bsz, kh, d):
            raise ValueError(f"rows-write kernel: {name} must be f32 "
                             f"{(bsz, kh, d)}, got {r.dtype} "
                             f"{tuple(r.shape)}")
        if r.device != k_all.device:
            raise ValueError(f"rows-write kernel: {name} on {r.device}")
    # the kernel reads the rows 16 bytes at a time: a contiguous view that
    # starts off that alignment (a slice of a wider row) is copied
    k_rows, v_rows = k_rows.contiguous(), v_rows.contiguous()
    k_rows, v_rows = (r.clone() if r.data_ptr() % 16 else r
                      for r in (k_rows, v_rows))
    pos32 = pos.to(device=k_all.device, dtype=torch.int32).reshape(bsz)
    pos32 = pos32.contiguous()
    lib = cuda_lib.kernels()
    err = lib.vt_ring_rows_write(
        k_all.data_ptr(), v_all.data_ptr(), k_rows.data_ptr(),
        v_rows.data_ptr(), pos32.data_ptr(), bsz, n_layers, kh, cap, d, li,
        kind, cuda_lib.stream_handle(k_all.device),
    )
    cuda_lib.check(err, "ring_rows_write")
    ring_rows_write.launches += 1
    return k_all, v_all


# kernel launches since the last reset (CPU calls never count)
ring_rows_write.launches = 0


def slot_logical_positions(p_end: torch.Tensor, cap: int) -> torch.Tensor:
    """Logical position currently held by each slot: int [B, cap] for the
    last written positions p_end [B]."""
    slots = torch.arange(cap, device=p_end.device, dtype=p_end.dtype)
    p = p_end.reshape(-1, 1)
    return p - torch.remainder(p - slots, cap)


def ring_attention(
    q: torch.Tensor,
    k_ring: torch.Tensor,
    v_ring: torch.Tensor,
    q_pos0: torch.Tensor,
    *,
    window: int,
    out_dtype=None,
) -> torch.Tensor:
    """Sliding-window causal GQA attention over a ring cache.

    q:       [B, T, H, D]   queries at logical positions q_pos0 .. q_pos0+T-1
    k_ring:  [B, KH, cap, D]  (K/V for those T positions must already be written)
    v_ring:  [B, KH, cap, D]
    q_pos0:  int [B]
    Returns: [B, T, H, D] in out_dtype (default q.dtype).

    Numerics follow the JAX ring_attention: both products take operands in
    the matmul dtype (the ring dtype, or q's for byte-wide rings) and
    accumulate in float32 — done here by widening those operands to f32,
    which is exact for the products; the softmax is f32 and the
    probabilities are rounded to the matmul dtype before the PV product.
    """
    bsz, t, h, d = q.shape
    _, kh, cap, _ = k_ring.shape
    g = h // kh
    out_dtype = out_dtype or q.dtype
    scale = 1.0 / math.sqrt(d)

    q_pos0 = q_pos0.reshape(bsz)
    p_end = q_pos0 + (t - 1)
    lpos = slot_logical_positions(p_end, cap)[:, None, :]        # [B, 1, cap]
    q_pos = (q_pos0[:, None]
             + torch.arange(t, device=q.device, dtype=q_pos0.dtype))[:, :, None]
    valid = (lpos >= 0) & (lpos <= q_pos) & (lpos > q_pos - window)  # [B,T,cap]

    mm_dtype = k_ring.dtype if k_ring.dtype.itemsize >= 2 else q.dtype
    qg = q.reshape(bsz, t, kh, g, d).to(mm_dtype).float()
    kf = k_ring.to(mm_dtype).float()
    scores = torch.einsum("btkgd,bksd->bkgts", qg, kf) * scale
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    vf = v_ring.to(mm_dtype).float()
    out = torch.einsum("bkgts,bksd->btkgd", probs.to(mm_dtype).float(), vf)
    return out.reshape(bsz, t, h, d).to(out_dtype)
