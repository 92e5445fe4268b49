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
here).
"""

from __future__ import annotations

import math

import torch


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
    vals = vals.to(ring.dtype)
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


def ring_rows_write(k_all: torch.Tensor, v_all: torch.Tensor,
                    k_rows: torch.Tensor, v_rows: torch.Tensor, li: int,
                    pos: torch.Tensor):
    """Write one K/V row per stream IN PLACE into the stacked
    [B, L, KH, cap, D] caches at (b, li, :, pos[b] % cap, :).

    k_rows/v_rows: [B, KH, D] (cast to the ring dtype); pos: int [B].
    Returns (k_all, v_all)."""
    bsz, _, _, cap, _ = k_all.shape
    slots = torch.remainder(pos, cap)
    bidx = torch.arange(bsz, device=k_all.device)
    k_all[bidx, li, :, slots, :] = k_rows.to(k_all.dtype)
    v_all[bidx, li, :, slots, :] = v_rows.to(v_all.dtype)
    return k_all, v_all


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
