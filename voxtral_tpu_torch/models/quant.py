"""Weight-only int8 / int4 quantization and the matmul/embedding helpers.

PyTorch counterpart of voxtral_tpu/models/quant.py; the quantized tensors
are byte-equal to the JAX package's.

  - int8: per-output-row symmetric scale, W8[o,i] = round(W[o,i] / s[o]),
    s[o] = max_i |W[o,i]| / 127 (round half to even, clip +-127).  The
    matmul is y = (x @ W8.T) * s: `ops/quant_mm.py int8_mm`.  On CUDA
    tensors its kernel reads the int8 bytes and widens them in registers
    (one byte a weight from device memory), the counterpart of the convert
    XLA fuses into the JAX package's product; on CPU tensors the plain
    version widens the whole weight to the activation dtype first (two or
    four bytes a weight written and read again).
  - int4: NIBBLE-PACKED int8 [out, in/2]; low nibbles hold input columns
    [0, in/2), high nibbles [in/2, in).  One f32 scale per (output row,
    half), max |W| / 7, clip +-7.  The matmul is two dots (one per half)
    with a per-half row-scale epilogue: `ops/quant_mm.py` (the hand-written
    CUDA kernel for CUDA tensors, `_mm4` below for CPU tensors).

Precision choice: JAX's `einsum(..., preferred_element_type=f32)` takes
bf16 operands and returns the float32 accumulator.  A plain bf16
`torch.matmul` would round that result to bf16, so `matmul_f32` keeps it in
float32: on CUDA through `torch.mm(..., out_dtype=torch.float32)` (the
tensor cores, f32 accumulate, f32 out); on the CPU by widening the operands
to float32, which is exact for the products.  float32 operands stay float32
(TF32 is switched off by the engine).
"""

from __future__ import annotations

from typing import Any

import torch

PyTree = Any

# weights quantized in the decoder/encoder layer stacks
QUANT_KEYS = ("wqkv", "wo", "w13", "w2")

# Under jit, XLA compiles the JAX package's `max / 127.0` and `max / 7.0`
# into multiplies by the float32 reciprocals; the same multiplies keep the
# scales bit-equal to it.  Its int8 table is quantized outside jit, with a
# true division.
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
_INV7 = torch.tensor(1.0 / 7.0, dtype=torch.float32).item()


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ b [k, n] with float32 accumulation and result."""
    a2 = a.reshape(-1, a.shape[-1])
    if a2.dtype == torch.float32 and b.dtype == torch.float32:
        y = a2 @ b
    elif a2.dtype == b.dtype and a2.is_cuda:
        y = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        y = a2.float() @ b.float()
    return y.reshape(*a.shape[:-1], b.shape[-1])


def _quantize(w: torch.Tensor, reciprocal: bool = True):
    """[..., out, in] float -> (int8 [..., out, in], f32 scale [..., out, 1]).
    `reciprocal`: the scale as the jitted JAX function rounds it."""
    wf = w.float()
    m = wf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(m * _INV127 if reciprocal else m / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def _quantize4(w: torch.Tensor):
    """[..., out, in] float -> (nibble-packed int8 [..., out, in/2], f32 scale
    [..., out, 2]) with one symmetric scale per nibble half.

    Packing: p[..., j] = (q[..., j] & 0xF) | (q[..., j + in/2] << 4)."""
    wf = w.float()
    in_dim = wf.shape[-1]
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {in_dim}")
    half = in_dim // 2
    wg = wf.reshape(*wf.shape[:-1], 2, half)
    s = torch.clamp_min(wg.abs().amax(dim=-1) * _INV7, 1e-12)     # [..., out, 2]
    q = torch.clamp(torch.round(wg / s[..., None]), -7, 7).to(torch.int32)
    packed = (q[..., 0, :] & 0xF) | ((q[..., 1, :] & 0xF) << 4)   # 0..255
    return packed.to(torch.uint8).view(torch.int8), s


def _unpack4(p: torch.Tensor, dtype):
    """Nibble-packed int8 [..., in/2] -> (lo, hi) halves in `dtype`.  In
    int32, (p << 28) >> 28 sign-extends the low nibble and p >> 4 (an
    arithmetic shift) the high one."""
    p32 = p.to(torch.int32)
    return ((p32 << 28) >> 28).to(dtype), (p32 >> 4).to(dtype)


def _map_rows(fn, w: torch.Tensor, chunks: int):
    """fn over `chunks` slices of w's leading axis, results concatenated:
    bounds the f32 temporaries to one slice (a whole full-width w13 stack in
    f32 is 5.9 GB), as the JAX package's lax.map does."""
    outs = [fn(part) for part in w.chunk(chunks, dim=0)]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(len(outs[0])))


def _quantize_table4(emb: torch.Tensor, c: int):
    """int4-quantize a [V, dim] table in `c` row chunks."""
    return _map_rows(_quantize4, emb, c)


@torch.no_grad()
def quantize_layer_stack(layers: PyTree, bits: int = 8) -> PyTree:
    """A copy of a stacked layer dict with its big matrices quantized; adds
    '<name>_scale' siblings ([L, out] for int8, [L, out, 2] for int4).
    Norms, biases and ada stay as they are.  Works one layer at a time."""
    out = dict(layers)
    for k in QUANT_KEYS:
        if k not in out:
            continue
        w = out[k]
        if bits == 4:
            out[k], out[k + "_scale"] = _map_rows(_quantize4, w, w.shape[0])
        else:
            q, s = _map_rows(_quantize, w, w.shape[0])
            out[k], out[k + "_scale"] = q, s.squeeze(-1)
    return out


@torch.no_grad()
def quantize_params(params: PyTree, *, encoder: bool = True,
                    decoder: bool = True, embeddings: bool = True,
                    bits: int = 8) -> PyTree:
    """A copy of `params` with the layer-stack matrices quantized (int8, or
    int4 nibble-packed when bits=4); with `embeddings`, the decoder's tied
    embedding table too (per row for int8, per (row, half) for int4).  The
    input tree is not modified; unquantized tensors are shared."""
    out = dict(params)
    if decoder and "decoder" in out:
        d = dict(out["decoder"])
        d["layers"] = quantize_layer_stack(d["layers"], bits=bits)
        if embeddings:
            emb = d["tok_embeddings"]
            if bits == 4:
                c = 8 if emb.shape[0] % 8 == 0 else 1
                d["tok_embeddings"], d["tok_embeddings_scale"] = \
                    _quantize_table4(emb, c)                   # scale [V, 2]
            else:
                q, s = _quantize(emb, reciprocal=False)
                d["tok_embeddings"] = q
                d["tok_embeddings_scale"] = s.squeeze(-1)      # [V]
        out["decoder"] = d
    if encoder and "encoder" in out:
        e = dict(out["encoder"])
        e["layers"] = quantize_layer_stack(e["layers"], bits=bits)
        out["encoder"] = e
    return out


def _is_packed4(w: torch.Tensor, s) -> bool:
    """int4 marker: int8 storage whose half-scale keeps the full rank
    ([out, 2] next to w [out, in/2]; int8 scales drop to [out])."""
    return s is not None and w.dtype == torch.int8 and s.dim() == w.dim()


def stack_is_packed4(layers: PyTree) -> bool:
    """True when a stacked layer dict holds nibble-packed int4 matrices."""
    w, s = layers.get("wqkv"), layers.get("wqkv_scale")
    return (s is not None and w.dtype == torch.int8 and s.dim() == 3
            and s.shape[-1] == 2)


def embed_rows(dparams: PyTree, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """tok_embeddings[ids] -> f32 for bf16/f32, int8 and int4 tables.
    ids: any integer shape; returns ids.shape + [dim].

    With `tp` (parallel/mesh.py TensorParallel), the float table is this
    rank's block of the vocab: each rank looks up the ids it holds, zeros
    for the others, and the ranks' rows are summed (one row plus zeros:
    exact)."""
    emb = dparams["tok_embeddings"]
    s = dparams.get("tok_embeddings_scale")
    if tp is not None:
        if s is not None:
            raise ValueError("a quantized table does not split over tp")
        n = emb.shape[0]
        local = ids.long() - tp.rank * n
        held = (local >= 0) & (local < n)
        rows = emb[local.clamp(0, n - 1)].float()
        return tp.sum(torch.where(held[..., None], rows, 0.0))
    if _is_packed4(emb, s):
        lo, hi = _unpack4(emb[ids], torch.float32)
        rows = torch.cat([lo, hi], dim=-1)                    # [.., dim]
        sg = s[ids].float()                                   # [.., 2]
        g = rows.shape[-1] // sg.shape[-1]
        return (rows.reshape(*rows.shape[:-1], sg.shape[-1], g)
                * sg[..., None]).reshape(rows.shape)
    rows = emb[ids].float()
    if emb.dtype == torch.int8:
        rows = rows * s[ids].float()[..., None]
    return rows


def _mm4(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor,
         cdtype) -> torch.Tensor:
    """The plain int4 product: x [T, in], p nibble-packed int8 [out, in/2],
    s f32 [out, 2] -> f32 [T, out].  Unpacks to `cdtype`, two f32-result
    products (one per nibble half), then the per-half row scales."""
    half = x.shape[-1] // 2
    lo, hi = _unpack4(p, cdtype)
    x = x.to(cdtype)
    y_lo = matmul_f32(x[:, :half], lo.t())
    y_hi = matmul_f32(x[:, half:], hi.t())
    return y_lo * s[None, :, 0] + y_hi * s[None, :, 1]


def matmul_rows(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`matmul_f32(a, w.t())` for a [..., k] and w [n, k] (contiguous, or
    the transpose view of a contiguous [k, n]), each row's bits independent
    of the row count on the card: `ops.bf16_mm.bf16_mm` (the row-invariant
    route, models/decoder.py:_use_rowinv)."""
    from ..ops import bf16_mm

    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    return bf16_mm.bf16_mm(a2, w).reshape(*a.shape[:-1], w.shape[0])


def mm(x: torch.Tensor, lp: PyTree, name: str,
       rowinv: bool = False) -> torch.Tensor:
    """einsum('td,od->to') with int8/int4 dequantization: x [..., in] @
    lp[name].T -> f32 [..., out].

    lp[name] is [out, in] (float, or int8 with lp[name+'_scale'] [out]) or
    nibble-packed int4 [out, in/2] with per-half scales [out, 2]; the int4
    and int8 products go to `ops.quant_mm.int4_mm` / `int8_mm` (kernels on
    CUDA).  One layer of a contiguous stacked weight is a zero-copy view, so
    the port passes it as a one-layer stack with li=0 (the JAX package
    keeps the whole stack out of its layer scan instead).  `rowinv`: the
    row-invariant route (the int kernels' row-invariant plans, float
    weights through `matmul_rows`)."""
    w = lp[name]
    s = lp.get(name + "_scale")
    if s is not None and w.dtype == torch.int8:
        from ..ops import quant_mm

        fn = quant_mm.int4_mm if _is_packed4(w, s) else quant_mm.int8_mm
        y = fn(x.reshape(-1, x.shape[-1]).contiguous(), w[None], s[None], 0,
               rowinv=rowinv)
        return y.reshape(*x.shape[:-1], w.shape[0])
    if rowinv:
        return matmul_rows(x, w)
    return matmul_f32(x, w.t())
