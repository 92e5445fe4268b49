"""Matmul and embedding helpers of the decoder/encoder, unquantized subset.

The JAX module also carries the int8 and int4 weight-only rungs; they are
not ported yet (ROADMAP.md, queue 1: "models/quant.py"), and quantized
weights raise NotImplementedError here rather than computing something
else.

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

NOT_PORTED = ("int8/int4 weights are not ported to PyTorch yet "
               "(ROADMAP.md queue 1, models/quant.py)")


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


def mm(x: torch.Tensor, lp: PyTree, name: str) -> torch.Tensor:
    """einsum('td,od->to'): x [..., in] @ lp[name].T ([out, in]) -> f32
    [..., out]."""
    w = lp[name]
    if w.dtype == torch.int8 or (name + "_scale") in lp:
        raise NotImplementedError(NOT_PORTED)
    return matmul_f32(x, w.t())


def embed_rows(dparams: PyTree, ids: torch.Tensor) -> torch.Tensor:
    """tok_embeddings[ids] -> f32; ids: any integer shape, returns
    ids.shape + [dim]."""
    emb = dparams["tok_embeddings"]
    if emb.dtype == torch.int8 or "tok_embeddings_scale" in dparams:
        raise NotImplementedError(NOT_PORTED)
    return emb[ids].float()
