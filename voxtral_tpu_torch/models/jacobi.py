"""Jacobi (fixpoint) greedy decoding: the sequential greedy output in fewer
passes over the decoder.

PyTorch counterpart of voxtral_tpu/models/jacobi.py.  Greedy decoding is
the unique fixpoint of the parallel teacher-forced map

    F(tokens)[t] = argmax logits(adapter[t] + embed(tokens[t-1]))

(positions attend only backwards; by induction, after iteration k the first
k tokens are right and never change).  Iterating F over a window of W
positions runs the decoder over W rows at once, so the gain over
sequential decode is the average number of tokens that settle per
iteration; the worst case (W iterations) is sequential cost plus overhead,
and the result is always the greedy sequence.

Differences from the JAX function:
  - The fixpoint loop (a `lax.while_loop` there) is a host loop: each
    iteration reads one bool from the device (has the argmax stopped
    moving?), and the iteration count is a host int.
  - The KV cache is written IN PLACE: each pass rewrites the window's W
    ring slots before it attends to them (`decoder_forward` at T = W, the
    plain `ring_write` + `ring_attention` path: the JAX package has no
    kernel for decoder chunks of T > 1 either).  At the fixpoint the
    written rows are the sequential ones, as in JAX, where the cache is
    carried through the loop.
  - Jacobi runs at B=1 only, as in the JAX package (which has no batched
    form); tensors keep the port's leading stream axis of 1.
  - On a CUDA device each pass over the window replays one CUDA graph per
    window size, captured on the cache (decoder._use_graph,
    ops/graphs.py); the fixpoint loop stays on the host.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import VoxtralConfig
from ..ops.graphs import graph_key
from . import quant
from .decoder import (
    KVCache,
    _alts_from_logits,
    _positions,
    _use_graph,
    decoder_forward,
    final_logits,
)

PyTree = Any


def _jacobi_window(params: PyTree, cfg: VoxtralConfig,
                   adapter_win: torch.Tensor, prev_token: torch.Tensor,
                   cache: KVCache, pos0: torch.Tensor, ada: torch.Tensor,
                   n_alt: int):
    """Fixpoint-decode one window of W positions of one stream.

    adapter_win [W, dim]; prev_token int [1]; pos0 int [1].  Returns
    (tokens [W], alt_ids [W, n_alt], alt_probs, best_probs [W], n_iters);
    the cache holds the window's K/V rows afterwards."""
    w = adapter_win.shape[0]
    a32 = adapter_win.float()

    def window_pass(a32, prev_token, guesses, pos0):
        prev = torch.cat([prev_token, guesses[:-1]])
        embeds = a32 + quant.embed_rows(params, prev)
        x, _ = decoder_forward(params, cfg, embeds[None], cache, pos0, ada)
        return final_logits(params, cfg, x)[0]              # [W, V] f32

    if _use_graph(cfg, cache, a32, "jacobi"):
        # one CUDA graph per window size on this cache (ops/graphs.py); the
        # logits are the graph's, read before the next pass
        key = graph_key("jacobi", params, ada, cfg, w, cache.k.data_ptr(),
                        cache.v.data_ptr())

        def forward(guesses):
            return cache.graphs.call(key, window_pass,
                                     (a32, prev_token, guesses, pos0),
                                     keep=(params, ada))[1]
    else:
        def forward(guesses):
            return window_pass(a32, prev_token, guesses, pos0)

    guesses = prev_token.expand(w).clone()
    iters = 0
    while iters < w:
        new = torch.argmax(forward(guesses), dim=-1).to(torch.int32)
        iters += 1
        settled = bool(torch.equal(new, guesses))          # one device read
        guesses = new
        if settled:
            break
    if n_alt > 0:
        # one more consistent pass exposes each step's logits for the alts
        _, best_p, alt_i, alt_p = _alts_from_logits(forward(guesses), n_alt)
        return guesses, alt_i, alt_p, best_p, iters + 1
    dev = guesses.device
    return (guesses, torch.zeros((w, 0), dtype=torch.int32, device=dev),
            torch.zeros((w, 0), dtype=torch.float32, device=dev),
            torch.zeros((w,), dtype=torch.float32, device=dev), iters)


@torch.no_grad()
def decode_burst_jacobi(
    params: PyTree,
    cfg: VoxtralConfig,
    adapter_chunk: torch.Tensor,   # [1, T, dim], T a multiple of `window`
    prev_token,                    # int, or int tensor [1]
    cache: KVCache,                # B=1, written in place
    pos0,                          # int, or int tensor [1]
    ada: torch.Tensor,
    n_alt: int = 0,
    window: int = 64,
):
    """Greedy burst decode by windowed Jacobi iteration: the outputs of
    decoder.decode_burst plus the total iteration count.  Windows run in
    order, each from the previous window's last token at pos0 + i * W;
    within a window the tokens settle in parallel.

    Returns (tokens [1, T] i32, alt_ids [1, T, n_alt], alt_probs
    [1, T, n_alt], best_probs [1, T], cache, iters)."""
    bsz, t, _ = adapter_chunk.shape
    if bsz != 1:
        raise ValueError(f"Jacobi decoding runs one stream, got B={bsz}")
    w = min(window, t)
    if t % w:
        raise ValueError(f"burst of {t} rows is not a multiple of the "
                         f"window {w}")
    dev = adapter_chunk.device
    prev = torch.as_tensor(prev_token).to(device=dev,
                                          dtype=torch.int32).reshape(1)
    pos = _positions(pos0, 1, dev)
    outs, iters = [], 0
    for i in range(t // w):
        toks, ai, ap, bp, it = _jacobi_window(
            params, cfg, adapter_chunk[0, i * w: (i + 1) * w], prev, cache,
            pos + i * w, ada, n_alt)
        outs.append((toks, ai, ap, bp))
        iters += it
        prev = toks[-1:]
    toks, ai, ap, bp = (torch.cat(x)[None] for x in zip(*outs))
    return toks, ai, ap, bp, cache, iters
