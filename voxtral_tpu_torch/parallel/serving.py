"""Multi-stream batched serving: N concurrent transcriptions per device.

PyTorch counterpart of the batched subset of voxtral_tpu/parallel/
serving.py.  The decode step is bound by weight reads, so B streams through
one step cost little more than one: the GEMMs read each weight once for
every stream (the int4 kernel folds the streams into its rows).

The JAX package writes its models for one stream and `jax.vmap`s them over
a stream axis; custom_vmap rules then route the per-stream Pallas calls
(row write, flash-decode, int4 matmul) to batched launches.  The port's
decoder is batched-first (`[B, ...]` everywhere, per-stream positions
int [B]), so these are thin callers of models/decoder.py and every launch
already serves the whole batch.  The JAX bprefill's unrolled layer loop
(which keeps XLA's vmapped cache updates in place) has no counterpart:
the port's layer loop is eager and its cache updates are in place.

Attention dispatch of `bdecode_burst` is the JAX rule: the flash-decode
kernel for rings of a >= 2-byte float type, the plain path
(`ring_rows_write` + `ring_attention`) for fp8 rings; the port's
attn_impl="auto" already resolves so at every B.

Not ported yet (ROADMAP.md item 8): `BatchedTranscriber` and
`batched_enc_cache`, which feed mel through the streaming encoder.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..config import VoxtralConfig
from ..models import decoder as dec_mod
from ..models.decoder import KVCache

PyTree = Any


def batched_dec_cache(cfg: VoxtralConfig, batch: int,
                      cap: Optional[int] = None, device="cpu") -> KVCache:
    """Zeroed decoder rings [batch, L, KH, cap, D] in cfg.kvdtype."""
    return KVCache.create(cfg.decoder, cfg.kvdtype, cap, batch=batch,
                          device=device)


@torch.no_grad()
def bprefill(dec_params: PyTree, cfg: VoxtralConfig, embeds: torch.Tensor,
             cache: KVCache, pos0: torch.Tensor, ada: torch.Tensor) -> KVCache:
    """Prompt prefill of B streams: embeds [B, T, dim] at per-stream
    positions pos0 int [B]; writes the cache in place and returns it."""
    return dec_mod.prefill(dec_params, cfg, embeds, cache, pos0, ada)


@torch.no_grad()
def bdecode_burst(dec_params: PyTree, cfg: VoxtralConfig, chunks, prev,
                  cache: KVCache, pos0, ada, n_alt: int = 0):
    """Greedy bursts of B streams: chunks [B, T, dim], prev int [B], pos0
    int [B].  Returns (tokens [B, T], alt_ids, alt_probs, best_probs,
    cache) on the device; the cache is updated in place."""
    return dec_mod.decode_burst(dec_params, cfg, chunks, prev, cache, pos0,
                                ada, n_alt=n_alt)
