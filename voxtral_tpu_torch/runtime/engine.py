"""Engine: loaded parameters + the shape-bucket policy, offline subset.

PyTorch counterpart of voxtral_tpu/runtime/engine.py.  It holds the weights
on one device and exposes the calls of the offline path (bulk encode,
prompt prefill, burst decode).  Everything is batched-first: tensors carry
a leading stream axis B (B=1 for one clip).

Decode bursts keep the JAX package's greedy bucket decomposition, so a clip
is cut into the same bursts in both packages.  PyTorch runs eagerly and
needs no per-shape program; the buckets are where CUDA-graph capture sizes
will go.

`quantize=` ("int8"/True or "int4") quantizes the decoder only, as the JAX
engine does (models/quant.py); the encoder stays exact.

Not ported yet (ROADMAP.md): the streaming encoder programs (conv chunks,
ring encoder, fused streaming), Jacobi decoding, encoder weight paging,
the memory ledger, warm-up.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import (
    RAW_AUDIO_LENGTH_PER_TOK,
    TOKEN_BOS,
    TOKEN_STREAMING_PAD,
    VoxtralConfig,
    delay_tokens_from_ms,
    n_right_pad_tokens,
)
from ..models import decoder as dec_mod
from ..models.decoder import KVCache, ada_scales
from ..models.quant import embed_rows, quantize_params
from ..tokenizer import TekkenTokenizer

DEFAULT_BUCKETS = (256, 64, 16, 4, 1)


def adaptive_dec_ring(cfg: VoxtralConfig, n_samples: int, slack: int = 64) -> int:
    """Smallest 128-aligned decoder ring that holds a whole clip of
    `n_samples` (prompt + audio tokens + right padding), capped at the
    attention window (the reference's grow-to-fit KV cache for offline
    clips, voxtral_decoder.c:214-311).  Ring index math is modular, so any
    cap works; a 60 s clip rides an 896-slot ring."""
    toks = (n_samples + RAW_AUDIO_LENGTH_PER_TOK - 1) // RAW_AUDIO_LENGTH_PER_TOK
    total = (1 + 32 + cfg.delay_tokens) + toks + n_right_pad_tokens(cfg.delay_tokens)
    return min(cfg.decoder.window, max(256, -(-(total + slack) // 128) * 128))


def decompose(n: int, buckets: Sequence[int]) -> list[int]:
    """Greedy largest-first decomposition of n into bucket sizes (buckets must
    include 1 so every n is representable)."""
    out = []
    for b in sorted(buckets, reverse=True):
        while n >= b:
            out.append(b)
            n -= b
    if n != 0:
        raise ValueError(f"buckets {tuple(buckets)} cannot represent {n}")
    return out


class VoxtralEngine:
    """Holds the weights on one device plus everything shape-static. One
    engine serves many streams (vox_ctx_t analog, voxtral.h:150-210)."""

    def __init__(
        self,
        cfg: VoxtralConfig,
        params,
        tokenizer: Optional[TekkenTokenizer] = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        dec_kv_ring: Optional[int] = None,
        decode_mode: str = "sequential",
        quantize: bool | str = False,      # False | True/"int8" | "int4"
    ):
        if decode_mode != "sequential":
            raise NotImplementedError(
                f"decode_mode={decode_mode!r}: Jacobi decoding is not ported "
                "yet (ROADMAP.md queue 1, models/jacobi.py)")
        # float32 products stay float32 on the card (the reference
        # numerics); both flags are process-wide torch settings
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        if quantize:
            # decoder only (where decode reads its bytes); a new tree, so
            # the caller's params stay as they were
            params = quantize_params(params, encoder=False,
                                     bits=4 if quantize == "int4" else 8)
        self.quantized = quantize
        self.params = params
        self.tokenizer = tokenizer
        self.decode_mode = decode_mode
        self.buckets = tuple(sorted(buckets, reverse=True))
        if self.buckets[-1] != 1:
            raise ValueError(f"buckets must include 1, got {self.buckets}")
        self.dec_kv_ring = dec_kv_ring or cfg.decoder.kv_ring
        dparams = params["decoder"]
        self.device = dparams["tok_embeddings"].device

        self.delay_tokens = cfg.delay_tokens
        self._ada = {self.delay_tokens: ada_scales(dparams, cfg)}
        # [dim] f32, on the device
        self.embed_bos = embed_rows(
            dparams, torch.tensor(TOKEN_BOS, device=self.device))
        self.embed_pad = embed_rows(
            dparams, torch.tensor(TOKEN_STREAMING_PAD, device=self.device))

    # -- config ------------------------------------------------------------
    @property
    def prompt_len(self) -> int:
        return 1 + 32 + self.delay_tokens

    def set_delay(self, delay_ms: int):
        """vox_set_delay analog (voxtral.c:1629-1635)."""
        self.delay_tokens = delay_tokens_from_ms(delay_ms)

    def ada(self) -> torch.Tensor:
        d = self.delay_tokens
        if d not in self._ada:
            cfg = self.cfg.replace(delay_tokens=d)
            self._ada[d] = ada_scales(self.params["decoder"], cfg)
        return self._ada[d]

    # -- cache factories -----------------------------------------------------
    def new_dec_cache(self, batch: int = 1) -> KVCache:
        return KVCache.create(self.cfg.decoder, self.cfg.kvdtype,
                              self.dec_kv_ring, batch=batch,
                              device=self.device)

    # -- phases ----------------------------------------------------------------
    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=self.device, dtype=dtype)

    def encode_clip_bulk(self, mel) -> torch.Tensor:
        """Whole-clip offline encode with NO ring state (the reference's
        batch vox_encoder_forward, voxtral_encoder.c:135-312): padded mel
        [B, Tm, 128] -> [B, Tm//8, 3072] f32 adapter rows on the device."""
        from ..models.bulk_encode import bulk_encode_clip

        return bulk_encode_clip(
            self.params["encoder"], self.params["adapter"], self.cfg,
            self._tensor(mel, torch.float32),
        )

    def encode_clips_bulk(self, mel_b) -> torch.Tensor:
        """Batched bulk encode of B clips of one length: [B, Tm, 128] ->
        [B, Tm//8, 3072] f32, one banded-kernel launch per layer for all
        streams (the JAX engine's name for the batched call)."""
        return self.encode_clip_bulk(mel_b)

    def prompt_embeds(self, adapter_rows) -> torch.Tensor:
        """[B, L, dim] adapter rows -> prompt embeddings on the device:
        row 0 + BOS embed, rows 1.. + STREAMING_PAD embed."""
        rows = self._tensor(adapter_rows)
        return torch.cat([rows[:, :1] + self.embed_bos,
                          rows[:, 1:] + self.embed_pad], dim=1)

    def prefill(self, embeds, cache: KVCache, pos0) -> KVCache:
        """Writes the prompt's K/V into `cache` in place and returns it."""
        return dec_mod.prefill(
            self.params["decoder"], self.cfg, self._tensor(embeds), cache,
            pos0, self.ada(),
        )

    def decode_burst(self, adapter_chunk, prev_token, cache: KVCache, pos0,
                     n_alt: int = 0):
        """Greedy burst: (tokens [B, T], alt_ids, alt_probs, best_probs,
        cache), all left on the device; the cache is updated in place."""
        return dec_mod.decode_burst(
            self.params["decoder"], self.cfg, self._tensor(adapter_chunk),
            torch.as_tensor(prev_token), cache, pos0, self.ada(), n_alt=n_alt,
        )
