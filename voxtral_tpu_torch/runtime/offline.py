"""Offline (whole-clip) transcription through the bulk no-ring encoder.

PyTorch counterpart of voxtral_tpu/runtime/offline.py.  When the whole clip
is in hand there is no reason to ring-buffer the encoder: pad the clip, run
the batch encoder, prefill the prompt, burst-decode every audio position,
stop at EOS (vox_encoder_forward + vox_decoder_* as a pipeline).

The adapter rows, the KV cache and the fed-back tokens stay on the device;
the host reads the tokens once per decode burst.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import (
    N_LEFT_PAD_TOKENS,
    RAW_AUDIO_LENGTH_PER_TOK,
    TOKEN_EOS,
    TOKEN_STREAMING_PAD,
    n_right_pad_tokens,
)
from ..native import make_mel_context
from ..tokenizer import TekkenTokenizer
from .engine import VoxtralEngine, decompose


def padded_clip_mel(engine: VoxtralEngine, samples: np.ndarray) -> np.ndarray:
    """Left-pad context + clip + alignment + right padding -> [Tm, 128] mel
    with Tm % 8 == 0 (the offline padding schedule, voxtral.c:1593-1597)."""
    ctx = make_mel_context(N_LEFT_PAD_TOKENS * RAW_AUDIO_LENGTH_PER_TOK)
    ctx.feed(np.asarray(samples, np.float32))
    align = (
        RAW_AUDIO_LENGTH_PER_TOK - (len(samples) % RAW_AUDIO_LENGTH_PER_TOK)
    ) % RAW_AUDIO_LENGTH_PER_TOK
    pad = align + n_right_pad_tokens(engine.delay_tokens) * RAW_AUDIO_LENGTH_PER_TOK
    ctx.feed(np.zeros(pad, np.float32))
    ctx.finish(0)
    mel = ctx.data()
    return mel[: (mel.shape[0] // 8) * 8]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def transcribe_offline_ids(
    engine: VoxtralEngine,
    samples: np.ndarray,
    dec_cache=None,
    timings: Optional[dict] = None,
) -> list[int]:
    """Whole-clip greedy decode -> ALL generated token ids (callers
    classify).  Stops at EOS.

    With a `timings` dict, the device is synchronized at the three phase
    boundaries (never inside a burst) and the dict receives encode_s,
    prefill_s, decode_s (wall seconds), decode_steps (positions decoded,
    post-EOS steps of the last burst included) and adapter_finite."""
    dev = engine.device
    t0 = time.monotonic()
    mel = padded_clip_mel(engine, samples)
    rows = engine.encode_clip_bulk(mel[None])          # [1, n, 3072] f32
    n = rows.shape[1]
    L = engine.prompt_len
    if n < L:
        raise ValueError(f"clip gives {n} adapter rows, fewer than the "
                         f"{L}-row prompt")
    if engine.dec_kv_ring < engine.cfg.decoder.window and n > engine.dec_kv_ring:
        raise ValueError(
            f"clip needs {n} decode positions but the ring holds "
            f"{engine.dec_kv_ring}; size the engine with adaptive_dec_ring")
    if timings is not None:
        timings["adapter_finite"] = bool(torch.isfinite(rows).all())
        _sync(dev)
        t1 = time.monotonic()
        timings["encode_s"] = t1 - t0

    cache = dec_cache if dec_cache is not None else engine.new_dec_cache()
    engine.prefill(engine.prompt_embeds(rows[:, : L - 1]), cache, 0)
    if timings is not None:
        _sync(dev)
        t2 = time.monotonic()
        timings["prefill_s"] = t2 - t1
        timings["decode_steps"] = 0

    out: list[int] = []
    prev = torch.full((1,), TOKEN_STREAMING_PAD, dtype=torch.int32, device=dev)
    pos = L - 1
    for b in decompose(n - pos, engine.buckets):
        toks, _, _, _, cache = engine.decode_burst(
            rows[:, pos: pos + b], prev, cache, pos)
        if timings is not None:
            timings["decode_steps"] += b
        host = toks[0].tolist()                        # one sync per burst
        if TOKEN_EOS in host:
            out.extend(host[: host.index(TOKEN_EOS)])
            break
        out.extend(host)
        prev = toks[:, -1]                             # stays on the device
        pos += b
    if timings is not None:
        timings["decode_s"] = time.monotonic() - t2
    return out


def transcribe_offline(engine: VoxtralEngine, samples: np.ndarray) -> str:
    """Whole-clip transcription text (text-class tokens joined)."""
    tok: Optional[TekkenTokenizer] = engine.tokenizer
    if tok is None:
        raise ValueError("engine has no tokenizer")
    ids = transcribe_offline_ids(engine, samples)
    return "".join(
        tok.decode(t) for t in ids
        if tok.classify(t) == TekkenTokenizer.TOK_TEXT
    ).strip()
