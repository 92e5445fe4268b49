"""A/B the bulk no-ring encoder against the incremental ring path on the
card.

PyTorch counterpart of tools/bulk_encode_bench.py.  Prints the encode wall
per clip of: the incremental fused path (engine.fused_encode over the
fused buckets, whose encoder chunks replay their CUDA graphs), the bulk
encoder at B=1 (models/bulk_encode.py, the banded kernel, eager by the
graph rule: it is device-bound) and the bulk encoder over groups of G
copies of the clip (BULK_GROUPS, default "4,8").  Each time is CUDA events
around three runs after a warm one.  Weights are seeded random
(`init_params(seed=0)`), the clip is seeded noise.

Usage:

    python -m voxtral_tpu_torch.tools.bulk_encode_bench [--device cuda|cpu]

Env: BULK_SECONDS (60), BULK_SKIP_INC=1 (skip the incremental path),
BULK_GROUPS.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import pick_device, timeit


def main(argv=None, cfg=None) -> int:
    """Runs the tool; `cfg` (default full_config()) lets tests use a small
    model."""
    p = argparse.ArgumentParser(prog="bulk_encode_bench")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    dev = pick_device(args.device, "bulk_encode_bench")
    if dev is None:
        return 1

    from ..audio.mel import MelContext
    from ..config import (
        N_LEFT_PAD_TOKENS,
        RAW_AUDIO_LENGTH_PER_TOK,
        full_config,
        n_right_pad_tokens,
    )
    from ..models.fused_stream import ConvTails
    from ..models.params import init_params
    from ..runtime.engine import VoxtralEngine

    print(f"device: {dev}", flush=True)
    cfg = cfg or full_config()
    params = init_params(cfg, seed=0, device=dev)
    engine = VoxtralEngine(
        cfg, params, buckets=(512, 256, 64, 16, 4, 1), enc_kv_ring=1280,
        dec_kv_ring=896,
    )

    seconds = float(os.environ.get("BULK_SECONDS", "60"))
    rng = np.random.default_rng(0)
    n = int(seconds * 16000)
    audio = (0.1 * rng.standard_normal(n)).astype(np.float32)
    ctx = MelContext(N_LEFT_PAD_TOKENS * RAW_AUDIO_LENGTH_PER_TOK)
    ctx.feed(audio)
    align = (RAW_AUDIO_LENGTH_PER_TOK - (n % RAW_AUDIO_LENGTH_PER_TOK)) \
        % RAW_AUDIO_LENGTH_PER_TOK
    ctx.feed(np.zeros(
        align + n_right_pad_tokens(6) * RAW_AUDIO_LENGTH_PER_TOK, np.float32))
    ctx.finish(0)
    mel = ctx.data()
    mel = mel[: (mel.shape[0] // 8) * 8]
    print(f"mel: {mel.shape}", flush=True)
    mel_dev = torch.from_numpy(np.ascontiguousarray(mel)).to(dev)

    def per_run_ms(fn):
        # timeit's two untimed runs warm the caches (and capture graphs)
        return timeit(fn, 3, dev) * 1000

    if os.environ.get("BULK_SKIP_INC") != "1":
        def inc_once():
            cache = engine.new_enc_cache()
            tails = ConvTails.create(cfg, device=dev)
            pos = i = 0
            out = None
            for q in engine.fused_sizes(mel.shape[0]):
                out, tails, cache = engine.fused_encode(
                    mel_dev[None, i: i + q], tails, cache, pos)
                pos += q // 2
                i += q
            return out

        print("warming incremental...", flush=True)
        print(f"incremental fused: {per_run_ms(inc_once):.1f} ms/clip",
              flush=True)

    print("warming bulk B=1...", flush=True)
    print(f"bulk B=1: {per_run_ms(lambda: engine.encode_clip_bulk(mel_dev[None])):.1f} "
          f"ms/clip", flush=True)

    for g in [int(x) for x in
              os.environ.get("BULK_GROUPS", "4,8").split(",") if x]:
        mb = mel_dev[None].expand(g, *mel_dev.shape).contiguous()
        print(f"warming bulk B={g}...", flush=True)
        dt = per_run_ms(lambda: engine.encode_clips_bulk(mb))
        print(f"bulk B={g}: {dt:.1f} ms/dispatch = {dt / g:.1f} ms/clip "
              f"({seconds * 1000 * g / dt:.0f}x realtime)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
