"""Ring against window-recompute encoder transcript A/B.

PyTorch counterpart of tools/window_ab.py.  The StreamPool's window mode
(models/bulk_encode.py window_encode_chunk: the banded kernel over each
slot's kept context, its stale rows hidden by a per-slot `kv_lo`) is an
approximation whose deep layers' receptive fields end at the kept
context's edge; `enc_ctx_extra` keeps k more windows of it.  This measures
what that costs: one checkpoint load, a one-slot pool per mode, the
token-level diff of window-mode transcripts (over the enc_ctx_extra
sweep) against the exact ring-mode one (the flash-encode kernel over the
encoder ring), over several clips.

With random weights the greedy margins are noise-sized, so the flips per
1k tokens are an upper bound on what a trained checkpoint would show.

Usage:

    python -m voxtral_tpu_torch.tools.window_ab [model_dir] [wav ...]
        [--device cuda|cpu]

model_dir defaults to $VOXTRAL_MODEL_DIR.  Env: AB_INTERVAL (feed
seconds, default 2.0), AB_SECONDS (clip length by tiling, default 60),
AB_EXTRAS (default "0,1,2"), AB_RING (decoder ring, default 1024),
AB_CLIPS (the least number of distinct clips, default 8: the WAVs given,
then rotated copies of them, then synthetic speech-shaped clips of
distinct seeds).  Mean +/- spread per extra is the result.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import pick_device, sync


def log(msg):
    print(f"[winab] {msg}", file=sys.stderr, flush=True)


def tile_to(samples: np.ndarray, seconds: float) -> np.ndarray:
    n = int(seconds * 16000)
    reps = int(np.ceil(n / len(samples)))
    return np.tile(samples, reps)[:n]


def synth_clip(seed: int, seconds: float) -> np.ndarray:
    """Speech-shaped synthetic clip: seed-distinct AM/FM tone bursts with
    pauses and noise, so each clip drives a distinct encoder state."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    f0 = 120.0 + 80.0 * rng.random()
    x = np.zeros(n, np.float32)
    for h in range(1, 5):                      # harmonics
        x += (0.2 / h) * np.sin(
            2 * np.pi * h * f0 * t
            + 3.0 * np.sin(2 * np.pi * rng.random() * 2.0 * t)
        ).astype(np.float32)
    env = np.clip(np.sin(2 * np.pi * (0.8 + rng.random()) * t), 0, None)
    x *= env.astype(np.float32)                # syllable-ish bursts
    x += 0.04 * rng.standard_normal(n).astype(np.float32)
    return x.astype(np.float32)


def clip_list(wavs, seconds: float, min_clips: int, load_wav):
    """[(name, audio)]: the given WAVs, then rotated copies (another
    stream phase over the same material), then synthetic seeds, until
    min_clips clips exist."""
    clips = []
    for wav in wavs:
        if os.path.exists(wav):
            clips.append((os.path.basename(wav),
                          tile_to(load_wav(wav), seconds)))
        else:
            log(f"{wav} missing — skipped")
    base = list(clips)
    k = 0
    while len(clips) < min_clips and k < len(base):
        name, audio = base[k]
        clips.append((f"{name}+rot{k + 1}",
                      np.roll(audio, (k + 1) * len(audio) // 3)))
        k += 1
    s = 0
    while len(clips) < min_clips:
        clips.append((f"synth{s}", synth_clip(s, seconds)))
        s += 1
    return clips


def diff(a, b):
    n = max(len(a), len(b))
    d = sum(1 for j in range(n)
            if (a[j] if j < len(a) else None) != (b[j] if j < len(b) else None))
    return d, n


def main(argv=None, cfg=None) -> int:
    """Runs the A/B; `cfg` (default full_config()) lets tests drive a
    smaller checkpoint."""
    p = argparse.ArgumentParser(prog="window_ab")
    p.add_argument("model_dir", nargs="?",
                   default=os.environ.get("VOXTRAL_MODEL_DIR"))
    p.add_argument("wavs", nargs="*")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if not args.model_dir:
        p.error("model_dir (or VOXTRAL_MODEL_DIR) is required")
    dev = pick_device(args.device, "winab")
    if dev is None:
        return 1
    interval = float(os.environ.get("AB_INTERVAL", "2.0"))
    seconds = float(os.environ.get("AB_SECONDS", "60"))
    extras = [int(x) for x in os.environ.get("AB_EXTRAS", "0,1,2").split(",")]
    dec_ring = int(os.environ.get("AB_RING", "1024"))
    min_clips = int(os.environ.get("AB_CLIPS", "8"))

    from ..config import full_config
    from ..io.wav import load_wav
    from ..models.params import load_params
    from ..parallel.scheduler import StreamPool
    from ..runtime.engine import VoxtralEngine
    from ..tokenizer import TekkenTokenizer

    cfg = cfg or full_config()
    t0 = time.monotonic()
    params = load_params(args.model_dir, cfg, device=dev, verbose=True)
    tok = TekkenTokenizer.load(os.path.join(args.model_dir, "tekken.json"))
    sync(dev)
    log(f"weights on the device (+{time.monotonic() - t0:.0f}s)")

    eng = VoxtralEngine(cfg, params, tokenizer=tok, buckets=(64, 16, 4, 1),
                        enc_kv_ring=1280, dec_kv_ring=dec_ring)

    feed_n = int(interval * 16000)

    def run(audio, enc_mode, extra=0):
        pool = StreamPool(eng, 1, dec_kv_ring=dec_ring, enc_mode=enc_mode,
                          enc_ctx_extra=extra)
        i = pool.add_stream()
        pool.set_processing_interval(i, interval)
        pieces = []
        for off in range(0, len(audio), feed_n):
            pool.feed(i, audio[off: off + feed_n])
            pool.tick()
            pieces += pool.get(i)
        pool.finish(i)
        pieces += pool.get(i)
        del pool
        return pieces

    clips = clip_list(args.wavs, seconds, min_clips, load_wav)
    log(f"{len(clips)} clips: {', '.join(n for n, _ in clips)}")

    grand = {e: [0, 0] for e in extras}
    rates = {e: [] for e in extras}           # per-clip flips/1k
    for name, audio in clips:
        log(f"{name}: {len(audio) / 16000:.0f}s, ring-mode baseline...")
        t0 = time.monotonic()
        base = run(audio, "ring")
        log(f"{name}: ring {len(base)} tokens (+{time.monotonic() - t0:.0f}s)")
        for e in extras:
            t0 = time.monotonic()
            win = run(audio, "window", e)
            d, n = diff(base, win)
            grand[e][0] += d
            grand[e][1] += n
            rates[e].append(1000.0 * d / max(1, n))
            print(f"WINDOW-AB {name} extra={e}: {d}/{n} tokens differ "
                  f"({rates[e][-1]:.1f} flips/1k; "
                  f"ring {len(base)} vs window {len(win)} tokens, "
                  f"+{time.monotonic() - t0:.0f}s)")

    for e in extras:
        d, n = grand[e]
        r = np.asarray(rates[e])
        print(f"WINDOW-AB TOTAL extra={e}: {d}/{n} "
              f"({1000.0 * d / max(1, n):.1f} flips/1k pooled; per-clip "
              f"mean {r.mean():.1f} +/- {r.std():.1f}, "
              f"min {r.min():.1f} max {r.max():.1f} over {len(r)} clips)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
