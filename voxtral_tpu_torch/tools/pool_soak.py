"""Long-stream serving soak: N continuous live streams for M minutes.

PyTorch counterpart of tools/pool_soak.py.  A StreamPool of N continuous
slots fed 1x-realtime for M wall-minutes (far past every ring's wrap
point), reporting

  - tick-latency p50/p90 of the FIRST and LAST quarter of the run (drift:
    a leak or fill-degradation signal),
  - restarts (the self-healing watchdogs are expected to fire on random
    weights; the soak checks that streams stay alive, not that they never
    restart),
  - tokens, and the pool's device byte ledger.

Usage:

    python -m voxtral_tpu_torch.tools.pool_soak [model_dir] [--device cuda|cpu]

model_dir defaults to $VOXTRAL_MODEL_DIR.  Env: SOAK_STREAMS (default 16) ·
SOAK_MINUTES (default 10) · SOAK_INTERVAL (feed seconds, default 0.5) ·
SOAK_GATE (encode gate seconds, default 0.8x the interval) ·
SOAK_ENC_MODE/SOAK_ENC_RING/SOAK_DEC_RING/SOAK_KV (default: ring, 896,
1024, float8_e4m3fn) · SOAK_QUANT (int8|int4 weight-only decoder) ·
SOAK_WAV (source clip; default synthetic audio) · SOAK_TICK_LOG=1 (log
every tick with its encode/decode split and tokens).  Prints one SOAK
summary line and SOAK PASS or SOAK FAIL (every stream alive, the last
quarter's p50 within 1.5x the first's, and inside the feed interval);
exits 0 on PASS.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import pick_device, synthetic_audio


def log(msg):
    print(f"[soak] {msg}", file=sys.stderr, flush=True)


def pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else -1.0


def main(argv=None, cfg=None) -> int:
    """Runs the tool; `cfg` (default full_config()) lets tests drive a
    small model directory."""
    p = argparse.ArgumentParser(prog="pool_soak")
    p.add_argument("model_dir", nargs="?",
                   default=os.environ.get("VOXTRAL_MODEL_DIR"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if not args.model_dir:
        p.error("model_dir (or VOXTRAL_MODEL_DIR) is required")
    dev = pick_device(args.device, "soak")
    if dev is None:
        return 1
    env = os.environ.get
    n = int(env("SOAK_STREAMS", "16"))
    minutes = float(env("SOAK_MINUTES", "10"))
    interval = float(env("SOAK_INTERVAL", "0.5"))
    gate = float(env("SOAK_GATE", str(0.8 * interval)))
    enc_mode = env("SOAK_ENC_MODE", "ring")
    enc_ring = int(env("SOAK_ENC_RING", "896"))
    dec_ring = int(env("SOAK_DEC_RING", "1024"))
    kv = env("SOAK_KV", "float8_e4m3fn")
    quant = env("SOAK_QUANT", "")

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
    log(f"weights on the device (+{time.monotonic() - t0:.0f}s)")
    eng = VoxtralEngine(cfg, params, tokenizer=tok, buckets=(64, 16, 4, 1),
                        enc_kv_ring=enc_ring, dec_kv_ring=dec_ring,
                        quantize=quant or False)
    pool = StreamPool(eng, n, dec_kv_ring=dec_ring, enc_mode=enc_mode,
                      enc_kv_ring=enc_ring, enc_kv_dtype=kv, dec_kv_dtype=kv)
    slots = []
    for _ in range(n):
        i = pool.add_stream()
        pool.set_processing_interval(i, gate)
        pool.set_continuous(i, True)
        slots.append(i)

    wav = env("SOAK_WAV")
    audio = np.tile(load_wav(wav), 8) if wav else synthetic_audio(90.0)
    feed_n = int(interval * 16000)
    deadline = time.monotonic() + minutes * 60.0
    ticks, tokens, ti = [], 0, 0
    log(f"soaking {n} streams x {minutes:g} min at -I {interval} (gate "
        f"{gate}, {enc_mode}/{kv}, enc {enc_ring} dec {dec_ring}"
        f"{', ' + quant if quant else ''})")
    tick_log = env("SOAK_TICK_LOG", "") == "1"
    while time.monotonic() < deadline:
        off = (ti * feed_n) % (len(audio) - feed_n)
        for i in slots:
            pool.feed(i, audio[off: off + feed_n])
        t1 = time.monotonic()
        e0, d0 = pool.encoder_ms, pool.decoder_ms
        gen0 = sum(s.n_generated for s in pool.slots)
        pool.tick()
        for i in slots:
            tokens += len(pool.get(i))
        ticks.append((time.monotonic() - t1) * 1000.0)
        if tick_log:
            log(f"tick {ti}: {ticks[-1]:.0f} ms (enc "
                f"{pool.encoder_ms - e0:.0f} / dec "
                f"{pool.decoder_ms - d0:.0f}) "
                f"{sum(s.n_generated for s in pool.slots) - gen0} tok")
        ti += 1
        if ti % 200 == 0:
            led = pool.memory_ledger()
            log(f"tick {ti}: p50 {pct(ticks[-200:], 50):.0f} ms, {tokens} "
                f"tokens, {sum(s.n_restarts for s in pool.slots)} restarts, "
                f"{led['total_resident'] / (1 << 30):.2f} GiB resident")

    q = max(1, len(ticks) // 4)
    first, last = ticks[1:q], ticks[-q:]   # tick 0 warms the allocator
    restarts = sum(s.n_restarts for s in pool.slots)
    alive = sum(1 for s in pool.slots if s.active)
    led = pool.memory_ledger()
    audio_s = ti * interval * n
    print(f"SOAK {n} streams x {ti} ticks (-I {interval}, {enc_mode}/{kv}"
          f"{', ' + quant if quant else ''}, {dev.type}): first-quarter p50 "
          f"{pct(first, 50):.0f}/p90 {pct(first, 90):.0f} ms -> last-quarter "
          f"p50 {pct(last, 50):.0f}/p90 {pct(last, 90):.0f} ms; {tokens} "
          f"tokens ({tokens / max(1e-9, audio_s) * 8.0:.1f}% of 1 tok/80ms), "
          f"{restarts} restarts, {alive}/{n} streams alive, "
          f"{led['total_resident'] / (1 << 30):.2f} GiB resident")
    ok = (alive == n
          and pct(last, 50) < max(1.5 * pct(first, 50), 50.0)
          and pct(last, 50) < interval * 1000.0)
    print("SOAK " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
