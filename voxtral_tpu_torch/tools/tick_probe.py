"""Per-tick latency attribution of a ring-mode StreamPool under load.

PyTorch counterpart of tools/tick_probe.py: N continuous live streams in a
StreamPool (ring encoder mode, fp8 encoder and decoder rings), fed
1x-realtime, one tick broken into its terms:

  encode wall  - the batched ring encode call(s)
  decode wall  - the decode bursts and their token reads
  bursts/tick  - bursts per tick: q = min(backlogs), so uneven backlogs
                 split one tick into several bursts, each with its own
                 launches and host read

Usage:

    python -m voxtral_tpu_torch.tools.tick_probe [model_dir] [n_streams]
        [ticks] [--device cuda|cpu]

model_dir defaults to $VOXTRAL_MODEL_DIR.  Env: PROBE_GATE_S (default 0.4),
PROBE_INTERVAL_S (default 0.5), PROBE_ENC_RING (default 896), PROBE_WAV (a
WAV file; default: synthetic audio), PROBE_SPLIT=1 (a device sync between
the tick's halves, so device time is charged to the half that launched it).
Two rounds of `ticks` ticks run; the second is reported.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import pick_device, sync, synthetic_audio


def log(msg):
    print(f"[tickprobe] {msg}", file=sys.stderr, flush=True)


def main(argv=None, cfg=None) -> int:
    """Runs the tool; `cfg` (default full_config()) lets tests drive a
    small model directory."""
    p = argparse.ArgumentParser(prog="tick_probe")
    p.add_argument("model_dir", nargs="?",
                   default=os.environ.get("VOXTRAL_MODEL_DIR"))
    p.add_argument("n_streams", nargs="?", type=int, default=16)
    p.add_argument("ticks", nargs="?", type=int, default=24)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if not args.model_dir:
        p.error("model_dir (or VOXTRAL_MODEL_DIR) is required")
    dev = pick_device(args.device, "tickprobe")
    if dev is None:
        return 1
    n, ticks = args.n_streams, args.ticks
    gate_s = float(os.environ.get("PROBE_GATE_S", "0.4"))
    interval_s = float(os.environ.get("PROBE_INTERVAL_S", "0.5"))
    enc_ring = int(os.environ.get("PROBE_ENC_RING", "896"))
    split = os.environ.get("PROBE_SPLIT", "0") == "1"

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
    engine = VoxtralEngine(cfg, params, tokenizer=tok, buckets=(64, 16, 4, 1))

    wav = os.environ.get("PROBE_WAV")
    audio = np.tile(load_wav(wav), 8) if wav else synthetic_audio(90.0)

    pool = StreamPool(
        engine, n, dec_kv_ring=1024, enc_mode="ring", enc_kv_ring=enc_ring,
        enc_kv_dtype="float8_e4m3fn", dec_kv_dtype="float8_e4m3fn")
    slots = []
    for _ in range(n):
        i = pool.add_stream()
        pool.set_processing_interval(i, gate_s)
        pool.set_continuous(i, True)
        slots.append(i)

    feed_n = int(interval_s * 16000)
    rows = []   # one per measured tick, in the order of `names`
    for rnd in range(2):          # round 0 warms the allocator and cuBLAS
        for ti in range(ticks):
            off = (ti * feed_n) % (len(audio) - feed_n)
            e0, d0 = pool.encoder_ms, pool.decoder_ms
            b0, r0, f0 = pool.n_bursts, pool.burst_rows, pool.fetch_ms
            ec0 = pool.n_enc_calls
            t1 = time.monotonic()
            for s in slots:
                pool.feed(s, audio[off: off + feed_n])
            if split:
                pool._tick_encoder()
                sync(dev)
                t_mid = time.monotonic()
                pool._tick_decoder()
                pool._mon_flush()
                dt = (time.monotonic() - t1) * 1000.0
                enc_wall = (t_mid - t1) * 1000.0
                dec_wall = dt - enc_wall
            else:
                pool.tick()
                dt = (time.monotonic() - t1) * 1000.0
                enc_wall = pool.encoder_ms - e0
                dec_wall = pool.decoder_ms - d0
            if rnd:
                rows.append((dt, enc_wall, dec_wall, pool.n_bursts - b0,
                             pool.burst_rows - r0, pool.fetch_ms - f0,
                             pool.n_enc_calls - ec0))
            for s in slots:
                pool.get(s)
            if ti % 8 == 0:
                log(f"round {rnd} tick {ti}/{ticks}: {dt:.0f} ms")

    a = np.array(rows)
    names = ["tick", "enc", "dec", "bursts", "rows", "fetch", "enc_calls"]
    print(f"TICKPROBE n={n} interval={interval_s} gate={gate_s} "
          f"enc_ring={enc_ring} ticks={len(rows)} split={int(split)} "
          f"device={dev.type}")
    for j, nm in enumerate(names):
        col = a[:, j]
        print(f"  {nm:9s} p50 {np.percentile(col, 50):8.1f}  "
              f"p90 {np.percentile(col, 90):8.1f}  "
              f"mean {col.mean():8.1f}  max {col.max():8.1f}")
    for r in a[a[:, 0].argsort()][-5:]:       # the five slowest ticks
        print("  worst: " + "  ".join(
            f"{nm}={v:.1f}" for nm, v in zip(names, r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
