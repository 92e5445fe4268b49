"""bf16 against int8 transcript A/B through the real loader.

PyTorch counterpart of tools/int8_ab.py.  The --int8 CLI flag (weight-only
int8 decoder, models/quant.py) may change transcripts at near-tied
tokens; this measures that delta on a clip: one checkpoint load, two
engines on it (the quantized one builds its own decoder tree and leaves
the loaded one as it is), a token-level diff of the two streaming
transcripts.

Usage:

    python -m voxtral_tpu_torch.tools.int8_ab [model_dir] [wav]
        [--device cuda|cpu]

model_dir defaults to $VOXTRAL_MODEL_DIR; with no WAV an 11 s synthetic
clip is used.  AB_BITS=4 A/Bs the int4 rung instead (the int4 kernel);
AB_KV=float8_e4m3fn A/Bs the fp8 decoder-KV rung instead (weights bf16 in
both engines; flash-decode reads the fp8 rings).  Prints the token
counts, the number of differing positions and the first few differences;
exit 0 always (the delta is a measurement, not a verdict).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import pick_device, sync, synthetic_audio


def log(msg):
    print(f"[int8ab] {msg}", file=sys.stderr, flush=True)


def diff_tokens(a: list, b: list) -> list:
    """(position, a's token or "<end>", b's) wherever the two differ."""
    n = max(len(a), len(b))
    return [(i, a[i] if i < len(a) else "<end>",
             b[i] if i < len(b) else "<end>")
            for i in range(n)
            if (a[i] if i < len(a) else None) != (b[i] if i < len(b) else None)]


def main(argv=None, cfg=None) -> int:
    """Runs the A/B; `cfg` (default full_config()) lets tests and the
    smoke run drive a smaller or shallower checkpoint."""
    p = argparse.ArgumentParser(prog="int8_ab")
    p.add_argument("model_dir", nargs="?",
                   default=os.environ.get("VOXTRAL_MODEL_DIR"))
    p.add_argument("wav", nargs="?", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if not args.model_dir:
        p.error("model_dir (or VOXTRAL_MODEL_DIR) is required")
    dev = pick_device(args.device, "int8ab")
    if dev is None:
        return 1

    from ..config import full_config
    from ..io.wav import load_wav
    from ..models.params import load_params
    from ..runtime.engine import VoxtralEngine, adaptive_dec_ring
    from ..runtime.stream import transcribe_tokens
    from ..tokenizer import TekkenTokenizer

    cfg = cfg or full_config()
    samples = load_wav(args.wav) if args.wav else synthetic_audio(11.0)
    log(f"{args.wav or 'synthetic clip'}: {len(samples) / 16000:.1f}s")

    t0 = time.monotonic()
    params = load_params(args.model_dir, cfg, device=dev, verbose=True)
    tok = TekkenTokenizer.load(os.path.join(args.model_dir, "tekken.json"))
    sync(dev)
    log(f"weights on the device (+{time.monotonic() - t0:.0f}s)")

    kw = dict(buckets=(64, 16, 4, 1),
              dec_kv_ring=adaptive_dec_ring(cfg, len(samples)))

    eng = VoxtralEngine(cfg, params, tokenizer=tok, **kw)
    t0 = time.monotonic()
    toks16 = transcribe_tokens(eng, samples)
    log(f"bf16: {len(toks16)} text tokens (+{time.monotonic() - t0:.0f}s)")
    del eng

    ab_kv = os.environ.get("AB_KV")
    if ab_kv:
        qmode = f"kv:{ab_kv}"
        cfg_kv = cfg.replace(kv_dtype=ab_kv, enc_kv_dtype=cfg.kv_dtype)
        eng8 = VoxtralEngine(cfg_kv, params, tokenizer=tok, **kw)
    else:
        qmode = "int4" if os.environ.get("AB_BITS") == "4" else "int8"
        eng8 = VoxtralEngine(cfg, params, tokenizer=tok, quantize=qmode, **kw)
    del params  # the quantized engine holds its own decoder tree
    t0 = time.monotonic()
    toks8 = transcribe_tokens(eng8, samples)
    log(f"{qmode}: {len(toks8)} text tokens (+{time.monotonic() - t0:.0f}s)")

    diffs = diff_tokens(toks16, toks8)
    n = max(len(toks16), len(toks8))
    print(f"QUANT-AB: bf16 {len(toks16)} tokens, {qmode} {len(toks8)} tokens, "
          f"{len(diffs)}/{n} positions differ "
          f"({100.0 * (1 - len(diffs) / max(1, n)):.1f}% identical)")
    for i, a, b in diffs[:10]:
        print(f"  @ {i}: bf16 {a!r} vs {qmode} {b!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
