"""CLI of the PyTorch/CUDA port, offline path only:

  python -m voxtral_tpu_torch.cli -d <model_dir> -i file.wav --bulk-encode

The model dir holds the reference's consolidated.safetensors and
tekken.json.  The transcript goes to stdout; metrics go to stderr in the
reference's formats.  The weights load onto the GPU when one is present,
else the CPU (where every kernel runs its plain PyTorch version).

The flag surface is the JAX package's (voxtral_tpu/cli.py).  The streaming,
stdin and microphone modes, --alt, --int8/--int4 and --jacobi are not
ported yet: they exit with status 2.  Decoding is sequential greedy: the
JAX CLI's default "auto" mode takes Jacobi bursts, which are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

_NOT_PORTED = {
    "stdin": "--stdin",
    "from_mic": "--from-mic",
    "alt": "--alt",
    "int8": "--int8",
    "int4": "--int4",
    "jacobi": "--jacobi",
    "monitor": "--monitor",
}


def main(argv=None, cfg=None) -> int:
    """Runs the CLI; `cfg` (default full_config()) lets tests drive a small
    model directory."""
    p = argparse.ArgumentParser(prog="voxtral-tpu-torch",
                                description=__doc__.splitlines()[0])
    p.add_argument("-d", "--model-dir", required=True)
    p.add_argument("-i", "--input", help="WAV file to transcribe")
    p.add_argument("--stdin", action="store_true")
    p.add_argument("--from-mic", action="store_true")
    p.add_argument("--alt", type=float, default=None, metavar="CUTOFF")
    p.add_argument("--delay", type=int, default=None, metavar="MS",
                   help="transcription delay 80..2400 ms")
    p.add_argument("--monitor", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--silent", action="store_true")
    p.add_argument("--bulk-encode", action="store_true",
                   help="offline -i: whole-clip no-ring batch encoder (the "
                        "only mode the port runs so far)")
    p.add_argument("--jacobi", action="store_true")
    p.add_argument("--no-jacobi", action="store_true",
                   help="sequential decoding (the port's only mode)")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int4", action="store_true")
    args = p.parse_args(argv)

    for attr, flag in _NOT_PORTED.items():
        if getattr(args, attr) not in (None, False):
            print(f"{flag}: not ported yet (ROADMAP.md)", file=sys.stderr)
            return 2
    if not (args.input and args.bulk_encode):
        print("the streaming path is not ported yet; the port runs "
              "`-i FILE --bulk-encode` (ROADMAP.md)", file=sys.stderr)
        return 2

    from .config import SAMPLE_RATE, full_config
    from .io.wav import load_wav
    from .models.params import load_params
    from .runtime.engine import VoxtralEngine, adaptive_dec_ring
    from .runtime.offline import transcribe_offline
    from .tokenizer import TekkenTokenizer

    v = 0 if args.silent else (2 if args.debug else 1)
    cfg = cfg or full_config()
    kv_env = os.environ.get("VOXTRAL_KV_DTYPE")
    if kv_env:
        cfg = cfg.replace(kv_dtype=kv_env)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")

    samples = load_wav(args.input)
    dec_ring = adaptive_dec_ring(cfg, len(samples))

    t0 = time.monotonic()
    if v:
        print(f"Loading model from {args.model_dir} onto {device}",
              file=sys.stderr)
    params = load_params(args.model_dir, cfg, device=device, verbose=v >= 2)
    tok = TekkenTokenizer.load(os.path.join(args.model_dir, "tekken.json"))
    engine = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=dec_ring,
                           buckets=(64, 16, 4, 1))
    if args.delay is not None:
        engine.set_delay(args.delay)
    if v:
        print(f"Model loaded in {time.monotonic() - t0:.1f}s", file=sys.stderr)
        print("Decoding: sequential greedy (Jacobi bursts are not ported)",
              file=sys.stderr)

    t0 = time.monotonic()
    text = transcribe_offline(engine, samples)
    sys.stdout.write(text + "\n")
    if v:
        dur = len(samples) / SAMPLE_RATE
        wall = time.monotonic() - t0
        print(f"Audio: {len(samples)} samples ({dur:.1f} seconds)",
              file=sys.stderr)
        print(f"Offline transcription: {wall * 1000:.0f} ms "
              f"({dur / wall:.1f}x realtime)", file=sys.stderr)
        if device.type == "cuda":
            print(f"GPU memory peak: "
                  f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
                  f"(dec ring {engine.dec_kv_ring})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
