"""CLI of the PyTorch/CUDA port, with the reference's flag surface
(main.c:27-42, 128-172):

  python -m voxtral_tpu_torch.cli -d <model_dir>
      (-i file.wav [--bulk-encode] | --stdin | --from-mic)
      [-I seconds] [--alt cutoff] [--delay ms] [--monitor] [--debug]
      [--silent] [--int8 | --int4] [--jacobi | --no-jacobi]
      [--device cuda|cpu] [--profile DIR]

The model dir holds the reference's consolidated.safetensors and
tekken.json.  Tokens stream to stdout as they are generated; metrics go to
stderr in the reference's formats.  `-i` streams the file 1 s at a time
through VoxStream; `-i --bulk-encode` runs the whole-clip offline path
instead.  `--stdin` takes WAV bytes, or raw s16le 16 kHz mono PCM in
continuous mode; `--from-mic` captures through arecord or ffmpeg.

The weights load onto the GPU (`--device cuda`, the default); with no CUDA
device the CLI refuses unless it is given `--device cpu`, where every
kernel runs its plain PyTorch version.  --int8 and --int4 quantize the
decoder's weights (models/quant.py), and VOXTRAL_KV_DTYPE=float8_e4m3fn
stores the KV rings in fp8.  Decoding is greedy in the JAX CLI's default
"auto" mode: Jacobi fixpoint bursts (models/jacobi.py) for bursts of 64
rows or more, sequential steps for shorter ones; --jacobi takes Jacobi for
every burst and --no-jacobi none.  --profile DIR writes a torch.profiler
trace (Chrome JSON) of the transcription into DIR.  The JAX CLI's
--compile-cache DIR and --no-compile-cache are accepted and change nothing:
the port keeps no XLA compile cache (its CUDA kernels are built once per
source set, ops/cuda_lib.py).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

# mic capture commands, in order of preference (main.c mic mode analog)
MIC_COMMANDS = (
    ["arecord", "-q", "-f", "S16_LE", "-r", "16000", "-c", "1", "-t", "raw"],
    ["ffmpeg", "-loglevel", "quiet", "-f", "pulse", "-i", "default",
     "-ar", "16000", "-ac", "1", "-f", "s16le", "-"],
)


def _mic_command():
    from shutil import which

    return next((c for c in MIC_COMMANDS if which(c[0])), None)


def _drain(stream, state, alt_mode: bool):
    """Print pending tokens; strips leading whitespace from the very first
    token and renders [best|alt...] groups in alt mode (main.c:48-104)."""
    if alt_mode:
        for g in stream.get_alt():
            alts = [a for a in g if a]
            if not state["any"]:
                alts[0] = alts[0].lstrip()
                if not alts[0]:
                    continue
                state["any"] = True
            if len(alts) > 1:
                sys.stdout.write("[" + "|".join(alts) + "]")
            else:
                sys.stdout.write(alts[0])
        sys.stdout.flush()
        return
    for tok in stream.get():
        if not state["any"]:
            tok = tok.lstrip()
            if not tok:
                continue
            state["any"] = True
        sys.stdout.write(tok)
    sys.stdout.flush()


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """torch.profiler over the block (and the card's kernels on CUDA), its
    Chrome trace written into `trace_dir`; nothing when it is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, f"voxtral_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"Profile trace: {path}", file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: every option of the JAX CLI's, and --device."""
    p = argparse.ArgumentParser(prog="voxtral-tpu-torch",
                                description=__doc__.splitlines()[0])
    p.add_argument("-d", "--model-dir", required=True)
    p.add_argument("-i", "--input", help="WAV file to transcribe")
    p.add_argument("--stdin", action="store_true",
                   help="read WAV or raw s16le 16kHz mono PCM from stdin")
    p.add_argument("--from-mic", action="store_true",
                   help="capture from the default mic (needs arecord or "
                        "ffmpeg)")
    p.add_argument("-I", "--interval", type=float, default=None,
                   help="processing interval seconds")
    p.add_argument("--alt", type=float, default=None, metavar="CUTOFF",
                   help="emit alternative tokens within CUTOFF")
    p.add_argument("--delay", type=int, default=None, metavar="MS",
                   help="transcription delay 80..2400 ms")
    p.add_argument("--monitor", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--silent", action="store_true")
    p.add_argument("--bulk-encode", action="store_true",
                   help="offline -i only: whole-clip no-ring batch encoder")
    p.add_argument("--jacobi", action="store_true",
                   help="Jacobi fixpoint decoding for every burst (greedy "
                        "tokens up to bf16 near-ties); the default, auto, "
                        "takes it for bursts of 64 rows or more")
    p.add_argument("--no-jacobi", action="store_true",
                   help="sequential decoding for every burst")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only decoder")
    p.add_argument("--int4", action="store_true",
                   help="int4 (nibble-packed, per-half scales) weight-only "
                        "decoder")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (default cuda; cpu runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of the "
                        "run to DIR")
    p.add_argument("--compile-cache", metavar="DIR", default=None,
                   help="accepted for the JAX CLI's sake; the port has no "
                        "XLA compile cache")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX CLI's sake; the port has no "
                        "XLA compile cache")
    return p


def main(argv=None, cfg=None) -> int:
    """Runs the CLI; `cfg` (default full_config()) lets tests drive a small
    model directory."""
    p = build_parser()
    args = p.parse_args(argv)

    for flag, given in (("--compile-cache", args.compile_cache is not None),
                        ("--no-compile-cache", args.no_compile_cache)):
        if given:
            print(f"{flag}: nothing to do, the PyTorch port has no XLA "
                  "compile cache", file=sys.stderr)
    if not (args.input or args.stdin or args.from_mic):
        p.error("one of -i, --stdin, --from-mic is required")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    if args.from_mic and _mic_command() is None:
        # fail fast, before the model load
        print("No mic capture backend (arecord/ffmpeg) available",
              file=sys.stderr)
        return 1

    from .config import SAMPLE_RATE, STREAM_DEFAULT_INTERVAL_S, full_config
    from .io.wav import load_wav, parse_wav_bytes, resample_linear
    from .models.params import load_params
    from .runtime import stream as stream_mod
    from .runtime.engine import VoxtralEngine, adaptive_dec_ring
    from .runtime.stream import VoxStream
    from .tokenizer import TekkenTokenizer

    stream_mod.verbose = v = 0 if args.silent else (2 if args.debug else 1)
    stream_mod.monitor = args.monitor
    cfg = cfg or full_config()
    kv_env = os.environ.get("VOXTRAL_KV_DTYPE")
    if kv_env:
        cfg = cfg.replace(kv_dtype=kv_env)
    device = torch.device(args.device)

    # read the input up front when its length is knowable, so the decoder
    # KV ring can be sized to the clip
    samples = None
    stdin_head = None
    if args.input:
        samples = load_wav(args.input)
    elif args.stdin:
        stdin_head = sys.stdin.buffer.read(4)
        if stdin_head == b"RIFF":
            raw, rate = parse_wav_bytes(stdin_head + sys.stdin.buffer.read())
            samples = resample_linear(raw, rate, SAMPLE_RATE)
            stdin_head = None
    # live mode restarts at STREAM_MAX_DECODE_KV=2000, so 2048 holds it
    dec_ring = adaptive_dec_ring(cfg, len(samples)) if samples is not None \
        else 2048

    t0 = time.monotonic()
    if v:
        print(f"Loading model from {args.model_dir} onto {device}",
              file=sys.stderr)
    params = load_params(args.model_dir, cfg, device=device, verbose=v >= 2)
    tok = TekkenTokenizer.load(os.path.join(args.model_dir, "tekken.json"))
    # streaming bursts are bounded by the processing interval (~25 tokens at
    # the 2 s default), so the 256-bucket is not needed
    engine = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=dec_ring,
                           buckets=(64, 16, 4, 1),
                           decode_mode=("jacobi" if args.jacobi
                                        else "sequential" if args.no_jacobi
                                        else "auto"),
                           quantize="int4" if args.int4 else args.int8)
    if args.delay is not None:
        engine.set_delay(args.delay)
    if v:
        print(f"Model loaded in {time.monotonic() - t0:.1f}s", file=sys.stderr)
        # the reference's "Metal GPU memory used" line (voxtral.c:247-249)
        led = engine.memory_ledger()
        print(f"Device memory: {led['params_total'] / 2**30:.2f} GiB weights "
              f"resident; KV caches "
              f"{led['dec_cache_bytes_per_stream'] / 2**20:.0f} (dec ring "
              f"{engine.dec_kv_ring}) + "
              f"{led['enc_cache_bytes_per_stream'] / 2**20:.0f} MiB/stream "
              f"(enc ring {engine.enc_kv_ring})", file=sys.stderr)
        mode = {"auto": f"auto (Jacobi for bursts of >= "
                        f"{engine.jacobi_window} rows, sequential below)",
                "jacobi": f"jacobi (window {engine.jacobi_window})",
                "sequential": "sequential"}[engine.decode_mode]
        print(f"Decoding: greedy, {mode}", file=sys.stderr)

    if args.input and args.bulk_encode:
        from .runtime.offline import transcribe_offline

        t0 = time.monotonic()
        with _profiled(args.profile, device):
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
                      f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
                      f" GiB (dec ring {engine.dec_kv_ring})",
                      file=sys.stderr)
        return 0

    if v:
        print("Compiling kernels...", file=sys.stderr)
        t0 = time.monotonic()
    engine.warmup(
        n_alt=4 if args.alt is not None else 0,
        progress=(lambda m: print(f"  {m}", file=sys.stderr, flush=True))
        if v else None,
        interval_s=args.interval if args.interval is not None
        else STREAM_DEFAULT_INTERVAL_S,
    )
    if v:
        print(f"Warm-up done in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    with _profiled(args.profile, device):
        _stream(args, VoxStream(engine), samples, stdin_head, v)
    return 0


def _stream(args, s, samples, stdin_head, v: int) -> None:
    """Feeds the input through the VoxStream `s`, printing tokens as they
    come (main.c:109-118 and the continuous modes), then its stats."""
    from .config import SAMPLE_RATE

    if args.interval is not None:
        s.set_processing_interval(args.interval)
    if args.alt is not None:
        s.set_alt(4, args.alt)
    state = {"any": False}

    def drain():
        _drain(s, state, args.alt is not None)

    if samples is not None:          # -i, or WAV bytes on stdin
        if v:
            print(f"Audio: {len(samples)} samples "
                  f"({len(samples) / SAMPLE_RATE:.1f} seconds)",
                  file=sys.stderr)
        # 1-second chunks, draining as we go (main.c:109-118)
        for i in range(0, len(samples), SAMPLE_RATE):
            s.feed(samples[i: i + SAMPLE_RATE])
            drain()
    elif args.stdin:                 # raw s16le PCM, live
        s.set_continuous(True)
        if stdin_head:
            s.feed(np.frombuffer(stdin_head, dtype="<i2").astype(np.float32)
                   / 32768.0)
        while True:
            raw = sys.stdin.buffer.read(8192)
            if not raw:
                break
            pcm = np.frombuffer(raw[: len(raw) // 2 * 2], dtype="<i2")
            s.feed(pcm.astype(np.float32) / 32768.0)
            drain()
    else:                            # --from-mic
        from .mic import MicCapture, run_mic_loop

        cmd = _mic_command()
        if v:
            print(f"Capturing from mic via {cmd[0]} (ctrl-c to stop)",
                  file=sys.stderr)
        s.set_continuous(True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        try:
            # over-buffer catch-up + silence gating + skip-feed during
            # extended silence (main.c:235-296), see mic.py
            run_mic_loop(s, MicCapture(proc.stdout), drain)
        except KeyboardInterrupt:
            pass
        finally:
            proc.terminate()
            proc.wait()
    s.finish()
    drain()
    sys.stdout.write("\n")
    s.print_stats()


if __name__ == "__main__":
    sys.exit(main())
