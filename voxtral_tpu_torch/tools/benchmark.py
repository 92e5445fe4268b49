"""Mini-suite benchmark runner (the reference's benchmark.py protocol).

PyTorch counterpart of tools/benchmark.py: runs the port's CLI
(`python -m voxtral_tpu_torch.cli -d MODEL_DIR -i WAV`) over WAV files N
times, parses its stderr metric lines with the JAX tool's regexes, and
reports the overall real-time factor, the weighted ms per decode step and
the short- and long-clip step averages.

What each CLI mode prints, and what is reported from it:

  -i (streaming, the default)  `Audio:`, `Encoder: ... (N ms)` and
      `Decoder: ... (S steps) in N ms (prefill P ms + X ms/step)`: the
      real-time factor from encoder + decoder ms, and the step figures
  -i --bulk-encode (offline)   `Audio:` and `Offline transcription: N ms`
      only: the real-time factor from that wall; no step figures

Usage:

    python -m voxtral_tpu_torch.tools.benchmark -d MODEL_DIR [-n REPEATS]
        [--cli-arg ARG]... [files...]

With no files it writes an 11 s synthetic clip and runs that.  Pass the
CLI's own flags through --cli-arg (e.g. --cli-arg=--bulk-encode,
--cli-arg=--device --cli-arg=cpu).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the JAX tool's (and the reference benchmark.py's) line formats
AUDIO_RE = re.compile(r"Audio:\s+\d+\s+samples\s+\(([0-9.]+)\s+seconds?\)")
DECODER_RE = re.compile(
    r"Decoder:\s+\d+\s+text tokens\s+\((\d+)\s+steps\)\s+in\s+(\d+)\s+ms\s+"
    r"\(prefill\s+(\d+)\s+ms\s+\+\s+([0-9.]+)\s+ms/step\)"
)
ENCODER_RE = re.compile(r"Encoder:\s+\d+\s+mel\s+->\s+\d+\s+tokens\s+\((\d+)\s+ms\)")
# the offline (--bulk-encode) mode's one timing line
OFFLINE_RE = re.compile(r"Offline transcription:\s+(\d+)\s+ms")


def run_cli(argv: list[str], cfg=None) -> tuple[int, str]:
    """The CLI's exit code and stderr: a subprocess, or in this process
    when `cfg` is given (a config the command line cannot carry)."""
    if cfg is None:
        proc = subprocess.run(
            [sys.executable, "-m", "voxtral_tpu_torch.cli"] + argv,
            capture_output=True, text=True)
        return proc.returncode, proc.stderr
    from .. import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, cfg=cfg)
    return rc, err.getvalue()


def parse_metrics(err: str) -> dict | None:
    """The metric lines of one run's stderr, or None when the audio line
    or both timing lines are missing."""
    audio_m = AUDIO_RE.search(err)
    dec_m = DECODER_RE.search(err)
    enc_m = ENCODER_RE.search(err)
    off_m = OFFLINE_RE.search(err)
    if not audio_m or not (dec_m or off_m):
        return None
    if dec_m:
        return {
            "mode": "stream",
            "audio_sec": float(audio_m.group(1)),
            "steps": int(dec_m.group(1)),
            "decoder_ms": int(dec_m.group(2)),
            "prefill_ms": int(dec_m.group(3)),
            "step_ms": float(dec_m.group(4)),
            "encoder_ms": int(enc_m.group(1)) if enc_m else 0,
        }
    return {"mode": "offline", "audio_sec": float(audio_m.group(1)),
            "steps": 0, "decoder_ms": int(off_m.group(1)), "prefill_ms": 0,
            "step_ms": 0.0, "encoder_ms": 0}


def run_one(model_dir: str, wav: Path, extra: list[str], cfg=None):
    t0 = time.monotonic()
    rc, err = run_cli(["-d", model_dir, "-i", str(wav)] + extra, cfg)
    wall = time.monotonic() - t0
    m = parse_metrics(err)
    if rc != 0 or m is None:
        print(err[-2000:], file=sys.stderr)
        raise RuntimeError(f"run failed for {wav}")
    return {"file": wav.name, **m, "wall_sec": wall}


def main(argv=None, cfg=None) -> int:
    """Runs the suite; `cfg` (default: the CLI's full_config(), in a
    subprocess) runs the CLI in this process on that config."""
    ap = argparse.ArgumentParser(prog="benchmark")
    ap.add_argument("-d", "--model-dir", required=True)
    ap.add_argument("-n", "--repeats", type=int, default=1)
    ap.add_argument("files", nargs="*", type=Path)
    ap.add_argument("--cli-arg", action="append", default=[],
                    help="extra args forwarded to the CLI")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="voxtral_bench_") as tmp:
        files = args.files
        if not files:
            from ..io.wav import write_wav
            from . import synthetic_audio

            files = [Path(tmp) / "synthetic_11s.wav"]
            write_wav(str(files[0]), synthetic_audio(11.0))
        results = []
        for rep in range(args.repeats):
            for wav in files:
                r = run_one(args.model_dir, wav, args.cli_arg, cfg)
                r["repeat"] = rep
                results.append(r)
                proc_sec = (r["encoder_ms"] + r["decoder_ms"]) / 1000.0
                rtf = proc_sec / r["audio_sec"] if r["audio_sec"] else 0
                steps = (f"{r['steps']} steps @ {r['step_ms']:.1f} ms/step, "
                         f"enc {r['encoder_ms']} ms"
                         if r["mode"] == "stream"
                         else f"offline {r['decoder_ms']} ms")
                print(f"  {wav.name}: {r['audio_sec']:.1f}s audio, {steps}, "
                      f"RTF {rtf:.4f}", file=sys.stderr)

    total_audio = sum(r["audio_sec"] for r in results)
    total_proc = sum(r["encoder_ms"] + r["decoder_ms"] for r in results) / 1000
    total_steps = sum(r["steps"] for r in results)
    print("\n=== Summary ===")
    print(f"overall_rtf         {total_proc / total_audio:.4f}  "
          f"({total_audio / max(total_proc, 1e-9):.2f}x realtime)")
    if total_steps:   # the streaming mode's lines carry the steps
        w_step = sum(r["step_ms"] * r["steps"] for r in results) / total_steps
        print(f"weighted_step_ms    {w_step:.2f}  "
              f"({1000.0 / max(w_step, 1e-9):.2f} tok/s)")
    short = [r["step_ms"] for r in results
             if r["mode"] == "stream" and r["audio_sec"] < 60]
    long_ = [r["step_ms"] for r in results
             if r["mode"] == "stream" and r["audio_sec"] >= 60]
    if short:
        print(f"short_clip_step_ms  {statistics.mean(short):.2f}")
    if long_:
        print(f"long_clip_step_ms   {statistics.mean(long_):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
