"""Measurement tools of the port, run as `python -m voxtral_tpu_torch.tools.
<name>`: jacobi_settle (Jacobi settle-rate brackets), tick_probe (a
StreamPool tick broken into its terms) and pool_soak (N live streams for M
minutes).  Each runs on the CUDA device, or on the CPU only when given
`--device cpu`."""

import sys

import numpy as np
import torch


def pick_device(name: str, tag: str) -> torch.device | None:
    """The device a tool runs on; None (after saying why on stderr) when
    it asks for CUDA and there is none: no fallback to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        print(f"[{tag}] no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return None
    dev = torch.device(name)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[{tag}] device: {kind}", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def synthetic_audio(seconds: float) -> np.ndarray:
    """A 220 Hz tone under a 1.3 Hz envelope plus noise, seeded: the
    audio of a tool given no WAV file."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.25 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 1.3 * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
