"""Seeded synthetic speech-band audio, one distinct clip a stream.

After the port's `voxtral_tpu_torch/tools/__init__.py:synthetic_audio`
(a 220 Hz tone under a 1.3 Hz envelope plus noise, seeded at 0), with
the seed taken from the run and each clip its own tone, envelope, level
and noise: all drawn on `device` from one torch.Generator, so the same
seed gives the same clips on the same kind of device.
"""

from __future__ import annotations

import math

import torch

SAMPLE_RATE = 16_000


@torch.no_grad()
def clips(seed: int, n: int, seconds: float, device) -> torch.Tensor:
    """[n, seconds * 16000] float32 clips on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((n, 1), generator=gen,
                                           device=device)

    f0, env = uniform(110.0, 330.0), uniform(0.6, 2.6)
    level, phase = uniform(0.1, 0.4), uniform(0.0, 2 * math.pi)
    t = torch.arange(int(seconds * SAMPLE_RATE), device=device,
                     dtype=torch.float32)[None] / SAMPLE_RATE
    noise = torch.randn((n, t.shape[1]), generator=gen, device=device)
    tone = torch.sin(2 * math.pi * f0 * t) * torch.sin(2 * math.pi * env * t
                                                       + phase)
    return level * tone + 0.05 * noise
