"""Tools of the port, run as `python -m voxtral_tpu_torch.tools.<name>`:

  checkpoint  make_fake_ckpt (a synthetic checkpoint in the reference's
              layout), inspect_weights (its tensors), fidelity_check (the
              engine through the real loader against the independent f32
              oracle of `oracle.py`), make_golden (token-ID fixtures:
              record, ingest, check), runtest.sh (the end-to-end
              regression script)
  A/B         int8_ab (bf16 against int8, int4 or fp8 KV), window_ab (the
              pool's ring encoder against window recompute)
  measuring   benchmark (the CLI over WAV files), jacobi_settle (Jacobi
              settle-rate brackets), tick_probe (a StreamPool tick broken
              into its terms), pool_soak (N live streams for M minutes),
              microbench (ms per step of the hot calls), decode_profile
              (the decode step split into its terms), int4_kernel_bench
              (one decode-shaped product per matrix, three ways),
              bulk_encode_bench (the incremental encoder against bulk)

Each runs on the CUDA device, or on the CPU only when given
`--device cpu`."""

import sys
import time

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet, dense): the least time a
# term could take is the larger of its bytes over the memory rate and its
# operations over the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


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


def timeit(fn, n: int, dev: torch.device) -> float:
    """Seconds per call of fn() over n calls, after two untimed ones: CUDA
    events around the calls on the card (the host's gaps between launches
    included, as a caller sees them), the host clock on the CPU."""
    fn()
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def graph_time(fn, n: int, dev: torch.device, reps: int = 3) -> float:
    """Seconds per call of fn() free of host gaps: on the card, n calls
    captured in one CUDA graph (after two warm calls on a side stream) and
    replayed `reps` times between CUDA events; on the CPU, timeit."""
    if dev.type != "cuda":
        return timeit(fn, n, dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / (reps * n)
