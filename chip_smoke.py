#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voxtral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases below
    python3 chip_smoke.py --profile    # device, build, then the profile
    python3 chip_smoke.py --int4 [ROOT]  # device, build, int4, rows only
                                         # (ROOT: the package of another
                                         # checkout, for an A/B in one call)
    python3 chip_smoke.py --only jacobi,pool_ring  # device, build, then the
                                         # named phases (ONLY_PHASES)

Phases, in order, each printing its own lines; any failure raises and the
script exits non-zero:

  1. device   torch/CUDA versions and the card's name and power limit;
               no CUDA device -> non-zero exit, no CPU fallback
  2. build    nvcc builds the hand-written kernels from
               voxtral_tpu_torch/csrc/*.cu for sm_90a
  3. banded   kernel (A) against its plain PyTorch version at the
               full-width encoder shape (H=KH=32, D=64, window 750), up to
               the serve phase's B=16 padded 30 s clips and the window
               pool's B=32 T=852 with mixed kv_lo, and the bench's
               shapes (bulk encode B=4 T=3196, the load-window-exact tick
               B=16 T=2648 with kv_lo up to its 2248-row context); its
               times, plain time (4 streams a call), bound and SDPA's at
               B=1 T=1500, the serve, pool and bench shapes
  4. flash    kernel (B) against its plain version at the full-width decoder
               shape (H=32, KH=8, D=128, L=26), with and without the row
               write, fp8, bf16 and f32 rings (bit-equal rings), up to the
               serve phase's B=16 rings of 896 slots, two calls bitwise
               equal, and the bench's B=64 bf16 and B=80 fp8 rings; its
               times, bound and SDPA's at the slice shape (B=1 cap 512 pos
               300), the serve shape (B=16 cap 896, mixed positions around
               500) in bf16 and fp8, and the bench's B=64 bf16 and B=80
               fp8
  5. flash_enc kernel (E) against its plain version at the full-width
               streaming-encoder shape (H=KH=32, D=64, stacked rings of
               1024 and 1000 slots, window 750) for B in {1, 16}, T from 4
               to 274, positions at 0, in the first lap and after
               wraparound, and on the bench's 1280-slot ring (T=512, 124,
               530 at B=1 and 2), under both mappings of its split walk
               (bitwise equal); its output bitwise equal across three
               chunkings of 256 rows at B=1 and B=16; its times at B=16
               T=64 and B=1 T=100 by mapping, at the ring pool's B=8
               T=24 (checked there too) and the bench's B=1 T=512 on
               1280 slots
  6. int4     kernel (C) against its plain version at the five
               full-width int4 matrices (wqkv, wo, w13, w2, logits table;
               26-layer stacks, read at layer 25) at 1, 16, 64, 608, 56
               and 2128 rows (the last two: the bench's int4 decode and
               prefill), two calls bitwise equal; its plans and the card's
               occupancy for them; graph-replay times at each row count
               but 1 of the kernel,
               plain and the bf16 yardstick, and of one decode step's 105
               products (26 layers + the table, 1.71 GB packed)
  7. rows     kernel (D) against its plain version on [16, 26, 8, 896,
               128] rings in fp8, bf16 and f32 (bit-equal rings); its
               graph-replay time beside the card's launch floor
  8. slice    full_config() bf16 with seeded random weights: three
               synthetic clips through transcribe_offline_ids on one
               VoxtralEngine, with launch counts, timings and checks
  9. serve    the batched serving pipeline at B=16 (bulk encode of all
               streams, bprefill, bdecode_burst bursts), once per rung of
               the dtype ladder bf16 / fp8kv / int8 / int4, with launch
               counts, timings, decode ms/step at mid-clip fill and checks
               (on fp8kv also the plain attention path, attn_impl "xla",
               timed beside the kernel's and counted for the row-write
               kernel); then once on the int4 weights dequantized to bf16
               (plain matmuls), whose ids must agree with the int4 rung's
  9b. graphs  the engine's CUDA graphs (voxtral_tpu_torch/ops/graphs.py)
               against eager in this call (phase_graphs): serve B=16 x 30 s
               on bf16, fp8kv, int8 and int4 with ids bit-equal, decode
               ms/step, device ms, device events, the host's launch calls
               (at most LAUNCH_CALLS_MAX per graphed step) and busy share at
               mid fill (fp8kv also under "xla", the row-write kernel), one
               step's f32 logits bit-equal; the B=1 stream's feed() p50/p90
               and the Jacobi clip, ids bit-equal; the captures' count, host
               seconds and pool memory (also for the whole run)
 10. stream   VoxStream at B=1 on an 11 s clip fed 1 s at a time (2 s
               interval), 0.5 s at a time (-I 0.5) and unfused: exact
               launch counts, id agreement among the runs and with the
               offline path, feed() walls, decode ms/step
 11. bstream  BatchedTranscriber at B=16 x 30 s, 200-frame intervals,
               decoder ring 896: exact launch counts, aggregate x realtime,
               stream 0 against a B=1 VoxStream
 12. jacobi   the 30 s clip of the slice through transcribe_offline_ids at
               B=1 with decode_mode "auto" (Jacobi for the 64-row bursts)
               and "sequential": exact launch counts, tokens per
               iteration, decode ms per token, the share of equal ids; then
               a small f32 config, where Jacobi ids must equal sequential
               ones up to a near-tie (JACOBI_TIE_REL)
 13. pool_ring the StreamPool in ring mode: 8 continuous slots, bf16
               encoder ring 1024 (flash-encode), decoder ring 896, -I 0.5
               with a 0.4 s gate, 2 rounds of 16 ticks, one slot churning:
               exact launch counts, tick p50/p90, tokens and bursts per
               tick, the encode/decode split, peak memory, slot 0 against a
               B=1 VoxStream fed the same audio
 14. pool_window the StreamPool in window mode: 32 slots, fp8 decoder ring
               1024, -I 2.0, 2 rounds of 8 ticks, the same churn (banded
               attention at B=32 with per-slot kv_lo); slot 0 against the
               ring pool's
 15. mesh     multi-device serving with ranks spawned on this one card,
               joined over gloo (NCCL takes one card per rank): (a) the
               full-width serve pipeline (bulk encode, batched prefill,
               decode bursts) of 4 x 10 s clips at dp 1 x tp 2 against the
               same clips unsharded: exact launches per rank (banded at 16
               heads, flash-decode at 16q/4kv), the prefill's last hidden
               state against an f32 witness of the same clips within
               MESH_HIDDEN_REL_TOL and MESH_WITNESS_FACTOR x the tp-1
               run's error, ids' agreement printed;
               (b) small_config at dp 2 x tp 2: f32 serving and ring pool
               ids exactly equal to the unsharded runs', then the pool in
               bf16 through flash-encode; (c) kernels #1, #4, #7 at one tp
               rank's serve shapes against plain, their graph-replay times,
               bounds and SDPA's, and flash-decode at the two pool shapes
 16. mel_device audio/mel_device.py on B=16 x 30 s clips against the host
               mel (3e-4), both times
 17. bench    the port's bench (voxtral_tpu_torch/bench.py, phase_bench)
               in this process: bf16 at 16 streams x 30 s with the three
               step probes, the -I 0.5 latency run and the four load rows
               at 4 ticks, then int4 alone; each result printed on its own
               line and failed on a -1 value, an `_oom` key, a value <= 0
               or no launch of its kernels; then run_once in bulk mode at
               4 streams, its ids bit-equal to serve_clips, and "inc"
               mode's agreeing with them (STREAM_AGREE_MIN)
 18. ckpt     the checkpoint path through the tools a user runs
               (phase_ckpt): make_fake_ckpt writes a full-width
               checkpoint cut to CKPT_LAYERS (4 + 4 layers, 2.0 GB) into a
               temporary directory; the CLI loads it with -d and
               transcribes an 11 s clip offline (--bulk-encode), streaming
               and with --int4 (load seconds, GiB, x realtime, the metric
               lines); fidelity_check PASSes against the independent f32
               oracle; make_golden record + check finds equal ids;
               int8_ab with AB_BITS=4 prints the differing positions;
               banded, flash-decode, flash-encode and int4 all launch
Besides, after flash_enc, f32_auto drives the f32 encoder path
(f32_encoder_auto): a float32 small_config under attn_impl "auto" runs
the banded and flash-encode kernels' f32 instantiation (csrc/attn_f32.cuh)
and equals the plain path within F32_ENCODER_REL_TOL; each f32 kernel is
held against its plain version (F32_ATTN_TOL) and timed at full width.  `--only ckpt_full` runs
the CLI's offline load and the fidelity check on the full-depth (32 + 26
layers, 8.9 GB) checkpoint.  Each phase's seconds are in `phase_s`.

The line before the last but one is a JSON object with one entry per
kernel (and the slice, serve, stream, bstream, jacobi, pool, mesh,
mel_device, f32_auto, bench and ckpt tables), the line before the last
the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  `--profile` instead prints
torch.profiler's breakdown of the serve pipeline at B=16 (encode,
prefill, decode per rung) and of the streaming paths at steady state (a
B=1 feed, a B=16 BatchedTranscriber interval).  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# tolerances of the kernel-vs-plain comparisons (max abs error, f32 outputs)
# (A): both versions round the probabilities to bf16 before the PV product,
#      the kernel against its running max, the plain one against the row max
BANDED_TOL = 2e-2
# (B): the same bf16/f32 ring values, f32 arithmetic in another order
FLASH_TOL = 1e-4
# (E), flash encode: as (A), both versions round the probabilities to bf16
#      before the PV product, against different maxima (the kernel's
#      running max, the plain version's row max)
FLASH_ENC_TOL = 2e-2
# (F): #1 and #7 on float32 queries (csrc/attn_f32.cuh): f32 throughout,
#      only the order of the f32 operations differs
F32_ATTN_TOL = 1e-5
# a float32 small_config's streaming and bulk encoder outputs under "auto"
# (both kernels' f32 walk) against "xla" (the plain functions), norm-wise
# relative: (F) through four layers
F32_ENCODER_REL_TOL = 1e-4
# (C): bf16 x int4 products are exact; only the f32 summation order differs
# (the mma tiles and the cluster's K split against cuBLAS), compared
# relative to max |plain|
INT4_REL_TOL = 1e-5
# kernels built to spill no register (the build phase fails if they do)
NO_SPILL_KERNELS = ("banded_attention_kernel", "flash_encode_kernel",
                    "flash_decode_kernel", "int4_mm_kernel",
                    "banded_attention_f32_kernel", "flash_encode_f32_kernel")
# slice/serve: one decoder step through the kernel path and through the
# plain path, bf16 hidden state (and f32 logits) compared relative to
# their max magnitude
STEP_REL_TOL = 5e-2
# serve: every int4 weight lies within half a quantization step of the
# weight it came from, |w - q s| <= (0.5 + QUANT4_STEP_SLACK) s (the slack
# covers the f32 rounding of w / s and q s)
QUANT4_STEP_SLACK = 1e-5
# serve: least share of ids the int4 rung must share with the same pipeline
# run in bf16 on its dequantized weights (the JAX tests' bar for a rung)
DEQUANT_AGREE_MIN = 0.5
# stream: least share of ids each streaming run must share with the others
# and with the offline path on the same clip (the same bar: random weights,
# and cuBLAS picks its GEMM algorithm by row count, so other chunkings
# round differently on the card)
STREAM_AGREE_MIN = 0.5
# jacobi: where f32 Jacobi ids first differ from sequential ones, a
# sequential top-2 logit gap below this share of max |logit| is a near-tie
# (f32 products in another order); any other difference fails
JACOBI_TIE_REL = 1e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms from CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the host's calls into the CUDA runtime that put work on a stream: one per
# kernel launch, graph launch, copy or fill; a graphed decode step makes
# three (its adapter row in, the graph, its token out) and its burst a few
LAUNCH_CALLS_MAX = 10
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel",
                "cuLaunchKernelEx")


def profiled(fn, iters: int = 1) -> tuple[list, int, float]:
    """The device events (kernels, copies) torch.profiler records over
    `iters` calls of fn(), after one unprofiled call; the host's launch
    calls into the runtime among its host events (LAUNCH_CALLS); and the
    host wall of the profiled calls in seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # the card's profiler has come back empty at times
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        # "Command Buffer Full" marks the host waiting on a full launch queue
        all_events = prof.events()
        events = [e for e in all_events
                  if e.device_type == DeviceType.CUDA
                  and "Command Buffer Full" not in e.name]
        calls = sum(1 for e in all_events
                    if e.device_type == DeviceType.CPU
                    and e.name in LAUNCH_CALLS)
        if events:
            return events, calls, wall
        log("timing", "torch.profiler recorded no device time; again")
    raise AssertionError("torch.profiler recorded no device time")


def device_events(fn, iters: int = 1) -> tuple[list, float]:
    """profiled() without the launch calls: (device events, wall s)."""
    events, _, wall = profiled(fn, iters)
    return events, wall


def device_ms(fn, iters: int, with_events: bool = False):
    """Mean device time of fn() in ms: the summed durations of its device
    events over `iters` calls (and, `with_events`, the events per call).
    Unlike cuda_ms it has no host gaps, which dominate when the host issues
    small kernels slower than the device runs them."""
    events, _ = device_events(fn, iters)
    ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    return (ms, len(events) / iters) if with_events else ms


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time of one call of fn() in ms, free of host gaps and of the
    profiler: `iters` calls captured in one CUDA graph, replayed `reps`
    times between CUDA events.  (torch.profiler dropped kernel records on
    the card, or returned none, in some runs.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture, as torch asks
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


# the card's published peaks (H100 SXM datasheet): the
# least time a kernel could take is the larger of its bytes over the memory
# rate and its operations over the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12     # float32 outside the tensor cores


def bound(n_bytes: float, n_flops: float, rate: float = BF16_FLOPS) -> dict:
    """bound_ms and bound_by for work that must move `n_bytes` (each input
    read once, each output written once) and do `n_flops` at `rate`."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sdpa_ms(q, k, v, mask, iters: int = 20) -> float:
    """CUDA-event time of one F.scaled_dot_product_attention call over
    [B, H, T, D] queries and [B, KH, S, D] keys with a boolean mask: the
    library yardstick of the attention kernels (the port never calls
    it)."""
    import torch.nn.functional as F

    gqa = q.shape[1] != k.shape[1]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=gqa), iters)


def phase_device() -> str:
    import torch

    log("device", f"python {sys.version.split()[0]} torch {torch.__version__} "
                  f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("[device] torch.cuda.is_available() is false: "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}, capability "
                  f"{torch.cuda.get_device_capability(0)}")
    # TF32 off for every float32 product (the reference numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def _kernel_name(mangled: str) -> str:
    """The kernel's name and template arguments in an Itanium-mangled
    symbol: the length-prefixed identifier that ends in "_kernel" (the
    anonymous namespace's hashed name before it is skipped by its length),
    then its "I...E" arguments."""
    pos = 0
    while True:
        m = re.compile(r"\d+").search(mangled, pos)
        if not m:
            return mangled
        end = m.end() + int(m.group())
        ident = mangled[m.end():end]
        if ident.endswith("_kernel"):
            args = re.match(r"I.*?E", mangled[end:])
            return ident + (args.group() if args else "")
        pos = end if ident.isidentifier() else m.end()


def phase_build() -> None:
    import os

    from voxtral_tpu_torch.ops import cuda_lib

    t0 = time.monotonic()
    lib_path = cuda_lib.build()
    cuda_lib.kernels()
    log("build", f"{lib_path} in {time.monotonic() - t0:.1f} s")
    # ptxas -v: one line per kernel with its registers and spill bytes
    name, stores, spills, kept_spills = None, 0, 0, 0
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = _kernel_name(line.split("'")[1])
            elif "spill stores" in line:
                spill = line.split("bytes stack frame, ")[1].split(",")
                stores = int(spill[0].split()[0])
                n = stores + int(spill[1].split()[0])
                spills += n
                if name and name.startswith(NO_SPILL_KERNELS):
                    kept_spills += n
            elif "Used" in line and "registers" in line and name:
                log("build", f"{name}: {line.split('Used ')[1].strip()}; "
                             f"spill stores {stores}")
                name = None
    log("build", f"spilled bytes over all kernels: {spills}")
    if kept_spills:
        raise AssertionError(f"[build] the kernels of {NO_SPILL_KERNELS} "
                             f"spill {kept_spills} bytes")


def _randn(gen, shape, dtype, device: str = "cuda"):
    import torch

    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _band_mask(t: int, window: int):
    import torch

    i = torch.arange(t, device="cuda")
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


# the plain banded version is timed over this many streams a call: its
# [T, T] f32 scores per head take 5.9 GB at B=16 T=1696 in one call
BANDED_PLAIN_STREAMS = 4


def _banded_times(q, k, v, kv_lo, window: int) -> dict:
    """Kernel (A) at one shape, bf16 out as on the path: CUDA events and
    device time, the plain version (in calls of BANDED_PLAIN_STREAMS
    streams), SDPA with the band mask, and the bound."""
    import torch

    from voxtral_tpu_torch.ops.banded_encode import (
        banded_attention_batched,
        banded_attention_plain,
    )

    bsz, t, h, d = q.shape

    def kern():
        banded_attention_batched(q, k, v, kv_lo, window=window,
                                 out_dtype=torch.bfloat16)

    def plain():
        for i in range(0, bsz, BANDED_PLAIN_STREAMS):
            j = i + BANDED_PLAIN_STREAMS
            banded_attention_plain(q[i:j], k[i:j], v[i:j], kv_lo[i:j],
                                   window=window, out_dtype=torch.bfloat16)

    out = {"ms": cuda_ms(kern, 20), "device_ms": graph_ms(kern, 10),
           "plain_ms": cuda_ms(plain, 3, warmup=1)}
    # the library call: SDPA with the boolean band mask (and each stream's
    # leading keys hidden below its kv_lo)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = _band_mask(t, window)
    if bool(kv_lo.any()):
        keys = torch.arange(t, device="cuda")
        mask = (mask[None] & (keys >= kv_lo[:, None, None]))[:, None]
    out["library_ms"] = sdpa_ms(qt, kt, vt, mask, 10)
    del qt, kt, vt, mask
    # row r meets the keys in [max(r - window + 1, kv_lo), r]; q, k, v
    # read, out written once, bf16
    rr = np.arange(t)
    pairs = int(sum(np.maximum(rr - np.maximum(rr - window + 1, lo) + 1,
                               0).sum() for lo in kv_lo.tolist()))
    out.update(bound(4 * q.numel() * 2, 4 * d * h * pairs))
    out["tflops"] = 4 * d * h * pairs / out["device_ms"] / 1e9
    return out


def phase_banded() -> dict:
    import torch

    from voxtral_tpu_torch.ops.banded_encode import (
        banded_attention_batched,
        banded_attention_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    h, d, window = 32, 64, 750
    t_serve = serve_encoder_len(30.0)
    t_bulk, (exact_ctx, exact_t) = serve_encoder_len(60.0), exact_window()
    cases = [  # (B, T, kv_lo)
        (1, 1500, [0]),          # a 30 s clip
        (1, 1013, [0]),          # ragged: not a multiple of the 64-row tile
        (2, 777, [0, 300]),      # leading keys hidden for stream 1
        (16, t_serve, [0] * 16),  # the serve phase's B=16 padded 30 s clips
        # the window-mode pool's tick at 32 slots: 752 context rows + 100
        # new (-I 2.0), every slot hiding its own stale context
        (32, 852, [(0, 300, 752, 0, 100)[i % 5] for i in range(32)]),
        # the bench's bulk encode: groups of 4 padded 60 s clips
        (4, t_bulk, [0] * 4),
        # the bench's load-window-exact tick: 16 slots of the 2248-row
        # context (enc_ctx_extra=2) + 400 new rows (-I 8.0), slots fresh,
        # one and two feeds in, and full
        (16, exact_t, [(exact_ctx, exact_ctx - 400, exact_ctx - 800,
                        0)[i % 4] for i in range(16)]),
    ]
    timed_cases = {(1, 1500): "", (16, t_serve): "_b16",
                   (32, 852): "_pool_window", (4, t_bulk): "_bench_bulk",
                   (16, exact_t): "_bench_exact"}
    worst = 0.0
    timed = {}
    for bsz, t, lo in cases:
        q = _randn(gen, (bsz, t, h, d), torch.bfloat16)
        k = _randn(gen, (bsz, t, h, d), torch.bfloat16)
        v = _randn(gen, (bsz, t, h, d), torch.bfloat16)
        kv_lo = torch.tensor(lo, dtype=torch.int32, device="cuda")
        # the plain version one stream at a time (its [T, T] scores per
        # head would take 5.9 GB at B=16)
        want = torch.cat([banded_attention_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_lo[i:i + 1],
            window=window, out_dtype=torch.float32) for i in range(bsz)])
        got = banded_attention_batched(q, k, v, kv_lo, window=window,
                                       out_dtype=torch.float32)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[banded] non-finite output B={bsz} T={t}")
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        ok = err <= BANDED_TOL
        log("banded", f"B={bsz} T={t} kv_lo={lo[:2]}: max_abs_err {err:.3e} "
                      f"(tol {BANDED_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[banded] B={bsz} T={t} err {err}")
        del got, want
        tag = timed_cases.get((bsz, t))
        if tag is not None:
            tm = _banded_times(q, k, v, kv_lo, window)
            tm["max_abs_err"] = err
            timed[tag] = tm
            log("banded", f"B={bsz} T={t}: kernel {tm['ms']:.4f} ms (device "
                          f"{tm['device_ms']:.4f}), "
                          f"{tm['tflops']:.1f} TFLOP/s, plain "
                          f"{tm['plain_ms']:.4f} ms, SDPA "
                          f"{tm['library_ms']:.4f} ms per call; bound "
                          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']})")
        del q, k, v
    banded_attention_batched.launches = 0
    out = {**{f"{key}{tag}": val for tag, tm in timed.items()
              for key, val in tm.items()}, "max_abs_err": worst}
    return out


def exact_window() -> tuple[int, int]:
    """(context rows, rows a tick) of the bench's load-window-exact row at
    full width: window_pad(cfg, extra=2) context rows beside the 400
    encoder rows of an 8 s feed (800 mel frames)."""
    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.models.bulk_encode import window_pad

    ctx = window_pad(full_config(), extra=2)
    return ctx, ctx + 400


def serve_encoder_len(seconds: float) -> int:
    """Encoder positions of one padded clip of `seconds` in the serve
    phase: padded mel frames / 2 (the conv stem's stride)."""
    import types

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    eng = types.SimpleNamespace(delay_tokens=full_config().delay_tokens)
    return padded_clip_mel(eng, make_audio(seconds, seed=0)).shape[0] // 2


def _mixed_positions(bsz: int, cap: int) -> list[int]:
    """One position per stream: 0, mid-ring, wrapped, then spread over
    three laps of the ring."""
    return [0, cap // 2, cap + 123] + [(97 * i) % (3 * cap)
                                       for i in range(3, bsz)]


def _flash_live(pos_l, cap: int, window: int) -> int:
    """Live window slots summed over the streams at these positions."""
    return sum(min(p + 1, window, cap) for p in pos_l)


def _flash_times(gen, bsz: int, cap: int, pos_l, rdt, window: int,
                 h: int = 32, kh: int = 8) -> dict:
    """Kernel (B) at one shape of the decode path (bf16 q and output, f32
    rows, a `rdt` ring, layer 25 of 26, h query and kh KV heads: the full
    width's, or one tp rank's): CUDA-event and device (graph replay) times
    with the row write (write+attend, the path's mode) and without it
    (attend), the plain version's, SDPA's over the layer's ring with the
    logical-position mask for bf16 rings (none takes fp8), and the
    bound."""
    import torch

    from voxtral_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_plain,
    )
    from voxtral_tpu_torch.ops.ring import slot_logical_positions

    d, n_layers = 128, 26
    li = n_layers - 1
    shape = (bsz, n_layers, kh, cap, d)
    k_all = _randn(gen, shape, rdt)
    v_all = _randn(gen, shape, rdt)
    q = _randn(gen, (bsz, h, d), torch.bfloat16)
    rows = (_randn(gen, (bsz, kh, d), torch.float32),
            _randn(gen, (bsz, kh, d), torch.float32))
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    kw = dict(window=window, out_dtype=torch.bfloat16)
    out = {}
    for mode, r in (("", rows), ("_attend", ())):
        def kern():
            flash_decode(q, k_all, v_all, li, pos, *r, **kw)

        out[f"ms{mode}"] = cuda_ms(kern, 50)
        out[f"device_ms{mode}"] = graph_ms(kern, 20)
        out[f"plain_ms{mode}"] = cuda_ms(lambda: flash_decode_plain(
            q, k_all, v_all, li, pos, *r, **kw), 10)
    out["library_ms"] = None       # SDPA takes no fp8 operands
    if rdt == torch.bfloat16:      # SDPA attends only
        lpos = slot_logical_positions(pos, cap)
        mask = ((lpos >= 0) & (lpos <= pos[:, None])
                & (lpos > pos[:, None] - window))[:, None, None, :]
        out["library_ms"] = sdpa_ms(q[:, :, None], k_all[:, li],
                                    v_all[:, li], mask, 50)
    # the live window's K and V rows read once at the ring's element size,
    # q read, the f32 rows read and written into the ring, the bf16 output
    # written; 4 D operations per (head, live slot)
    live, elt = _flash_live(pos_l, cap, window), rdt.itemsize
    out.update(bound(2 * live * kh * d * elt + q.numel() * 2
                     + 2 * bsz * kh * d * (4 + elt) + bsz * h * d * 2,
                     4 * h * d * live))
    del k_all, v_all
    return out


def phase_flash() -> dict:
    import torch

    from voxtral_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_plain,
        flash_decode_splits,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    h, kh, d, n_layers, window = 32, 8, 128, 26, 8192
    li = n_layers - 1
    cases = []  # (B, cap, pos)
    for cap in (896, 8192):
        for p in (0, cap // 2, cap + 123):
            cases.append((1, cap, [p]))
        cases.append((3, cap, [0, cap // 2 + 7, 2 * cap + 5]))
    # the serve phase's B=16 rings, with each stream at its own position
    cases.append((16, 896, _mixed_positions(16, 896)))
    # the bench's headline decode: B=64 on bf16 rings, B=80 on fp8 rings
    # (its fp8kv rung), ring 896, mixed positions
    bench_cases = {torch.bfloat16: (64, 896, _mixed_positions(64, 896)),
                   torch.float8_e4m3fn: (80, 896, _mixed_positions(80, 896))}
    worst = 0.0
    for rdt in (torch.float8_e4m3fn, torch.bfloat16, torch.float32):
        # q in the ring's compute dtype, as the decoder passes it
        qdt = torch.float32 if rdt == torch.float32 else torch.bfloat16
        for bsz, cap, pos_l in cases + ([bench_cases[rdt]]
                                        if rdt in bench_cases else []):
            shape = (bsz, n_layers, kh, cap, d)
            k_all = _randn(gen, shape, rdt)
            v_all = _randn(gen, shape, rdt)
            q = _randn(gen, (bsz, h, d), qdt)
            k_rows = _randn(gen, (bsz, kh, d), torch.float32)
            v_rows = _randn(gen, (bsz, kh, d), torch.float32)
            pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
            kw = dict(window=window, out_dtype=torch.float32)
            # attention only (the function of Pallas #2/#3), twice
            got = flash_decode(q, k_all, v_all, li, pos, **kw)
            again = flash_decode(q, k_all, v_all, li, pos, **kw)
            want = flash_decode_plain(q, k_all, v_all, li, pos, **kw)
            # row write + attention (Pallas #4), each on its own ring copy,
            # the kernel twice
            kk, vk = k_all.clone(), v_all.clone()
            kk2, vk2 = k_all.clone(), v_all.clone()
            kp, vp = k_all, v_all
            got_w = flash_decode(q, kk, vk, li, pos, k_rows, v_rows, **kw)
            again_w = flash_decode(q, kk2, vk2, li, pos, k_rows, v_rows,
                                   **kw)
            want_w = flash_decode_plain(q, kp, vp, li, pos, k_rows, v_rows,
                                        **kw)
            torch.cuda.synchronize()
            err = max((got - want).abs().max().item(),
                      (got_w - want_w).abs().max().item())
            rings_equal = all(
                torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in ((kk, kp), (vk, vp), (kk2, kp), (vk2, vp)))
            same = torch.equal(got, again) and torch.equal(got_w, again_w)
            worst = max(worst, err)
            ok = err <= FLASH_TOL and rings_equal and same
            log("flash", f"{str(rdt)[6:]} B={bsz} cap={cap} pos={pos_l[:3]} "
                         f"splits={flash_decode_splits(min(cap, window), bsz, kh)}"
                         f": max_abs_err {err:.3e} (tol {FLASH_TOL}), rings "
                         f"{'bit-equal' if rings_equal else 'DIFFER'}, two "
                         f"calls {'bitwise equal' if same else 'DIFFER'} "
                         f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[flash] {rdt} B={bsz} cap={cap} "
                                     f"pos={pos_l} err {err} rings "
                                     f"{rings_equal} deterministic {same}")
            del k_all, v_all, kk, vk, kk2, vk2, kp, vp
    # times: the slice shape (B=1, a 30 s clip's ring of 512 mid-clip, bf16)
    # and the serve shape (B=16, ring 896, positions around 500) in bf16 and
    # fp8
    serve_pos = [500 + 13 * (i % 16 - 8) for i in range(80)]
    shapes = {"": (1, 512, [300], torch.bfloat16),
              "_b16_bf16": (16, 896, serve_pos[:16], torch.bfloat16),
              "_b16_fp8": (16, 896, serve_pos[:16], torch.float8_e4m3fn),
              "_bench_b64_bf16": (64, 896, serve_pos[:64], torch.bfloat16),
              "_bench_b80_fp8": (80, 896, serve_pos, torch.float8_e4m3fn)}
    out = {"max_abs_err": worst, "deterministic": True,
           "replaces_also": ["voxtral_tpu/ops/flash_decode.py:44",
                             "voxtral_tpu/ops/flash_decode.py:124"]}
    for tag, (bsz, cap, pos_l, rdt) in shapes.items():
        tm = _flash_times(gen, bsz, cap, pos_l, rdt, window)
        out.update({f"{k}{tag}": v for k, v in tm.items()})
        out[f"splits{tag}"] = flash_decode_splits(min(cap, window), bsz, kh)
        lib = tm["library_ms"]
        log("flash", f"B={bsz} {str(rdt)[6:]} cap={cap} pos={pos_l[:3]}..: "
                     f"write+attend kernel {tm['ms']:.4f} ms (device "
                     f"{tm['device_ms']:.4f}), plain {tm['plain_ms']:.4f}; "
                     f"attend kernel {tm['ms_attend']:.4f} (device "
                     f"{tm['device_ms_attend']:.4f}), plain "
                     f"{tm['plain_ms_attend']:.4f}; SDPA (attend) "
                     f"{'none' if lib is None else f'{lib:.4f}'} ms; bound "
                     f"{tm['bound_ms']:.6f} ms ({tm['bound_by']})")
    flash_decode.launches = 0
    return out


# full-width int4 matrices: (out, in) of the decoder's four layer weights
# and the tied logits table, in the decode step's order (four products a
# layer, then the table)
INT4_SHAPES = {"wqkv": (6144, 3072), "wo": (3072, 4096),
               "w13": (18432, 3072), "w2": (3072, 9216),
               "logits": (131072, 3072)}
INT4_LAYERS = 26            # the decoder's depth: full stacks, 1.71 GB packed
# B=16 decode, a B=1 Jacobi window (64 rows through every product of the
# window's pass), B=16 x 38 prefill
INT4_ROWS = (16, 64, 608)
# the bench's int4 rung: its B=56 decode and B=56 x 38 prefill
INT4_BENCH_ROWS = (56, 2128)


def _int4_bound(shapes, rows: int) -> dict:
    """bound of int4 products [(out, in)] at `rows`: packed weights, scales
    and x read once, f32 y written once; 2 operations per weight and row."""
    n_bytes = sum(o * i // 2 + o * 2 * 4 + rows * i * 2 + rows * o * 4
                  for o, i in shapes)
    return bound(n_bytes, sum(2 * rows * o * i for o, i in shapes))


def _dequant_bf16(p, s):
    """The packed layer [out, in/2] with its scales [out, 2] as the bf16
    [out, in] weight (the yardstick's operand, made before any timing)."""
    import torch

    from voxtral_tpu_torch.models.quant import _unpack4

    lo, hi = _unpack4(p, torch.float32)
    return torch.cat([lo * s[:, :1], hi * s[:, 1:]], dim=-1).bfloat16()


def _rotating(fn, n: int):
    """fn(i) for i = 0, 1, .. mod n on successive calls: graph_ms then
    replays calls over n layers, so a product's weights come from device
    memory, as in a decode step, not from the previous call's L2 lines."""
    import itertools

    count = itertools.count()
    return lambda: fn(next(count) % n)


def phase_int4() -> dict:
    """Kernel (C) on full 26-layer stacks of random packed bytes (every
    byte is a valid pair of int4 weights) and the table: within
    INT4_REL_TOL of plain and bitwise repeatable at 1, 16 and 608 rows on
    layer 25 of each product; graph-replay times at 16 and 608 rows (layers
    rotating) of the kernel, plain and the bf16 yardstick (torch.mm on the
    weight dequantized to bf16 beforehand: four times the bytes, so not
    the library call of this function); the decode step's 105 products at
    16 rows in decode order."""
    import torch

    from voxtral_tpu_torch.ops.quant_mm import int4_mm, int4_mm_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    stacks = {}
    for name, (out_dim, in_dim) in INT4_SHAPES.items():
        n_layers = 1 if name == "logits" else INT4_LAYERS
        stacks[name] = (
            torch.randint(-128, 128, (n_layers, out_dim, in_dim // 2),
                          generator=gen, device="cuda", dtype=torch.int8),
            torch.rand((n_layers, out_dim, 2), generator=gen,
                       device="cuda") * 0.02 + 0.001)
    packed = sum(p.numel() for p, _ in stacks.values())
    log("int4", f"stacks: {INT4_LAYERS} layers + table, "
                f"{packed / 1e9:.3f} GB packed")
    _int4_plans()
    worst_abs, worst_rel, out = 0.0, 0.0, {"library_ms": None}
    for name, (out_dim, in_dim) in INT4_SHAPES.items():
        p, s = stacks[name]
        n_layers = p.shape[0]
        wd = [_dequant_bf16(p[li], s[li]) for li in range(min(4, n_layers))]
        for rows in (1,) + INT4_ROWS + INT4_BENCH_ROWS:
            x = _randn(gen, (rows, in_dim), torch.bfloat16)
            got = int4_mm(x, p, s, n_layers - 1)
            again = int4_mm(x, p, s, n_layers - 1)
            want = int4_mm_plain(x, p, s, n_layers - 1)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"[int4] non-finite {name} rows={rows}")
            same = torch.equal(got, again)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            ok = rel <= INT4_REL_TOL and same
            log("int4", f"{name} [{out_dim}x{in_dim}] rows={rows} layer "
                        f"{n_layers - 1}: max_abs_err {err:.3e}, rel "
                        f"{rel:.3e} (tol {INT4_REL_TOL}), two calls "
                        f"{'bitwise equal' if same else 'DIFFER'} "
                        f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[int4] {name} rows={rows} rel {rel} "
                                     f"repeatable {same}")
            del got, again, want
            if rows == 1:
                continue
            tm = {
                "ms": graph_ms(_rotating(
                    lambda li: int4_mm(x, p, s, li), n_layers),
                    min(n_layers, INT4_LAYERS)),
                "plain_ms": graph_ms(_rotating(
                    lambda li: int4_mm_plain(x, p, s, li), len(wd)), len(wd)),
                "bf16_mm_ms": graph_ms(_rotating(
                    lambda li: torch.mm(x, wd[li].t(),
                                        out_dtype=torch.float32), len(wd)),
                    len(wd)),
                **_int4_bound([(out_dim, in_dim)], rows)}
            for k, v in tm.items():
                out[f"{k}_{name}_rows{rows}"] = v
            log("int4", f"{name} rows={rows}: kernel {tm['ms']:.4f} ms, "
                        f"plain {tm['plain_ms']:.4f}, bf16 mm (yardstick) "
                        f"{tm['bf16_mm_ms']:.4f} ms (graph replay, layers "
                        f"rotating); {p[0].numel() / tm['ms'] / 1e6:.0f} "
                        f"GB/s of packed weights; bound {tm['bound_ms']:.4f} "
                        f"ms ({tm['bound_by']})")
        del wd
    # the decode step: 4 products a layer over 26 layers, then the table,
    # at 16 rows, each x made once
    xs = {i: _randn(gen, (16, i), torch.bfloat16)
          for _, i in INT4_SHAPES.values()}

    def step():
        for li in range(INT4_LAYERS):
            for name in ("wqkv", "wo", "w13", "w2"):
                int4_mm(xs[INT4_SHAPES[name][1]], *stacks[name], li)
        int4_mm(xs[INT4_SHAPES["logits"][1]], *stacks["logits"], 0)

    step_shapes = [INT4_SHAPES[n] for n in ("wqkv", "wo", "w13", "w2")
                   for _ in range(INT4_LAYERS)] + [INT4_SHAPES["logits"]]
    sb = _int4_bound(step_shapes, 16)
    out.update({"step_ms": graph_ms(step, 2), "step_bound_ms": sb["bound_ms"],
                "step_products": len(step_shapes)})
    log("int4", f"decode step, {len(step_shapes)} products at 16 rows over "
                f"{INT4_LAYERS} layers + table: {out['step_ms']:.4f} ms "
                f"(graph replay); bound {sb['bound_ms']:.4f} ms "
                f"({sb['bound_by']})")
    del stacks, xs
    torch.cuda.empty_cache()
    int4_mm.launches = 0
    # the summary: the five products at 16 rows (the B=16 decode shape);
    # no single PyTorch call takes this nibble-half packing with per-half
    # scales, so library_ms is None
    out.update({"max_abs_err": worst_abs, "max_rel_err": worst_rel})
    for k in ("ms", "plain_ms", "bf16_mm_ms"):
        out[k] = sum(out[f"{k}_{n}_rows16"] for n in INT4_SHAPES)
        out[f"{k}_layers_rows608"] = sum(out[f"{k}_{n}_rows608"]
                                         for n in INT4_SHAPES if n != "logits")
    out.update(_int4_bound(INT4_SHAPES.values(), 16))
    b608 = _int4_bound([INT4_SHAPES[n] for n in INT4_SHAPES
                        if n != "logits"], 608)
    out["bound_ms_layers_rows608"] = b608["bound_ms"]
    log("int4", f"five products at 16 rows: kernel {out['ms']:.4f} ms, bound "
                f"{out['bound_ms']:.4f} ms ({out['bound_by']}); four layer "
                f"products at 608 rows: kernel "
                f"{out['ms_layers_rows608']:.4f} ms, plain "
                f"{out['plain_ms_layers_rows608']:.4f}, bf16 mm "
                f"{out['bf16_mm_ms_layers_rows608']:.4f}, bound "
                f"{b608['bound_ms']:.4f} ms ({b608['bound_by']})")
    # a Jacobi window's pass and the bench's B=56 decode step: the five
    # products at 64 and 56 rows; the bench's B=56 prefill: the four layer
    # products at 2128 rows
    for rows, names, tag in ((64, list(INT4_SHAPES), "rows64"),
                             (56, list(INT4_SHAPES), "rows56"),
                             (2128, list(INT4_SHAPES)[:4], "layers_rows2128")):
        for k in ("ms", "plain_ms", "bf16_mm_ms"):
            out[f"{k}_{tag}"] = sum(out[f"{k}_{n}_rows{rows}"] for n in names)
        b = _int4_bound([INT4_SHAPES[n] for n in names], rows)
        out[f"bound_ms_{tag}"], out[f"bound_by_{tag}"] = (b["bound_ms"],
                                                           b["bound_by"])
        log("int4", f"{len(names)} products at {rows} rows: kernel "
                    f"{out[f'ms_{tag}']:.4f} ms, plain "
                    f"{out[f'plain_ms_{tag}']:.4f}, bf16 mm "
                    f"{out[f'bf16_mm_ms_{tag}']:.4f}, bound "
                    f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return out


def _int4_plans() -> None:
    """The kernel's plan for each product at 16 and 608 rows, and the
    blocks per SM the plan assumes against the card's occupancy query
    (fails if the plan assumes more: it would launch past one wave)."""
    from voxtral_tpu_torch.ops import cuda_lib, quant_mm

    if not hasattr(quant_mm, "int4_mm_plan"):   # an older tree (A/B runs)
        return
    lib = cuda_lib.kernels()
    for nj in (2, 4, 16):
        for cs in ((1,) if nj == 16 else (1, 2)):
            assumed = quant_mm.int4_mm_blocks_per_sm(nj, cs)
            got = lib.vt_int4_mm_occupancy(nj, cs)
            smem = quant_mm.int4_mm_smem(nj, cs)
            log("int4", f"tile nj={nj} split={cs > 1}: {smem} bytes of "
                        f"shared memory, {got} blocks per SM (plan assumes "
                        f"{assumed})")
            if got < assumed:
                raise AssertionError(f"[int4] nj={nj} cs={cs}: the card "
                                     f"holds {got} blocks per SM, the plan "
                                     f"assumes {assumed}")
    sms = cuda_lib.sm_count(0)
    for rows in INT4_ROWS + INT4_BENCH_ROWS:
        for name, (out_dim, in_dim) in INT4_SHAPES.items():
            plan = quant_mm.int4_mm_plan(rows, out_dim, in_dim // 2, sms)
            log("int4", f"plan {name} rows={rows}: {plan}")


def phase_rows() -> dict:
    import torch

    from voxtral_tpu_torch.ops.ring import (
        ring_rows_write,
        ring_rows_write_plain,
        to_ring_dtype,
    )

    # torch's own cast on the card, for the record: torch 2.11 makes NaN
    # past 464 where the kernel saturates, so the plain version clamps first
    # (ops/ring.py:to_ring_dtype)
    probe = torch.tensor([500.0, -1000.0, 449.0, 464.0, 480.0, 0.3],
                         device="cuda")
    log("rows", f"torch cuda .to(float8_e4m3fn) of {probe.tolist()}: "
                f"{probe.to(torch.float8_e4m3fn).float().tolist()}")
    # the card's fixed cost of one launch: a one-element zero_() in graph
    # replay (the floor of a kernel this small)
    one = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(lambda: one.zero_(), 50)
    log("rows", f"launch floor: one-element zero_() {floor_ms:.6f} ms "
                f"(graph replay)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bsz, n_layers, kh, cap, d = 16, 26, 8, 896, 128
    # 0, mid-ring, wrapped, then mixed positions
    pos_l = [0, cap // 2, cap + 123] + [(97 * i) % (3 * cap)
                                         for i in range(3, bsz)]
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    k_rows = _randn(gen, (bsz, kh, d), torch.float32)
    v_rows = _randn(gen, (bsz, kh, d), torch.float32)
    k_rows[::2] *= 1000.0        # |x| > 448 on every other stream
    v_rows[1::2] *= 1000.0
    times = {}
    for rdt in (torch.float8_e4m3fn, torch.bfloat16, torch.float32):
        shape = (bsz, n_layers, kh, cap, d)
        kk = _randn(gen, shape, torch.float32).to(rdt)
        vk = _randn(gen, shape, torch.float32).to(rdt)
        kp, vp = kk.clone(), vk.clone()
        for li in (0, n_layers - 1):
            ring_rows_write(kk, vk, k_rows, v_rows, li, pos)
            ring_rows_write_plain(kp, vp, k_rows, v_rows, li, pos)
        torch.cuda.synchronize()
        same = (torch.equal(kk.view(torch.uint8), kp.view(torch.uint8))
                and torch.equal(vk.view(torch.uint8), vp.view(torch.uint8)))
        log("rows", f"{str(rdt)[6:]} rings {list(shape)}, pos {pos_l[:3]}..: "
                    f"rings {'bit-equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"[rows] {rdt}: rings differ")

        def kern_call():
            ring_rows_write(kk, vk, k_rows, v_rows, 7, pos)

        def plain_call():
            ring_rows_write_plain(kp, vp, k_rows, v_rows, 7, pos)

        slots = torch.remainder(pos, cap)
        bidx = torch.arange(bsz, device="cuda")
        kr, vr = to_ring_dtype(k_rows, rdt), to_ring_dtype(v_rows, rdt)

        def library_call():   # the index assignments, rows already cast
            kp[bidx, 7, :, slots, :] = kr
            vp[bidx, 7, :, slots, :] = vr

        times[rdt] = (graph_ms(kern_call, 50), graph_ms(plain_call, 20),
                      graph_ms(library_call, 20))
        log("rows", f"{str(rdt)[6:]} B={bsz}: kernel {times[rdt][0]:.6f} ms, "
                    f"plain {times[rdt][1]:.6f} ms, index assignment "
                    f"{times[rdt][2]:.6f} ms per call (graph replay)")
        del kk, vk, kp, vp
    ring_rows_write.launches = 0
    # the summary times: fp8 rings, as the fp8 rungs write them
    keys = ("ms", "plain_ms", "library_ms")
    # fp8: f32 rows read once, one byte per element written, K and V
    out = {"max_abs_err": 0.0, "launch_floor_ms": floor_ms,
           **dict(zip(keys, times[torch.float8_e4m3fn])),
           **bound(2 * bsz * kh * d * (4 + 1), 0)}
    log("rows", f"fp8 B={bsz}: kernel {out['ms']:.6f} ms against a launch "
                f"floor of {floor_ms:.6f} ms and a bound of "
                f"{out['bound_ms']:.6f} ms ({out['bound_by']})")
    for rdt, vals in times.items():
        for k, v in zip(keys, vals):
            out[f"{k}_{str(rdt)[6:]}"] = v
    return out


# the bench's encoder ring (1280 slots: window 750 + its 1024-frame fused
# chunk of 512 rows): (B, T, positions) with B=1 the incremental encode
# and B=2 the batched one; T=512 where a 60 s clip writes it (0 to 3072,
# the ring wrapped from 1280 on), its 124-row tail at 3072, and 530, the
# largest chunk the ring holds beside its window
BENCH_ENC_RING = dict(cap=1280, cases=((1, 512, (0, 512, 1536, 3072)),
                                       (1, 124, (3072,)),
                                       (1, 530, (0, 5000)),
                                       (2, 512, (0, 2560))))


# the streaming encoder at full width: stacked rings [B, 32, 32, 1024, 64]
# (1024 = the engine's ring for buckets (64, 16, 4, 1)) and, for the ragged
# edge, 1000 slots; chunks of 4 to 274 rows (274 = the largest fused chunk
# the ring holds beside its window), queries at 0, inside the first lap
# (17, 40: most of the walk's segments hold no written slot) and after
# wraparound; the bitwise check writes 256 rows after 800 as one chunk and
# as two other partitions
FLASH_ENC_FULL = dict(n_layers=32, heads=32, head_dim=64, cap=1024,
                      ragged_cap=1000, window=750, ts=(4, 64, 100, 256, 274),
                      positions=(0, 17, 40, 300, 5000), prefill=800,
                      splits=((256,), (64, 64, 64, 64), (100, 100, 56)),
                      bench=BENCH_ENC_RING)


def _stream_positions(positions, bsz: int) -> list[int]:
    """One position per stream: the listed ones, then spread over them."""
    return [positions[i % len(positions)] + 37 * (i // len(positions))
            for i in range(bsz)]


def _enc_mask(pos0, t: int, cap: int, window: int):
    """[B, T, cap] validity of ring slots for the chunk's query rows (the
    kernel's logical-position mask)."""
    import torch

    from voxtral_tpu_torch.ops.ring import slot_logical_positions

    lpos = slot_logical_positions(pos0 + (t - 1), cap)[:, None, :]
    q_pos = (pos0[:, None] + torch.arange(t, device=pos0.device,
                                          dtype=pos0.dtype))[:, :, None]
    return (lpos >= 0) & (lpos <= q_pos) & (lpos > q_pos - window)


def phase_flash_enc(device: str = "cuda", shapes: dict = FLASH_ENC_FULL,
                    batches=(1, 16)) -> dict:
    """Kernel (E), flash encode, against its plain version over layer L-1 of
    stacked rings read in place, at every (B, T, position) of `shapes`;
    then the kernel's bitwise chunking invariance; then its times at the
    two streaming shapes (B=16 T=64, the batched transcriber's chunk; B=1
    T=100, the 2 s fused chunk).  main() runs it at full width on the card;
    with device="cpu" a tiny `shapes` rehearses it (the wrapper then runs
    the plain version and nothing is timed)."""
    import torch

    from voxtral_tpu_torch.ops.flash_encode import (
        flash_bulk_attention_batched,
        flash_encode_plain,
        flash_encode_segments,
    )
    from voxtral_tpu_torch.ops.ring import ring_chunk_write

    on_gpu = device == "cuda"
    sh = shapes
    n_layers, h, d, cap, window = (sh[k] for k in (
        "n_layers", "heads", "head_dim", "cap", "window"))
    li = n_layers - 1
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    kw = dict(window=window, out_dtype=torch.float32)

    def rings(bsz, n_slots=cap):   # zeros but for layer li, which is read
        k_all, v_all = (torch.zeros((bsz, n_layers, h, n_slots, d),
                                    dtype=torch.bfloat16, device=device)
                        for _ in range(2))
        for x in (k_all, v_all):
            x[:, li] = _randn(gen, (bsz, h, n_slots, d), torch.bfloat16,
                              device)
        return k_all, v_all

    def check(k_all, v_all, q, pos_l) -> float:
        """The kernel against plain at one case; both mappings of the split
        walk to blocks agree bit for bit (the default takes one)."""
        bsz, t, n_slots = q.shape[0], q.shape[1], k_all.shape[3]
        pos = torch.tensor(pos_l, dtype=torch.int32, device=device)
        want = flash_encode_plain(q, k_all[:, li], v_all[:, li], pos, **kw)
        got, walk = (flash_bulk_attention_batched(
            q, k_all[:, li], v_all[:, li], pos, split=sp, **kw)
            for sp in (True, False))
        if not torch.equal(got, walk):
            raise AssertionError(
                f"[flash_enc] cap={n_slots} B={bsz} T={t} "
                f"pos={pos_l[:3]}: the split mappings differ")
        del walk
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[flash_enc] non-finite cap={n_slots} "
                                 f"B={bsz} T={t} pos={pos_l[:3]}")
        err = (got - want).abs().max().item()
        ok = err <= FLASH_ENC_TOL
        log("flash_enc", f"cap={n_slots} B={bsz} T={t} pos={pos_l[:3]}: "
                         f"max_abs_err {err:.3e} (tol {FLASH_ENC_TOL}) "
                         f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[flash_enc] cap={n_slots} B={bsz} T={t} "
                                 f"pos={pos_l} err {err}")
        return err

    worst = 0.0
    for n_slots in (cap, sh["ragged_cap"]):
        for bsz in batches:
            k_all, v_all = rings(bsz, n_slots)
            pos_sets = ([[p] for p in sh["positions"]] if bsz == 1 else
                        [_stream_positions(sh["positions"], bsz)])
            for t in sh["ts"]:
                q = _randn(gen, (bsz, t, h, d), torch.bfloat16, device)
                for pos_l in pos_sets:
                    worst = max(worst, check(k_all, v_all, q, pos_l))
            del k_all, v_all
    # the bench's encoder ring: its chunks at the positions they take
    # (every stream of a batched encode at the same one)
    bench = sh["bench"]
    for bsz, t, positions in bench["cases"]:
        k_all, v_all = rings(bsz, bench["cap"])
        q = _randn(gen, (bsz, t, h, d), torch.bfloat16, device)
        for p in positions:
            worst = max(worst, check(k_all, v_all, q, [p] * bsz))
        del k_all, v_all

    # bitwise invariance: `prefill` rows, then n more written and attended
    # as each partition of `splits`, on fresh rings each time
    n0, n = sh["prefill"], sum(sh["splits"][0])
    for bsz in batches:
        kv = _randn(gen, (bsz, n0 + n, h, d), torch.bfloat16, device)
        vv = _randn(gen, (bsz, n0 + n, h, d), torch.bfloat16, device)
        qq = _randn(gen, (bsz, n, h, d), torch.bfloat16, device)

        def run(sizes):
            k_all, v_all = (torch.zeros((bsz, n_layers, h, cap, d),
                                        dtype=torch.bfloat16, device=device)
                            for _ in range(2))
            zero = torch.zeros(bsz, dtype=torch.int32, device=device)
            ring_chunk_write(k_all, v_all, kv[:, :n0], vv[:, :n0], li, zero)
            outs, at = [], 0
            for s in sizes:
                p = torch.full((bsz,), n0 + at, dtype=torch.int32,
                               device=device)
                _, _, kr, vr = ring_chunk_write(
                    k_all, v_all, kv[:, n0 + at: n0 + at + s],
                    vv[:, n0 + at: n0 + at + s], li, p)
                outs.append(flash_bulk_attention_batched(
                    qq[:, at: at + s], kr, vr, p, window=window))
                at += s
            return torch.cat(outs, dim=1)

        ref = run(sh["splits"][0])
        for sizes in sh["splits"][1:]:
            same = torch.equal(ref, run(sizes))
            log("flash_enc", f"B={bsz}: {n} rows after {n0} as {list(sizes)} "
                             f"vs {list(sh['splits'][0])}: "
                             f"{'bitwise equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"[flash_enc] B={bsz} chunking {sizes} "
                                     "changed the output")
    flash_bulk_attention_batched.launches = 0
    log("flash_enc", "one block per segment and one block walking every "
                     "segment: bitwise equal at every case")
    out = {"max_abs_err": worst, "bitwise_invariant": True}
    if not on_gpu:
        return out

    # times at the streaming shapes, bf16 out as on the path, full window:
    # the default, and each mapping of the split forced (the default's
    # numbers under the plain keys)
    plan = flash_encode_segments(cap)
    # B=16 T=64, the batched transcriber's chunk; B=1 T=100, the 2 s fused
    # chunk; B=8 T=24, the ring-mode pool's tick at -I 0.5 (a 0.4 s gate:
    # 48 mel frames), its slots at their own positions; B=1 T=512 on the
    # bench's ring, its 1024-frame fused chunk after the ring has wrapped
    for bsz, t, tag, at, n_slots in (
            (16, 64, "", (2000, 5000), cap),
            (1, 100, "_b1_t100", (2000, 5000), cap),
            (8, 24, "_pool_ring", (40, 300, 2000, 5000), cap),
            (1, 512, "_bench_inc", (3072,), bench["cap"])):
        k_all, v_all = rings(bsz, n_slots)
        kr, vr = k_all[:, li], v_all[:, li]
        q = _randn(gen, (bsz, t, h, d), torch.bfloat16, device)
        pos = torch.tensor(_stream_positions(at, bsz),
                           dtype=torch.int32, device=device)
        if tag == "_pool_ring":
            err = (flash_bulk_attention_batched(q, kr, vr, pos, **kw)
                   - flash_encode_plain(q, kr, vr, pos, **kw)).abs().max()
            err = err.item()
            out["max_abs_err_pool_ring"] = err
            log("flash_enc", f"B={bsz} T={t} pos {pos.tolist()[:4]}: "
                             f"max_abs_err {err:.3e} (tol {FLASH_ENC_TOL})")
            if not err <= FLASH_ENC_TOL:
                raise AssertionError(f"[flash_enc] pool ring shape err {err}")
        alts = {}   # device ms by mapping
        for sp in (None, True, False):
            def kern():
                flash_bulk_attention_batched(q, kr, vr, pos, window=window,
                                             split=sp)

            mode = {None: "auto", True: "split", False: "walk"}[sp]
            out[f"ms_{mode}{tag}"] = cuda_ms(kern, 50)
            out[f"device_ms_{mode}{tag}"] = alts[mode] = graph_ms(kern, 20)
        ms, dms = out[f"ms_auto{tag}"], out[f"device_ms_auto{tag}"]
        plain = cuda_ms(lambda: flash_encode_plain(q, kr, vr, pos,
                                                   window=window), 5)
        # the library call: SDPA over the layer's ring with the
        # logical-position mask
        valid = _enc_mask(pos, t, n_slots, window)
        lib = sdpa_ms(q.transpose(1, 2).contiguous(), kr, vr, valid[:, None])
        # the K/V rows some query of the chunk sees, read once; q read and
        # the output written once (bf16); 4 D operations per (row, head,
        # valid key)
        n_slots = int(valid.any(dim=1).sum())
        b = bound(2 * n_slots * h * d * 2 + 2 * q.numel() * 2,
                  4 * d * h * int(valid.sum()))
        flash_bulk_attention_batched.launches = 0
        out.update({f"ms{tag}": ms, f"device_ms{tag}": dms,
                    f"plain_ms{tag}": plain, f"library_ms{tag}": lib,
                    f"bound_ms{tag}": b["bound_ms"],
                    f"bound_by{tag}": b["bound_by"], "segments": plan,
                    "segments_bench": flash_encode_segments(bench["cap"])})
        alts = ", ".join(f"{k} {v:.4f}" for k, v in alts.items())
        log("flash_enc", f"B={bsz} T={t} pos {pos.tolist()[:3]}: kernel "
                         f"{ms:.4f} ms (device {dms:.4f}; {alts}), plain "
                         f"{plain:.4f} ms, SDPA {lib:.4f} ms per call; bound "
                         f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        del k_all, v_all, kr, vr
    return out


def make_audio(seconds: float, seed: int) -> np.ndarray:
    """440 Hz tone under a 3 Hz envelope plus noise (the tests' recipe)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t) * np.sin(2 * np.pi * 3.0 * t)
    noise = 0.05 * rng.standard_normal(n)
    return (tone + noise).astype(np.float32)


def phase_slice(cfg, params, device: str, clip_seconds) -> dict:
    """Drives the offline path: `cfg` with the weights `params` on
    `device`, one clip per entry of `clip_seconds`.  main() runs it at full
    width on the card; with device="cpu" and a tiny config it rehearses the
    phase on a machine without one (CPU tensors launch no kernel, so the
    launch-count checks then need the plain functions counted instead)."""
    import torch

    from voxtral_tpu_torch.config import (
        SAMPLE_RATE,
        TOKEN_TEXT_MIN,
    )
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.ops.banded_encode import banded_attention_batched
    from voxtral_tpu_torch.ops.flash_decode import flash_decode
    from voxtral_tpu_torch.runtime.engine import (
        VoxtralEngine,
        adaptive_dec_ring,
    )
    from voxtral_tpu_torch.runtime.offline import (
        padded_clip_mel,
        transcribe_offline_ids,
    )

    on_gpu = device == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    vocab = cfg.decoder.vocab_size
    tok = byte_tokenizer(vocab)
    clips = [make_audio(s, seed=i) for i, s in enumerate(clip_seconds)]
    ring = adaptive_dec_ring(cfg, max(len(c) for c in clips))
    engine = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=ring,
                           buckets=(64, 16, 4, 1))
    log("slice", f"engine: dec ring {ring}, buckets {engine.buckets}, "
                 f"decode {engine.decode_mode}")

    def run(samples):
        banded_attention_batched.launches = 0
        flash_decode.launches = 0
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        sync()
        stats: dict = {}
        w0 = time.monotonic()
        ids = transcribe_offline_ids(engine, samples, timings=stats)
        sync()
        wall = time.monotonic() - w0
        return ids, stats, wall, (banded_attention_batched.launches,
                                  flash_decode.launches)

    # warm-up outside the measured runs (cuBLAS handles, allocator)
    run(clips[0][:SAMPLE_RATE])
    per_clip = []
    first_ids = None
    counts_total = [0, 0]
    for i, samples in enumerate(clips):
        ids, st, wall, (na, nb) = run(samples)
        dur = len(samples) / SAMPLE_RATE
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        steps = st["decode_steps"]
        if not all(0 <= t < vocab for t in ids):
            raise AssertionError(f"[slice] clip {i}: token id out of range")
        if not st["adapter_finite"]:
            raise AssertionError(f"[slice] clip {i}: NaN/inf adapter rows")
        if na != cfg.encoder.n_layers:
            raise AssertionError(f"[slice] clip {i}: banded launches {na} "
                                 f"!= {cfg.encoder.n_layers}")
        if nb != cfg.decoder.n_layers * steps:
            raise AssertionError(f"[slice] clip {i}: flash launches {nb} != "
                                 f"{cfg.decoder.n_layers} x {steps} steps")
        counts_total[0] += na
        counts_total[1] += nb
        n_text = sum(t >= TOKEN_TEXT_MIN for t in ids)
        rec = {
            "clip_s": dur, "tokens": len(ids), "text_tokens": n_text,
            "decode_steps": steps, "encode_ms": st["encode_s"] * 1e3,
            "prefill_ms": st["prefill_s"] * 1e3,
            "decode_ms_per_step": st["decode_s"] * 1e3 / max(steps, 1),
            "x_realtime": dur / wall, "peak_gib": peak / 2**30,
            "banded_launches": na, "flash_launches": nb,
        }
        per_clip.append(rec)
        log("slice", f"clip {i} ({dur:.1f} s): {len(ids)} ids "
                     f"({n_text} text), {steps} decode steps; encode "
                     f"{rec['encode_ms']:.2f} ms, prefill "
                     f"{rec['prefill_ms']:.2f} ms, decode "
                     f"{rec['decode_ms_per_step']:.3f} ms/step, "
                     f"{rec['x_realtime']:.2f}x realtime, peak "
                     f"{rec['peak_gib']:.2f} GiB; launches A={na} B={nb}")
        if first_ids is None:
            first_ids = ids
    again, _, _, _ = run(clips[0])
    if again != first_ids:
        raise AssertionError("[slice] second run of clip 0 gave other ids")
    log("slice", "second run of clip 0: identical ids")

    # reference check on a small input: one decoder step through the kernel
    # path (attn_impl auto -> flash-decode kernel) and the plain path
    # (attn_impl xla), from the same prefilled cache
    mel = padded_clip_mel(engine, clips[0])
    rows = engine.encode_clip_bulk(mel[None])
    plen = engine.prompt_len
    cache = engine.new_dec_cache()
    engine.prefill(engine.prompt_embeds(rows[:, : plen - 1]), cache, 0)
    pos = torch.full((1,), plen - 1, dtype=torch.int32, device=device)
    emb = rows[:, plen - 1: plen] + engine.embed_pad
    outs = {}
    for impl in ("auto", "xla"):
        c2 = dec_mod.KVCache(cache.k.clone(), cache.v.clone())
        cfg_i = cfg.replace(decoder=dataclasses.replace(cfg.decoder,
                                                        attn_impl=impl))
        x, _ = dec_mod.decoder_forward(params["decoder"], cfg_i, emb, c2,
                                       pos, engine.ada())
        outs[impl] = x.float()
    scale = outs["xla"].abs().max().item()
    step_err = (outs["auto"] - outs["xla"]).abs().max().item() / scale
    log("slice", f"decoder step kernel path vs plain path: max rel err "
                 f"{step_err:.3e} (tol {STEP_REL_TOL})")
    if not step_err <= STEP_REL_TOL:
        raise AssertionError(f"[slice] decoder step rel err {step_err}")
    banded_attention_batched.launches = 0
    flash_decode.launches = 0
    return {"clips": per_clip, "launches": counts_total,
            "step_rel_err": step_err}


def byte_tokenizer(vocab: int):
    from voxtral_tpu_torch.tokenizer import TekkenTokenizer

    return TekkenTokenizer([bytes([i % 256]) for i in range(vocab - 1000)],
                           1000)


def make_params(cfg, device: str):
    """Seeded random weights (init_params(seed=0)) on `device`."""
    import torch

    from voxtral_tpu_torch.models.params import init_params

    t0 = time.monotonic()
    params = init_params(cfg, seed=0, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    n_params = sum(x.numel() for grp in params.values()
                   for x in _leaves(grp))
    log("params", f"init_params(seed=0) {n_params / 1e9:.3f} B params on "
                  f"{device} in {time.monotonic() - t0:.1f} s")
    return params


@contextlib.contextmanager
def plain_kernels():
    """Routes the decoder's int4 products and decode-step row writes to
    their plain PyTorch versions for the duration (the reference side of a
    kernel-path check; attn_impl="xla" keeps flash-decode, flash-encode
    and the bulk encoder's banded kernel off)."""
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.ops import quant_mm, ring

    saved = (quant_mm.int4_mm, dec_mod.ring_rows_write)
    quant_mm.int4_mm = quant_mm.int4_mm_plain
    dec_mod.ring_rows_write = ring.ring_rows_write_plain
    try:
        yield
    finally:
        quant_mm.int4_mm, dec_mod.ring_rows_write = saved


def _agreement(a, b) -> float:
    """Share of positions where two id sequences agree (over the longer)."""
    n = max(len(a), len(b))
    return sum(x == y for x, y in zip(a, b)) / n if n else 1.0


# the dtype ladder of the serving pipeline: (name, decoder ring dtype or
# None for the config's, quantize=)
RUNGS = (("bf16", None, False), ("fp8kv", "float8_e4m3fn", False),
         ("int8", "float8_e4m3fn", "int8"), ("int4", "float8_e4m3fn", "int4"))
# the ladder plus a check of the int4 rung: the same pipeline on the int4
# weights dequantized to the params' dtype, through the plain matmuls
SERVE_RUNGS = RUNGS + (("int4deq", "float8_e4m3fn", "dequant4"),)


def dequantize4(qparams, params):
    """`qparams` (params with an int4 decoder and table) with its packed
    matrices dequantized to the dtype of `params`' weights: q s, nibbles
    unpacked here with masks (independently of models/quant.py).  Checks
    every dequantized weight lies within half a quantization step of the
    weight of `params` it came from; returns (tree, worst |w - q s| / s)."""
    import torch

    from voxtral_tpu_torch.models.quant import QUANT_KEYS

    def unpack(p, s):    # [rows, in/2] int8, [rows, 2] f32 -> f32 [rows, in]
        u = p.view(torch.uint8).to(torch.int32)
        lo, hi = ((u & 0xF) ^ 8) - 8, ((u >> 4) ^ 8) - 8
        return torch.cat([lo * s[..., :1], hi * s[..., 1:]], dim=-1)

    dq = dict(qparams["decoder"])
    dq["layers"] = dict(dq["layers"])
    src = params["decoder"]
    todo = [(dq["layers"], k, src["layers"][k]) for k in QUANT_KEYS]
    todo.append((dq, "tok_embeddings", src["tok_embeddings"]))
    worst = 0.0
    for tree, k, w in todo:
        p, s = tree.pop(k), tree.pop(k + "_scale")
        if w.dim() == 2:      # the table: [V, dim] in row chunks
            p, s, w = p[None], s[None], w[None]
        out = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        half = w.shape[-1] // 2
        for li in range(w.shape[0]):
            for r in range(0, w.shape[1], 16384):
                sl = (li, slice(r, r + 16384))
                wd = unpack(p[sl], s[sl])
                step = s[sl].repeat_interleave(half, dim=-1)
                ratio = ((wd - w[sl].float()).abs() / step).max().item()
                worst = max(worst, ratio)
                if not ratio <= 0.5 + QUANT4_STEP_SLACK:
                    raise AssertionError(f"[serve] int4 {k} layer {li}: |w - "
                                         f"q s| reaches {ratio} steps")
                out[sl] = wd.to(w.dtype)
        tree[k] = out[0] if k == "tok_embeddings" else out
    return {**qparams, "decoder": dq}, worst


# serve rungs run once (bf16 twice, the second timed and checked for the
# same ids): the depth the script's time limit allows.  A single run's
# times hold its first-call costs, so they go under their own names
# (first_run_*), never under the warm second run's
SERVE_ONCE = ("fp8kv", "int8", "int4", "int4deq")
SERVE_TIMES = ("encode_ms", "prefill_ms", "decode_ms_per_step", "wall_s",
               "x_realtime_aggregate")


def phase_serve(cfg, params, device: str, n_streams: int, seconds: float,
                dec_ring: int, rungs=SERVE_RUNGS,
                extra_steps: int = 32) -> dict:
    """The batched serving pipeline (bench.py run_once, the port's
    serving.serve_clips): B lockstep streams of `seconds` synthetic audio,
    each from its own seed, through bulk encode of all streams -> prefill
    -> bdecode_burst bursts of (64, 16, 4, 1), once per rung on its own
    engine built from `params`.
    The "dequant4" rung runs the int4 weights dequantized (dequantize4) and
    must agree with the int4 rung on DEQUANT_AGREE_MIN of its ids.  On the
    fp8kv rung the mid-fill decode also runs with attn_impl "xla" (the
    plain attention path and the row-write kernel), timed beside "auto".
    main() runs it at full width on the card; a tiny CPU config rehearses
    it (with the plain functions counted, as for phase_slice)."""
    import torch

    from voxtral_tpu_torch.config import SAMPLE_RATE
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models.quant import embed_rows, quantize_params
    from voxtral_tpu_torch.ops.banded_encode import banded_attention_batched
    from voxtral_tpu_torch.ops.flash_decode import flash_decode
    from voxtral_tpu_torch.ops.quant_mm import int4_mm
    from voxtral_tpu_torch.ops.ring import ring_rows_write
    from voxtral_tpu_torch.parallel import serving as sv
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import (
        padded_clip_mel,
        transcribe_offline_ids,
    )

    on_gpu = device == "cuda"
    counters = (banded_attention_batched, flash_decode, ring_rows_write,
                int4_mm)

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    clips = [make_audio(seconds, seed=100 + i) for i in range(n_streams)]
    tok = byte_tokenizer(cfg.decoder.vocab_size)
    n_layers = cfg.decoder.n_layers
    table, rung_ids, bf16_b1 = [], {}, None
    launch_totals = {f.__name__: 0 for f in counters}
    mel = None
    for name, kv, quantize in rungs:
        rcfg = cfg if kv is None else cfg.replace(kv_dtype=kv,
                                                  enc_kv_dtype="bfloat16")
        t0 = time.monotonic()
        rparams, deq_steps = params, None
        if quantize == "dequant4":
            rparams, deq_steps = dequantize4(quantize_params(
                params, encoder=False, bits=4), params)
            log("serve", f"{name}: int4 weights within {deq_steps:.7f} "
                         f"quantization steps of the bf16 ones (tol "
                         f"{0.5 + QUANT4_STEP_SLACK})")
            quantize = False
        engine = VoxtralEngine(rcfg, rparams, tokenizer=tok,
                               dec_kv_ring=dec_ring, buckets=(64, 16, 4, 1),
                               quantize=quantize)
        del rparams
        sync()
        log("serve", f"{name}: engine (kv {str(rcfg.kvdtype)[6:]}, quantize "
                     f"{quantize}) in {time.monotonic() - t0:.1f} s")
        if mel is None:   # host mel once; the pipeline starts from mel
            mel = torch.from_numpy(np.stack(
                [padded_clip_mel(engine, c) for c in clips])).to(device)
        dp = engine.params["decoder"]
        plen = engine.prompt_len

        def run_once():
            for f in counters:
                f.launches = 0
            if on_gpu:
                torch.cuda.reset_peak_memory_stats()
            ids, run = sv.serve_clips(engine, mel)
            steps = run["decode_steps"]
            st = {"encode_ms": run["encode_s"] * 1e3,
                  "prefill_ms": run["prefill_s"] * 1e3,
                  "decode_ms_per_step": (run["decode_s"] * 1e3
                                         / max(steps, 1)),
                  "wall_s": run["encode_s"] + run["prefill_s"]
                  + run["decode_s"], "decode_steps": steps,
                  "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                               if on_gpu else 0.0),
                  "launches": {f.__name__: f.launches for f in counters}}
            return ids, run["adapter_rows"], st

        # the first run warms the allocator and cuBLAS for these shapes;
        # the second is timed and must give the same ids (the SERVE_ONCE
        # rungs report their first)
        ids, rows, first = run_once()
        st = first
        if name not in SERVE_ONCE:
            again, _, st = run_once()
            if again != ids:
                raise AssertionError(f"[serve] {name}: second run gave other "
                                     "ids")
        steps = st["decode_steps"]
        dur = len(clips[0]) / SAMPLE_RATE
        st["x_realtime_aggregate"] = n_streams * dur / st["wall_s"]
        st["runs"] = 1 if name in SERVE_ONCE else 2
        # checks: launch counts of both runs, id range, finite adapter rows;
        # every rung decodes through flash-decode (fp8 rings included)
        want = {
            "banded_attention_batched": cfg.encoder.n_layers,
            "flash_decode": n_layers * steps,
            "ring_rows_write": 0,
            "int4_mm": (4 * n_layers + (4 * n_layers + 1) * steps
                        if quantize == "int4" else 0),
        }
        if not st["launches"] == first["launches"] == want:
            raise AssertionError(f"[serve] {name}: launches {st['launches']}, "
                                 f"{first['launches']} != {want}")
        for k, v in st["launches"].items():
            launch_totals[k] += v
        vocab = cfg.decoder.vocab_size
        if not all(0 <= t < vocab for s_ids in ids for t in s_ids):
            raise AssertionError(f"[serve] {name}: token id out of range")
        if not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"[serve] {name}: NaN/inf adapter rows")

        # decode ms/step at mid-clip fill (bench.py step_extra): 2 bursts
        # of `extra_steps` steps at position 500 from a fresh cache, CUDA
        # events; on fp8kv with each attention path, counted
        for impl in ("auto", "xla") if name == "fp8kv" else ("auto",):
            icfg = rcfg.replace(decoder=dataclasses.replace(
                rcfg.decoder, attn_impl=impl))
            xcache = sv.batched_dec_cache(icfg, n_streams,
                                          engine.dec_kv_ring, device=device)
            xchunk = torch.zeros((n_streams, extra_steps, cfg.decoder.dim),
                                 device=device)
            xprev = torch.full((n_streams,), 32, dtype=torch.int32,
                               device=device)
            xpos = torch.full((n_streams,), 500, dtype=torch.int32,
                              device=device)

            ran = [0]   # decode steps run, for the exact launch counts

            def burst():
                sv.bdecode_burst(dp, icfg, xchunk, xprev, xcache, xpos,
                                 engine.ada())
                ran[0] += xchunk.shape[1]

            for f in counters:
                f.launches = 0
            tag = "" if impl == "auto" else "_xla"
            if on_gpu:
                st[f"step_ms_mid_fill{tag}"] = (cuda_ms(burst, 2, warmup=1)
                                                / extra_steps)
                xchunk = xchunk[:, :8]   # device time over 8 profiled steps
                dms, n_ev = device_ms(burst, 1, with_events=True)
                st[f"device_ms_per_step_mid_fill{tag}"] = dms / 8
                st[f"device_events_per_step_mid_fill{tag}"] = n_ev / 8
                st[f"busy_mid_fill{tag}"] = (
                    st[f"device_ms_per_step_mid_fill{tag}"]
                    / st[f"step_ms_mid_fill{tag}"])
            else:
                burst()
            sync()
            n_steps = ran[0]
            got = {f.__name__: f.launches for f in counters}
            want_x = {"banded_attention_batched": 0, "int4_mm": 0,
                      "flash_decode": n_layers * n_steps * (impl == "auto"),
                      "ring_rows_write": n_layers * n_steps * (impl == "xla")}
            if quantize == "int4":
                want_x["int4_mm"] = (4 * n_layers + 1) * n_steps
            if got != want_x:
                raise AssertionError(f"[serve] {name} {impl} mid-fill "
                                     f"launches {got} != {want_x}")
            if impl == "xla":   # the row-write kernel's main-path launches
                st["launches_xla_mid_fill"] = got
                launch_totals["ring_rows_write"] += got["ring_rows_write"]
            del xcache

        # one decoder step (+ logits) through the kernel path and the plain
        # path from the same prefilled cache
        cache = sv.batched_dec_cache(rcfg, n_streams, engine.dec_kv_ring,
                                     device=device)
        sv.bprefill(dp, rcfg, engine.prompt_embeds(rows[:, :plen])[
            :, : plen - 1], cache, torch.zeros(n_streams, dtype=torch.int32,
                                               device=device), engine.ada())
        pos = torch.full((n_streams,), plen - 1, dtype=torch.int32,
                         device=device)
        prev = torch.full((n_streams,), 32, dtype=torch.int32, device=device)
        emb = (rows[:, plen - 1].float()
               + embed_rows(dp, prev))[:, None]
        outs = {}
        for impl in ("auto", "xla"):
            c2 = dec_mod.KVCache(cache.k.clone(), cache.v.clone())
            cfg_i = rcfg.replace(decoder=dataclasses.replace(
                rcfg.decoder, attn_impl=impl))
            ctx = plain_kernels() if impl == "xla" else contextlib.nullcontext()
            with ctx:
                x, _ = dec_mod.decoder_forward(dp, cfg_i, emb, c2, pos,
                                               engine.ada())
                lg = dec_mod.final_logits(dp, cfg_i, x)
            outs[impl] = (x.float(), lg)
            del c2
        step_err = max(
            ((outs["auto"][i] - outs["xla"][i]).abs().max()
             / outs["xla"][i].abs().max()).item() for i in (0, 1))
        st["step_rel_err"] = step_err
        log("serve", f"{name}: decoder step + logits, kernel path vs plain "
                     f"path: max rel err {step_err:.3e} (tol {STEP_REL_TOL})")
        if not step_err <= STEP_REL_TOL:
            raise AssertionError(f"[serve] {name}: step rel err {step_err}")
        del cache, outs

        rung_ids[name] = ids
        if name == "bf16":   # stream 0 alone through the B=1 offline path
            bf16_b1 = transcribe_offline_ids(engine, clips[0])
            st["stream0_agree_b1"] = _agreement(ids[0], bf16_b1)
        for ref in ("bf16", "int4"):
            if ref in rung_ids and name != ref:
                st[f"agree_{ref}"] = float(np.mean([
                    _agreement(a, b) for a, b in zip(ids, rung_ids[ref])]))
        if deq_steps is not None:
            st["int4_max_quant_steps"] = deq_steps
            if not st["agree_int4"] >= DEQUANT_AGREE_MIN:
                raise AssertionError(
                    f"[serve] {name}: {st['agree_int4']:.3f} of ids equal "
                    f"to the int4 rung's (min {DEQUANT_AGREE_MIN})")
        st["tokens"] = sum(len(t) for t in ids)
        st["rung"] = name
        table.append(st)
        extras = "".join(f", {k} {st[k]:.3f}" for k in
                         ("step_ms_mid_fill", "device_ms_per_step_mid_fill",
                          "device_events_per_step_mid_fill", "busy_mid_fill",
                          "step_ms_mid_fill_xla",
                          "device_ms_per_step_mid_fill_xla",
                          "device_events_per_step_mid_fill_xla",
                          "busy_mid_fill_xla",
                          "stream0_agree_b1", "agree_bf16", "agree_int4")
                         if k in st)
        log("serve", f"{name}: B={n_streams} x {dur:.1f} s, {steps} decode "
                     f"steps, {st['tokens']} ids; "
                     + ("first run: " if name in SERVE_ONCE else "")
                     + f"encode {st['encode_ms']:.2f} ms, prefill "
                     f"{st['prefill_ms']:.2f} ms, decode "
                     f"{st['decode_ms_per_step']:.3f} ms/step, "
                     f"{st['x_realtime_aggregate']:.2f}x realtime aggregate, "
                     f"peak {st['peak_gib']:.2f} GiB{extras}; launches "
                     f"{st['launches']}"
                     + ("" if name in SERVE_ONCE
                        else "; second run identical ids"))
        if name in SERVE_ONCE:
            for key in SERVE_TIMES:
                st[f"first_run_{key}"] = st.pop(key)
        del engine, dp, rows
        if on_gpu:
            torch.cuda.empty_cache()
    for f in counters:
        f.launches = 0
    return {"rungs": table, "launches": launch_totals}


def _stream_counters():
    from voxtral_tpu_torch.ops.banded_encode import banded_attention_batched
    from voxtral_tpu_torch.ops.flash_decode import flash_decode
    from voxtral_tpu_torch.ops.flash_encode import flash_bulk_attention_batched

    return (flash_bulk_attention_batched, flash_decode,
            banded_attention_batched)


def _check_stream_launches(phase: str, cfg, launches: dict, enc_calls: int,
                           steps: int) -> None:
    """Exact launch counts of a streaming run: flash encode once per
    encoder layer for each encoder call of T > 1 rows, flash decode once
    per decoder layer per sequential decode step (`steps`), the bulk
    encoder's kernel never."""
    want = {"flash_bulk_attention_batched": cfg.encoder.n_layers * enc_calls,
            "flash_decode": cfg.decoder.n_layers * steps,
            "banded_attention_batched": 0}
    if launches != want or enc_calls <= 0 or steps <= 0:
        raise AssertionError(f"[{phase}] launches {launches} != {want} "
                             f"({enc_calls} encoder chunks, {steps} steps)")


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def phase_stream(cfg, params, device: str, seconds: float = 11.0) -> dict:
    """Drives the streaming path at B=1: VoxStream on an engine built as
    the CLI builds it (buckets (64, 16, 4, 1), adaptive decoder ring, the
    encoder ring the engine sizes, decode_mode "auto", the CLI's warm-up),
    one synthetic clip
    fed three ways: 1 s at a time at the default 2 s interval, 0.5 s at a
    time at -I 0.5, and 1 s at a time with fused_streaming=False.  Checks
    the exact launch counts of each run and the id agreement of the runs
    with each other and with transcribe_offline_ids on the same clip.
    main() runs it at full width on the card; a tiny CPU config rehearses
    it (with the plain functions counted, as for phase_slice)."""
    import torch

    from voxtral_tpu_torch.config import (
        SAMPLE_RATE,
        STREAM_DEFAULT_INTERVAL_S,
    )
    from voxtral_tpu_torch.runtime.engine import (
        VoxtralEngine,
        adaptive_dec_ring,
    )
    from voxtral_tpu_torch.runtime.offline import transcribe_offline_ids
    from voxtral_tpu_torch.runtime.stream import VoxStream

    on_gpu = device == "cuda"
    counters = _stream_counters()

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    tok = byte_tokenizer(cfg.decoder.vocab_size)
    clip = make_audio(seconds, seed=7)
    ring = adaptive_dec_ring(cfg, len(clip))
    engines = {fused: VoxtralEngine(cfg, params, tokenizer=tok,
                                    dec_kv_ring=ring, buckets=(64, 16, 4, 1),
                                    decode_mode="auto",
                                    fused_streaming=fused)
               for fused in (True, False)}
    eng = engines[True]
    warm = eng.warmup(interval_s=STREAM_DEFAULT_INTERVAL_S)
    log("stream", f"engine: enc ring {eng.enc_kv_ring}, dec ring "
                  f"{eng.dec_kv_ring}, buckets {eng.buckets}, fused buckets "
                  f"{eng.fused_buckets}; warm-up {warm:.1f} s")
    runs = (("1s_at_2s", True, SAMPLE_RATE, None),
            ("0.5s_at_0.5s", True, SAMPLE_RATE // 2, 0.5),
            ("1s_at_2s_unfused", False, SAMPLE_RATE, None))
    table, ids = [], {}
    for name, fused, feed_n, interval in runs:
        for f in counters:
            f.launches = 0
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        s = VoxStream(engines[fused])
        s.record_ids = True
        js0 = engines[fused].jacobi_steps
        if interval is not None:
            s.set_processing_interval(interval)
        feed_walls = []
        sync()
        w0 = time.monotonic()
        for i in range(0, len(clip), feed_n):
            f0 = time.monotonic()
            s.feed(clip[i: i + feed_n])
            sync()
            feed_walls.append(time.monotonic() - f0)
        s.finish()
        sync()
        wall = time.monotonic() - w0
        launches = {f.__name__: f.launches for f in counters}
        # Jacobi bursts ("auto" takes bursts of >= 64 rows) run the plain
        # ring path: only the sequential steps launch flash-decode
        j_steps = engines[fused].jacobi_steps - js0
        _check_stream_launches("stream", cfg, launches, s.n_enc_chunk_calls,
                               s.n_decode_steps - j_steps)
        vocab = cfg.decoder.vocab_size
        if not s.generated_ids or not all(0 <= t < vocab
                                          for t in s.generated_ids):
            raise AssertionError(f"[stream] {name}: no ids or ids out of "
                                 "range")
        ids[name] = s.generated_ids
        rec = {
            "run": name, "fused": fused, "feed_s": feed_n / SAMPLE_RATE,
            "interval_s": (interval if interval is not None
                           else STREAM_DEFAULT_INTERVAL_S),
            "clip_s": seconds, "wall_s": wall, "x_realtime": seconds / wall,
            "feeds": len(feed_walls),
            "encoder_ms_per_feed": s.encoder_ms / len(feed_walls),
            "feed_p50_ms": _percentile(feed_walls, 50) * 1e3,
            "feed_p90_ms": _percentile(feed_walls, 90) * 1e3,
            "prefill_ms": s.prefill_ms,
            "decode_ms_per_step": ((s.decoder_ms - s.prefill_ms)
                                   / max(s.n_decode_steps, 1)),
            "decode_steps": s.n_decode_steps, "jacobi_steps": j_steps,
            "ids": len(s.generated_ids),
            "text_tokens": s.n_text_tokens,
            "encoder_chunks": s.n_enc_chunk_calls,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_gpu else 0.0),
            "launches": launches,
        }
        table.append(rec)
        log("stream", f"{name}: {seconds:.1f} s in {wall:.3f} s "
                      f"({rec['x_realtime']:.2f}x realtime), {rec['ids']} ids "
                      f"({rec['text_tokens']} text); encoder "
                      f"{rec['encoder_ms_per_feed']:.2f} ms/feed (issue), "
                      f"feed() wall p50 {rec['feed_p50_ms']:.2f} p90 "
                      f"{rec['feed_p90_ms']:.2f} ms; prefill "
                      f"{rec['prefill_ms']:.2f} ms, decode "
                      f"{rec['decode_ms_per_step']:.3f} ms/step over "
                      f"{rec['decode_steps']} steps; peak "
                      f"{rec['peak_gib']:.2f} GiB; launches {launches}")
    for f in counters:
        f.launches = 0
    ids["offline"] = transcribe_offline_ids(eng, clip)
    names = list(ids)
    agree, first_diff = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            agree[f"{a}~{b}"] = _agreement(ids[a], ids[b])
            # where the two greedy decodes part (a flipped near-tie feeds
            # back, so the ids after it differ more)
            first_diff[f"{a}~{b}"] = next(
                (j for j, (x, y) in enumerate(zip(ids[a], ids[b])) if x != y),
                min(len(ids[a]), len(ids[b])))
    log("stream", "id agreement: " + ", ".join(
        f"{k} {v:.3f} (first differs at {first_diff[k]})"
        for k, v in agree.items()) + f"; min {STREAM_AGREE_MIN}")
    low = {k: v for k, v in agree.items() if not v >= STREAM_AGREE_MIN}
    if low:
        raise AssertionError(f"[stream] id agreement below "
                             f"{STREAM_AGREE_MIN}: {low}")
    for f in counters:
        f.launches = 0
    return {"runs": table, "agreement": agree, "first_diff": first_diff,
            "launches": {f.__name__: sum(r["launches"][f.__name__]
                                         for r in table) for f in counters}}


def phase_bstream(cfg, params, device: str, n_streams: int = 16,
                  seconds: float = 30.0, dec_ring: int = 896,
                  interval_frames: int = 200) -> dict:
    """Drives the lockstep BatchedTranscriber: B streams of `seconds`
    synthetic audio, each from its own seed, as padded mel fed
    `interval_frames` at a time (bconv0/bconv1/bencode/badapter, then
    bprefill and bdecode_burst), decoder ring `dec_ring`.  Checks the exact
    launch counts and the ids, and prints stream 0's agreement with a B=1
    VoxStream of the same clip.  main() runs it at full width on the card;
    a tiny CPU config rehearses it."""
    import torch

    from voxtral_tpu_torch.parallel.serving import BatchedTranscriber
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel
    from voxtral_tpu_torch.runtime.stream import VoxStream

    on_gpu = device == "cuda"
    counters = _stream_counters()

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    tok = byte_tokenizer(cfg.decoder.vocab_size)
    engine = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=dec_ring,
                           buckets=(64, 16, 4, 1))
    clips = [make_audio(seconds, seed=100 + i) for i in range(n_streams)]
    mel = torch.from_numpy(np.stack([padded_clip_mel(engine, c)
                                     for c in clips])).to(device)
    # a short warm run (allocator, cuBLAS handles for these shapes)
    BatchedTranscriber(engine, n_streams, dec_kv_ring=dec_ring).transcribe(
        mel[:, : 2 * interval_frames], interval_frames=interval_frames)
    for f in counters:
        f.launches = 0
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    tr = BatchedTranscriber(engine, n_streams, dec_kv_ring=dec_ring)
    sync()
    w0 = time.monotonic()
    toks = tr.transcribe(mel, interval_frames=interval_frames)
    sync()
    wall = time.monotonic() - w0
    launches = {f.__name__: f.launches for f in counters}
    _check_stream_launches("bstream", cfg, launches, tr.n_enc_chunk_calls,
                           tr.decode_steps)
    vocab = cfg.decoder.vocab_size
    if not all(toks) or not all(0 <= t < vocab for s in toks for t in s):
        raise AssertionError("[bstream] a stream without ids, or ids out of "
                             "range")
    # stream 0 alone through VoxStream (1 s feeds, default interval)
    s = VoxStream(engine)
    s.record_ids = True
    for i in range(0, len(clips[0]), 16000):
        s.feed(clips[0][i: i + 16000])
    s.finish()
    m = min(len(toks[0]), len(s.generated_ids))
    agree_b1 = _agreement(toks[0][:m], s.generated_ids[:m])
    rec = {"streams": n_streams, "clip_s": seconds, "wall_s": wall,
           "x_realtime_aggregate": n_streams * seconds / wall,
           "encode_ms": tr.encode_time * 1e3,
           "decode_ms": tr.decode_time * 1e3,
           "decode_steps": tr.decode_steps,
           "decode_ms_per_step": tr.decode_time * 1e3
           / max(tr.decode_steps, 1),
           "encoder_chunks": tr.n_enc_chunk_calls,
           "tokens": sum(len(t) for t in toks),
           "stream0_agree_b1": agree_b1, "compared": m,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if on_gpu else 0.0),
           "launches": launches}
    log("bstream", f"B={n_streams} x {seconds:.1f} s in {wall:.3f} s "
                   f"({rec['x_realtime_aggregate']:.2f}x realtime aggregate); "
                   f"encode {rec['encode_ms']:.1f} ms, decode "
                   f"{rec['decode_ms']:.1f} ms ({rec['decode_ms_per_step']:.3f}"
                   f" ms/step over {tr.decode_steps} steps), "
                   f"{tr.n_enc_chunk_calls} encoder chunks, {rec['tokens']} "
                   f"ids; stream 0 vs B=1 VoxStream {agree_b1:.3f} over {m} "
                   f"ids; peak {rec['peak_gib']:.2f} GiB; launches {launches}")
    for f in counters:
        f.launches = 0
    return rec


def small_config(compute_dtype: str = "float32"):
    """A few layers at narrow widths with the full-width head dims the
    kernels take (encoder 4 x 64, decoder 4q/2kv x 128): the config of the
    f32 Jacobi check here and of the tests' pool runs on the card."""
    from voxtral_tpu_torch.config import tiny_config

    c = tiny_config(compute_dtype=compute_dtype, dec_kv_ring=256,
                    enc_kv_ring=128, enc_window=64, dec_window=256)
    return c.replace(
        encoder=dataclasses.replace(c.encoder, dim=256, n_heads=4,
                                    head_dim=64, n_kv_heads=4, hidden=512),
        decoder=dataclasses.replace(c.decoder, dim=256, n_heads=4,
                                    head_dim=128, n_kv_heads=2, hidden=512),
        adapter_hidden=256)


def jacobi_vs_sequential(params, cfg, rows, ada, window: int) -> dict:
    """One stream's burst over adapter rows [1, T, dim] decoded from a
    fresh cache sequentially and by Jacobi (window `window`).  Where the
    ids first differ, the sequential top-2 logit gap there is read; the
    difference is a near-tie when that gap is below
    JACOBI_TIE_REL x max |logit|.  Returns the comparison."""
    import torch

    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models.jacobi import decode_burst_jacobi

    dev = rows.device
    dparams, d = params["decoder"], cfg.decoder
    prev = torch.tensor([32], dtype=torch.int32, device=dev)

    def cache():
        return dec_mod.KVCache.create(d, cfg.kvdtype, 256, device=dev)

    seq = dec_mod.decode_burst(dparams, cfg, rows, prev, cache(), 0, ada)[0]
    jac, _, _, _, _, iters = decode_burst_jacobi(dparams, cfg, rows, prev,
                                                 cache(), 0, ada,
                                                 window=window)
    seq, jac = seq[0].tolist(), jac[0].tolist()
    out = {"t": len(seq), "window": window, "iters": iters,
           "first_diff": None, "near_tie": None}
    j = next((i for i, (a, b) in enumerate(zip(seq, jac)) if a != b), None)
    if j is None:
        return out
    # the sequential logits at position j: replay j steps, then one more
    c = cache()
    if j:
        dec_mod.decode_burst(dparams, cfg, rows[:, :j], prev, c, 0, ada)
    p_j = torch.tensor([seq[j - 1]] if j else [32], dtype=torch.int32,
                       device=dev)
    emb = (rows[:, j].float()
           + dec_mod.quant.embed_rows(dparams, p_j))[:, None]
    x, _ = dec_mod.decoder_forward(dparams, cfg, emb, c, j, ada)
    logits = dec_mod.final_logits(dparams, cfg, x)[0, 0]
    top2 = torch.topk(logits, 2).values
    gap = (top2[0] - top2[1]).item()
    scale = logits.abs().max().item()
    out.update(first_diff=j, gap=gap, scale=scale,
               near_tie=gap < JACOBI_TIE_REL * scale)
    return out


def phase_jacobi(cfg, params, device: str, seconds: float = 30.0) -> dict:
    """Jacobi decoding at B=1: the slice's 30 s clip through
    transcribe_offline_ids on two engines over the same weights,
    decode_mode "auto" (the CLI's default: Jacobi for the 64-row bursts)
    and "sequential", with exact launch counts (a Jacobi window of 64
    rows runs the plain ring path, so only sequential steps launch
    flash-decode), tokens per iteration, decode ms per token and the share
    of equal ids.  Then the small f32 config (small_config) on `device`:
    Jacobi ids equal sequential ids at every position up to a near-tie
    (jacobi_vs_sequential).  main() runs it at full width on the card; a
    tiny CPU config rehearses it."""
    import torch

    from voxtral_tpu_torch.config import SAMPLE_RATE
    from voxtral_tpu_torch.models.decoder import ada_scales
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.ops.banded_encode import banded_attention_batched
    from voxtral_tpu_torch.ops.flash_decode import flash_decode
    from voxtral_tpu_torch.runtime.engine import (
        VoxtralEngine,
        adaptive_dec_ring,
    )
    from voxtral_tpu_torch.runtime.offline import transcribe_offline_ids

    on_gpu = device == "cuda"
    tok = byte_tokenizer(cfg.decoder.vocab_size)
    clip = make_audio(seconds, seed=2)     # phase_slice's 30 s clip
    ring = adaptive_dec_ring(cfg, len(clip))
    engines = {m: VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=ring,
                                buckets=(64, 16, 4, 1), decode_mode=m)
               for m in ("auto", "sequential")}
    for eng in engines.values():   # warm: a 64-row burst on each engine
        transcribe_offline_ids(eng, clip[: 6 * SAMPLE_RATE])
    runs, ids = {}, {}
    for mode, eng in engines.items():
        banded_attention_batched.launches = flash_decode.launches = 0
        it0, js0 = len(eng.jacobi_iters), eng.jacobi_steps
        stats: dict = {}
        ids[mode] = transcribe_offline_ids(eng, clip, timings=stats)
        steps = stats["decode_steps"]
        iters = sum(eng.jacobi_iters[it0:])
        j_steps = eng.jacobi_steps - js0
        launches = {"banded_attention_batched":
                    banded_attention_batched.launches,
                    "flash_decode": flash_decode.launches}
        want = {"banded_attention_batched": cfg.encoder.n_layers,
                "flash_decode": cfg.decoder.n_layers * (steps - j_steps)}
        if launches != want or (mode == "auto") != (j_steps > 0):
            raise AssertionError(f"[jacobi] {mode}: launches {launches} != "
                                 f"{want} ({steps} steps, {j_steps} by "
                                 "Jacobi)")
        if not all(0 <= t < cfg.decoder.vocab_size for t in ids[mode]):
            raise AssertionError(f"[jacobi] {mode}: id out of range")
        rec = {"decode_steps": steps, "jacobi_steps": j_steps,
               "jacobi_iters": iters,
               "tokens_per_iter": j_steps / iters if iters else None,
               "decode_ms_per_token": stats["decode_s"] * 1e3 / max(steps, 1),
               "ids": len(ids[mode]), "launches": launches}
        runs[mode] = rec
        log("jacobi", f"{mode}: {steps} decode steps ({j_steps} in "
                      f"{len(eng.jacobi_iters) - it0} Jacobi bursts, {iters} "
                      f"iterations"
                      + (f", {rec['tokens_per_iter']:.3f} tokens/iter"
                         if iters else "")
                      + f"), decode {rec['decode_ms_per_token']:.3f} "
                      f"ms/token, {len(ids[mode])} ids; launches {launches}")
    agree = _agreement(ids["auto"], ids["sequential"])
    first = next((i for i, (a, b) in enumerate(zip(ids["auto"],
                                                   ids["sequential"]))
                  if a != b), min(len(ids["auto"]), len(ids["sequential"])))
    log("jacobi", f"auto vs sequential ids (bf16): {agree:.4f} equal, first "
                  f"differs at {first}")

    # the f32 check: decoder only, on random adapter rows
    scfg = small_config("float32")
    sparams = init_params(scfg, seed=0, device=device)
    sada = ada_scales(sparams["decoder"], scfg)
    rng = np.random.default_rng(6)
    checks = []
    for t, w in ((64, 64), (96, 32)):
        rows = torch.from_numpy((rng.standard_normal(
            (1, t, scfg.decoder.dim)) * 0.5).astype(np.float32)).to(device)
        res = jacobi_vs_sequential(sparams, scfg, rows, sada, w)
        checks.append(res)
        if res["first_diff"] is None:
            verdict = "ids equal to sequential"
        else:
            verdict = (f"first differs at {res['first_diff']}: top-2 gap "
                       f"{res['gap']:.3e} vs {JACOBI_TIE_REL} x "
                       f"{res['scale']:.3e} ("
                       + ("near-tie" if res["near_tie"] else "FAIL") + ")")
        log("jacobi", f"f32 small config T={t} W={w}: {res['iters']} "
                      f"iterations; {verdict}")
        if res["first_diff"] is not None and not res["near_tie"]:
            raise AssertionError(f"[jacobi] f32 Jacobi ids differ from "
                                 f"sequential at {res['first_diff']}, not a "
                                 f"near-tie: {res}")
    flash_decode.launches = banded_attention_batched.launches = 0
    if on_gpu:
        torch.cuda.empty_cache()
    return {"clip_s": seconds, "runs": runs, "agree": agree,
            "first_diff": first, "f32_checks": checks,
            "launches_flash_decode": sum(r["launches"]["flash_decode"]
                                         for r in runs.values()),
            "launches_banded": sum(r["launches"]["banded_attention_batched"]
                                   for r in runs.values())}


def capture_stats(start=(0, 0.0, 0)) -> dict:
    """The CUDA graphs captured since `start` (GraphedCall's counters then):
    how many, their host seconds, and the memory their captures added to
    the allocator's reserve (their private pools)."""
    from voxtral_tpu_torch.ops.graphs import GraphedCall as gc

    n = gc.captures - start[0]
    sec = gc.capture_s - start[1]
    return {"graphs": n, "capture_s": sec,
            "capture_ms_mean": sec * 1e3 / max(n, 1),
            "pool_gib": (gc.pool_bytes - start[2]) / 2**30}


def _step_logits_bit_equal(engine, cfg, bsz: int, device: str,
                           pos: int = 500, seed: int = 3) -> bool:
    """One decoder step and its f32 logits at position `pos` over a ring
    of random rows: run eagerly, and as the replay of its CUDA graph
    (ops/graphs.py) from the same ring.  True when the logits and both
    rings are equal bit for bit."""
    import torch

    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models.quant import embed_rows
    from voxtral_tpu_torch.ops.graphs import GraphStore, graph_key

    dp, ada = engine.params["decoder"], engine.ada()
    base = engine.new_dec_cache(bsz)
    gen = torch.Generator(device=device).manual_seed(seed)
    for t in (base.k, base.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=device) * 0.5)
    row = torch.randn((bsz, cfg.decoder.dim), generator=gen, device=device)
    prev = torch.full((bsz,), 32, dtype=torch.int32, device=device)
    at = torch.full((bsz,), pos, dtype=torch.int32, device=device)

    def body(cache):
        def step(row, prev, at):
            embed = (row.float() + embed_rows(dp, prev))[:, None]
            x, _ = dec_mod.decoder_forward(dp, cfg, embed, cache, at, ada)
            return dec_mod.final_logits(dp, cfg, x)[:, 0]
        return step

    eager = dec_mod.KVCache(base.k.clone(), base.v.clone())
    want = body(eager)(row, prev, at)
    graphed = dec_mod.KVCache(base.k.clone(), base.v.clone(), GraphStore())
    key = graph_key("logits", dp, ada, cfg, bsz)
    graph, _ = graphed.graphs.call(key, body(graphed), (row, prev, at))
    graphed.k.copy_(base.k)
    graphed.v.copy_(base.v)
    got = graph(row, prev, at)
    return bool(torch.equal(got, want) and torch.equal(graphed.k, eager.k)
                and torch.equal(graphed.v, eager.v))


def phase_graphs(cfg, params, device: str, n_streams: int = 16,
                 seconds: float = 30.0, dec_ring: int = 896,
                 extra_steps: int = 32, stream_seconds: float = 11.0,
                 jacobi_seconds: float = 30.0) -> dict:
    """The engine's CUDA graphs (ops/graphs.py) against eager, both in this
    call, on engines that differ only in `cuda_graphs`:
      * serve_clips at B=`n_streams` x `seconds` on the bf16, fp8kv, int8
        and int4 rungs: ids bit-equal, exact launch counts both ways,
        decode ms/step; at mid fill (position 500, bursts of
        `extra_steps`) decode ms/step, device ms/step, device events and
        the host's launch calls into the runtime per step (LAUNCH_CALLS)
        and the busy share, the bursts' ids bit-equal; on fp8kv also under
        attn_impl "xla" (the row-write kernel); one step's f32 logits and
        rings bit-equal (_step_logits_bit_equal);
      * a B=1 VoxStream built as the CLI builds it, an `stream_seconds`
        clip fed 1 s at a time: feed() wall p50/p90, ids bit-equal;
      * the `jacobi_seconds` clip offline under decode_mode "auto" (Jacobi
        windows of 64): ids bit-equal;
      * the captures: their number, host seconds and pool memory.
    main() runs it at full width on the card; a tiny CPU config rehearses
    it with a stand-in graph."""
    import torch

    from voxtral_tpu_torch.config import (
        SAMPLE_RATE,
        STREAM_DEFAULT_INTERVAL_S,
    )
    from voxtral_tpu_torch.ops import graphs
    from voxtral_tpu_torch.parallel import serving as sv
    from voxtral_tpu_torch.runtime.engine import (
        VoxtralEngine,
        adaptive_dec_ring,
    )
    from voxtral_tpu_torch.runtime.offline import (
        padded_clip_mel,
        transcribe_offline_ids,
    )
    from voxtral_tpu_torch.runtime.stream import VoxStream

    on_gpu = device == "cuda"
    wrappers = graphs.counted_wrappers()
    names = [f.__name__ for f in wrappers]
    totals = dict.fromkeys(names, 0)
    nl, el = cfg.decoder.n_layers, cfg.encoder.n_layers

    def zero():
        for f in wrappers:
            f.launches = 0

    def take(tag, want):
        """The launches since zero(), checked against `want` (the kernels
        it does not name: 0) and added to the phase's totals."""
        got = {f.__name__: f.launches for f in wrappers}
        want = {n: want.get(n, 0) for n in names}
        if got != want:
            raise AssertionError(f"[graphs] {tag}: launches {got} != {want}")
        for n in names:
            totals[n] += got[n]
        return got

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    def both(tag, a, b):
        if a != b:
            raise AssertionError(f"[graphs] {tag}: graph ids differ from "
                                 "eager ids")

    gc = graphs.GraphedCall
    start = (gc.captures, gc.capture_s, gc.pool_bytes)
    tok = byte_tokenizer(cfg.decoder.vocab_size)
    clips = [make_audio(seconds, seed=100 + i) for i in range(n_streams)]
    mel, table = None, []
    for name, kv, quantize in RUNGS:
        rcfg = cfg if kv is None else cfg.replace(kv_dtype=kv,
                                                  enc_kv_dtype="bfloat16")
        engine = VoxtralEngine(rcfg, params, tokenizer=tok,
                               dec_kv_ring=dec_ring, buckets=(64, 16, 4, 1),
                               quantize=quantize)
        if mel is None:
            mel = torch.from_numpy(np.stack(
                [padded_clip_mel(engine, c) for c in clips])).to(device)
        dp = engine.params["decoder"]
        int4 = quantize == "int4"
        rec, ids = {"rung": name}, {}
        for graphed in (False, True):
            tag = "graph" if graphed else "eager"
            engine.cuda_graphs = graphed
            zero()
            c0 = graphs.GraphedCall.captures
            ids[tag], run = sv.serve_clips(engine, mel)
            steps = run["decode_steps"]
            take(f"{name} serve {tag}", {
                "banded_attention_batched": el, "flash_decode": nl * steps,
                "int4_mm": (4 * nl + (4 * nl + 1) * steps) if int4 else 0})
            rec[f"serve_decode_ms_per_step_{tag}"] = (run["decode_s"] * 1e3
                                                     / steps)
            rec[f"serve_wall_s_{tag}"] = (run["encode_s"] + run["prefill_s"]
                                          + run["decode_s"])
            rec[f"serve_captures_{tag}"] = graphs.GraphedCall.captures - c0
        both(f"{name} serve", ids["eager"], ids["graph"])
        rec["decode_steps"] = steps
        rec["tokens"] = sum(len(t) for t in ids["graph"])

        for impl in ("auto", "xla") if name == "fp8kv" else ("auto",):
            icfg = rcfg.replace(decoder=dataclasses.replace(
                rcfg.decoder, attn_impl=impl))
            burst_ids = {}
            for graphed in (False, True):
                tag = (("graph" if graphed else "eager")
                       + ("" if impl == "auto" else "_xla"))
                xcache = sv.batched_dec_cache(icfg, n_streams, dec_ring,
                                              device=device, graphs=graphed)
                xchunk = torch.zeros((n_streams, extra_steps,
                                      cfg.decoder.dim), device=device)
                xprev = torch.full((n_streams,), 32, dtype=torch.int32,
                                   device=device)
                xpos = torch.full((n_streams,), 500, dtype=torch.int32,
                                  device=device)
                ran, last = [0], [None]

                def burst(n=extra_steps):
                    last[0] = sv.bdecode_burst(dp, icfg, xchunk[:, :n], xprev,
                                               xcache, xpos, engine.ada())[0]
                    ran[0] += n

                zero()
                if on_gpu:
                    step_ms = cuda_ms(burst, 2, warmup=1) / extra_steps
                    ev, calls, _ = profiled(lambda: burst(8))
                    dms = sum(e.time_range.elapsed_us() for e in ev) / 8e3
                    if graphed and not calls / 8 <= LAUNCH_CALLS_MAX:
                        raise AssertionError(
                            f"[graphs] {name} {tag}: {calls / 8} launch "
                            f"calls per graphed step (max {LAUNCH_CALLS_MAX})")
                    rec.update({
                        f"step_ms_mid_fill_{tag}": step_ms,
                        f"device_ms_per_step_mid_fill_{tag}": dms,
                        f"device_events_per_step_mid_fill_{tag}": len(ev) / 8,
                        f"launch_calls_per_step_mid_fill_{tag}": calls / 8,
                        f"busy_mid_fill_{tag}": dms / step_ms})
                else:
                    burst()
                    burst()
                sync()
                n = ran[0]
                got = take(f"{name} {tag} mid fill", {
                    "flash_decode": nl * n * (impl == "auto"),
                    "ring_rows_write": nl * n * (impl == "xla"),
                    "int4_mm": (4 * nl + 1) * n if int4 else 0})
                if impl == "xla" and graphed:
                    rec["launches_xla_mid_fill_graph"] = got
                burst_ids[graphed] = last[0].tolist()
                del xcache
            both(f"{name} {impl} mid fill", burst_ids[False], burst_ids[True])
        rec["logits_bit_equal"] = _step_logits_bit_equal(engine, rcfg,
                                                         n_streams, device)
        if not rec["logits_bit_equal"]:
            raise AssertionError(f"[graphs] {name}: the graphed step's "
                                 "logits or rings differ from eager")
        table.append(rec)
        log("graphs", f"{name}: serve B={n_streams} x {seconds:.0f} s ids "
                      f"bit-equal ({steps} steps, {rec['tokens']} ids), logits "
                      "bit-equal; " + ", ".join(
                          f"{k} {v:.3f}" for k, v in rec.items()
                          if isinstance(v, float)))
        del engine, dp
        if on_gpu:
            torch.cuda.empty_cache()

    # the B=1 stream as the CLI builds it, fed 1 s at a time
    clip = make_audio(stream_seconds, seed=7)
    eng = VoxtralEngine(cfg, params, tokenizer=tok,
                        dec_kv_ring=adaptive_dec_ring(cfg, len(clip)),
                        buckets=(64, 16, 4, 1), decode_mode="auto")
    eng.warmup(interval_s=STREAM_DEFAULT_INTERVAL_S)
    stream, sids = {}, {}
    for graphed in (False, True):
        tag = "graph" if graphed else "eager"
        eng.cuda_graphs = graphed
        zero()
        c0, js0 = graphs.GraphedCall.captures, eng.jacobi_steps
        s = VoxStream(eng)
        s.record_ids = True
        walls = []
        for i in range(0, len(clip), SAMPLE_RATE):
            f0 = time.monotonic()
            s.feed(clip[i: i + SAMPLE_RATE])
            sync()
            walls.append(time.monotonic() - f0)
        s.finish()
        sync()
        take(f"stream {tag}", {
            "flash_bulk_attention_batched": el * s.n_enc_chunk_calls,
            "flash_decode": nl * (s.n_decode_steps
                                  - (eng.jacobi_steps - js0))})
        sids[tag] = s.generated_ids
        stream.update({f"feed_p50_ms_{tag}": _percentile(walls, 50) * 1e3,
                       f"feed_p90_ms_{tag}": _percentile(walls, 90) * 1e3,
                       f"captures_{tag}": graphs.GraphedCall.captures - c0})
    both("stream", sids["eager"], sids["graph"])
    stream.update({"feeds": len(walls), "ids": len(sids["graph"])})
    log("graphs", f"stream B=1 {stream_seconds:.0f} s fed 1 s at a time: ids "
                  "bit-equal; " + ", ".join(f"{k} {v:.3f}" for k, v in
                                            stream.items()
                                            if isinstance(v, float)))

    # Jacobi windows (decode_mode "auto" offline)
    jclip = make_audio(jacobi_seconds, seed=2)
    jeng = VoxtralEngine(cfg, params, tokenizer=tok,
                         dec_kv_ring=adaptive_dec_ring(cfg, len(jclip)),
                         buckets=(64, 16, 4, 1), decode_mode="auto")
    jacobi, jids = {}, {}
    for graphed in (False, True):
        tag = "graph" if graphed else "eager"
        jeng.cuda_graphs = graphed
        zero()
        js0, st = jeng.jacobi_steps, {}
        jids[tag] = transcribe_offline_ids(jeng, jclip, timings=st)
        j_steps = jeng.jacobi_steps - js0
        if j_steps <= 0:
            raise AssertionError("[graphs] jacobi: no Jacobi burst")
        take(f"jacobi {tag}", {
            "banded_attention_batched": el,
            "flash_decode": nl * (st["decode_steps"] - j_steps)})
        jacobi[f"decode_ms_per_token_{tag}"] = (st["decode_s"] * 1e3
                                                / st["decode_steps"])
    both("jacobi", jids["eager"], jids["graph"])
    jacobi["jacobi_steps"] = j_steps
    log("graphs", f"jacobi {jacobi_seconds:.0f} s offline \"auto\": ids "
                  f"bit-equal ({j_steps} rows by Jacobi); decode ms/token "
                  f"eager {jacobi['decode_ms_per_token_eager']:.3f}, graph "
                  f"{jacobi['decode_ms_per_token_graph']:.3f}")
    captures = capture_stats(start)
    log("graphs", f"captures: {captures['graphs']} graphs in "
                  f"{captures['capture_s']:.2f} s "
                  f"({captures['capture_ms_mean']:.1f} ms each), pools "
                  f"{captures['pool_gib']:.3f} GiB in all")
    zero()
    return {"rungs": table, "stream": stream, "jacobi": jacobi,
            "captures": captures, "launches": totals}


# bench.py's load rows: the ring pool (8 slots, bf16 encoder ring 1024 so
# flash-encode runs, decoder ring 896) at -I 0.5, the window pool (32
# slots, fp8 decoder ring 1024) at -I 2.0
POOL_RING = dict(tag="pool_ring", n_slots=8, enc_mode="ring", interval_s=0.5,
                 n_ticks=16, dec_ring=896)
POOL_WINDOW = dict(tag="pool_window", n_slots=32, enc_mode="window",
                   interval_s=2.0, n_ticks=8, dec_ring=1024,
                   dec_kv_dtype="float8_e4m3fn")


def _pool_counters():
    from voxtral_tpu_torch.ops.quant_mm import int4_mm
    from voxtral_tpu_torch.ops.ring import ring_rows_write

    return _stream_counters() + (int4_mm, ring_rows_write)


def phase_pool(cfg, params, device: str, tag: str, n_slots: int,
               enc_mode: str, interval_s: float, n_ticks: int,
               dec_ring: int, dec_kv_dtype=None, ref_ids=None) -> dict:
    """Drives the StreamPool as bench.py's load rows do: `n_slots`
    continuous slots, each fed its own synthetic audio 1x realtime,
    `interval_s` per tick with a 0.8x encode gate (the gate fires every
    tick), two rounds of `n_ticks` ticks, the last slot leaving and
    joining mid round 1.  Each tick runs its encoder half, a device sync,
    then its decoder half, so the split is device time.  Checks the exact
    launch counts (ring mode: flash-encode per encoder layer per encode
    call, window mode: banded; flash-decode per decoder layer per decoded
    row, parked rows included) and the ids; reports tick p50/p90, tokens
    per tick, the split, bursts per tick, peak memory, and slot 0's id
    agreement with a B=1 VoxStream fed the same audio (ring mode) or with
    `ref_ids` (window mode, the ring pool's slot 0).  main() runs it at
    full width on the card; a tiny CPU config rehearses it."""
    import torch

    from voxtral_tpu_torch.config import SAMPLE_RATE
    from voxtral_tpu_torch.parallel.scheduler import StreamPool
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.stream import VoxStream

    on_gpu = device == "cuda"
    counters = _pool_counters()

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    tok = byte_tokenizer(cfg.decoder.vocab_size)
    engine = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=dec_ring,
                           buckets=(64, 16, 4, 1))
    gate = 0.8 * interval_s
    feed_n = int(interval_s * SAMPLE_RATE)
    clips = [make_audio(2 * n_ticks * interval_s, seed=200 + i)
             for i in range(n_slots)]

    def new_pool():
        pool = StreamPool(engine, n_slots, dec_kv_ring=dec_ring,
                          enc_mode=enc_mode, dec_kv_dtype=dec_kv_dtype)
        pool.record_ids = True
        return pool

    def start(pool, i):
        pool.set_processing_interval(i, gate)
        pool.set_continuous(i, True)

    # a short warm pool (allocator, cuBLAS handles for these shapes)
    warm = new_pool()
    for i in range(n_slots):
        start(warm, warm.add_stream())
    for ti in range(3):
        for i in range(n_slots):
            warm.feed(i, clips[i][ti * feed_n: (ti + 1) * feed_n])
        warm.tick()
    del warm
    sync()

    pool = new_pool()
    slots = []
    for _ in range(n_slots):
        slots.append(pool.add_stream())
        start(pool, slots[-1])
    for f in counters:
        f.launches = 0
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    e0, b0, r0 = pool.n_enc_calls, pool.n_bursts, pool.burst_rows
    ticks, enc_ms, dec_ms, toks, bursts = [], [], [], [], []
    w0 = time.monotonic()
    for rnd in range(2):
        for ti in range(n_ticks):
            if rnd and ti == n_ticks // 2:      # the last slot churns
                pool.close(slots[-1])
                slots[-1] = pool.add_stream()
                start(pool, slots[-1])
            at = (rnd * n_ticks + ti) * feed_n
            gen0 = sum(s.n_generated for s in pool.slots)
            nb0 = pool.n_bursts
            t1 = time.monotonic()
            for i, sidx in enumerate(slots):
                pool.feed(sidx, clips[i][at: at + feed_n])
            pool._tick_encoder()
            sync()
            t_mid = time.monotonic()
            pool._tick_decoder()
            pool._mon_flush()
            t2 = time.monotonic()
            ticks.append((t2 - t1) * 1e3)
            enc_ms.append((t_mid - t1) * 1e3)
            dec_ms.append((t2 - t_mid) * 1e3)
            toks.append(sum(s.n_generated for s in pool.slots) - gen0)
            bursts.append(pool.n_bursts - nb0)
            for sidx in slots:
                pool.get(sidx)
    sync()
    wall = time.monotonic() - w0
    launches = {f.__name__: f.launches for f in counters}
    n_enc, rows = pool.n_enc_calls - e0, pool.burst_rows - r0
    want = {"flash_bulk_attention_batched":
            cfg.encoder.n_layers * n_enc * (enc_mode == "ring"),
            "banded_attention_batched":
            cfg.encoder.n_layers * n_enc * (enc_mode == "window"),
            "flash_decode": cfg.decoder.n_layers * rows,
            "int4_mm": 0, "ring_rows_write": 0}
    if launches != want or n_enc <= 0 or rows <= 0:
        raise AssertionError(f"[{tag}] launches {launches} != {want} ({n_enc} "
                             f"encode calls, {rows} decoded rows)")
    ids0 = pool.slots[0].generated_ids
    vocab = cfg.decoder.vocab_size
    if not ids0 or not all(0 <= t < vocab for s in pool.slots
                           for t in s.generated_ids):
        raise AssertionError(f"[{tag}] no ids on slot 0, or ids out of "
                             "range")
    if ref_ids is None:   # slot 0's audio through a B=1 VoxStream
        s = VoxStream(engine)
        s.record_ids = True
        s.set_processing_interval(gate)
        s.set_continuous(True)
        for at in range(0, 2 * n_ticks * feed_n, feed_n):
            s.feed(clips[0][at: at + feed_n])
        ref_ids, ref = s.generated_ids, "b1_voxstream"
    else:
        ref = "pool_ring"
    m = min(len(ids0), len(ref_ids))
    agree = _agreement(ids0[:m], ref_ids[:m])
    n_t = len(ticks)
    rec = {"slots": n_slots, "enc_mode": pool.enc_mode,
           "interval_s": interval_s, "gate_s": gate, "ticks": n_t,
           "dec_ring": dec_ring,
           "dec_kv_dtype": str(pool.dec_cache.k.dtype)[6:],
           "tick_p50_ms": _percentile(ticks, 50),
           "tick_p90_ms": _percentile(ticks, 90),
           "encode_p50_ms": _percentile(enc_ms, 50),
           "decode_p50_ms": _percentile(dec_ms, 50),
           "encode_ms_mean": float(np.mean(enc_ms)),
           "decode_ms_mean": float(np.mean(dec_ms)),
           "tokens_per_tick": float(np.mean(toks)),
           "bursts_per_tick": float(np.mean(bursts)),
           "encode_calls": n_enc, "decoded_rows": rows, "wall_s": wall,
           "restarts": sum(s.n_restarts for s in pool.slots),
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if on_gpu else 0.0),
           "pool_gib": pool.memory_ledger()["pool_total"] / 2**30,
           f"slot0_agree_{ref}": agree, "compared": m,
           "launches": launches}
    log(tag, f"{n_slots} slots {pool.enc_mode}, -I {interval_s} (gate "
             f"{gate:.1f}), {n_t} ticks in {wall:.2f} s: tick p50 "
             f"{rec['tick_p50_ms']:.1f} p90 {rec['tick_p90_ms']:.1f} ms "
             f"(encode p50 {rec['encode_p50_ms']:.1f}, decode p50 "
             f"{rec['decode_p50_ms']:.1f}), {rec['tokens_per_tick']:.1f} "
             f"tokens and {rec['bursts_per_tick']:.2f} bursts per tick, "
             f"{rec['restarts']} restarts; peak {rec['peak_gib']:.2f} GiB "
             f"(pool {rec['pool_gib']:.2f}); slot 0 vs {ref} {agree:.3f} "
             f"over {m} ids; launches {launches}")
    for f in counters:
        f.launches = 0
    rec["slot0_ids"] = ids0
    del pool
    if on_gpu:
        torch.cuda.empty_cache()
    return rec


def _print_profile(tag: str, events: list, wall_s: float, steps: int,
                   unit: str = "step") -> None:
    """Per-step device time, busy share and the largest device items."""
    from collections import defaultdict

    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    total = sum(us for us, _ in by_name.values())
    log("profile", f"{tag}: wall {wall_s * 1e3 / steps:.3f} ms/{unit} "
                   f"profiled, device {total / 1e3 / steps:.3f} ms/{unit}, "
                   f"busy {total / 1e6 / wall_s:.3f}, device events "
                   f"{len(events) / steps:.1f}/{unit}")
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:12]:
        log("profile", f"  {us / 1e3 / steps:8.4f} ms/{unit} "
                       f"{cnt / steps:7.1f} calls/{unit} "
                       f"{100 * us / total:5.1f} %  {name[:80]}")


def profile_streaming(cfg, params, n_streams: int = 16,
                      dec_ring: int = 896) -> None:
    """torch.profiler breakdown of the streaming paths at steady state:
    one 2 s feed() of a B=1 VoxStream after 4 s of audio, and one
    200-frame interval (encoder chunks, adapter, decode burst) of the
    B=`n_streams` BatchedTranscriber after four intervals."""
    import torch

    from voxtral_tpu_torch.parallel.serving import BatchedTranscriber
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel
    from voxtral_tpu_torch.runtime.stream import VoxStream

    tok = byte_tokenizer(cfg.decoder.vocab_size)
    eng = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=dec_ring,
                        buckets=(64, 16, 4, 1))
    clip = make_audio(30.0, seed=7)
    s = VoxStream(eng)
    s.feed(clip[: 4 * 16000])
    at = [4 * 16000]

    def feed():
        s.feed(clip[at[0]: at[0] + 2 * 16000])
        at[0] += 2 * 16000

    ev, wall = device_events(feed)
    _print_profile("stream B=1 feed of 2 s (one interval)", ev, wall, 1,
                   unit="feed")
    mel = torch.from_numpy(np.stack([padded_clip_mel(
        eng, make_audio(30.0, seed=100 + i))
        for i in range(n_streams)])).cuda()
    tr = BatchedTranscriber(eng, n_streams, dec_kv_ring=dec_ring)
    pos = [0]

    def interval():
        tr.feed_mel(mel[:, pos[0]: pos[0] + 200])
        tr.run_decoder()
        pos[0] += 200

    for _ in range(4):
        interval()
    steps0 = tr.decode_steps
    ev, wall = device_events(interval)
    log("profile", f"bstream: {tr.decode_steps - steps0} decode steps in the "
                   f"two intervals (unprofiled + profiled)")
    _print_profile(f"bstream B={n_streams} interval of 200 mel frames", ev,
                   wall, 1, unit="interval")


def phase_profile(cfg, params, n_streams: int = 16, steps: int = 16,
                  dec_ring: int = 896) -> None:
    """torch.profiler breakdown of the serve pipeline at B=`n_streams` x
    30 s (PERF.md section 5): the bf16 rung's bulk encode and prefill, then
    `steps` decode steps at position 500 from a fresh cache on each rung,
    with the unprofiled wall of the same burst beside it."""
    import torch

    from voxtral_tpu_torch.parallel import serving as sv
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    zeros = torch.zeros(n_streams, dtype=torch.int32, device="cuda")
    for name, kv, quantize in RUNGS:
        rcfg = cfg if kv is None else cfg.replace(kv_dtype=kv,
                                                  enc_kv_dtype="bfloat16")
        eng = VoxtralEngine(rcfg, params, dec_kv_ring=dec_ring,
                            buckets=(64, 16, 4, 1), quantize=quantize)
        dp = eng.params["decoder"]
        if name == "bf16":
            mel = torch.from_numpy(np.stack([padded_clip_mel(
                eng, make_audio(30.0, seed=100 + i))
                for i in range(n_streams)])).cuda()
            out = {}

            def encode():
                out["rows"] = eng.encode_clips_bulk(mel)

            ev, wall = device_events(encode)
            _print_profile(f"{name} bulk encode B={n_streams} x 30 s", ev,
                           wall, 1)
            plen = eng.prompt_len
            prompt = eng.prompt_embeds(out["rows"][:, :plen])[:, : plen - 1]
            cache = sv.batched_dec_cache(rcfg, n_streams, dec_ring,
                                         device="cuda")
            ev, wall = device_events(lambda: sv.bprefill(
                dp, rcfg, prompt, cache, zeros, eng.ada()))
            _print_profile(f"{name} prefill B={n_streams} x {plen - 1}", ev,
                           wall, 1)
            del out, cache, mel, prompt
        cache = sv.batched_dec_cache(rcfg, n_streams, dec_ring, device="cuda")
        chunk = torch.zeros((n_streams, steps, cfg.decoder.dim),
                            device="cuda")
        prev = torch.full((n_streams,), 32, dtype=torch.int32, device="cuda")
        pos = torch.full((n_streams,), 500, dtype=torch.int32, device="cuda")

        # fp8kv: the kernel's attention (auto) and the plain path (xla)
        for impl in ("auto", "xla") if name == "fp8kv" else ("auto",):
            icfg = rcfg.replace(decoder=dataclasses.replace(
                rcfg.decoder, attn_impl=impl))

            def burst():
                sv.bdecode_burst(dp, icfg, chunk, prev, cache, pos, eng.ada())

            burst()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            burst()
            torch.cuda.synchronize()
            plain_wall = time.monotonic() - t0
            tag = name if impl == "auto" else f"{name} ({impl})"
            log("profile", f"{tag}: unprofiled "
                           f"{plain_wall * 1e3 / steps:.3f} ms/step")
            ev, wall = device_events(burst)
            _print_profile(f"{tag} decode B={n_streams} pos 500", ev, wall,
                           steps)
        del eng, dp, cache
        torch.cuda.empty_cache()


# the mesh phase: (a) full width at tp 2, (b) a small f32 config at
# dp 2 x tp 2, (c) the kernels at one tp rank's shapes
MESH_TP = 2
# (a): the hidden state the tp-2 bf16 pipeline's prompt prefill ends in,
# held, norm-wise (||h - h_ref|| / ||h_ref||), against a witness: the
# same clips unsharded in float32 (the same bf16-valued weights widened,
# every product and attention on its plain path).  The tp partial sums
# reach each bf16 cast in another order of f32 additions, so the tp-2 run
# may differ from the tp-1 bf16 run by rounding, which 58 bf16 layers on
# random weights amplify to the order of 1e-2; both runs' errors against
# the witness must then be of one size: the tp-2 error within
# MESH_HIDDEN_REL_TOL and within MESH_WITNESS_FACTOR times the tp-1 error.
# Printed beside them, unbounded: the max-abs ratios
# (max |h - h_ref| / max |h_ref|) and tp 2 against tp 1 directly.
MESH_HIDDEN_REL_TOL = 2e-2
MESH_WITNESS_FACTOR = 2.0


def _rel_errs(h, ref) -> tuple[float, float]:
    """(norm-wise, max-abs) relative error of h against ref."""
    d = (h - ref).astype(np.float64)
    r = ref.astype(np.float64)
    return (float(np.linalg.norm(d) / np.linalg.norm(r)),
            float(np.abs(d).max() / np.abs(r).max()))


def _first_diff(a, b) -> int:
    """The first index where two id sequences differ (-1: none)."""
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return -1 if n is None and len(a) == len(b) else (
        min(len(a), len(b)) if n is None else n)


def _check_rank_launches(tag: str, outs, want_fn) -> None:
    """Every rank's launches against want_fn(rank's result)."""
    for o in outs:
        want = want_fn(o)
        if o["launches"] != want:
            raise AssertionError(f"[mesh] {tag} rank {o['rank']}: launches "
                                 f"{o['launches']} != {want}")


def _launch_dict(banded=0, flash=0, enc=0, int4=0) -> dict:
    return {"banded_attention_batched": banded, "flash_decode": flash,
            "flash_bulk_attention_batched": enc, "int4_mm": int4}


def _float_tree(tree):
    """`tree` with every floating-point leaf widened to float32."""
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _mesh_full_width(cfg, params, device: str, seconds: float,
                     n_streams: int) -> dict:
    """(a): B synthetic clips through serving.serve_clips unsharded here
    (on `params`, init_params(seed=0) on `device`), once more unsharded as
    the float32 witness (MESH_HIDDEN_REL_TOL), and at dp 1 x tp 2 in two
    spawned ranks sharing the device over gloo, each rebuilding
    init_params(seed=0) on the device, slicing it and freeing it.  Each
    run serves the clips once (its wall includes its first-call costs: the
    depth the script's time limit allows)."""
    import torch

    from voxtral_tpu_torch import dryrun
    from voxtral_tpu_torch.parallel.mesh import run_ranks
    from voxtral_tpu_torch.runtime.engine import (
        VoxtralEngine,
        adaptive_dec_ring,
    )
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    on_gpu = device == "cuda"
    clips = [make_audio(seconds, seed=400 + i) for i in range(n_streams)]
    kw = dict(dec_kv_ring=adaptive_dec_ring(cfg, len(clips[0])),
              buckets=(64, 16, 4, 1))
    eng = VoxtralEngine(cfg, params, **kw)
    mel = np.stack([padded_clip_mel(eng, c) for c in clips])
    ref = dryrun.run_serving(eng, mel, clips=True)
    del eng
    wcfg = cfg.replace(
        param_dtype="float32", compute_dtype="float32", kv_dtype="float32",
        encoder=dataclasses.replace(cfg.encoder, attn_impl="xla"),
        decoder=dataclasses.replace(cfg.decoder, attn_impl="xla"))
    with plain_kernels():
        weng = VoxtralEngine(wcfg, _float_tree(params), **kw)
        wit = dryrun.run_serving(weng, mel, clips=True)
    del weng
    if on_gpu:
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    outs = run_ranks(dryrun.mesh_serve, MESH_TP,
                     (1, MESH_TP, cfg, 0, mel, kw, device, "gloo", True),
                     device=device, backend="gloo")
    spawn_s = time.monotonic() - t0
    steps = ref["decode_steps"]
    n_enc, n_dec = cfg.encoder.n_layers, cfg.decoder.n_layers
    want = _launch_dict(banded=n_enc, flash=n_dec * steps) if on_gpu \
        else _launch_dict()
    if ref["launches"] != want:
        raise AssertionError(f"[mesh] tp 1: launches {ref['launches']} != "
                             f"{want}")
    _check_rank_launches("tp 2", outs, lambda o: want)
    h0 = outs[0]["prefill_last_hidden"]
    if not all(np.array_equal(o["prefill_last_hidden"], h0) for o in outs):
        raise AssertionError("[mesh] tp 2: the ranks' hidden states differ")
    if not all(o["tokens"] == outs[0]["tokens"] for o in outs):
        raise AssertionError("[mesh] tp 2: the ranks' ids differ")
    href, hw = ref["prefill_last_hidden"], wit["prefill_last_hidden"]
    if not (np.isfinite(h0).all() and np.isfinite(hw).all()
            and h0.shape == href.shape == hw.shape):
        raise AssertionError(f"[mesh] tp 2: hidden state {h0.shape}")
    rel, rel_max = _rel_errs(h0, hw)
    rel1, rel1_max = _rel_errs(href, hw)
    e2e, e2e_max = _rel_errs(h0, href)
    vocab = cfg.decoder.vocab_size
    ids, ids_ref, ids_w = outs[0]["tokens"], ref["tokens"], wit["tokens"]
    if not all(0 <= t < vocab for s_ids in ids for t in s_ids):
        raise AssertionError("[mesh] tp 2: token id out of range")
    agree = [_agreement(a, b) for a, b in zip(ids, ids_ref)]
    first = [_first_diff(a, b) for a, b in zip(ids, ids_ref)]
    agree_w = {tag: [_agreement(a, b) for a, b in zip(got, ids_w)]
               for tag, got in (("tp1", ids_ref), ("tp2", ids))}
    rec = {"tp": MESH_TP, "streams": n_streams, "clip_s": seconds,
           "decode_steps": steps, "hidden_rel_err": rel,
           "hidden_rel_tol": MESH_HIDDEN_REL_TOL,
           "hidden_max_rel_err": rel_max,
           "tp1_hidden_rel_err": rel1, "tp1_hidden_max_rel_err": rel1_max,
           "witness_factor": rel / rel1 if rel1 else float("inf"),
           "witness_factor_tol": MESH_WITNESS_FACTOR,
           "tp2_vs_tp1_hidden_rel_err": e2e,
           "tp2_vs_tp1_hidden_max_rel_err": e2e_max,
           "ids_agree": agree, "first_diff": first,
           "ids_agree_witness": agree_w,
           "tokens": sum(len(t) for t in ids), "spawn_s": spawn_s,
           "launches_per_rank": outs[0]["launches"],
           "launches": {k: sum(o["launches"][k] for o in outs)
                        for k in outs[0]["launches"]}}
    # one cold run a side: its times hold the first-call costs, under
    # their own names (first_run_*), never those of a warm run
    for tag, r in (("tp1", ref), ("tp2", outs[0])):
        rec[f"first_run_encode_ms_{tag}"] = r["encode_s"] * 1e3
        rec[f"first_run_prefill_ms_{tag}"] = r["prefill_s"] * 1e3
        rec[f"first_run_decode_ms_per_step_{tag}"] = (
            r["decode_s"] * 1e3 / max(r["decode_steps"], 1))
    log("mesh", f"(a) full width, dp 1 x tp {MESH_TP} over gloo on one "
                f"card, B={n_streams} x {seconds:.0f} s: prefill last hidden "
                f"state against the f32 witness, norm-wise tp 2 {rel:.3e} "
                f"(tol {MESH_HIDDEN_REL_TOL}), tp 1 {rel1:.3e}, ratio "
                f"{rec['witness_factor']:.3f} (tol {MESH_WITNESS_FACTOR}); "
                f"max-abs tp 2 {rel_max:.3e}, tp 1 {rel1_max:.3e}; tp 2 "
                f"against tp 1 {e2e:.3e} / {e2e_max:.3e}; ids agree "
                f"{[round(a, 3) for a in agree]} with tp 1, first "
                f"difference at {first}, with the witness tp 1 "
                f"{[round(a, 3) for a in agree_w['tp1']]}, tp 2 "
                f"{[round(a, 3) for a in agree_w['tp2']]}; per-rank "
                f"launches {outs[0]['launches']} ({steps} decode steps); "
                f"first runs: encode {rec['first_run_encode_ms_tp1']:.1f} -> "
                f"{rec['first_run_encode_ms_tp2']:.1f} ms, prefill "
                f"{rec['first_run_prefill_ms_tp1']:.1f} -> "
                f"{rec['first_run_prefill_ms_tp2']:.1f} ms, decode "
                f"{rec['first_run_decode_ms_per_step_tp1']:.2f} -> "
                f"{rec['first_run_decode_ms_per_step_tp2']:.2f} ms/step "
                f"(tp 1 -> tp 2)")
    if not rel <= MESH_HIDDEN_REL_TOL:
        raise AssertionError(f"[mesh] tp 2 hidden state rel err {rel} "
                             "against the f32 witness")
    if not rel <= MESH_WITNESS_FACTOR * rel1:
        raise AssertionError(f"[mesh] tp 2 hidden state rel err {rel} > "
                             f"{MESH_WITNESS_FACTOR} x tp 1's {rel1}")
    return rec


def _mesh_small(device: str, seconds: float = 4.0) -> dict:
    """(b): small_config at dp 2 x tp 2 in four spawned ranks over gloo,
    against the same runs unsharded here (init_params(seed=0) on
    `device` in every process): in float32 the streaming
    BatchedTranscriber and a ring-mode StreamPool, ids exactly equal (the
    encoder kernels' f32 walk is the same for a row at any head count);
    then the pool in bf16, its ids' agreement printed."""
    import torch

    from voxtral_tpu_torch import dryrun
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.parallel.mesh import run_ranks
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    on_gpu = device == "cuda"
    dp, tp = 2, MESH_TP
    kw = dict(buckets=(16, 4, 1), enc_kv_ring=128, dec_kv_ring=256)
    pool_kw = dict(dec_kv_ring=256, enc_mode="ring")
    audios = [make_audio(seconds, seed=500 + i) for i in range(2 * dp)]
    rec = {"dp": dp, "tp": tp}
    for tag, cfg in (("f32", small_config("float32")),
                     ("bf16", small_config("bfloat16"))):
        n_enc, n_dec = cfg.encoder.n_layers, cfg.decoder.n_layers
        eng = VoxtralEngine(cfg, init_params(cfg, seed=0, device=device),
                            tokenizer=dryrun._tokenizer(), **kw)
        runs = []
        if tag == "f32":
            mel = np.stack([padded_clip_mel(eng, a) for a in audios])
            ref = dryrun.run_serving(eng, mel)
            outs = run_ranks(dryrun.mesh_serve, dp * tp,
                             (dp, tp, cfg, 0, mel, kw, device, "gloo"),
                             device=device, backend="gloo")
            steps = outs[0]["decode_steps"]
            _check_rank_launches(
                f"{tag} serve", outs, lambda o: _launch_dict(
                    flash=n_dec * o["decode_steps"] * on_gpu,
                    enc=n_enc * o["enc_chunk_calls"] * on_gpu))
            runs.append(("serve", ref["tokens"], outs))
            rec["serve_decode_steps_per_rank"] = steps
        ref = dryrun.run_pool(eng, audios, pool_kw)
        outs = run_ranks(dryrun.mesh_pool, dp * tp,
                         (dp, tp, cfg, 0, audios, kw, pool_kw, device,
                          "gloo"),
                         device=device, backend="gloo")
        _check_rank_launches(
            f"{tag} pool", outs, lambda o: _launch_dict(
                flash=n_dec * o["burst_rows"] * on_gpu,
                enc=n_enc * o["enc_calls"] * on_gpu))
        runs.append(("pool", ref["ids"], outs))
        del eng
        for name, want, outs in runs:
            got = outs[0]["tokens" if name == "serve" else "ids"]
            if not all(o["tokens" if name == "serve" else "ids"] == got
                       for o in outs):
                raise AssertionError(f"[mesh] {tag} {name}: ranks differ")
            agree = [_agreement(a, b) for a, b in zip(got, want)]
            rec[f"{name}_{tag}_agree"] = agree
            rec[f"{name}_{tag}_tokens"] = sum(len(t) for t in got)
            rec[f"{name}_{tag}_launches"] = {
                k: sum(o["launches"][k] for o in outs)
                for k in outs[0]["launches"]}
            log("mesh", f"(b) small_config {tag} dp {dp} x tp {tp}, {name}: "
                        f"{rec[f'{name}_{tag}_tokens']} ids, agree "
                        f"{[round(a, 3) for a in agree]} with the unsharded "
                        f"run; launches {rec[f'{name}_{tag}_launches']}")
            if tag == "f32" and got != want:
                raise AssertionError(f"[mesh] f32 {name}: ids differ from "
                                     f"the unsharded run's ({agree})")
            if not rec[f"{name}_{tag}_tokens"] > 0:
                raise AssertionError(f"[mesh] {tag} {name}: no ids")
        if on_gpu:
            torch.cuda.empty_cache()
    return rec


def _rank_shape_times() -> dict:
    """(c): kernels #1, #4 and #7 at one tp-2 rank's serve shapes against
    their plain versions, then graph-replay times beside the bound and
    SDPA: banded at B=16 T=1696 with 16 heads; flash-decode at B=16 cap
    896 with 16q/4kv in bf16 and fp8; flash-encode at B=16 T=64 with 16
    heads.  Also flash-decode at the two pool shapes of full width that
    the pool phases launch: B=8 cap 896 bf16 (ring mode) and B=32 cap
    1024 fp8 (window mode)."""
    import torch

    from voxtral_tpu_torch.ops.banded_encode import (
        banded_attention_batched,
        banded_attention_plain,
    )
    from voxtral_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_plain,
        flash_decode_splits,
    )
    from voxtral_tpu_torch.ops.flash_encode import (
        flash_bulk_attention_batched,
        flash_encode_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    out = {}
    h_enc, h_dec, kh_dec = 32 // MESH_TP, 32 // MESH_TP, 8 // MESH_TP
    # #1: the bulk encoder's attention at one rank's heads
    t = serve_encoder_len(30.0)
    q, k, v = (_randn(gen, (16, t, h_enc, 64), torch.bfloat16)
               for _ in range(3))
    lo = torch.zeros(16, dtype=torch.int32, device="cuda")
    got = banded_attention_batched(q, k, v, lo, window=750,
                                   out_dtype=torch.float32)
    err = max((got[i] - banded_attention_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], lo[i:i + 1], window=750,
        out_dtype=torch.float32)[0]).abs().max().item() for i in range(16))
    if not err <= BANDED_TOL:
        raise AssertionError(f"[mesh] banded at {h_enc} heads: err {err}")
    tm = _banded_times(q, k, v, lo, 750)
    out["banded"] = {"shape": f"B=16 T={t} H=KH={h_enc}",
                     "max_abs_err": err, **tm}
    del q, k, v, got
    # #4 at one rank's heads, then the two full-width pool shapes
    serve_pos = [500 + 13 * (i - 8) for i in range(16)]
    cases = (("rank_bf16", 16, 896, serve_pos, torch.bfloat16, h_dec, kh_dec),
             ("rank_fp8", 16, 896, serve_pos, torch.float8_e4m3fn, h_dec,
              kh_dec),
             ("pool_ring", 8, 896, [300 + 41 * i for i in range(8)],
              torch.bfloat16, 32, 8),
             ("pool_window", 32, 1024, [200 + 23 * i for i in range(32)],
              torch.float8_e4m3fn, 32, 8))
    for tag, bsz, cap, pos_l, rdt, h, kh in cases:
        kk = _randn(gen, (bsz, 26, kh, cap, 128), rdt)
        vv = _randn(gen, (bsz, 26, kh, cap, 128), rdt)
        qq = _randn(gen, (bsz, h, 128), torch.bfloat16)
        rows = [_randn(gen, (bsz, kh, 128), torch.float32) for _ in range(2)]
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        kw = dict(window=8192, out_dtype=torch.float32)
        k2, v2 = kk.clone(), vv.clone()
        got = flash_decode(qq, kk, vv, 25, pos, *rows, **kw)
        again = flash_decode(qq, k2, v2, 25, pos, *rows, **kw)
        want = flash_decode_plain(qq, kk.clone(), vv.clone(), 25, pos,
                                  *rows, **kw)
        err = (got - want).abs().max().item()
        if not (err <= FLASH_TOL and torch.equal(got, again)
                and torch.equal(kk.view(torch.uint8), k2.view(torch.uint8))):
            raise AssertionError(f"[mesh] flash-decode {tag}: err {err}")
        del kk, vv, k2, v2
        tm = _flash_times(gen, bsz, cap, pos_l, rdt, 8192, h=h, kh=kh)
        out[f"flash_decode_{tag}"] = {
            "shape": f"B={bsz} cap={cap} {h}q/{kh}kv {str(rdt)[6:]}",
            "splits": flash_decode_splits(cap, bsz, kh), "max_abs_err": err,
            **tm}
    # #7 at one rank's heads
    cap, t = 1024, 64
    kr, vr = (_randn(gen, (16, h_enc, cap, 64), torch.bfloat16)
              for _ in range(2))
    q = _randn(gen, (16, t, h_enc, 64), torch.bfloat16)
    pos = torch.tensor(_stream_positions((2000, 5000), 16), dtype=torch.int32,
                       device="cuda")
    kw = dict(window=750, out_dtype=torch.float32)
    got, walk = (flash_bulk_attention_batched(q, kr, vr, pos, split=sp, **kw)
                 for sp in (True, False))
    err = (got - flash_encode_plain(q, kr, vr, pos, **kw)).abs().max().item()
    if not (err <= FLASH_ENC_TOL and torch.equal(got, walk)):
        raise AssertionError(f"[mesh] flash-encode at {h_enc} heads: err "
                             f"{err}")

    def kern():
        flash_bulk_attention_batched(q, kr, vr, pos, window=750)

    valid = _enc_mask(pos, t, cap, 750)
    n_slots = int(valid.any(dim=1).sum())
    out["flash_encode"] = {
        "shape": f"B=16 T={t} H=KH={h_enc} cap {cap}", "max_abs_err": err,
        "split_mappings_bitwise_equal": True,
        "ms": cuda_ms(kern, 50), "device_ms": graph_ms(kern, 20),
        "plain_ms": cuda_ms(lambda: flash_encode_plain(q, kr, vr, pos,
                                                       window=750), 5),
        "library_ms": sdpa_ms(q.transpose(1, 2).contiguous(), kr, vr,
                              valid[:, None]),
        **bound(2 * n_slots * h_enc * 64 * 2 + 2 * q.numel() * 2,
                4 * 64 * h_enc * int(valid.sum()))}
    for fn in (banded_attention_batched, flash_decode,
               flash_bulk_attention_batched):
        fn.launches = 0
    for name, r in out.items():
        log("mesh", f"(c) {name} {r['shape']}: max_abs_err "
                    f"{r['max_abs_err']:.3e}; device {r['device_ms']:.4f} ms "
                    f"(events {r['ms']:.4f}), plain {r['plain_ms']:.4f}, "
                    f"SDPA {r['library_ms'] or float('nan'):.4f}; bound "
                    f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    return out


def phase_mesh(cfg, params, device: str = "cuda", seconds: float = 10.0,
               n_streams: int = 4) -> dict:
    """Multi-device serving on one card: ranks spawned by
    parallel/mesh.py run_ranks share it over gloo (NCCL takes one card per
    rank).  (a) `cfg` with `params` (init_params(seed=0) on `device`) at
    dp 1 x tp 2 against the same clips unsharded: exact per-rank launch
    counts (banded once per layer of the bulk encode at 16 heads,
    flash-decode once per layer per step at 16q/4kv), the prefill's last
    hidden state against an f32 witness (MESH_HIDDEN_REL_TOL,
    MESH_WITNESS_FACTOR), the ids' agreement printed;
    (b) small_config at dp 2 x tp 2 (_mesh_small); (c) on the card, the
    kernels at one rank's shapes (_rank_shape_times).  main() runs it at
    full width on the card; a tiny config rehearses it on the CPU (no
    kernel launches there, none expected)."""
    out = {"full_width": _mesh_full_width(cfg, params, device, seconds,
                                          n_streams),
           "small": _mesh_small(device)}
    if device == "cuda":
        out["rank_shapes"] = _rank_shape_times()
    return out


def phase_mel_device(device: str = "cuda", n_clips: int = 16,
                     seconds: float = 30.0) -> dict:
    """audio/mel_device.py on `device` against the host mel
    (audio/mel.py) on B clips: within 3e-4, and both times (the host's
    wall for all clips one by one, the device's CUDA-event time of one
    batched call)."""
    import torch

    from voxtral_tpu_torch.audio.mel import mel_spectrogram
    from voxtral_tpu_torch.audio.mel_device import mel_spectrogram_device

    clips = np.stack([make_audio(seconds, seed=600 + i)
                      for i in range(n_clips)])
    t0 = time.monotonic()
    ref = np.stack([mel_spectrogram(c) for c in clips])
    host_ms = (time.monotonic() - t0) * 1e3
    x = torch.from_numpy(clips).to(device)
    got = mel_spectrogram_device(x)
    err = float(np.abs(got.cpu().numpy() - ref).max())
    rec = {"clips": n_clips, "clip_s": seconds, "frames": ref.shape[1],
           "max_abs_err": err, "tol": 3e-4, "host_ms": host_ms}
    if device == "cuda":
        rec["device_ms"] = cuda_ms(lambda: mel_spectrogram_device(x), 10)
    log("mel_device", f"B={n_clips} x {seconds:.0f} s ({ref.shape[1]} "
                      f"frames): max_abs_err {err:.3e} against the host mel "
                      f"(tol 3e-4); host {host_ms:.1f} ms, device "
                      f"{rec.get('device_ms', float('nan')):.3f} ms")
    if not (got.shape == ref.shape and err <= 3e-4):
        raise AssertionError(f"[mel_device] err {err}, shape "
                             f"{tuple(got.shape)}")
    return rec


# the bench phase (phase_bench): the port's bench at the serve cell's
# depth, every side phase on, the load rows at 4 ticks a round; then its
# int4 rung alone; then bulk-mode run_once at B=4 held to serve_clips
BENCH_ENV = {"BENCH_STREAMS": "16", "BENCH_SECONDS": "30", "BENCH_TRIES": "1",
             "BENCH_LOAD_TICKS": "4"}
BENCH_INT4_ENV = {**BENCH_ENV, "BENCH_MODE": "int4", "BENCH_LAT": "0",
                  "BENCH_LOAD": "0"}
BENCH_BULK_STREAMS = 4
# the kernels each bench run must launch: flash-decode and flash-encode in
# bf16 (its "inc" encode, every decode), the int4 product in int4
BENCH_KERNELS = {"bf16": ("flash_decode", "flash_bulk_attention_batched"),
                 "int4": ("int4_mm",)}


def _bench_faults(res: dict) -> list[str]:
    """What makes a bench result a failure: a value of -1 (an OOM in a
    side measurement, or a latency run that decoded nothing), an `_oom`
    key, a headline value <= 0."""
    extra = res["extra"]
    bad = [k for k, v in extra.items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)
           and v == -1]
    bad += [k for k in extra if k.endswith("_oom")]
    if not res["value"] > 0:
        bad.append(f"value {res['value']}")
    return bad


def phase_bench(cfg, params, device: str, env: dict = BENCH_ENV,
                int4_env: dict = BENCH_INT4_ENV,
                bulk_streams: int = BENCH_BULK_STREAMS) -> dict:
    """The port's bench (voxtral_tpu_torch/bench.py) in this process on
    `params`: `env` (bf16, every side phase), then `int4_env`; each result
    printed on a line of its own, and failed on a -1 value, an `_oom` key,
    a value <= 0 or no launch of its kernels (BENCH_KERNELS).  Then
    run_once in "bulk" mode at `bulk_streams` streams of the env's clip:
    its ids bit-equal to serving.serve_clips on the same mel and engine,
    and "inc" mode's ids agreeing with them on at least STREAM_AGREE_MIN
    of positions (the two differ in the softmax's summing order)."""
    import dataclasses

    from voxtral_tpu_torch import bench
    from voxtral_tpu_torch.parallel.serving import serve_clips
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel
    from voxtral_tpu_torch.tools import synthetic_audio

    def blog(msg):
        log("bench", msg.strip())

    out, launches = {}, {}
    for tag, e in (("bf16", env), ("int4", int4_env)):
        t0 = time.monotonic()
        res = bench.run(bench.settings(e), device, cfg, params, log=blog)
        print(json.dumps(res), flush=True)
        got = res["extra"]["kernel_launches"]
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        faults = _bench_faults(res)
        faults += [f"no {k} launch" for k in BENCH_KERNELS[tag]
                   if not got[k] > 0]
        if faults:
            raise AssertionError(f"[bench] {tag}: {faults}")
        out[tag] = {"metric": res["metric"], "value": res["value"],
                    "s": time.monotonic() - t0}
        log("bench", f"{tag}: {res['metric']} = {res['value']} "
                     f"({out[tag]['s']:.1f} s), launches {got}")

    s = bench.settings({**env, "BENCH_STREAMS": str(bulk_streams),
                        "BENCH_ENC": "bulk",
                        "BENCH_ENC_GROUP": str(bulk_streams)})
    engine, _ = bench.build_engine(s, device, cfg, params)
    mel = padded_clip_mel(engine, synthetic_audio(s.seconds))
    bench.reset_launches()
    bulk = bench.run_once(engine, s, mel, "bulk", log=blog)
    served, _ = serve_clips(engine, np.stack([mel] * bulk_streams))
    inc = bench.run_once(engine, dataclasses.replace(s, enc="inc"), mel,
                         "inc", log=blog)
    for k, v in bench.kernel_launches().items():
        launches[k] = launches.get(k, 0) + v
    for i, (a, b) in enumerate(zip(bulk["tokens"], served)):
        if a != b:
            raise AssertionError(
                f"[bench] bulk stream {i}: ids differ from serve_clips at "
                f"position {_first_diff(a, b)} (lengths {len(a)}, {len(b)})")
    if len(bulk["tokens"]) != len(served):
        raise AssertionError("[bench] bulk and serve_clips stream counts")
    agree = [_agreement(a, b) for a, b in zip(inc["tokens"], bulk["tokens"])]
    log("bench", f"bulk B={bulk_streams} x {s.seconds:g} s: ids bit-equal to "
                 f"serve_clips ({sum(map(len, served))} ids); inc against "
                 f"bulk agree {min(agree):.3f} (min {STREAM_AGREE_MIN})")
    if not min(agree) >= STREAM_AGREE_MIN:
        raise AssertionError(f"[bench] inc against bulk agree {agree}")
    out.update({"bulk_equal_serve_clips": True, "inc_agree_bulk": agree,
                "bulk_steps": bulk["steps"], "launches": launches})
    return out


def _f32_kernels(device: str = "cuda") -> dict:
    """#1 and #7 on float32 queries against their plain versions on the
    card: at the f32 path's shapes (small_config's bulk encode of 96 mel
    frames, its 24-row chunks over a 128-slot ring) and at full width
    (H = 32, window 750: a 30 s clip and a 777-row one hiding 300 leading
    keys; the 2 s chunk of 100 rows over the 2048-slot ring, f32 and bf16
    rings, past its wrap), timed at full width with the f32 bound."""
    import torch

    from voxtral_tpu_torch.ops.banded_encode import (
        banded_attention_batched,
        banded_attention_plain,
    )
    from voxtral_tpu_torch.ops.flash_encode import (
        flash_bulk_attention_batched,
        flash_encode_plain,
    )

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    f32, d = torch.float32, 64
    out = {"banded": {"max_abs_err": 0.0}, "flash_encode": {"max_abs_err": 0.0}}

    def check(name, got, want, shape):
        err = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= F32_ATTN_TOL
        log("f32_auto", f"{name} f32 {shape}: max_abs_err {err:.3e} (tol "
                        f"{F32_ATTN_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[f32_auto] {name} {shape} err {err}")
        rec = out[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    for bsz, t, h, window, lo in ((2, 48, 4, 64, [0, 0]),
                                  (2, 777, 32, 750, [0, 300]),
                                  (1, 1500, 32, 750, [0])):
        q, k, v = (_randn(gen, (bsz, t, h, d), f32, device) for _ in range(3))
        kv_lo = torch.tensor(lo, dtype=torch.int32, device=device)
        kw = dict(window=window, out_dtype=f32)
        check("banded", banded_attention_batched(q, k, v, kv_lo, **kw),
              banded_attention_plain(q, k, v, kv_lo, **kw),
              f"B={bsz} T={t} H={h} kv_lo={lo}")
        if t == 1500:
            rec = out["banded"]
            rec["ms"] = cuda_ms(lambda: banded_attention_batched(
                q, k, v, kv_lo, **kw), 10)
            rec["plain_ms"] = cuda_ms(lambda: banded_attention_plain(
                q, k, v, kv_lo, **kw), 3)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            rec["library_ms"] = sdpa_ms(qt, kt, vt, _band_mask(t, window), 5)
            del qt, kt, vt
            rr = np.arange(t)
            pairs = int((rr - np.maximum(rr - window + 1, 0) + 1).sum())
            rec.update(bound(4 * q.numel() * 4, 4 * d * h * pairs, F32_FLOPS))
        del q, k, v
    for bsz, t, h, cap, window, pos_l, rdt in (
            (2, 24, 4, 128, 64, [0, 24], f32),
            (2, 24, 4, 128, 64, [100, 200], f32),
            (1, 100, 32, 2048, 750, [2400], f32),
            (1, 100, 32, 2048, 750, [2400], torch.bfloat16)):
        q = _randn(gen, (bsz, t, h, d), f32, device)
        kr, vr = (_randn(gen, (bsz, h, cap, d), f32, device).to(rdt)
                  for _ in range(2))
        pos = torch.tensor(pos_l, dtype=torch.int32, device=device)
        kw = dict(window=window, out_dtype=f32)
        check("flash_encode",
              flash_bulk_attention_batched(q, kr, vr, pos, **kw),
              flash_encode_plain(q, kr, vr, pos, **kw),
              f"B={bsz} T={t} H={h} cap={cap} pos={pos_l} "
              f"ring {str(rdt)[6:]}")
        if cap == 2048 and rdt == f32:
            rec = out["flash_encode"]
            rec["ms"] = cuda_ms(lambda: flash_bulk_attention_batched(
                q, kr, vr, pos, **kw), 20)
            rec["plain_ms"] = cuda_ms(lambda: flash_encode_plain(
                q, kr, vr, pos, **kw), 5)
            valid = _enc_mask(pos, t, cap, window)
            rec["library_ms"] = sdpa_ms(q.transpose(1, 2).contiguous(), kr,
                                        vr, valid[:, None], 10)
            n_slots = int(valid.any(dim=1).sum())
            rec.update(bound(2 * n_slots * h * d * 4 + 2 * q.numel() * 4,
                             4 * d * h * int(valid.sum()), F32_FLOPS))
        del q, kr, vr
    for name, rec in out.items():
        log("f32_auto", f"{name} f32 at full width: kernel {rec['ms']:.4f} "
                        f"ms, plain {rec['plain_ms']:.4f} ms, SDPA "
                        f"{rec['library_ms']:.4f} ms per call; bound "
                        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    banded_attention_batched.launches = 0
    flash_bulk_attention_batched.launches = 0
    return out


def f32_encoder_auto(device: str = "cuda") -> dict:
    """The f32 encoder path on `device`: small_config in float32 under
    attn_impl "auto" runs the streaming encoder (two chunks of 24 rows)
    and the bulk encoder on both encoder kernels' f32 instantiation
    (flash-encode once per layer per chunk, banded once per layer, as in
    bf16) and equals the plain path ("xla") within F32_ENCODER_REL_TOL;
    on the card the kernels are also held against their plain versions
    directly (_f32_kernels)."""
    import torch

    from voxtral_tpu_torch.models import bulk_encode as bulk_mod
    from voxtral_tpu_torch.models import encoder as enc_mod
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.ops.banded_encode import banded_attention_batched
    from voxtral_tpu_torch.ops.flash_encode import (
        flash_bulk_attention_batched,
    )

    kernels = (flash_bulk_attention_batched, banded_attention_batched)
    gen = torch.Generator().manual_seed(7)
    mel = torch.randn((2, 96, 128), generator=gen).to(device)
    x = torch.randn((2, 48, 256), generator=gen).to(device)

    def run(cfg, impl):
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                      attn_impl=impl))
        params = init_params(cfg, seed=0, device=device)
        cache = enc_mod.EncKVCache.create(cfg.encoder, cfg.enc_kvdtype, 128,
                                          batch=2, device=device)
        for f in kernels:
            f.launches = 0
        ys = [enc_mod.encode_chunk(params["encoder"], cfg, x[:, i: i + 24],
                                   cache, i)[0] for i in (0, 24)]
        rows = bulk_mod.bulk_encode_clip(params["encoder"], params["adapter"],
                                         cfg, mel)
        if device == "cuda":
            torch.cuda.synchronize()
        return torch.cat(ys, dim=1), rows, [f.launches for f in kernels]

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    f32 = small_config("float32")
    y, rows, launches = run(f32, "auto")
    y_x, rows_x, _ = run(f32, "xla")
    n = f32.encoder.n_layers
    _, _, bf16_launches = run(small_config("bfloat16"), "auto")
    for f in kernels:
        f.launches = 0
    rec = {"f32_launches": launches, "bf16_launches": bf16_launches,
           "f32_rel_err_stream": rel(y, y_x),
           "f32_rel_err_bulk": rel(rows, rows_x)}
    log("f32_auto", f"small_config f32 under attn_impl auto against the "
                    f"plain path: streaming {rec['f32_rel_err_stream']:.3e}, "
                    f"bulk {rec['f32_rel_err_bulk']:.3e} norm-wise (tol "
                    f"{F32_ENCODER_REL_TOL}); launches (flash-encode, "
                    f"banded) f32 {launches}, bf16 {bf16_launches}")
    on_gpu = device == "cuda"
    want = [2 * n * on_gpu, n * on_gpu]
    if not (rec["f32_rel_err_stream"] <= F32_ENCODER_REL_TOL
            and rec["f32_rel_err_bulk"] <= F32_ENCODER_REL_TOL
            and launches == want and bf16_launches == want):
        raise AssertionError(f"[f32_auto] {rec}")
    if on_gpu:
        rec["kernels"] = _f32_kernels(device)
    return rec


# the cut-depth checkpoint of the ckpt phase: full widths, 4 encoder and 4
# decoder layers (1.0 B parameters, 2.0 GB in bf16)
CKPT_LAYERS = (4, 4)


def ckpt_config(layers=CKPT_LAYERS):
    """full_config() at `layers` (encoder, decoder) depth, or at full depth
    when `layers` is None."""
    from voxtral_tpu_torch.config import full_config

    cfg = full_config()
    if layers is None:
        return cfg
    return cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, n_layers=layers[0]),
        decoder=dataclasses.replace(cfg.decoder, n_layers=layers[1]))


def _ckpt_counters() -> dict:
    """The ckpt phase's kernels (flash-encode, flash-decode, banded, int4)
    by name."""
    return {f.__name__: f for f in _pool_counters()[:4]}


def _counted_run(fn):
    """fn()'s result and the kernel launches it made (counters set to 0
    before, read after) and its wall in seconds."""
    counters = _ckpt_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.monotonic()
    out = fn()
    wall = time.monotonic() - t0
    return out, {k: f.launches for k, f in counters.items()}, wall


def _captured(fn):
    """fn()'s result, stdout and stderr."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn()
    return res, out.getvalue(), err.getvalue()


CKPT_STEPS = ("offline", "stream", "int4", "fidelity", "golden", "int4_ab")


def phase_ckpt(cfg, device: str = "cuda", tag: str = "ckpt",
               steps=CKPT_STEPS, clip_seconds: float = 11.0,
               fidelity_seconds: float = 7.0) -> dict:
    """The checkpoint path through the tools a user runs, on `device`:
    make_fake_ckpt writes a synthetic checkpoint of `cfg` (seed 0) into a
    temporary directory (deleted at the end; the phase fails when the disk
    lacks the room), then, on one synthetic clip:
      offline  the CLI (-d, -i, --bulk-encode): banded once per encoder
               layer, flash-decode
      stream   the CLI (-d, -i): flash-encode, flash-decode, no banded
      int4     the CLI (-d, -i, --int4): the int4 kernel, flash-encode
      fidelity fidelity_check against the independent f32 oracle: PASS
               under the JAX tool's gates; flash-decode once per decoder
               layer per step
      golden   make_golden record, then check: equal ids
      int4_ab  int8_ab with AB_BITS=4: the differing positions
    Each CLI run's load seconds, weights GiB, x realtime and metric lines
    are parsed (tools/benchmark.py's regexes).  Every kernel of the path
    (banded, flash-decode, flash-encode, int4) must launch.  main() runs it
    on the card at CKPT_LAYERS; a tiny config rehearses it on the CPU, with
    the plain functions counted as the kernels."""
    import shutil
    import tempfile

    import torch

    from voxtral_tpu_torch.io.wav import write_wav
    from voxtral_tpu_torch.tools import (
        benchmark,
        fidelity_check,
        int8_ab,
        make_fake_ckpt,
        make_golden,
    )

    specs = make_fake_ckpt.tensor_specs(cfg)
    need = make_fake_ckpt.checkpoint_bytes(specs)
    n_params = sum(int(np.prod(shape)) for _, shape, _ in specs)
    root = tempfile.mkdtemp(prefix="voxtral_ckpt_")
    rec = {"encoder_layers": cfg.encoder.n_layers,
           "decoder_layers": cfg.decoder.n_layers, "params": n_params,
           "checkpoint_bytes": need}
    try:
        free = shutil.disk_usage(root).free
        rec["disk_free_bytes"] = free
        log(tag, f"checkpoint of {cfg.encoder.n_layers} + "
                 f"{cfg.decoder.n_layers} layers at full width: "
                 f"{n_params / 1e9:.3f} B params, {need / 1e9:.2f} GB; "
                 f"{free / 1e9:.1f} GB free under {root}")
        if free < need + (1 << 30):
            raise AssertionError(f"[{tag}] {free / 1e9:.1f} GB free under "
                                 f"{root}, the checkpoint needs "
                                 f"{need / 1e9:.2f} GB and 1 GiB more")
        model = os.path.join(root, "model")
        t0 = time.monotonic()
        _captured(lambda: make_fake_ckpt.main([model, "0"], cfg=cfg))
        rec["write_s"] = time.monotonic() - t0
        wav = os.path.join(root, "clip.wav")
        write_wav(wav, make_audio(clip_seconds, seed=700))
        log(tag, f"make_fake_ckpt wrote {model} in {rec['write_s']:.1f} s; "
                 f"{clip_seconds:.0f} s clip")
        base = ["-d", model, "-i", wav, "--device", device]
        launches = {}
        for name, extra in (("offline", ["--bulk-encode"]), ("stream", []),
                            ("int4", ["--int4"])):
            if name not in steps:
                continue
            (rc, err), n, wall = _counted_run(
                lambda: benchmark.run_cli(base + extra, cfg))
            m = benchmark.parse_metrics(err)
            load = re.search(r"Model loaded in ([0-9.]+)s", err)
            gib = re.search(r"Device memory: ([0-9.]+) GiB", err)
            if rc != 0 or m is None or not load or not gib:
                raise AssertionError(f"[{tag}] CLI {name}: rc {rc}\n"
                                     f"{err[-3000:]}")
            proc_s = (m["encoder_ms"] + m["decoder_ms"]) / 1e3
            run = {"rc": rc, "wall_s": wall, "load_s": float(load.group(1)),
                   "weights_gib": float(gib.group(1)),
                   "x_realtime": m["audio_sec"] / proc_s, "launches": n,
                   **m, "lines": [ln for ln in err.splitlines()
                                  if ln.startswith(("Audio:", "Encoder:",
                                                    "Decoder:", "Offline",
                                                    "Device memory:",
                                                    "Model loaded"))]}
            rec[f"cli_{name}"] = run
            launches[f"cli_{name}"] = n
            log(tag, f"CLI {' '.join(extra) or '(streaming)'}: load "
                     f"{run['load_s']:.1f} s, {run['weights_gib']:.2f} GiB "
                     f"weights, {run['x_realtime']:.2f}x realtime, wall "
                     f"{wall:.1f} s; launches {n}; "
                     + " | ".join(run["lines"]))
        nd, ne = cfg.decoder.n_layers, cfg.encoder.n_layers
        if "fidelity" in steps:
            (res, _, ferr), n, wall = _counted_run(lambda: _captured(
                lambda: fidelity_check.fidelity(model, fidelity_seconds,
                                                torch.device(device), cfg)))
            res["flips"] = [list(f) for f in res["flips"]]
            rec["fidelity"] = {**res, "verdict": fidelity_check.verdict(res),
                               "wall_s": wall, "launches": n}
            launches["fidelity"] = n
            log(tag, f"{fidelity_check.verdict(res)}; adapter rel err "
                     f"{res['adapter_rel_err']:.4f} (tol "
                     f"{fidelity_check.ADAPTER_REL_TOL}); flips "
                     f"(step, engine, oracle, gap) {res['flips']}; load "
                     f"{res['load_s']:.1f} s, {res['weights_gib']:.2f} GiB; "
                     f"{wall:.1f} s; launches {n}")
            if not res["ok"]:
                raise AssertionError(f"[{tag}] {fidelity_check.verdict(res)}"
                                     f"\n{ferr[-3000:]}")
            if (n["flash_decode"] != nd * res["steps"]
                    or n["flash_bulk_attention_batched"] <= 0):
                raise AssertionError(f"[{tag}] fidelity launches {n}")
        if "golden" in steps:
            fixdir = os.path.join(root, "golden")
            common = ["-d", model, "--fixtures", fixdir, "--device", device]
            ((rc1, out1, _), (rc2, out2, _)), n, wall = _counted_run(lambda: (
                _captured(lambda: make_golden.main(["record"] + common + [wav],
                                                   cfg=cfg)),
                _captured(lambda: make_golden.main(
                    ["check"] + common + ["--wav-dir", root], cfg=cfg))))
            ok_line = [ln for ln in out2.splitlines()
                       if "clip.torch_engine.json" in ln]
            rec["golden"] = {"record": out1.strip(), "check": ok_line,
                             "rc": [rc1, rc2], "wall_s": wall,
                             "launches": n}
            launches["golden"] = n
            log(tag, f"make_golden record: {out1.strip()}; check: "
                     f"{ok_line} (rc {rc1}, {rc2}), {wall:.1f} s; launches "
                     f"{n}")
            if rc1 or rc2 or not ok_line or not ok_line[0].startswith("OK"):
                raise AssertionError(f"[{tag}] make_golden: {out1}{out2}")
        if "int4_ab" in steps:
            os.environ["AB_BITS"] = "4"
            try:
                (rc, out, _), n, wall = _counted_run(lambda: _captured(
                    lambda: int8_ab.main([model, wav, "--device", device],
                                         cfg=cfg)))
            finally:
                del os.environ["AB_BITS"]
            lines = out.strip().splitlines()
            rec["int4_ab"] = {"lines": lines, "wall_s": wall, "launches": n}
            launches["int4_ab"] = n
            log(tag, f"int8_ab AB_BITS=4: {' | '.join(lines)}; {wall:.1f} "
                     f"s; launches {n}")
            if rc or not lines or not lines[0].startswith("QUANT-AB: "):
                raise AssertionError(f"[{tag}] int8_ab: rc {rc} {out}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {k: sum(n[k] for n in launches.values())
             for k in _ckpt_counters()}
    rec["launches"] = total
    log(tag, f"launches in the phase {total}")
    want = {"banded_attention_batched": "offline",
            "flash_bulk_attention_batched": "stream",
            "flash_decode": "offline", "int4_mm": "int4"}
    idle = [k for k, step in want.items() if step in steps and total[k] <= 0]
    if idle:
        raise AssertionError(f"[{tag}] no launch of {idle}")
    if "offline" in steps and launches["cli_offline"][
            "banded_attention_batched"] != ne:
        raise AssertionError(f"[{tag}] offline banded launches "
                             f"{launches['cli_offline']}")
    if "stream" in steps and launches["cli_stream"][
            "banded_attention_batched"]:
        raise AssertionError(f"[{tag}] streaming launched banded")
    return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# the phases `--only` runs by name (after device and build), in this order
ONLY_PHASES = ("banded", "flash", "flash_enc", "f32_auto", "int4", "rows",
               "graphs", "jacobi", "pool_ring", "pool_window", "mesh",
               "mel_device", "bench", "ckpt", "ckpt_full")


def run_only(names) -> dict:
    """The named phases alone (a quick check of some phases on the card;
    the full run is what proves the port)."""
    from voxtral_tpu_torch.config import full_config

    out, cfg, params = {}, full_config(), None
    for name in ONLY_PHASES:
        if name not in names:
            continue
        if name in ("graphs", "jacobi", "pool_ring", "pool_window", "mesh",
                    "bench") and params is None:
            params = make_params(cfg, "cuda")
        if name == "graphs":
            out[name] = phase_graphs(cfg, params, "cuda")
        elif name == "mesh":
            out[name] = phase_mesh(cfg, params, "cuda")
        elif name == "jacobi":
            out[name] = phase_jacobi(cfg, params, "cuda")
        elif name == "bench":
            out[name] = phase_bench(cfg, params, "cuda")
        elif name == "pool_ring":
            out[name] = phase_pool(cfg, params, "cuda", **POOL_RING)
        elif name == "pool_window":
            out[name] = phase_pool(cfg, params, "cuda", **POOL_WINDOW,
                                   ref_ids=out.get("pool_ring", {}).get(
                                       "slot0_ids"))
        elif name == "f32_auto":
            out[name] = f32_encoder_auto("cuda")
        elif name == "ckpt":
            out[name] = phase_ckpt(ckpt_config(), "cuda")
        elif name == "ckpt_full":
            # the full-depth checkpoint (8.9 GB): the CLI's load and the
            # fidelity check only
            out[name] = phase_ckpt(ckpt_config(None), "cuda", tag=name,
                                   steps=("offline", "fidelity"))
        else:
            out[name] = globals()[f"phase_{name}"]()
    for rec in out.values():
        rec.pop("slot0_ids", None)
    return out


def main(argv: list[str]) -> int:
    import torch

    if not (argv in ([], ["--profile"])
            or (argv[:1] == ["--int4"] and len(argv) <= 2)
            or (argv[:1] == ["--only"] and len(argv) == 2
                and set(argv[1].split(",")) <= set(ONLY_PHASES))):
        raise SystemExit(f"usage: {sys.argv[0]} [--profile | --int4 [ROOT] "
                         f"| --only PHASE[,PHASE..] of {ONLY_PHASES}]")
    if argv[1:2] and argv[0] == "--int4":
        # the package of another checkout (an A/B of two trees in one call)
        sys.path.insert(0, argv[1])
    t_start = time.monotonic()
    smi = phase_device()
    log("device", f"nvidia-smi: {smi}")
    phase_build()
    if argv[:1] == ["--int4"]:
        import voxtral_tpu_torch

        log("device", f"package {voxtral_tpu_torch.__file__}")
        print(json.dumps({"int4": phase_int4(), "rows": phase_rows(),
                          "total_s": time.monotonic() - t_start}))
        return 0
    if argv[:1] == ["--only"]:
        print(json.dumps(run_only(argv[1].split(","))))
        return 0
    if argv == ["--profile"]:
        from voxtral_tpu_torch.config import full_config

        cfg = full_config()
        params = make_params(cfg, "cuda")
        phase_profile(cfg, params)
        profile_streaming(cfg, params)
        return 0
    phase_s = {}
    from voxtral_tpu_torch.ops import graphs

    graphs.reset_stats()

    def timed(name, fn, *args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        phase_s[name] = time.monotonic() - t0
        log("time", f"{name} {phase_s[name]:.1f} s")
        return out

    banded = timed("banded", phase_banded)
    flash = timed("flash", phase_flash)
    flash_enc = timed("flash_enc", phase_flash_enc)
    f32_auto = timed("f32_auto", f32_encoder_auto, "cuda")
    from voxtral_tpu_torch.config import full_config

    int4 = timed("int4", phase_int4)
    rows = timed("rows", phase_rows)
    cfg = full_config()
    params = timed("params", make_params, cfg, "cuda")
    sl = timed("slice", phase_slice, cfg, params, "cuda", (4.0, 11.0, 30.0))
    # bench.py's serving shape: decoder ring 896, bursts (64, 16, 4, 1)
    sv = timed("serve", phase_serve, cfg, params, "cuda", n_streams=16,
               seconds=30.0, dec_ring=896)
    served = sv["launches"]
    gr = timed("graphs", phase_graphs, cfg, params, "cuda")
    graphed = gr["launches"]
    st = timed("stream", phase_stream, cfg, params, "cuda")
    bst = timed("bstream", phase_bstream, cfg, params, "cuda")
    streamed = {k: st["launches"][k] + bst["launches"][k]
                for k in st["launches"]}
    jac = timed("jacobi", phase_jacobi, cfg, params, "cuda")
    pr = timed("pool_ring", phase_pool, cfg, params, "cuda", **POOL_RING)
    pw = timed("pool_window", phase_pool, cfg, params, "cuda", **POOL_WINDOW,
               ref_ids=pr.pop("slot0_ids"))
    pw.pop("slot0_ids")
    ms = timed("mesh", phase_mesh, cfg, params, "cuda")
    mel_dev = timed("mel_device", phase_mel_device, "cuda")
    bn = timed("bench", phase_bench, cfg, params, "cuda")
    benched = bn["launches"]
    del params
    torch.cuda.empty_cache()
    ck = timed("ckpt", phase_ckpt, ckpt_config(), "cuda")
    ckpt = ck["launches"]
    # the mesh path's launches: every rank's, (a) and (b)
    fw, small, shapes = ms["full_width"], ms["small"], ms["rank_shapes"]
    meshed = {k: fw["launches"][k] + sum(
        small[f"{run}_launches"][k]
        for run in ("serve_f32", "pool_f32", "pool_bf16"))
        for k in fw["launches"]}

    def rank_keys(rec, tag):
        return {f"{k}_{tag}": v for k, v in rec.items()}

    # the f32 path (f32_auto): launches, and the f32 instantiations' checks
    f32_banded, f32_enc = (
        {"launches_f32": n, **{f"f32_{k}": v
                               for k, v in f32_auto["kernels"][name].items()}}
        for name, n in (("banded", f32_auto["f32_launches"][1]),
                        ("flash_encode", f32_auto["f32_launches"][0])))

    kernels = [
        {"name": "banded_attention", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/banded_attention.cu",
         "replaces": "voxtral_tpu/ops/banded_encode.py:56",
         "launches": (sl["launches"][0] + served["banded_attention_batched"]
                      + graphed["banded_attention_batched"]
                      + jac["launches_banded"]
                      + pw["launches"]["banded_attention_batched"]
                      + meshed["banded_attention_batched"]
                      + ckpt["banded_attention_batched"]
                      + f32_banded["launches_f32"]
                      + benched["banded_attention_batched"]),
         "launches_bench": benched["banded_attention_batched"],
         "launches_pool_window": pw["launches"]["banded_attention_batched"],
         "launches_mesh": meshed["banded_attention_batched"],
         "launches_ckpt": ckpt["banded_attention_batched"],
         **banded, **rank_keys(shapes["banded"], "tp2_rank"), **f32_banded},
        {"name": "flash_decode", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/flash_decode.cu",
         "replaces": "voxtral_tpu/ops/flash_decode.py:232",
         "launches": (sl["launches"][1] + served["flash_decode"]
                      + graphed["flash_decode"]
                      + streamed["flash_decode"] + jac["launches_flash_decode"]
                      + pr["launches"]["flash_decode"]
                      + pw["launches"]["flash_decode"]
                      + meshed["flash_decode"] + ckpt["flash_decode"]
                      + benched["flash_decode"]),
         "launches_bench": benched["flash_decode"],
         "launches_by_path": {
             "slice": sl["launches"][1],
             **{f"serve_{r['rung']}": r["launches"]["flash_decode"]
                for r in sv["rungs"]},
             "graphs": graphed["flash_decode"],
             "stream": st["launches"]["flash_decode"],
             "bstream": bst["launches"]["flash_decode"],
             "jacobi": jac["launches_flash_decode"],
             "pool_ring": pr["launches"]["flash_decode"],
             "pool_window": pw["launches"]["flash_decode"],
             "mesh": meshed["flash_decode"],
             "ckpt": ckpt["flash_decode"],
             "bench": benched["flash_decode"]}, **flash,
         **{k2: v for tag in ("rank_bf16", "rank_fp8", "pool_ring",
                              "pool_window")
            for k2, v in rank_keys(shapes[f"flash_decode_{tag}"],
                                   tag).items()}},
        {"name": "flash_encode", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/flash_encode.cu",
         "replaces": "voxtral_tpu/ops/flash_encode.py:51",
         "launches": (streamed["flash_bulk_attention_batched"]
                      + graphed["flash_bulk_attention_batched"]
                      + pr["launches"]["flash_bulk_attention_batched"]
                      + meshed["flash_bulk_attention_batched"]
                      + ckpt["flash_bulk_attention_batched"]
                      + f32_enc["launches_f32"]
                      + benched["flash_bulk_attention_batched"]),
         "launches_bench": benched["flash_bulk_attention_batched"],
         "launches_mesh": meshed["flash_bulk_attention_batched"],
         "launches_ckpt": ckpt["flash_bulk_attention_batched"],
         "launches_stream": st["launches"]["flash_bulk_attention_batched"],
         "launches_bstream": bst["launches"]["flash_bulk_attention_batched"],
         "launches_graphs": graphed["flash_bulk_attention_batched"],
         "launches_pool_ring": pr["launches"]["flash_bulk_attention_batched"],
         **flash_enc, **rank_keys(shapes["flash_encode"], "tp2_rank"),
         **f32_enc},
        {"name": "int4_mm", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/int4_mm.cu",
         "replaces": "voxtral_tpu/ops/quant_mm.py:44",
         "launches": (served["int4_mm"] + graphed["int4_mm"] + ckpt["int4_mm"]
                      + benched["int4_mm"]),
         "launches_bench": benched["int4_mm"],
         "launches_ckpt": ckpt["int4_mm"],
         "launches_graphs": graphed["int4_mm"], **int4},
        {"name": "ring_rows_write", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/ring_rows_write.cu",
         "replaces": "voxtral_tpu/ops/ring.py:88",
         "launches": served["ring_rows_write"] + graphed["ring_rows_write"],
         "launches_graphs": graphed["ring_rows_write"], **rows},
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    idle = [p for p, n in kernels[1]["launches_by_path"].items() if n <= 0]
    if idle:   # every rung decodes through it, the fp8 ones included
        raise AssertionError(f"flash_decode: no launch on {idle}")
    if not (kernels[2]["launches_stream"] > 0
            and kernels[2]["launches_bstream"] > 0
            and kernels[2]["launches_pool_ring"] > 0):
        raise AssertionError("flash_encode: no launch on stream, bstream or "
                             "pool_ring")
    if not kernels[0]["launches_pool_window"] > 0:
        raise AssertionError("banded_attention: no launch on pool_window")
    if not (kernels[0]["launches_mesh"] > 0 and kernels[2]["launches_mesh"] > 0):
        raise AssertionError("banded or flash_encode: no launch on mesh")
    idle = [k["name"] for k in kernels if k.get("launches_f32") == 0]
    if idle:
        raise AssertionError(f"{idle}: no launch on the f32 encoder path")
    idle = [k["name"] for k in kernels if k.get("launches_graphs") == 0]
    if idle:   # the graphed paths: flash-decode's is checked above
        raise AssertionError(f"{idle}: no launch in a graph")
    idle = [k["name"] for k in kernels if k.get("launches_ckpt") == 0]
    if idle:   # flash_decode's "ckpt" path is checked above
        raise AssertionError(f"{idle}: no launch on ckpt")
    idle = [k["name"] for k in kernels if k.get("launches_bench") == 0]
    if idle:   # #1 (bulk, the window rows), #4, #6 (int4), #7 ("inc")
        raise AssertionError(f"{idle}: no launch in the bench")
    captured = capture_stats()
    log("graphs", f"the whole run captured {captured['graphs']} graphs in "
                  f"{captured['capture_s']:.2f} s, pools "
                  f"{captured['pool_gib']:.3f} GiB in all")
    total_s = time.monotonic() - t_start
    log("done", f"all phases in {total_s:.1f} s")
    print(json.dumps({"kernels": kernels, "clips": sl["clips"],
                      "step_rel_err": sl["step_rel_err"],
                      "serve": sv["rungs"], "stream": st,
                      "bstream": bst, "jacobi": jac, "pool_ring": pr,
                      "pool_window": pw, "mesh": ms, "mel_device": mel_dev,
                      "f32_auto": f32_auto, "ckpt": ck, "graphs": gr,
                      "bench": bn,
                      "captured": captured, "phase_s": phase_s,
                      "total_s": total_s}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
