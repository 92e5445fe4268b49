#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voxtral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases below
    python3 chip_smoke.py --profile    # device, build, then the profile
    python3 chip_smoke.py --int4 [ROOT]  # device, build, int4, rows only
                                         # (ROOT: the package of another
                                         # checkout, for an A/B in one call)
    python3 chip_smoke.py --only jacobi,pool_ring  # device, build, then the
                                         # named phases (ONLY_PHASES)
    python3 chip_smoke.py --bf16 [ROOT]  # device, build, the bf16_mm
                                         # sweep (phase_bf16_sweep; ROOT:
                                         # another checkout's package, its
                                         # bits compared)
    python3 chip_smoke.py --int8 [ROOT]  # device, build, the int8_mm
                                         # sweep (phase_int8_sweep; ROOT:
                                         # another checkout's package,
                                         # timed in the same call)
    python3 chip_smoke.py --norm [ROOT]  # device, build, the norm kernel
                                         # (phase_norm; ROOT: another
                                         # checkout's norm and its layer
                                         # sequence, compared bit for bit
                                         # and timed in the same call,
                                         # phase_norm_other_tree)

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
               equal, every mapping of its batch-free split (1 .. S blocks
               per cluster) bitwise equal, stream 0 alone bitwise equal to
               stream 0 in the batch, and the bench's B=64 bf16 and B=80
               fp8 rings; its times (against the parent's batch-dependent
               plan, parent_flash_plan, in turns), bound and SDPA's at the
               slice shape (B=1 cap 512 pos 300) in bf16 and fp8, the serve
               shape (B=16 cap 896, mixed positions around 500) in bf16
               and fp8, and B=64 (bf16, fp8) and B=80 fp8
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
               1280 slots; all of it again on e4m3 rings (the kernel
               widens them as it loads them), with the bench's load-ring
               chunks (B=8 and 16, T=25 and 50, 896 slots) and times
               against the plain ring_attention the encoder took there
               before; then both mappings timed over a sweep of (B, T), the
               data of the mapping rule
  6. int4     kernel (C) against its plain version at the five
               full-width int4 matrices (wqkv, wo, w13, w2, logits table;
               26-layer stacks, read at layer 25) at 1, 16, 64, 608, 56
               and 2128 rows (the last two: the bench's int4 decode and
               prefill), two calls bitwise equal; its plans and the card's
               occupancy for them; graph-replay times at each row count
               but 1 of the kernel,
               plain and the bf16 yardstick, and of one decode step's 105
               products (26 layers + the table, 1.71 GB packed)
  6b. int8    kernel (G), csrc/int8_mm.cu (the counterpart of the int8
               convert XLA fuses into the JAX package's int8 product: the
               ring's wgmma tile), on both plans (row-count, row-invariant)
               against its plain version (the layer widened to bf16, then
               torch.mm) on full 26-layer int8 stacks and the table: every
               product of the decode step at 16, 56 and 64 rows, layer
               25's four and the table at 1 and 64 rows, its four at 608,
               2128 and 2432 (the B=16, 56 and 64 prefills), two calls
               bitwise equal; its plans and the card's occupancy for them;
               graph-replay times of the kernel on both plans, the path it
               replaces, the bf16 mm yardstick and
               torch._weight_int8pack_mm where the card's torch has it;
               the decode step's 105 products at 16, 56 and 64 rows on
               both plans, plain, bf16 mm and torch._weight_int8pack_mm
  7. rows     kernel (D) against its plain version on [16, 26, 8, 896,
               128] rings in fp8, bf16 and f32 (bit-equal rings); its
               graph-replay time beside the card's launch floor
  7b. rowinv  kernel (H), csrc/bf16_mm.cu (the streaming encoder side's
               float products, row-invariant), on the eight products of
               that side at full width, and the int8 and int4 kernels on
               their row-invariant plans on a layer's four, at rows 1, 2,
               24, 50, 64, 124, 192, 512 and 1696: every row bit-equal to
               the same row in one larger call, at an offset and alone;
               within tolerance of plain, two calls bitwise equal, one
               launch a call, bf16_mm's two ways to run its split bitwise
               equal; the plans against the card's occupancy; at which row
               counts torch.mm gives a row other bits (printed); graph-replay
               times of bf16_mm (both ways) against torch.mm(out_dtype=f32),
               of the int kernels' row-invariant plans against their
               row-count plans, with bounds; the norm kernel
               (csrc/rms_norm.cu: the residual add, norm and ada scale in
               one launch, phase_norm) in each of its modes (the norm
               alone, the add, the add with a bias, the add with ada) at
               the encoder's and the decoder's width, bf16 and f32 (rows
               1..80 and B x 38) row-invariant, bit-equal to the unfused
               sequence it replaced and within a bf16 step of torch's,
               gated; its graph-replay times at a decode step's 16, 56 and
               64 rows, the B=64 prefill and the encoder's chunks beside
               the norm alone, the unfused sequence, torch's, F.rms_norm
               and the bound; torch's norm's row dependence printed;
               bf16_mm and the int8 kernel's
               row-invariant plan on the decoder's five products (rows
               1..2432 bitwise invariant, times at 16, 56, 64 rows against
               torch.mm, the int8 row-count plan and bound)
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
               mid fill (fp8kv also under "xla",
               the row-write kernel; int8
               also on its plain products, widen + mm, against the int8
               kernel: ms/step, device ms, burst memory), one
               step's f32 logits bit-equal; the B=1 stream's feed() p50/p90
               and the Jacobi clip, ids bit-equal; the captures' count, host
               seconds and pool memory (also for the whole run); the serve
               halves at 20 s clips
 10. stream   VoxStream at B=1 on an 11 s clip fed 1 s at a time (2 s
               interval), 0.5 s at a time (-I 0.5) and unfused: exact
               launch counts (bf16_mm's too), ids equal and rows by encoder
               position bit-equal among the runs (conv stem, encoder,
               adapter), id agreement with the offline path, feed() walls,
               decode ms/step; the same runs through the cuBLAS route
               (cublas_stream: torch.mm), their agreement, walls and the
               first stage where their rows part, eager and probed inside
               every layer over the clip's first 3 s; an int8 and an int4
               pair (the encoder's layers quantized too), ids and rows
               equal; the three runs on an e4m3 encoder ring of 896 under
               "auto" (flash-encode reads e4m3), gated the same way, and on
               the encoder's plain attention (attn_impl "xla"), printed
 11. bstream  BatchedTranscriber at B=16 x 30 s, 200-frame intervals,
               decoder ring 896: exact launch counts, aggregate x realtime,
               stream 0 against a B=1 VoxStream of the same clip, gated:
               the same ids, its encoder side's rows and its decoder's K/V
               rows by position bit-equal
 11b. batchinv stream 0's graphed decode step at B = 1, 3, 16, 64 on
               bf16, fp8kv, int8 and int4: logits and K/V rows bit-equal
               to B=1's, its prefill alone against inside B = 4 and 64
               (gated), and, on the parent's route in the same call, where
               the rows part (decoder_probe); the graphed step at B = 16,
               56, 64 and the B=64 prefill timed on both routes
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
               B=1 VoxStream fed the same audio, gated as bstream's
 13b. pool_ring_fp8 the ring pool at the bench's load-ring settings: 8
               slots, e4m3 encoder ring 896 and decoder ring 1024, -I 0.5,
               2 rounds of 8 ticks, slot 0 gated against a B=1 VoxStream;
               then the same on the encoder's plain attention, printed
 14. pool_window the StreamPool in window mode: 32 slots, fp8 decoder ring
               1024, -I 2.0, 2 rounds of 8 ticks, the same churn (banded
               attention at B=32 with per-slot kv_lo); slot 0 against the
               ring pool's
 15. mesh     multi-device serving with ranks spawned on this one card,
               joined over gloo (NCCL takes one card per rank): (a) the
               full-width serve pipeline (bulk encode, batched prefill,
               decode bursts; MESH_LAYERS deep) of 4 x 5 s clips at dp 1 x
               tp 2 against the
               same clips unsharded: exact launches per rank (banded at 16
               heads, flash-decode at 16q/4kv; bf16_mm and the norm kernel
               against the rank's own count of its passes, mesh_rank), the
               prefill's last hidden
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
import functools
import itertools
import json
import os
import re
import shutil
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
# (G): bf16 x int8 products are exact (a weight in [-127, 127] is exact in
# bf16); only the f32 summation order differs, as for (C): the mma tiles
# and the cluster's K split against cuBLAS, relative to max |plain|
INT8_REL_TOL = 1e-5
# kernels built to spill no register (the build phase fails if they do)
NO_SPILL_KERNELS = ("banded_attention_kernel", "flash_encode_kernel",
                    "flash_decode_kernel", "int4_mm_kernel",
                    "banded_attention_f32_kernel", "flash_encode_f32_kernel",
                    "int8_mm_kernel",
                    "bf16_mm_kernel", "rms_norm_kernel")
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
# stream: least share of positions at which the offline path,
# teacher-forced on a streaming run's ids, predicts them: between the
# readings of a sound decoder on the card (0.966-0.987, H100 80GB HBM3,
# 700 W) and that of the same decoder with its middle layer's attention
# output zeroed (0.779), which the phase reads beside it and which must
# stay below this bar
STREAM_FORCED_MIN = 0.9
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


def busy_us(events) -> float:
    """The time in us in which at least one of `events` ran on the device:
    the union of their intervals, so that kernels that overlap (a
    programmatic dependent launch starts before the kernel ahead of it
    ends) count once.  Over a wall time it is the busy share; one minus it
    the device's idle share."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo if hi is not None else 0.0)


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
            elif "Potential Performance Loss" in line:
                # ptxas serialized a kernel's wgmma chain (C7515 and kin)
                log("build", f"{name}: {line.split('info    : ')[-1].strip()}")
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

        def parent():
            with flash_plan(parent_flash_plan):
                kern()

        out[f"ms{mode}"] = cuda_ms(kern, 50)
        # the plan against the parent's (parent_flash_plan), in turns
        dev = {"": [], "_parent": []}
        for tag, fn in (("_parent", parent), ("", kern), ("", kern),
                        ("_parent", parent)):
            dev[tag].append(graph_ms(fn, 20))
        for tag, v in dev.items():
            out[f"device_ms{tag}{mode}"] = float(np.mean(v))
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


# flash: plans timed against each other at the serve and bench shapes
# (ranges x slots, blocks per cluster): the split's cost by range count;
# at B=1 each split as a cluster of one block a range (its mapping there),
# at caps 512 and 896 with the window full
FLASH_SWEEP = ((1, 896, 1), (2, 448, 1), (4, 256, 1), (7, 128, 1),
               (7, 128, 7))
FLASH_SWEEP_B1 = {512: ((1, 512, 1), (2, 256, 2), (4, 128, 4), (8, 64, 8)),
                  896: ((1, 896, 1), (2, 448, 2), (4, 256, 4), (7, 128, 7))}


def _flash_plan_sweep(gen, window: int = 8192) -> dict:
    """Kernel (B)'s device ms (graph replay, write + attend, bf16 rings)
    under each plan: at B=16 and 64 on 896 slots, positions around 500,
    each of FLASH_SWEEP (what a range costs when one block walks them, and
    what the cluster mapping costs where it passes a wave); at B=1 on 512
    and 896 slots, the window full, each of FLASH_SWEEP_B1 (what fewer
    ranges cost a lone stream)."""
    import torch

    from voxtral_tpu_torch.ops.flash_decode import FlashPlan, flash_decode

    out = {}
    cases = [(16, 896, FLASH_SWEEP, [500 + 13 * (i - 8) for i in range(16)]),
             (64, 896, FLASH_SWEEP,
              [500 + 13 * (i % 16 - 8) for i in range(64)])]
    cases += [(1, cap, plans, [cap + 123])
              for cap, plans in FLASH_SWEEP_B1.items()]
    for bsz, cap, plans, pos_l in cases:
        shape = (bsz, 26, 8, cap, 128)
        k_all = _randn(gen, shape, torch.bfloat16)
        v_all = _randn(gen, shape, torch.bfloat16)
        q = _randn(gen, (bsz, 32, 128), torch.bfloat16)
        rows = [_randn(gen, (bsz, 8, 128), torch.float32) for _ in range(2)]
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        tag = f"b{bsz}_" if cap == 896 else f"b{bsz}_cap{cap}_"
        for plan in plans:
            with flash_plan(lambda *a, p=plan: FlashPlan(*p)):
                out[tag + "x".join(map(str, plan))] = graph_ms(
                    lambda: flash_decode(q, k_all, v_all, 25, pos, *rows,
                                         window=window,
                                         out_dtype=torch.bfloat16), 20)
        del k_all, v_all
        log("flash", f"plans at B={bsz} bf16 cap {cap} (ranges x slots x "
                     f"blocks per cluster: device ms): " + ", ".join(
                         f"{k[len(tag):]} {v:.4f}" for k, v in out.items()
                         if k.startswith(tag) and "cap" not in k[len(tag):]))
    return out


def phase_flash() -> dict:
    import torch

    from voxtral_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_plain,
        flash_decode_plan,
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
            # every mapping of the split (1 .. S blocks per cluster) gives
            # the same bits, attend and write + attend (uncounted); stream
            # 0 alone gives its bits inside the batch (before the plain
            # version writes the rows into k_all, v_all)
            plan = flash_decode_plan(min(cap, window), bsz, kh)
            maps_equal = True
            for c in range(1, plan.splits + 1):
                with flash_plan(lambda *a, c=c: plan._replace(cluster=c)):
                    m = flash_decode(q, k_all, v_all, li, pos, **kw)
                    km, vm = k_all.clone(), v_all.clone()
                    m_w = flash_decode(q, km, vm, li, pos, k_rows, v_rows,
                                       **kw)
                maps_equal &= (torch.equal(m, got) and torch.equal(m_w, got_w)
                               and torch.equal(km.view(torch.uint8),
                                               kk.view(torch.uint8)))
                del km, vm
            n0 = flash_decode.launches
            alone = flash_decode(q[:1], k_all[:1], v_all[:1], li, pos[:1],
                                 **kw)
            flash_decode.launches = n0
            alone_equal = torch.equal(alone[0], got[0])
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
            ok = (err <= FLASH_TOL and rings_equal and same and maps_equal
                  and alone_equal)
            log("flash", f"{str(rdt)[6:]} B={bsz} cap={cap} pos={pos_l[:3]} "
                         f"splits={plan.splits}x{plan.chunk} "
                         f"cluster={plan.cluster}"
                         f": max_abs_err {err:.3e} (tol {FLASH_TOL}), rings "
                         f"{'bit-equal' if rings_equal else 'DIFFER'}, two "
                         f"calls {'bitwise equal' if same else 'DIFFER'}, "
                         f"mappings 1..{plan.splits} "
                         f"{'bitwise equal' if maps_equal else 'DIFFER'}, "
                         f"stream 0 alone "
                         f"{'bitwise equal' if alone_equal else 'DIFFERS'} "
                         f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[flash] {rdt} B={bsz} cap={cap} "
                                     f"pos={pos_l} err {err} rings "
                                     f"{rings_equal} deterministic {same} "
                                     f"mappings {maps_equal} alone "
                                     f"{alone_equal}")
            del k_all, v_all, kk, vk, kk2, vk2, kp, vp
    # times: the slice shape (B=1, a 30 s clip's ring of 512 mid-clip, bf16)
    # and the serve shape (B=16, ring 896, positions around 500) in bf16 and
    # fp8
    serve_pos = [500 + 13 * (i % 16 - 8) for i in range(80)]
    shapes = {"": (1, 512, [300], torch.bfloat16),
              "_b1_fp8": (1, 512, [300], torch.float8_e4m3fn),
              "_b16_bf16": (16, 896, serve_pos[:16], torch.bfloat16),
              "_b16_fp8": (16, 896, serve_pos[:16], torch.float8_e4m3fn),
              "_bench_b64_bf16": (64, 896, serve_pos[:64], torch.bfloat16),
              "_b64_fp8": (64, 896, serve_pos[:64], torch.float8_e4m3fn),
              "_bench_b80_fp8": (80, 896, serve_pos, torch.float8_e4m3fn)}
    out = {"max_abs_err": worst, "deterministic": True,
           "mappings_equal": True, "batch_invariant": True,
           "replaces_also": ["voxtral_tpu/ops/flash_decode.py:44",
                             "voxtral_tpu/ops/flash_decode.py:124"]}
    for tag, (bsz, cap, pos_l, rdt) in shapes.items():
        tm = _flash_times(gen, bsz, cap, pos_l, rdt, window)
        out.update({f"{k}{tag}": v for k, v in tm.items()})
        plan = flash_decode_plan(min(cap, window), bsz, kh)
        out[f"plan{tag}"] = list(plan)
        out[f"parent_plan{tag}"] = list(parent_flash_plan(min(cap, window),
                                                          bsz, kh))
        lib = tm["library_ms"]
        log("flash", f"B={bsz} {str(rdt)[6:]} cap={cap} pos={pos_l[:3]}.. "
                     f"plan {tuple(plan)} (parent's "
                     f"{tuple(out[f'parent_plan{tag}'])}): "
                     f"write+attend kernel {tm['ms']:.4f} ms (device "
                     f"{tm['device_ms']:.4f}, parent's plan "
                     f"{tm['device_ms_parent']:.4f}; attend "
                     f"{tm['device_ms_attend']:.4f} against "
                     f"{tm['device_ms_parent_attend']:.4f}), plain "
                     f"{tm['plain_ms']:.4f}; "
                     f"attend kernel {tm['ms_attend']:.4f} (device "
                     f"{tm['device_ms_attend']:.4f}), plain "
                     f"{tm['plain_ms_attend']:.4f}; SDPA (attend) "
                     f"{'none' if lib is None else f'{lib:.4f}'} ms; bound "
                     f"{tm['bound_ms']:.6f} ms ({tm['bound_by']})")
    out["plan_sweep"] = _flash_plan_sweep(gen, window)
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

    def step(fn=int4_mm):
        for li in range(INT4_LAYERS):
            for name in ("wqkv", "wo", "w13", "w2"):
                fn(xs[INT4_SHAPES[name][1]], *stacks[name], li)
        fn(xs[INT4_SHAPES["logits"][1]], *stacks["logits"], 0)

    step_shapes = [INT4_SHAPES[n] for n in ("wqkv", "wo", "w13", "w2")
                   for _ in range(INT4_LAYERS)] + [INT4_SHAPES["logits"]]
    sb = _int4_bound(step_shapes, 16)
    out.update({"step_ms": graph_ms(step, 2),
                "step_plain_ms": graph_ms(lambda: step(int4_mm_plain), 1,
                                          reps=3),
                "step_bound_ms": sb["bound_ms"],
                "step_products": len(step_shapes)})
    log("int4", f"decode step, {len(step_shapes)} products at 16 rows over "
                f"{INT4_LAYERS} layers + table: {out['step_ms']:.4f} ms, "
                f"plain {out['step_plain_ms']:.4f} ms (graph replay); bound "
                f"{sb['bound_ms']:.4f} ms ({sb['bound_by']})")
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
    _mm_plans(4, INT4_ROWS + INT4_BENCH_ROWS)


def _mm_plans(bits: int, rows_list) -> None:
    """The int4 or int8 kernel's plan for each product at `rows_list`, and
    the blocks per SM the plan assumes against the card's occupancy query
    (fails if the plan assumes more: it would launch past one wave)."""
    from voxtral_tpu_torch.ops import cuda_lib, quant_mm

    tag = f"int{bits}"
    if not hasattr(quant_mm, f"{tag}_mm_plan"):   # an older tree (A/B runs)
        return
    lib = cuda_lib.kernels()
    plan_of = getattr(quant_mm, f"{tag}_mm_plan")
    if bits == 4:   # (nj, K split)
        tiles = [(nj, cs) for nj in (2, 4, 16)
                 for cs in ((1,) if nj == 16 else (1, 2))]
        occupancy = lib.vt_int4_mm_occupancy
        per_sm, smem_of = quant_mm.int4_mm_blocks_per_sm, quant_mm.int4_mm_smem
    else:   # (tile rows, single blocks) of the ring; the model follows rows
        tiles = [(64, True), (64, False), (128, True)]
        occupancy = lambda rows, seq: lib.vt_int8_mm_occupancy(int(seq), rows)
        per_sm = lambda rows, seq: quant_mm.int8_mm_blocks_per_sm(rows)
        smem_of = lambda rows, seq: quant_mm.int8_mm_smem(rows)
    for a, b in tiles:
        assumed = per_sm(a, b)
        got = occupancy(a, b)
        log(tag, f"tile {a} {b}: {smem_of(a, b)} bytes of shared memory, "
                 f"{got} blocks per SM (plan assumes {assumed})")
        if got < assumed:
            raise AssertionError(f"[{tag}] tile {a} {b}: the card holds "
                                 f"{got} blocks per SM, the plan assumes "
                                 f"{assumed}")
    sms = cuda_lib.sm_count(0)
    for rows in rows_list:
        for name, (out_dim, in_dim) in INT4_SHAPES.items():
            k = in_dim // 2 if bits == 4 else in_dim
            plan = plan_of(rows, out_dim, k, sms)
            txt = ""
            if bits == 8:
                lp = quant_mm.int8_mm_launch(rows, out_dim, k, sms, True)
                txt = (f"; row-invariant "
                       f"{quant_mm.int8_mm_rowinv_plan(out_dim, k, sms)}, "
                       f"launch {lp[:3]}")
            log(tag, f"plan {name} rows={rows}: {plan}{txt}")


# the int8 phase at full width: the int8 rung's products (INT4_SHAPES'
# (out, in), 26-layer stacks + the table: 3.43 GB of int8) at its row
# counts: a B=1 stream, the smoke's B=16 serve and the bench's B=56 decode
# (step_rows: every product of the decode step), a B=1 Jacobi window, the
# B=16 and B=56 prefills (16 x 38 and 56 x 38 rows: the four layer products)
INT8_FULL = dict(products=INT4_SHAPES, layers=INT4_LAYERS,
                 step_rows=(16, 56, 64),
                 rows=(1, 16, 56, 64, 608, 2128, 2432),
                 prefill_rows=(608, 2128, 2432))
# the int8 kernel's two plans: the row-count plan (int8_mm_plan) and the
# row-invariant one (int8_mm_rowinv_plan, every decoder call's route)
INT8_PLANS = (("", False), ("rowinv_", True))
PLAN_NAME = {"": "row-count plan", "rowinv_": "row-invariant plan"}


def _int8_bound(shapes, rows: int) -> dict:
    """bound of int8 products [(out, in)] at `rows`: weights (one byte
    each), scales and x read once, f32 y written once; 2 operations per
    weight and row."""
    n_bytes = sum(o * i + o * 4 + rows * i * 2 + rows * o * 4
                  for o, i in shapes)
    return bound(n_bytes, sum(2 * rows * o * i for o, i in shapes))


def _int8pack_mm():
    """torch._weight_int8pack_mm where this torch has it for CUDA tensors
    (its int8 weight-only product: bf16 x, bf16 row scales, bf16 out), else
    None: the library yardstick, never called by the port."""
    import torch

    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    x = torch.ones((16, 128), dtype=torch.bfloat16, device="cuda")
    w = torch.ones((64, 128), dtype=torch.int8, device="cuda")
    try:
        y = fn(x, w, torch.ones(64, dtype=torch.bfloat16, device="cuda"))
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log("int8", f"torch._weight_int8pack_mm on CUDA: {type(e).__name__}: "
                    f"{str(e).splitlines()[0][:120]}")
        return None
    return fn if float(y[0, 0]) == 128.0 else None


def phase_int8(device: str = "cuda", shapes: dict = INT8_FULL) -> dict:
    """Kernel (G) on int8 stacks of random bytes in [-127, 127] (`shapes`:
    full width, 26 layers and the table), on both of its plans
    (INT8_PLANS): within INT8_REL_TOL of int8_mm_plain and two calls
    bitwise equal on every product of the decode step (every layer's four
    and the table) at each of `step_rows`, and on the last layer's four
    and the table at each of `rows` (the four alone at `prefill_rows`),
    one launch a call, counted; on the card also its plans and the card's
    occupancy for them, graph-replay times per shape (layers rotating) of
    the kernel on each plan, of the path it replaces (int8_mm_plain: the
    layer widened to bf16, then torch.mm), of torch.mm on a bf16 weight
    (the bf16 rung's product, a yardstick) and of
    torch._weight_int8pack_mm where the card's torch has it (bf16 scales
    and output: a library yardstick, not this function), and the decode
    step's products at `step_rows` in decode order, the kernel on each
    plan, plain, bf16 mm and torch._weight_int8pack_mm.  A tiny CPU config
    rehearses it (the plain function counted as the kernel)."""
    import torch

    from voxtral_tpu_torch.ops.quant_mm import int8_mm, int8_mm_plain

    on_gpu = device == "cuda"
    products, n_layers = shapes["products"], shapes["layers"]
    names = list(products)
    layer_names = [n for n in names if n != "logits"]
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    stacks = {}
    for name, (out_dim, in_dim) in products.items():
        stacks[name] = (
            torch.randint(-127, 128, (1 if name == "logits" else n_layers,
                                      out_dim, in_dim),
                          generator=gen, device=device, dtype=torch.int8),
            torch.rand((1 if name == "logits" else n_layers, out_dim),
                       generator=gen, device=device) * 0.02 + 0.001)
    n_bytes = sum(w.numel() for w, _ in stacks.values())
    log("int8", f"stacks: {n_layers} layers + table, {n_bytes / 1e9:.3f} GB "
                "of int8")
    lib_mm = None
    if on_gpu:
        _mm_plans(8, shapes["rows"])
        lib_mm = _int8pack_mm()
    worst_abs, worst_rel, out, checked = 0.0, 0.0, {}, 0

    def check(name, rows, li, x, rowinv):
        nonlocal worst_abs, worst_rel, checked
        w, s = stacks[name]
        n0 = int8_mm.launches
        got = int8_mm(x, w, s, li, rowinv=rowinv)
        again = int8_mm(x, w, s, li, rowinv=rowinv)
        want = int8_mm_plain(x, w, s, li)
        if int8_mm.launches != n0 + 2:
            raise AssertionError(f"[int8] {name} rows={rows}: "
                                 f"{int8_mm.launches - n0} launches for two "
                                 "calls")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[int8] non-finite {name} rows={rows}")
        same = torch.equal(got, again)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        checked += 1
        if not (rel <= INT8_REL_TOL and same):
            raise AssertionError(f"[int8] {name} rows={rows} layer {li} "
                                 f"rowinv={rowinv}: rel {rel} (tol "
                                 f"{INT8_REL_TOL}), two calls "
                                 f"{'equal' if same else 'DIFFER'}")
        return err, rel

    # every product of the decode step at its row counts, on both plans
    for rows in shapes["step_rows"]:
        xs = {i: _randn(gen, (rows, i), torch.bfloat16, device)
              for _, i in products.values()}
        for plan, rowinv in INT8_PLANS:
            step_rel = 0.0
            for name, (_, in_dim) in products.items():
                for li in range(stacks[name][0].shape[0]):
                    step_rel = max(step_rel, check(name, rows, li,
                                                   xs[in_dim], rowinv)[1])
            log("int8", f"decode step at {rows} rows, {PLAN_NAME[plan]}: "
                        f"{4 * n_layers + 1} products ({n_layers} "
                        f"layers x 4 + table) within rel {step_rel:.3e} of "
                        f"plain (tol {INT8_REL_TOL}), two calls bitwise "
                        "equal, ok")
    for name, (out_dim, in_dim) in products.items():
        w, s = stacks[name]
        n_w = w.shape[0]
        wd = [(w[li].float() * s[li, :, None]).bfloat16()
              for li in range(min(4, n_w))]
        sb = [s[li].bfloat16() for li in range(len(wd))]
        for rows in shapes["rows"]:
            if name == "logits" and rows in shapes["prefill_rows"]:
                continue
            x = _randn(gen, (rows, in_dim), torch.bfloat16, device)
            for plan, rowinv in INT8_PLANS:
                err, rel = check(name, rows, n_w - 1, x, rowinv)
                log("int8", f"{name} [{out_dim}x{in_dim}] rows={rows} layer "
                            f"{n_w - 1}, {PLAN_NAME[plan]}: "
                            f"max_abs_err {err:.3e}, rel {rel:.3e} (tol "
                            f"{INT8_REL_TOL}), two calls bitwise equal ok")
            if rows == 1 or not on_gpu:
                continue
            tm = {
                **{f"{plan}ms": graph_ms(_rotating(
                    lambda li, ri=rowinv: int8_mm(x, w, s, li, rowinv=ri),
                    n_w), n_w) for plan, rowinv in INT8_PLANS},
                "plain_ms": graph_ms(_rotating(
                    lambda li: int8_mm_plain(x, w, s, li), len(wd)), len(wd)),
                "bf16_mm_ms": graph_ms(_rotating(
                    lambda li: torch.mm(x, wd[li].t(),
                                        out_dtype=torch.float32), len(wd)),
                    len(wd)),
                **_int8_bound([(out_dim, in_dim)], rows)}
            lib_txt = ""
            if lib_mm is not None:
                try:          # eagerly first: a refusal raises outside a graph
                    lib_mm(x, w[0], sb[0])
                    tm["library_ms"] = graph_ms(_rotating(
                        lambda li: lib_mm(x, w[li], sb[li]), len(wd)),
                        len(wd))
                    lib_txt = f", int8pack_mm {tm['library_ms']:.4f}"
                except RuntimeError as e:
                    lib_txt = f", int8pack_mm refused ({str(e)[:80]})"
            for k, v in tm.items():
                out[f"{k}_{name}_rows{rows}"] = v
            log("int8", f"{name} rows={rows}: kernel {tm['ms']:.4f} ms "
                        f"(row-invariant plan {tm['rowinv_ms']:.4f}), widen "
                        f"+ mm (plain) {tm['plain_ms']:.4f}, bf16 mm "
                        f"{tm['bf16_mm_ms']:.4f}{lib_txt} ms (graph replay, "
                        f"layers rotating); {w[0].numel() / tm['ms'] / 1e6:.0f}"
                        f" GB/s of int8 weights; bound {tm['bound_ms']:.4f} "
                        f"ms ({tm['bound_by']})")
        del wd, sb
    # the decode step: 4 products a layer, then the table, in decode order
    step_shapes = [products[n] for _ in range(n_layers)
                   for n in layer_names] + [products["logits"]]
    out.update({"step_products": len(step_shapes),
                "checked_products": checked, "max_abs_err": worst_abs,
                "max_rel_err": worst_rel})
    for rows in shapes["step_rows"] if on_gpu else ():
        xs = {i: _randn(gen, (rows, i), torch.bfloat16, device)
              for _, i in products.values()}

        def step(prod):
            for li in range(n_layers):
                for name in layer_names:
                    prod(name, xs[products[name][1]], li)
            prod("logits", xs[products["logits"][1]], 0)

        sb = _int8_bound(step_shapes, rows)
        tag = f"step_rows{rows}"
        for plan, rowinv in INT8_PLANS:
            out[f"{tag}_{plan}ms"] = graph_ms(lambda: step(
                lambda name, x, li: int8_mm(x, *stacks[name], li,
                                            rowinv=rowinv)), 2, reps=3)
        out.update({f"{tag}_plain_ms": graph_ms(lambda: step(
                        lambda name, x, li: int8_mm_plain(
                            x, *stacks[name], li)), 1, reps=3),
                    f"{tag}_bound_ms": sb["bound_ms"]})
        # the yardsticks on the same step: torch.mm on the weights
        # dequantized to bf16, and torch._weight_int8pack_mm
        wb = {name: torch.stack([(w[li].float() * s[li, :, None]).bfloat16()
                                 for li in range(w.shape[0])])
              for name, (w, s) in stacks.items()}
        out[f"{tag}_bf16_mm_ms"] = graph_ms(lambda: step(
            lambda name, x, li: torch.mm(x, wb[name][li].t(),
                                         out_dtype=torch.float32)), 1, reps=3)
        del wb
        lib_txt = ""
        if lib_mm is not None:
            sb8 = {name: s.bfloat16() for name, (_, s) in stacks.items()}
            out[f"{tag}_library_ms"] = graph_ms(lambda: step(
                lambda name, x, li: lib_mm(x, stacks[name][0][li],
                                           sb8[name][li])), 1, reps=1)
            lib_txt = f", int8pack_mm {out[f'{tag}_library_ms']:.4f}"
            del sb8
        log("int8", f"decode step, {len(step_shapes)} products at {rows} rows "
                    f"over {n_layers} layers + table: kernel "
                    f"{out[f'{tag}_ms']:.4f} ms (row-invariant plan "
                    f"{out[f'{tag}_rowinv_ms']:.4f}), widen + mm "
                    f"{out[f'{tag}_plain_ms']:.4f}, bf16 mm "
                    f"{out[f'{tag}_bf16_mm_ms']:.4f}{lib_txt} ms (graph "
                    f"replay); bound {sb['bound_ms']:.4f} ms "
                    f"({sb['bound_by']})")
    del stacks
    if on_gpu:
        torch.cuda.empty_cache()
    int8_mm.launches = 0
    # the summary: the five products at the first decode row count (the
    # B=16 decode shape), then each timed row count's sums
    r0 = shapes["step_rows"][0]
    out.update(_int8_bound(products.values(), r0))
    out["library_ms"] = None
    for rows in [r for r in shapes["rows"] if r != 1] if on_gpu else ():
        group = layer_names if rows in shapes["prefill_rows"] else names
        tag = ("" if rows == r0 else f"_rows{rows}" if len(group) == len(names)
               else f"_layers_rows{rows}")
        for k in ("ms", "rowinv_ms", "plain_ms", "bf16_mm_ms", "library_ms"):
            keys = [f"{k}_{n}_rows{rows}" for n in group]
            if all(key in out for key in keys):
                out[f"{k}{tag}"] = sum(out[key] for key in keys)
        b = _int8_bound([products[n] for n in group], rows)
        if tag:
            out[f"bound_ms{tag}"], out[f"bound_by{tag}"] = (b["bound_ms"],
                                                             b["bound_by"])
        lib = out.get(f"library_ms{tag}")
        log("int8", f"{len(group)} products at {rows} rows: kernel "
                    f"{out[f'ms{tag}']:.4f} ms (row-invariant plan "
                    f"{out[f'rowinv_ms{tag}']:.4f}), widen + mm "
                    f"{out[f'plain_ms{tag}']:.4f}, bf16 mm "
                    f"{out[f'bf16_mm_ms{tag}']:.4f}, int8pack_mm "
                    f"{'none' if lib is None else f'{lib:.4f}'}, bound "
                    f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    log("int8", f"{checked} products checked on both plans, worst rel "
                f"{worst_rel:.3e} (tol {INT8_REL_TOL}), every pair of calls "
                "bitwise equal")
    return out


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


# the bench's load-ring rows (bench.py load_rows: 8 and 16 slots at -I 0.5
# on an e4m3 encoder ring of 896): a 0.5 s feed is 25 encoder rows (the
# 16-slot row's 0.4 s gate fires every tick), 50 where the 8-slot row's
# gate of the interval fires every other tick; slots at their own
# positions after the ring has wrapped
LOAD_RING = dict(cap=896, cases=((8, 25, (3000,)), (16, 25, (3000,)),
                                 (8, 50, (3000,))))
# the mapping sweep: every (B, T) both mappings of the split walk are timed
# at, on the 1024-slot streaming ring, full window, bf16 and e4m3 rings
FLASH_ENC_SWEEP = dict(cap=1024, batches=(1, 2, 4, 8, 16),
                       ts=(8, 25, 64, 100, 256, 512))
# the rings the phase checks the kernel on: bf16 (the bf16 configs'
# encoder ring) and e4m3 (fp8 encoder rings, the load-ring rows)
FLASH_ENC_RINGS = ("bfloat16", "float8_e4m3fn")


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
                      bench=BENCH_ENC_RING, load=LOAD_RING,
                      sweep=FLASH_ENC_SWEEP)


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


def _flash_enc_sweep(gen, sh: dict) -> dict:
    """Both mappings of flash-encode's split walk timed (graph replay) at
    every (B, T) of sh["sweep"] on bf16 and e4m3 rings: the data the
    mapping rule (ops/flash_encode.py flash_encode_use_split) is read off.
    Prints, per ring, each point's query tiles, split and walk ms and which
    is faster, the tiles-per-SM crossover, and the points where the rule
    picks the slower mapping (ungated: both mappings give the same bits)."""
    import torch

    from voxtral_tpu_torch.ops import cuda_lib
    from voxtral_tpu_torch.ops.flash_encode import (
        TILE_ROWS,
        flash_bulk_attention_batched,
        flash_encode_use_split,
    )

    sw, h, d, window = sh["sweep"], sh["heads"], sh["head_dim"], sh["window"]
    sms = cuda_lib.sm_count(0)
    cap, t_max = sw["cap"], max(sw["ts"])
    out = {}
    for dt in FLASH_ENC_RINGS:
        rdt = getattr(torch, dt)
        points, wrong = [], []
        for bsz in sw["batches"]:
            kr, vr = (_randn(gen, (bsz, h, cap, d), rdt) for _ in range(2))
            q_all = _randn(gen, (bsz, t_max, h, d), torch.bfloat16)
            pos = torch.tensor(_stream_positions((3000, 5000), bsz),
                               dtype=torch.int32, device="cuda")
            for t in sw["ts"]:
                q = q_all[:, :t]
                ms = {sp: graph_ms(lambda sp=sp: flash_bulk_attention_batched(
                    q, kr, vr, pos, window=window, split=sp), 10)
                    for sp in (True, False)}
                tiles = -(-t // TILE_ROWS) * h * bsz
                best = ms[True] < ms[False]
                points.append({"B": bsz, "T": t, "tiles": tiles,
                               "split_ms": ms[True], "walk_ms": ms[False]})
                if flash_encode_use_split(tiles, sms,
                                          kr.element_size()) != best:
                    wrong.append((bsz, t))
                log("flash_enc", f"sweep {dt} B={bsz} T={t} ({tiles} query "
                                 f"tiles, {tiles / sms:.2f} an SM): split "
                                 f"{ms[True]:.4f} ms, walk {ms[False]:.4f} "
                                 f"ms ({'split' if best else 'walk'})")
            del kr, vr, q_all
        flash_bulk_attention_batched.launches = 0
        won = sorted(p["tiles"] for p in points
                     if p["split_ms"] < p["walk_ms"])
        lost = sorted(p["tiles"] for p in points
                      if p["split_ms"] >= p["walk_ms"])
        log("flash_enc", f"sweep {dt}: the split wins at query tiles "
                         f"{won}, the walk at {lost}; the rule picks the "
                         f"slower mapping at (B, T) {wrong or 'none'}")
        out[f"sweep_{dt}"] = {"points": points, "rule_slower_at": wrong}
    return out


def phase_flash_enc(device: str = "cuda", shapes: dict = FLASH_ENC_FULL,
                    batches=(1, 16)) -> dict:
    """Kernel (E), flash encode, against its plain version over layer L-1 of
    stacked rings read in place, on bf16 and e4m3 rings, at every (B, T,
    position) of `shapes` and the bench's load-ring shapes (e4m3); then the
    kernel's bitwise chunking invariance on both rings; then its times at
    the streaming shapes (B=16 T=64, the batched transcriber's chunk; B=1
    T=100, the 2 s fused chunk; the ring pool's; the bench's "inc" chunk;
    on e4m3 rings also the load-ring rows), and on e4m3 rings against the
    plain ring_attention path the encoder took there before (the parent's
    route); last the mapping sweep.  main() runs it at full width on the
    card; with device="cpu" a tiny `shapes` rehearses it (the wrapper then
    runs the plain version and nothing is timed)."""
    import torch

    from voxtral_tpu_torch.ops.flash_encode import (
        flash_bulk_attention_batched,
        flash_encode_plain,
        flash_encode_segments,
    )
    from voxtral_tpu_torch.ops.ring import ring_attention, ring_chunk_write

    on_gpu = device == "cuda"
    sh = shapes
    n_layers, h, d, cap, window = (sh[k] for k in (
        "n_layers", "heads", "head_dim", "cap", "window"))
    li = n_layers - 1
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    kw = dict(window=window, out_dtype=torch.float32)

    def rings(bsz, n_slots=cap, rdt=torch.bfloat16):
        """zeros but for layer li, which is read"""
        k_all, v_all = (torch.zeros((bsz, n_layers, h, n_slots, d),
                                    dtype=rdt, device=device)
                        for _ in range(2))
        for x in (k_all, v_all):
            x[:, li] = _randn(gen, (bsz, h, n_slots, d), rdt, device)
        return k_all, v_all

    def check(k_all, v_all, q, pos_l) -> float:
        """The kernel against plain at one case; both mappings of the split
        walk to blocks agree bit for bit (the default takes one)."""
        bsz, t, n_slots = q.shape[0], q.shape[1], k_all.shape[3]
        tag = f"{str(k_all.dtype)[6:]} cap={n_slots} B={bsz} T={t}"
        pos = torch.tensor(pos_l, dtype=torch.int32, device=device)
        want = flash_encode_plain(q, k_all[:, li], v_all[:, li], pos, **kw)
        got, walk = (flash_bulk_attention_batched(
            q, k_all[:, li], v_all[:, li], pos, split=sp, **kw)
            for sp in (True, False))
        if not torch.equal(got, walk):
            raise AssertionError(f"[flash_enc] {tag} pos={pos_l[:3]}: the "
                                 "split mappings differ")
        del walk
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[flash_enc] non-finite {tag} "
                                 f"pos={pos_l[:3]}")
        err = (got - want).abs().max().item()
        ok = err <= FLASH_ENC_TOL
        log("flash_enc", f"{tag} pos={pos_l[:3]}: max_abs_err {err:.3e} "
                         f"(tol {FLASH_ENC_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[flash_enc] {tag} pos={pos_l} err {err}")
        return err

    worst = {dt: 0.0 for dt in FLASH_ENC_RINGS}
    for dt in FLASH_ENC_RINGS:
        rdt = getattr(torch, dt)
        for n_slots in (cap, sh["ragged_cap"]):
            for bsz in batches:
                k_all, v_all = rings(bsz, n_slots, rdt)
                pos_sets = ([[p] for p in sh["positions"]] if bsz == 1 else
                            [_stream_positions(sh["positions"], bsz)])
                for t in sh["ts"]:
                    q = _randn(gen, (bsz, t, h, d), torch.bfloat16, device)
                    for pos_l in pos_sets:
                        worst[dt] = max(worst[dt],
                                        check(k_all, v_all, q, pos_l))
                del k_all, v_all
        # the bench's encoder ring: its chunks at the positions they take
        # (every stream of a batched encode at the same one); on e4m3 rings
        # also the load-ring rows' chunks, each slot at its own position
        ring_cases = [(sh["bench"]["cap"], c, False)
                      for c in sh["bench"]["cases"]]
        if rdt == torch.float8_e4m3fn and "load" in sh:
            ring_cases += [(sh["load"]["cap"], c, True)
                           for c in sh["load"]["cases"]]
        for n_slots, (bsz, t, positions), own in ring_cases:
            k_all, v_all = rings(bsz, n_slots, rdt)
            q = _randn(gen, (bsz, t, h, d), torch.bfloat16, device)
            for p in positions:
                pos_l = _stream_positions((p,), bsz) if own else [p] * bsz
                worst[dt] = max(worst[dt], check(k_all, v_all, q, pos_l))
            del k_all, v_all

        # bitwise invariance: `prefill` rows, then n more written and
        # attended as each partition of `splits`, on fresh rings each time
        n0, n = sh["prefill"], sum(sh["splits"][0])
        for bsz in batches:
            kv = _randn(gen, (bsz, n0 + n, h, d), torch.bfloat16, device)
            vv = _randn(gen, (bsz, n0 + n, h, d), torch.bfloat16, device)
            qq = _randn(gen, (bsz, n, h, d), torch.bfloat16, device)

            def run(sizes):
                k_all, v_all = (torch.zeros((bsz, n_layers, h, cap, d),
                                            dtype=rdt, device=device)
                                for _ in range(2))
                zero = torch.zeros(bsz, dtype=torch.int32, device=device)
                ring_chunk_write(k_all, v_all, kv[:, :n0], vv[:, :n0], li,
                                 zero)
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
                log("flash_enc", f"{dt} B={bsz}: {n} rows after {n0} as "
                                 f"{list(sizes)} vs {list(sh['splits'][0])}:"
                                 f" {'bitwise equal' if same else 'DIFFER'}")
                if not same:
                    raise AssertionError(f"[flash_enc] {dt} B={bsz} "
                                         f"chunking {sizes} changed the "
                                         "output")
    flash_bulk_attention_batched.launches = 0
    log("flash_enc", "one block per segment and one block walking every "
                     "segment: bitwise equal at every case, both rings")
    out = {"max_abs_err": max(worst.values()), "bitwise_invariant": True}
    if not on_gpu:
        return out
    out["max_abs_err_fp8"] = worst["float8_e4m3fn"]

    # times at the streaming shapes, bf16 out as on the path, full window:
    # the default, and each mapping of the split forced (the default's
    # numbers under the plain keys; e4m3 rings under keys ending "_fp8")
    plan = flash_encode_segments(cap)
    bench = sh["bench"]
    # B=16 T=64, the batched transcriber's chunk; B=1 T=100, the 2 s fused
    # chunk; B=8 T=24, the ring-mode pool's tick at -I 0.5 (a 0.4 s gate:
    # 48 mel frames), its slots at their own positions; B=1 T=512 on the
    # bench's ring, its 1024-frame fused chunk after the ring has wrapped;
    # on e4m3 rings the load-ring rows
    cases = [(16, 64, "", (2000, 5000), cap),
             (1, 100, "_b1_t100", (2000, 5000), cap),
             (8, 24, "_pool_ring", (40, 300, 2000, 5000), cap),
             (1, 512, "_bench_inc", (3072,), bench["cap"])]
    load_cases = [(bsz, t, f"_load_b{bsz}_t{t}", pos, sh["load"]["cap"])
                  for bsz, t, pos in sh["load"]["cases"]]
    for dt in FLASH_ENC_RINGS:
        rdt = getattr(torch, dt)
        fp8 = rdt == torch.float8_e4m3fn
        sfx = "_fp8" if fp8 else ""
        for bsz, t, tag, at, n_slots in cases + (load_cases if fp8 else []):
            tag += sfx
            k_all, v_all = rings(bsz, n_slots, rdt)
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
                                 f"max_abs_err {err:.3e} (tol "
                                 f"{FLASH_ENC_TOL})")
                if not err <= FLASH_ENC_TOL:
                    raise AssertionError(f"[flash_enc] pool ring shape err "
                                         f"{err}")
            alts = {}   # device ms by mapping
            for sp in (None, True, False):
                def kern():
                    flash_bulk_attention_batched(q, kr, vr, pos,
                                                 window=window, split=sp)

                mode = {None: "auto", True: "split", False: "walk"}[sp]
                out[f"ms_{mode}{tag}"] = cuda_ms(kern, 50)
                out[f"device_ms_{mode}{tag}"] = alts[mode] = graph_ms(kern,
                                                                      20)
            ms, dms = out[f"ms_auto{tag}"], out[f"device_ms_auto{tag}"]
            plain = cuda_ms(lambda: flash_encode_plain(q, kr, vr, pos,
                                                       window=window), 5)
            valid = _enc_mask(pos, t, n_slots, window)
            if fp8:
                # SDPA takes no e4m3 operand: no library call; beside it
                # the path it replaced, the plain ring_attention (the
                # parent's route for an fp8 encoder ring)
                lib = None
                out[f"replaced_ms{tag}"] = graph_ms(
                    lambda: ring_attention(q, kr, vr, pos, window=window,
                                           out_dtype=torch.bfloat16), 5)
            else:
                # the library call: SDPA over the layer's ring with the
                # logical-position mask
                lib = sdpa_ms(q.transpose(1, 2).contiguous(), kr, vr,
                              valid[:, None])
            # the K/V rows some query of the chunk sees, read once (2
            # bytes an element, e4m3 1); q read and the output written once
            # (bf16); 4 D operations per (row, head, valid key)
            n_live = int(valid.any(dim=1).sum())
            b = bound(2 * n_live * h * d * kr.element_size()
                      + 2 * q.numel() * 2, 4 * d * h * int(valid.sum()))
            flash_bulk_attention_batched.launches = 0
            out.update({f"ms{tag}": ms, f"device_ms{tag}": dms,
                        f"plain_ms{tag}": plain, f"library_ms{tag}": lib,
                        f"bound_ms{tag}": b["bound_ms"],
                        f"bound_by{tag}": b["bound_by"], "segments": plan,
                        "segments_bench": flash_encode_segments(
                            bench["cap"])})
            alts = ", ".join(f"{k} {v:.4f}" for k, v in alts.items())
            yard = (f"ring_attention (replaced) "
                    f"{out[f'replaced_ms{tag}']:.4f} ms" if fp8
                    else f"SDPA {lib:.4f} ms")
            log("flash_enc", f"{dt} B={bsz} T={t} cap={n_slots} pos "
                             f"{pos.tolist()[:3]}: kernel {ms:.4f} ms "
                             f"(device {dms:.4f}; {alts}), plain "
                             f"{plain:.4f} ms, {yard} per call; bound "
                             f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            del k_all, v_all, kr, vr
    if "sweep" in sh:
        out.update(_flash_enc_sweep(gen, sh))
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
        _zero_rowinv()
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        sync()
        stats: dict = {}
        w0 = time.monotonic()
        ids = transcribe_offline_ids(engine, samples, timings=stats)
        sync()
        wall = time.monotonic() - w0
        return ids, stats, wall, (banded_attention_batched.launches,
                                  flash_decode.launches,
                                  *_rowinv_launches().values())

    # warm-up outside the measured runs (cuBLAS handles, allocator)
    run(clips[0][:SAMPLE_RATE])
    per_clip = []
    first_ids = None
    counts_total = [0, 0, 0, 0, 0]
    for i, samples in enumerate(clips):
        ids, st, wall, (na, nb, nh, nn, nq) = run(samples)
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
        # the decoder's products: 4 a layer of the prefill, 4 a layer and
        # the table a step; the norms 2 a layer of the prefill and of each
        # step and the final norm a step, and 2 a layer and the final norm
        # of the clip's one bulk encoder pass
        nl, ne = cfg.decoder.n_layers, cfg.encoder.n_layers
        want_h = (4 * nl + (4 * nl + 1) * steps) * _dec_route(cfg, on_gpu)
        want_n = 2 * nl + (2 * nl + 1) * steps + 2 * ne + 1
        # the qkv epilogue: one a layer of the prefill, of each step and of
        # the bulk encoder pass
        want_q = nl * (1 + steps) + ne
        if (nh, nn, nq) != (want_h, want_n, want_q):
            raise AssertionError(f"[slice] clip {i}: bf16_mm, rms_norm and "
                                 f"qkv_rope launches {nh}, {nn}, {nq} != "
                                 f"{want_h}, {want_n}, {want_q}")
        counts_total[0] += na
        counts_total[1] += nb
        counts_total[2] += nh
        counts_total[3] += nn
        counts_total[4] += nq
        n_text = sum(t >= TOKEN_TEXT_MIN for t in ids)
        rec = {
            "clip_s": dur, "tokens": len(ids), "text_tokens": n_text,
            "decode_steps": steps, "encode_ms": st["encode_s"] * 1e3,
            "prefill_ms": st["prefill_s"] * 1e3,
            "decode_ms_per_step": st["decode_s"] * 1e3 / max(steps, 1),
            "x_realtime": dur / wall, "peak_gib": peak / 2**30,
            "banded_launches": na, "flash_launches": nb,
            "bf16_mm_launches": nh, "rms_norm_launches": nn,
            "qkv_rope_launches": nq,
        }
        per_clip.append(rec)
        log("slice", f"clip {i} ({dur:.1f} s): {len(ids)} ids "
                     f"({n_text} text), {steps} decode steps; encode "
                     f"{rec['encode_ms']:.2f} ms, prefill "
                     f"{rec['prefill_ms']:.2f} ms, decode "
                     f"{rec['decode_ms_per_step']:.3f} ms/step, "
                     f"{rec['x_realtime']:.2f}x realtime, peak "
                     f"{rec['peak_gib']:.2f} GiB; launches A={na} B={nb} "
                     f"bf16_mm={nh} rms_norm={nn} qkv_rope={nq}")
        if first_ids is None:
            first_ids = ids
    again, _, _, _ = run(clips[0])
    _zero_rowinv()
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
    _zero_rowinv()
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


def _uncounted(plain):
    """`plain` in a kernel wrapper's place: a `launches` count that stays 0,
    so a graph captured on the plain path (ops/graphs.py reads the count of
    every wrapper it finds) keeps the kernels' counts exact."""
    @functools.wraps(plain)
    def stand_in(*args, rowinv=False, **kwargs):   # the int kernels' plan
        return plain(*args, **kwargs)

    stand_in.launches = 0
    return stand_in


@contextlib.contextmanager
def plain_norms():
    """Routes every norm of the model (decoder, streaming and bulk encoder)
    to torch's, `add_rms_norm_plain` (the residual add, the sum of squares
    in torch's order and the ada scale), through an uncounted stand-in for
    the duration."""
    from voxtral_tpu_torch.models import bulk_encode
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models import encoder as enc_mod
    from voxtral_tpu_torch.ops.norms import add_rms_norm_plain

    mods = (dec_mod, enc_mod, bulk_encode)
    saved = [m.add_rms_norm for m in mods]
    for m in mods:
        m.add_rms_norm = _uncounted(add_rms_norm_plain)
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.add_rms_norm = fn


@contextlib.contextmanager
def plain_qkv_rope(models=("decoder", "encoder", "bulk_encode")):
    """Routes the qkv product's epilogue of the named model modules
    (`models/<name>.py`) to the torch sequence, `qkv_rope_plain` (the
    bias add, the split, `apply_rope_interleaved` and the casts), through
    an uncounted stand-in for the duration."""
    import importlib

    from voxtral_tpu_torch.ops.rope import qkv_rope_plain

    mods = [importlib.import_module(f"voxtral_tpu_torch.models.{m}")
            for m in models]
    saved = [m.qkv_rope for m in mods]
    for m in mods:
        m.qkv_rope = _uncounted(qkv_rope_plain)
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.qkv_rope = fn


@contextlib.contextmanager
def plain_kernels():
    """Routes the decoder's products (int4, int8 and the row-invariant
    bf16), the norms, the qkv epilogues and decode-step row writes to
    their plain PyTorch versions for the duration (the reference side of
    a kernel-path check; attn_impl="xla" keeps flash-decode, flash-encode
    and the bulk encoder's banded kernel off)."""
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.ops import bf16_mm, quant_mm, ring

    saved = (quant_mm.int4_mm, quant_mm.int8_mm, dec_mod.ring_rows_write,
             bf16_mm.bf16_mm)
    quant_mm.int4_mm = _uncounted(quant_mm.int4_mm_plain)
    quant_mm.int8_mm = _uncounted(quant_mm.int8_mm_plain)
    dec_mod.ring_rows_write = ring.ring_rows_write_plain
    bf16_mm.bf16_mm = _uncounted(bf16_mm.bf16_mm_plain)
    try:
        with plain_norms(), plain_qkv_rope():
            yield
    finally:
        (quant_mm.int4_mm, quant_mm.int8_mm, dec_mod.ring_rows_write,
         bf16_mm.bf16_mm) = saved


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
    from voxtral_tpu_torch.ops.quant_mm import int4_mm, int8_mm
    from voxtral_tpu_torch.ops.ring import ring_rows_write
    from voxtral_tpu_torch.parallel import serving as sv
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import (
        padded_clip_mel,
        transcribe_offline_ids,
    )

    from voxtral_tpu_torch.ops.bf16_mm import bf16_mm
    from voxtral_tpu_torch.ops.norms import rms_norm
    from voxtral_tpu_torch.ops.rope import qkv_rope

    on_gpu = device == "cuda"
    counters = (banded_attention_batched, flash_decode, ring_rows_write,
                int4_mm, int8_mm, bf16_mm, rms_norm, qkv_rope)

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
        # every rung decodes through flash-decode (fp8 rings included), the
        # quantized ones their products through their kernel: one a layer
        # product of the prefill, 105 a decode step (the table's included);
        # the float rungs theirs through bf16_mm on the card; the norms 2 a
        # layer of the prefill and of each step, the final norm a step, and
        # those of the one bulk encoder pass; the qkv epilogue one a layer
        # of each of those passes
        quant = 4 * n_layers + (4 * n_layers + 1) * steps
        want = {
            "banded_attention_batched": cfg.encoder.n_layers,
            "flash_decode": n_layers * steps,
            "ring_rows_write": 0,
            "int4_mm": quant if quantize == "int4" else 0,
            "int8_mm": quant if quantize == "int8" else 0,
            "bf16_mm": quant * (_dec_route(rcfg, on_gpu) and not quantize),
            "rms_norm": (2 * n_layers + (2 * n_layers + 1) * steps
                         + 2 * cfg.encoder.n_layers + 1),
            "qkv_rope": n_layers * (1 + steps) + cfg.encoder.n_layers,
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
                ev, _ = device_events(burst)
                st[f"device_ms_per_step_mid_fill{tag}"] = sum(
                    e.time_range.elapsed_us() for e in ev) / 8e3
                st[f"device_events_per_step_mid_fill{tag}"] = len(ev) / 8
                st[f"busy_mid_fill{tag}"] = (busy_us(ev) / 8e3
                                             / st[f"step_ms_mid_fill{tag}"])
            else:
                burst()
            sync()
            n_steps = ran[0]
            got = {f.__name__: f.launches for f in counters}
            want_x = {"banded_attention_batched": 0, "int4_mm": 0,
                      "int8_mm": 0,
                      "flash_decode": n_layers * n_steps * (impl == "auto"),
                      "ring_rows_write": n_layers * n_steps * (impl == "xla"),
                      "bf16_mm": (4 * n_layers + 1) * n_steps
                      * (_dec_route(rcfg, on_gpu) and not quantize),
                      "rms_norm": (2 * n_layers + 1) * n_steps,
                      "qkv_rope": n_layers * n_steps}
            if quantize in ("int4", "int8"):
                want_x[f"{quantize}_mm"] = (4 * n_layers + 1) * n_steps
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


# ---- row invariance of the streaming encoder side --------------------------

# the row counts of the rowinv phase: a B=1 chunk's few rows (T=1 and 2 of
# the unfused buckets, 24 and 50 of -I 0.5 and 1 s feeds), a tile's edge
# (64), larger B=1 chunks (124, 192), the bench's T=512 chunk and a B=16
# transcriber interval (16 x 106)
ROWINV_ROWS = (1, 2, 24, 50, 64, 124, 192, 512, 1696)
# each row count runs twice: on rows [0, n) and on rows [SHIFT, SHIFT + n),
# which puts the same rows at other places in the tile
ROWINV_SHIFT = 7
# (H), bf16_mm: bf16 x bf16 products are exact in f32; only the f32
# summation order differs (the wgmma k16 steps and the cluster's K split
# against cuBLAS), compared relative to max |plain|
BF16_MM_REL_TOL = 1e-5
# the rowinv phase's weight copies a timed call rotates over (the larger
# products' copies exceed the 50 MB L2, as a layer's weights do in a chunk)
ROWINV_COPIES = 4
# the norm kernel against torch's (rms_norm_plain), relative to max
# |plain|: the same f32 function with the sum of squares in another
# order; bf16 outputs round apart by one bf16 step (2^-8 relative) where
# the two f32 values straddle a rounding boundary
RMS_NORM_TOL = {"torch.bfloat16": 2 ** -7, "torch.float32": 1e-5}
# the modes of the norm kernel (ops/norms.py:add_rms_norm): the norm alone
# (the final norms, layer 0's attn_norm), the residual add (the decoder's
# attn_norm), the add with a bias (the encoders' norms), the add with the
# ada scale (the decoder's ffn_norm)
NORM_MODES = ("norm", "add", "bias", "ada")
# where the norm kernel is timed, each in the mode of its layer's ffn_norm:
# the decoder at a decode step's rows (B = 16, 56, 64) and the B=64
# prefill; the encoder at a B=1 stream's 1 s chunk, the ring pool's 8 x 24
# and the bench's "inc" chunk of 512
NORM_TIME_SHAPES = (("dec", 16, "ada"), ("dec", 56, "ada"),
                    ("dec", 64, "ada"), ("dec", 2432, "ada"),
                    ("enc", 50, "bias"), ("enc", 192, "bias"),
                    ("enc", 512, "bias"))
# rowinv: the decoder's prefill rows, B x 38, at these B (the smoke's
# serve and batchinv prefills, the bench's B=56 and B=64)
ROWINV_PREFILL_ROWS = 38
ROWINV_PREFILL_B = (1, 3, 4, 16, 56, 64)
# the stream phase's eager localisation runs: the first seconds of the clip
STREAM_LOCATE_S = 3.0


def rowinv_shapes(cfg) -> dict:
    """(out, in) of every product of the streaming encoder side: a layer's
    four, the adapter's two, the conv stem's two im2col products."""
    e = cfg.encoder
    return {"wqkv": (3 * e.qkv_dim, e.dim), "wo": (e.dim, e.qkv_dim),
            "w13": (2 * e.hidden, e.dim), "w2": (e.dim, e.hidden),
            "adapter_w0": (cfg.adapter_hidden, 4 * e.dim),
            "adapter_w1": (cfg.decoder.dim, cfg.adapter_hidden),
            "conv0": (e.dim, e.conv_kernel * e.n_mel),
            "conv1": (e.dim, e.conv_kernel * e.dim)}


ROWINV_LAYER = ("wqkv", "wo", "w13", "w2")
# the conv stem's products, whose weights the model stores [in, out]
ROWINV_CONV = ("conv0", "conv1")


def bf16_mm_as(x, w, seq: bool, tile_rows=None):
    """ops.bf16_mm.bf16_mm's launch on its plan with the split's way to run
    given (seq True: single blocks, False: clusters) and, if given, the
    tile height, for the checks that each gives the same bits and for the
    times of each; not counted."""
    import torch

    from voxtral_tpu_torch.ops import bf16_mm as bmod
    from voxtral_tpu_torch.ops import cuda_lib

    (rows, k), n = x.shape, w.shape[0]
    sms = cuda_lib.sm_count(x.device)
    lp = bmod.bf16_mm_launch(rows, n, k, sms)
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    tile = tile_rows or lp.tile_rows
    cuda_lib.check(cuda_lib.kernels().vt_bf16_mm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, k,
        len(lp.ranges), int(seq), int(bmod.weight_layout(w)),
        bmod.bf16_mm_blocks(rows, n, k, tile, seq, sms), tile,
        cuda_lib.stream_handle(x.device)), "bf16_mm")
    return out


@contextlib.contextmanager
def cublas_stream():
    """Routes the streaming encoder side (and with it the decoder's
    products, norms and qkv epilogues) through cuBLAS and torch again,
    through stand-ins: float products to torch.mm (`bf16_mm_plain`), the
    int kernels on their row-count plans, the norms to torch's
    (`add_rms_norm_plain`), the qkv epilogues to torch's
    (`qkv_rope_plain`), and T == 1 chunks to `ring_attention`.  The
    stand-ins carry `launches = 0` (ops/graphs.py reads every wrapper's
    count during a capture)."""
    from voxtral_tpu_torch.models import encoder as enc_mod
    from voxtral_tpu_torch.ops import bf16_mm, quant_mm
    from voxtral_tpu_torch.runtime import stream as stream_mod

    def row_plans(fn):
        @functools.wraps(fn)
        def stand_in(x, w, s, li, rowinv=False):
            return fn(x, w, s, li)
        stand_in.launches = 0
        return stand_in

    saved = (bf16_mm.bf16_mm, quant_mm.int4_mm, quant_mm.int8_mm,
             enc_mod.chunk_attention, stream_mod.chunk_attention)
    bf16_mm.bf16_mm = _uncounted(bf16_mm.bf16_mm_plain)
    quant_mm.int4_mm = row_plans(saved[1])
    quant_mm.int8_mm = row_plans(saved[2])
    enc_mod.chunk_attention = stream_mod.chunk_attention = (
        lambda t, cdtype: t > 1)
    try:
        with plain_norms(), plain_qkv_rope():
            yield
    finally:
        (bf16_mm.bf16_mm, quant_mm.int4_mm, quant_mm.int8_mm,
         enc_mod.chunk_attention, stream_mod.chunk_attention) = saved


def _stream_arg(args, kwargs, i: int) -> bool:
    """Whether a call of a function shared with the bulk encoder (its
    `call` argument at position i) is a streaming one."""
    return (args[i] if len(args) > i else kwargs.get("call", "stream")) \
        == "stream"


@contextlib.contextmanager
def encoder_probe(cfg, deep: bool = False, record: bool = True,
                  stream: int = 0):
    """Records the streaming encoder side while it runs: `calls` counts
    its streaming calls (conv0, conv1, encoder chunks, adapter), `rows`
    holds each stage's rows of batch entry `stream` in call order, i.e.
    by position: "mel" (the host mel the stem reads), "conv1" (the conv
    stem), "encoder" (after the final norm), "adapter".  `deep` (eager runs only: a captured graph runs no Python)
    also records inside: conv0 and both products of the stem ("conv0.mm",
    "conv1.mm"), and per layer li "Lli.attn_norm", "Lli.wqkv",
    "Lli.attention", "Lli.wo", "Lli.ffn_norm", "Lli.w13", "Lli.w2",
    "Lli.out", then "final_norm", "adapter.w0", "adapter.w1".  With
    `record` off it only counts.  A StreamPool encode call in which slot
    `stream` takes no part (its taker flag is off: its rows are zeros in,
    garbage out) records nothing for it: the rows are what that slot
    computed."""
    import torch

    from voxtral_tpu_torch.models import bulk_encode
    from voxtral_tpu_torch.models import encoder as enc_mod
    from voxtral_tpu_torch.models import fused_stream
    from voxtral_tpu_torch.parallel import scheduler as sched

    stem_k = cfg.encoder.conv_kernel * cfg.encoder.n_mel
    calls = {"conv": 0, "encoder": 0, "adapter": 0}
    rows: dict = {}
    state = {"layer": None, "norms": 0, "mm": None, "pool": None}
    takes = []     # per pool encode call: whether `stream` takes part

    def put(stage, y):     # y: [B, ..., D]
        if record:
            rows.setdefault(stage, []).append((
                y.detach()[stream].reshape(-1, y.shape[-1]).clone(),
                state["pool"]))

    patches = []

    def patch(mod, name, make):
        patches.append((mod, name, getattr(mod, name)))
        setattr(mod, name, make(getattr(mod, name)))

    def conv(stage, call_at):
        def make(fn):
            def f(*a, **k):
                y = fn(*a, **k)
                if _stream_arg(a, k, call_at):
                    calls["conv"] += 1
                    if stage == "conv0":
                        put("mel", a[1])
                    if deep or stage == "conv1":
                        put(stage, y[0])
                return y
            return f
        return make

    def enc_layers(fn):
        def f(*a, **k):
            y = fn(*a, **k)
            calls["encoder"] += 1
            put("encoder", y)
            return y
        return f

    def adapter(fn):
        def f(*a, **k):
            if not _stream_arg(a, k, 3):
                return fn(*a, **k)
            state["mm"] = "adapter"
            try:
                y = fn(*a, **k)
            finally:
                state["mm"] = None
            calls["adapter"] += 1
            put("adapter", y)
            return y
        return f

    def pool_call(fn):
        def f(*a, **k):    # a[7]: the pool's taker flags [B]
            takes.append(a[7][stream].clone())
            state["pool"] = len(takes) - 1
            try:
                return fn(*a, **k)
            finally:
                state["pool"] = None
        return f

    for mod in (enc_mod, bulk_encode):
        patch(mod, "conv0_chunk", conv("conv0", 4))
        patch(mod, "conv1_chunk", conv("conv1", 4))
    for mod in (enc_mod, fused_stream):
        patch(mod, "encoder_layers", enc_layers)
        patch(mod, "adapter_forward", adapter)
    patch(sched, "pool_encode_ring", pool_call)
    patch(sched, "pool_encode_window", pool_call)
    if deep:
        def layer(fn):
            def f(cfg, cdtype, x, tail, lp, cache, li, *rest):
                state["layer"], state["norms"] = li, 0
                try:
                    x, tail = fn(cfg, cdtype, x, tail, lp, cache, li, *rest)
                finally:
                    state["layer"] = None
                # the layer's output: its FFN output is added in the next
                # norm's call, so the residual is formed here as that
                # call forms it
                y, b = tail
                put(f"L{li:02d}.out", x + (y + b).to(x.dtype))
                return x, tail
            return f

        def norm(fn):
            def f(x, *a, **k):
                x_new, y = fn(x, *a, **k)
                li = state["layer"]
                if li is None:
                    put("final_norm", y)
                else:
                    put(f"L{li:02d}."
                        f"{('attn', 'ffn')[state['norms'] % 2]}_norm", y)
                    state["norms"] += 1
                return x_new, y
            return f

        def product(fn):
            def f(x, lp, name, *a, **k):
                y = fn(x, lp, name, *a, **k)
                li = state["layer"]
                put(f"L{li:02d}.{name}" if li is not None
                    else f"{state['mm'] or 'other'}.{name}", y)
                return y
            return f

        def conv_mm(fn):
            def f(cols, w):
                y = fn(cols, w)
                put("conv0.mm" if cols.shape[-1] == stem_k else "conv1.mm", y)
                return y
            return f

        def attention(fn):
            def f(*a, **k):
                y = fn(*a, **k)
                put(f"L{state['layer']:02d}.attention", y)
                return y
            return f

        patch(enc_mod, "_enc_layer_step", layer)
        patch(enc_mod, "add_rms_norm", norm)
        patch(enc_mod, "mm", product)
        patch(enc_mod, "matmul_rows", conv_mm)
        patch(enc_mod, "matmul_f32", conv_mm)
        patch(enc_mod, "flash_bulk_attention_batched", attention)
        patch(enc_mod, "ring_attention", attention)
    try:
        yield calls, rows
    finally:
        for mod, name, fn in reversed(patches):
            setattr(mod, name, fn)
        took = [bool(t) for t in takes]
        for k in rows:
            rows[k] = torch.cat([y for y, call in rows[k]
                                 if call is None or took[call]])


def first_row_diff(rows_a: dict, rows_b: dict):
    """The first stage (in the order stages were first recorded) at which
    two runs' rows differ bitwise over their common rows, with the first
    such row and the rows compared; None when every stage is equal."""
    for stage, a in rows_a.items():
        b = rows_b.get(stage)
        if a is None or b is None:
            continue
        n = min(a.shape[0], b.shape[0])
        same = (a[:n] == b[:n]) | (a[:n].isnan() & b[:n].isnan())
        bad = (~same.all(dim=-1)).nonzero()
        if bad.numel():
            return {"stage": stage, "row": int(bad[0, 0]), "rows": n}
    return None


@contextlib.contextmanager
def decoder_probe(stream: int = 0):
    """Records the decoder while it runs eagerly (a captured graph runs no
    Python): `rows` holds batch entry `stream`'s rows of each stage in call
    order: "embed" (the step's or prefill's input embeddings), per layer li
    "Lli.attn_norm", "Lli.wqkv", "Lli.attention" (the input of wo),
    "Lli.wo", "Lli.ffn_norm" (after the ada scale), "Lli.w13", "Lli.w2",
    "Lli.out", then "final_norm", "logits", "argmax" and, for a step with
    alternatives,
    "alts" (the argmax's probability and the alternatives', after the
    softmax over the vocabulary)."""
    import torch

    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models import quant

    rows: dict = {}
    state = {"layer": None, "norms": 0}

    def put(stage, y):     # y: [B, ..., D]
        rows.setdefault(stage, []).append(
            y.detach()[stream].reshape(-1, y.shape[-1]).clone())

    patches = []

    def patch(mod, name, make):
        patches.append((mod, name, getattr(mod, name)))
        setattr(mod, name, make(getattr(mod, name)))

    def forward(fn):
        def f(params, cfg, embeds, *a, **k):
            put("embed", embeds)
            return fn(params, cfg, embeds, *a, **k)
        return f

    def layer(fn):
        def f(cfg, cdtype, x, y, lp, ada, cache, li, *rest):
            state["layer"], state["norms"] = li, 0
            try:
                x, y = fn(cfg, cdtype, x, y, lp, ada, cache, li, *rest)
            finally:
                state["layer"] = None
            # the layer's output: its FFN output is added in the next
            # norm's call, so the residual is formed here as that call
            # forms it
            put(f"L{li:02d}.out", x + y.to(x.dtype))
            return x, y
        return f

    def norm(fn):
        def f(x, *a, **k):
            x_new, y = fn(x, *a, **k)
            li = state["layer"]
            if li is None:
                put("final_norm", y)
            else:
                put(f"L{li:02d}.{('attn', 'ffn')[state['norms'] % 2]}_norm",
                    y)
                state["norms"] += 1
            return x_new, y
        return f

    def product(fn):
        def f(x, lp, name, *a, **k):
            li = state["layer"]
            if name == "wo":
                put(f"L{li:02d}.attention", x)
            y = fn(x, lp, name, *a, **k)
            put(f"L{li:02d}.{name}", y)
            return y
        return f

    def logits(fn):
        def f(*a, **k):
            y = fn(*a, **k)
            put("logits", y)
            put("argmax", y.argmax(-1, keepdim=True))
            return y
        return f

    def alts(fn):
        def f(lg, n_alt):
            out = fn(lg, n_alt)
            put("alts", torch.cat([out[1][:, None], out[3]], dim=-1))
            return out
        return f

    patch(dec_mod, "decoder_layers", forward)
    patch(dec_mod, "_layer_step", layer)
    patch(dec_mod, "add_rms_norm", norm)
    patch(quant, "mm", product)
    patch(dec_mod, "final_logits", logits)
    patch(dec_mod, "_alts_from_logits", alts)
    try:
        yield rows
    finally:
        for mod, name, fn in reversed(patches):
            setattr(mod, name, fn)
        for k in rows:
            rows[k] = torch.cat(rows[k])


def ring_rows_diff(cache_a, sa: int, n_a: int, cache_b, sb: int, n_b: int):
    """Where two decoder rings' rows part: stream sa's of cache_a, written
    at positions 0 .. n_a - 1, against stream sb's of cache_b, at 0 ..
    n_b - 1, over the positions both still hold (at slot p % cap), K and V
    of every layer bitwise.  None when all are equal, else the first
    position that differs and how many were compared."""
    import torch

    cap_a, cap_b = cache_a.k.shape[3], cache_b.k.shape[3]
    lo, hi = max(0, n_a - cap_a, n_b - cap_b), min(n_a, n_b)
    p = torch.arange(lo, hi, device=cache_a.k.device)
    same = torch.ones(hi - lo, dtype=torch.bool, device=p.device)
    for a, b in ((cache_a.k, cache_b.k), (cache_a.v, cache_b.v)):
        ra = a[sa][:, :, p % cap_a].view(torch.uint8)
        rb = b[sb][:, :, (p % cap_b).to(b.device)].view(torch.uint8)
        same &= (ra == rb.to(ra.device)).flatten(3).all(-1).all(1).all(0)
    bad = (~same).nonzero()
    if bad.numel():
        return {"position": lo + int(bad[0, 0]), "positions": hi - lo}
    return None


def _call_counter(name: str):
    """A stand-in kernel wrapper: a `launches` count under `name`."""
    def counter():
        pass

    counter.__name__, counter.launches = name, 0
    return counter


# the passes whose norms run on the norm kernel (csrc/rms_norm.cu) on every
# path: the decoder's forward passes (any T) and logits calls, the bulk
# encoder's passes and the streaming encoder's chunks.  With
# decoder_calls() on they count like kernel launches, so a CUDA graph's
# capture records them and its replays add them
DECODER_CALLS = (_call_counter("decoder_layers"),
                 _call_counter("final_logits"))
ENCODER_CALLS = (_call_counter("bulk_transformer"),
                 _call_counter("_encoder_layers"))
_CALLS_ON = [0]


@contextlib.contextmanager
def decoder_calls():
    """Counts the decoder's forward passes and logits calls in
    DECODER_CALLS, and the bulk and streaming encoder's passes in
    ENCODER_CALLS, for the duration, exactly under CUDA graphs: the
    counters ride among ops/graphs.py's counted wrappers.  The decoder's
    share of bf16_mm's launches and every norm launch follow from them
    (_dec_rowinv_want, _norms_want).  Re-entered, it counts once."""
    from voxtral_tpu_torch.models import bulk_encode, jacobi
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models import encoder as enc_mod
    from voxtral_tpu_torch.ops import graphs

    if _CALLS_ON[0]:
        yield
        return

    def counted(fn, counter):
        @functools.wraps(fn)
        def f(*a, **k):
            counter.launches += 1
            return fn(*a, **k)
        return f

    wrappers = graphs.counted_wrappers
    saved = [(m, n, getattr(m, n)) for m in (dec_mod, jacobi)
             for n in ("decoder_layers", "final_logits")]
    saved += [(bulk_encode, "bulk_transformer", bulk_encode.bulk_transformer),
              (enc_mod, "_encoder_layers", enc_mod._encoder_layers)]
    counter = {c.__name__: c for c in DECODER_CALLS + ENCODER_CALLS}
    graphs.counted_wrappers = (lambda: wrappers() + DECODER_CALLS
                               + ENCODER_CALLS)
    for m, n, fn in saved:
        setattr(m, n, counted(fn, counter[n]))
    _CALLS_ON[0] = 1
    try:
        yield
    finally:
        _CALLS_ON[0] = 0
        graphs.counted_wrappers = wrappers
        for m, n, fn in saved:
            setattr(m, n, fn)


def _dec_rowinv_want(cfg, on_gpu: bool, float_weights: bool = True) -> int:
    """bf16_mm's launches by the decoder since DECODER_CALLS were zeroed,
    on the card's row-invariant route (`decoder._use_rowinv`), else 0:
    four a layer per forward pass and one per logits call with float
    decoder weights (the int rungs' go to their kernels)."""
    if not (_dec_route(cfg, on_gpu) and float_weights):
        return 0
    fwd, logits = (c.launches for c in DECODER_CALLS)
    return 4 * cfg.decoder.n_layers * fwd + logits


def _norms_want(cfg) -> int:
    """The norm kernel's launches since the counters were zeroed, on every
    rung and dtype: two a layer per decoder forward pass and one per
    logits call, two a layer and the final norm per encoder pass (bulk or
    streaming chunk).  CPU calls count only through the tests' stand-ins,
    which count every call."""
    fwd, logits = (c.launches for c in DECODER_CALLS)
    enc = sum(c.launches for c in ENCODER_CALLS)
    return (2 * cfg.decoder.n_layers * fwd + logits
            + (2 * cfg.encoder.n_layers + 1) * enc)


def _qkv_rope_want(cfg) -> int:
    """The qkv epilogue kernel's launches since the counters were zeroed,
    on every rung and dtype: one a layer per decoder forward pass and per
    encoder pass (bulk or streaming chunk).  CPU calls count only through
    the tests' stand-ins, which count every call."""
    fwd = DECODER_CALLS[0].launches
    enc = sum(c.launches for c in ENCODER_CALLS)
    return cfg.decoder.n_layers * fwd + cfg.encoder.n_layers * enc


def _dec_route(cfg, on_gpu: bool) -> bool:
    """Whether the decoder runs on the card's row-invariant route
    (`decoder._use_rowinv`): its float products on bf16_mm (an int rung's
    on the int kernels' row-invariant plans)."""
    from voxtral_tpu_torch.models.decoder import _use_rowinv

    return on_gpu and _use_rowinv(cfg.cdtype, "decoder")


def _rowinv_want(cfg, calls: dict, quantized_encoder: bool = False) -> int:
    """bf16_mm's exact launches on a stream's encoder side: one per conv
    call, two per adapter call, four per layer of each encoder chunk when
    its weights are float (the int kernels take them otherwise)."""
    n_layers = cfg.encoder.n_layers
    return (calls["conv"] + 2 * calls["adapter"]
            + (0 if quantized_encoder else 4 * n_layers * calls["encoder"]))


def _rowinv_expect(cfg, calls: dict, on_gpu: bool,
                   quantized: bool = False) -> dict:
    """bf16_mm's launches: _rowinv_want on the card's row-invariant route,
    else 0 (CPU calls never count; float32 configs keep torch.mm), plus
    the decoder's share (_dec_rowinv_want; `quantized`: the encoder's and
    the decoder's weights int, as the stream phase's int pairs run them);
    the norm kernel's (_norms_want) and the qkv epilogue's
    (_qkv_rope_want)."""
    from voxtral_tpu_torch.models.decoder import _use_rowinv

    bf16 = _dec_rowinv_want(cfg, on_gpu, not quantized)
    if on_gpu and _use_rowinv(cfg.cdtype, "stream"):
        bf16 += _rowinv_want(cfg, calls, quantized)
    return {"bf16_mm": bf16, "rms_norm": _norms_want(cfg),
            "qkv_rope": _qkv_rope_want(cfg)}


def _check_rowinv(tag: str, cfg, calls: dict, on_gpu: bool,
                  quantized: bool = False) -> dict:
    """bf16_mm's, the norm kernel's and the qkv epilogue's launches since
    _zero_rowinv, checked exact against _rowinv_expect."""
    got = _rowinv_launches()
    want = _rowinv_expect(cfg, calls, on_gpu, quantized)
    if got != want:
        raise AssertionError(f"[{tag}] row-invariant kernels' launches {got}"
                             f" != {want} ({calls}, decoder and encoder "
                             f"calls {[c.launches for c in DECODER_CALLS]}"
                             f" {[c.launches for c in ENCODER_CALLS]})")
    return got


def _rowinv_launches() -> dict:
    """bf16_mm's, the norm kernel's and the qkv epilogue's counters."""
    from voxtral_tpu_torch.ops import bf16_mm
    from voxtral_tpu_torch.ops.norms import rms_norm
    from voxtral_tpu_torch.ops.rope import qkv_rope

    return {"bf16_mm": bf16_mm.bf16_mm.launches,
            "rms_norm": rms_norm.launches, "qkv_rope": qkv_rope.launches}


def _zero_rowinv() -> None:
    from voxtral_tpu_torch.ops import bf16_mm
    from voxtral_tpu_torch.ops.norms import rms_norm
    from voxtral_tpu_torch.ops.rope import qkv_rope

    bf16_mm.bf16_mm.launches = rms_norm.launches = qkv_rope.launches = 0
    for c in DECODER_CALLS + ENCODER_CALLS:
        c.launches = 0


def _bf16_bound(shapes, rows: int) -> dict:
    """bound of bf16 products [(out, in)] at `rows`: weights (two bytes
    each) and x read once, f32 y written once; 2 operations per weight and
    row."""
    n_bytes = sum(o * i * 2 + rows * i * 2 + rows * o * 4 for o, i in shapes)
    return bound(n_bytes, sum(2 * rows * o * i for o, i in shapes))


# (H) at the decoder's products: as BF16_MM_REL_TOL, over K up to 9216
# (w2; the encoder's largest is 5120), whose f32 sums take more roundings
DEC_MM_REL_TOL = 2e-5
# rowinv: the decoder's products (INT4_SHAPES: the four of a layer and the
# tied table) on bf16_mm, checked at these rows (a step at B = 1, 16, 56,
# 64; the prefills of B = 16, 56, 64) and timed at the decode step's
DEC_ROWINV_ROWS = (1, 16, 56, 64, 608, 2128, 2432)
DEC_ROWINV_TIME_ROWS = (16, 56, 64)


def _norm_inputs(gen, mode: str, rows: int, width: int, dtype,
                 device: str = "cuda"):
    """Seeded inputs of one mode of add_rms_norm (NORM_MODES): x [rows,
    width] in dtype, the weight, and the keywords y (f32, a product's
    output), bias and ada (f32 [width]) the mode takes."""
    import torch

    x = _randn(gen, (rows, width), dtype, device)
    w = torch.rand((width,), generator=gen, device=device) + 0.5
    kw = {}
    if mode != "norm":
        kw["y"] = _randn(gen, (rows, width), torch.float32, device) * 0.5
    if mode == "bias":
        kw["bias"] = _randn(gen, (width,), torch.float32, device) * 0.1
    if mode == "ada":
        kw["ada"] = _randn(gen, (width,), torch.float32, device) * 0.2
    return x, w, kw


def norm_unfused(x, w, eps: float = 1e-5, y=None, bias=None, ada=None):
    """The sequence the layers ran around the norm kernel before its fused
    form: torch's bias add, cast and residual add, the kernel's norm alone
    (`rms_norm`), torch's ada ops and cast."""
    from voxtral_tpu_torch.ops.norms import rms_norm

    if y is not None:
        x = x + (y if bias is None else y + bias).to(x.dtype)
    n = rms_norm(x, w, eps)
    if ada is not None:
        n = (n.float() * (1.0 + ada)).to(x.dtype)
    return x, n


# the decode step's norm side timed as one chain (decode_profile's "norms"
# term): 26 layers' two norms with their residual adds and ada scale, at a
# step's rows
NORM_CHAIN_ROWS = (16, 56, 64)


def norm_chain_ms(fused: bool, rows: int, width: int = 3072,
                  layers: int = 26, device: str = "cuda") -> float:
    """Graph-replay ms of a decode step's norm side without its products
    (one seeded f32 tensor stands in for each product's output), as the
    layers run it: `fused`, two add_rms_norm calls a layer (the ada scale
    in the ffn_norm's); else the sequence before the fused call, torch's
    cast and add, the norm alone (`rms_norm`) and torch's ada ops.  The
    norm is that of the package on sys.path, so a subprocess on another
    checkout times that tree's."""
    import torch

    from voxtral_tpu_torch.ops import norms

    gen = torch.Generator(device=device).manual_seed(rows)
    bf16 = torch.bfloat16
    x0 = _randn(gen, (rows, width), bf16, device)
    y = _randn(gen, (rows, width), torch.float32, device) * 0.5
    w = [torch.rand((width,), generator=gen, device=device) + 0.5
         for _ in range(2 * layers)]
    ada = [_randn(gen, (width,), torch.float32, device) * 0.2
           for _ in range(layers)]

    def chain():
        x, yy = x0, None
        for li in range(layers):
            if fused:
                x, _ = norms.add_rms_norm(x, w[2 * li], y=yy)
                x, _ = norms.add_rms_norm(x, w[2 * li + 1], y=y,
                                          ada=ada[li])
                yy = y
                continue
            norms.rms_norm(x, w[2 * li]).to(bf16)
            x = x + y.to(x.dtype)
            hn = norms.rms_norm(x, w[2 * li + 1]).float()
            (hn * (1.0 + ada[li])).to(bf16)
            x = x + y.to(x.dtype)
        return x

    n0 = norms.rms_norm.launches
    ms = graph_ms(chain, 1)
    norms.rms_norm.launches = n0
    return ms


def _norm_bound(mode: str, rows: int, width: int, x_bytes: int) -> dict:
    """bound of one add_rms_norm call: x and y read once, x_new (with y)
    and the normed rows written once, the weight, bias and ada read once;
    its f32 operations (the square and sum, two products, the add, bias
    and ada) at the card's f32 rate."""
    per = x_bytes * 2 + (4 + x_bytes) * (mode != "norm")
    vec = 4 * width * (1 + (mode == "bias") + (mode == "ada"))
    ops = 4 + (mode != "norm") + (mode == "bias") + 2 * (mode == "ada")
    return bound(rows * width * per + vec, rows * width * ops, F32_FLOPS)


def _norm_times(gen, cfg, device: str = "cuda") -> dict:
    """Graph-replay ms of the norm kernel at NORM_TIME_SHAPES in bf16: the
    fused call in its layer's mode, beside the norm alone, the unfused
    sequence it replaced (norm_unfused, in one graph), torch's
    (add_rms_norm_plain), F.rms_norm (the library's norm alone: no
    PyTorch call computes the fused function) and the bound."""
    import torch
    import torch.nn.functional as F

    from voxtral_tpu_torch.ops.norms import (
        add_rms_norm,
        add_rms_norm_plain,
        rms_norm,
    )

    out = {}
    for kind, n, mode in NORM_TIME_SHAPES:
        width = cfg.decoder.dim if kind == "dec" else cfg.encoder.dim
        x, w, kw = _norm_inputs(gen, mode, n, width, torch.bfloat16, device)
        n0 = rms_norm.launches
        tm = {"ms": graph_ms(lambda: add_rms_norm(x, w, **kw), 20),
              "norm_only_ms": graph_ms(lambda: rms_norm(x, w), 20),
              "unfused_ms": graph_ms(lambda: norm_unfused(x, w, **kw), 20),
              "plain_ms": graph_ms(lambda: add_rms_norm_plain(x, w, **kw),
                                   20),
              "library_ms": graph_ms(lambda: F.rms_norm(
                  x.float(), (width,), w).to(x.dtype), 20),
              **_norm_bound(mode, n, width, 2)}
        rms_norm.launches = n0
        out.update({f"norm_{k}_{kind}{n}": v for k, v in tm.items()})
        log("norm", f"[{n} x {width}] bf16 {mode}: fused {tm['ms']:.4f} ms, "
                    f"norm alone {tm['norm_only_ms']:.4f}, unfused sequence "
                    f"{tm['unfused_ms']:.4f}, torch's "
                    f"{tm['plain_ms']:.4f}, F.rms_norm "
                    f"{tm['library_ms']:.4f} ms; bound "
                    f"{tm['bound_ms']:.6f} ms ({tm['bound_by']})")
    for n in NORM_CHAIN_ROWS:
        tm = {"fused": norm_chain_ms(True, n, cfg.decoder.dim,
                                     cfg.decoder.n_layers, device),
              "unfused": norm_chain_ms(False, n, cfg.decoder.dim,
                                       cfg.decoder.n_layers, device)}
        out.update({f"norm_chain_{k}_ms_dec{n}": v for k, v in tm.items()})
        log("norm", f"a decode step's norm side at {n} rows "
                    f"({cfg.decoder.n_layers} layers): fused "
                    f"{tm['fused']:.4f} ms, unfused sequence "
                    f"{tm['unfused']:.4f} ms")
    return out


# --norm ROOT: the rows at which this tree's norm alone is compared bit for
# bit with ROOT's rms_norm, and at which a layer's norm sequence is
NORM_PARENT_ROWS = (1, 16, 50, 56, 64, 512, 2432)
NORM_PARENT_LAYER_ROWS = {"dec": (16, 56, 64, 2432), "enc": (50, 192, 512)}

_NORM_OTHER_TREE = r"""
import importlib.util, sys, torch
sys.path.insert(0, sys.argv[1])
from voxtral_tpu_torch.ops import norms
from voxtral_tpu_torch.ops.norms import rms_norm
spec = importlib.util.spec_from_file_location("this_smoke", sys.argv[4])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
inp, outs = torch.load(sys.argv[2]), {}
for key, (x, w) in inp["norm"].items():
    x, w = x.cuda(), w.cuda()
    for n in inp["rows"]:
        outs[key + (n,)] = rms_norm(x[:n], w).cpu()
def seq(x, y, b, ada, w):   # the tree's lines around its norm
    x = x + (y if b is None else y + b).to(x.dtype)
    n = rms_norm(x, w)
    if ada is not None:
        n = n.float() * (1.0 + ada)
    return x, n.to(torch.bfloat16)
for key, t in inp["layer"].items():
    x, y, b1, ada, w1, y2, b2, w2 = (None if v is None else v.cuda()
                                     for v in t)
    x1, n1 = seq(x, y, b1, ada, w1)
    x2, n2 = seq(x1, y2, b2, None, w2)
    outs[key] = [v.cpu() for v in (x1, n1, x2, n2)]
# the tree's times at this tree's shapes (chip_smoke._norm_times and
# norm_chain_ms): its norm alone, its sequence around the norm, and its
# fused call where it has one
fused = getattr(norms, "add_rms_norm", None)
gen, times = torch.Generator(device="cuda").manual_seed(19), {}
for kind, n, mode in smoke.NORM_TIME_SHAPES:
    width = inp["widths"][kind]
    x, w, kw = smoke._norm_inputs(gen, mode, n, width, torch.bfloat16)
    times[f"norm_only_ms_{kind}{n}"] = smoke.graph_ms(lambda: rms_norm(x, w),
                                                      20)
    times[f"unfused_ms_{kind}{n}"] = smoke.graph_ms(
        lambda: smoke.norm_unfused(x, w, **kw), 20)
    if fused is not None:
        times[f"ms_{kind}{n}"] = smoke.graph_ms(lambda: fused(x, w, **kw),
                                                20)
for n in smoke.NORM_CHAIN_ROWS:
    times[f"chain_unfused_ms_dec{n}"] = smoke.norm_chain_ms(
        False, n, inp["widths"]["dec"], inp["layers"])
    if fused is not None:
        times[f"chain_fused_ms_dec{n}"] = smoke.norm_chain_ms(
            True, n, inp["widths"]["dec"], inp["layers"])
outs["times"] = times
torch.save(outs, sys.argv[3])
"""


def phase_norm_other_tree(root: str) -> dict:
    """`--norm ROOT`: ROOT's norm (another checkout's package, e.g. the
    parent unpacked with git archive) in a subprocess on the same seeded
    inputs: its rms_norm's rows at NORM_PARENT_ROWS, both widths and
    dtypes, against this tree's norm alone, and its sequence of torch ops
    and norms around a decoder layer's ffn_norm and tail (the wo output
    added, the norm, the ada scale; the w2 output added, the next
    attn_norm) and an encoder layer's (with the biases) against this
    tree's two fused calls: every row gated bit-equal.  The subprocess
    also times ROOT's norm alone, its sequence around the norm and (where
    ROOT has one) its fused call at NORM_TIME_SHAPES, and a decode step's
    norm side (norm_chain_ms) at NORM_CHAIN_ROWS: the "before" of this
    tree's _norm_times in the same call."""
    import tempfile

    import torch

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.ops.norms import add_rms_norm, rms_norm

    cfg = full_config()
    gen = torch.Generator().manual_seed(17)
    f32, bf16 = torch.float32, torch.bfloat16

    def vec(width, scale=None):
        if scale is None:
            return torch.rand((width,), generator=gen) + 0.5
        return torch.randn((width,), generator=gen) * scale

    inp = {"rows": NORM_PARENT_ROWS, "norm": {}, "layer": {},
           "widths": {"dec": cfg.decoder.dim, "enc": cfg.encoder.dim},
           "layers": cfg.decoder.n_layers}
    for width in (cfg.encoder.dim, cfg.decoder.dim):
        for dt in (bf16, f32):
            inp["norm"][(width, str(dt))] = (torch.randn(
                (max(NORM_PARENT_ROWS), width), generator=gen).to(dt),
                vec(width))
    for kind, rows in NORM_PARENT_LAYER_ROWS.items():
        width = cfg.decoder.dim if kind == "dec" else cfg.encoder.dim
        dec = kind == "dec"
        for n in rows:
            def act(scale):
                return torch.randn((n, width), generator=gen) * scale
            inp["layer"][(kind, n)] = (
                act(1.0).to(bf16), act(0.5), None if dec else vec(width, 0.1),
                vec(width, 0.2) if dec else None, vec(width), act(0.5),
                None if dec else vec(width, 0.1), vec(width))
    tmp = tempfile.mkdtemp()
    src, dst = os.path.join(tmp, "in.pt"), os.path.join(tmp, "out.pt")
    torch.save(inp, src)
    run = subprocess.run([sys.executable, "-c", _NORM_OTHER_TREE, root, src,
                          dst, os.path.abspath(__file__)],
                         capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f"[norm] {root}: {run.stderr[-2000:]}")
    other = torch.load(dst)
    shutil.rmtree(tmp)
    n0 = rms_norm.launches
    differ = []
    for key, (x, w) in inp["norm"].items():
        x, w = x.cuda(), w.cuda()
        differ += [key + (n,) for n in NORM_PARENT_ROWS
                   if not torch.equal(rms_norm(x[:n], w).cpu(),
                                      other[key + (n,)])]
    for key, t in inp["layer"].items():
        x, y, b1, ada, w1, y2, b2, w2 = (None if v is None else v.cuda()
                                         for v in t)
        x1, n1 = add_rms_norm(x, w1, y=y, bias=b1, ada=ada)
        x2, n2 = add_rms_norm(x1, w2, y=y2, bias=b2)
        if not all(torch.equal(a.cpu(), b)
                   for a, b in zip((x1, n1, x2, n2), other[key])):
            differ.append(key)
    rms_norm.launches = n0
    log("norm", f"{root}: its rms_norm at rows {NORM_PARENT_ROWS} (widths "
                f"{cfg.encoder.dim} and {cfg.decoder.dim}, bf16 and f32) "
                f"and its torch sequence around a layer's ffn_norm and tail "
                f"(decoder rows {NORM_PARENT_LAYER_ROWS['dec']}, encoder "
                f"{NORM_PARENT_LAYER_ROWS['enc']}) against this tree's "
                + ("norm alone and fused calls: bit-equal" if not differ
                   else f"calls: DIFFER at {differ}"))
    times = other["times"]
    for kind, n, mode in NORM_TIME_SHAPES:
        log("norm", f"{root} [{n} x {inp['widths'][kind]}] bf16 {mode}: "
                    f"its norm alone {times[f'norm_only_ms_{kind}{n}']:.4f}"
                    f" ms, its sequence around the norm "
                    f"{times[f'unfused_ms_{kind}{n}']:.4f} ms"
                    + (f", its fused call {times[f'ms_{kind}{n}']:.4f} ms"
                       if f"ms_{kind}{n}" in times else ""))
    for n in NORM_CHAIN_ROWS:
        log("norm", f"{root}: a decode step's norm side at {n} rows, its "
                    f"sequence {times[f'chain_unfused_ms_dec{n}']:.4f} ms"
                    + (f", its fused calls "
                       f"{times[f'chain_fused_ms_dec{n}']:.4f} ms"
                       if f"chain_fused_ms_dec{n}" in times else ""))
    if differ:
        raise AssertionError(f"[norm] {root} differs at {differ}")
    return {"root": root, "norm_rows": NORM_PARENT_ROWS,
            "layer_rows": NORM_PARENT_LAYER_ROWS, "bit_equal": True,
            "times": times}


def phase_norm(device: str = "cuda", cfg=None,
               rows_list=ROWINV_ROWS) -> dict:
    """The norm kernel (csrc/rms_norm.cu through ops/norms.py:
    add_rms_norm) in every mode of NORM_MODES, at the encoder's width and
    the decoder's, in bf16 and f32: each row's bits (x_new and the normed
    rows) at every row count up to 80, of `rows_list` and (decoder) the
    prefills' B x 38, at two offsets, equal to the same rows of one full
    call; the full call bit-equal to a second call and to the unfused
    sequence it replaced (norm_unfused: torch's cast and add, the norm
    alone, torch's ada ops), x_new bit-equal to torch's, the normed rows
    within RMS_NORM_TOL of torch's (add_rms_norm_plain); one launch a
    call.  Printed beside: where torch's mean of squares gives a row other
    bits (the reason for the kernel).  On the card also the graph-replay
    times (_norm_times).  Run by the rowinv phase and by `--norm`; on the
    CPU (tiny config) the plain version against itself, nothing gated."""
    import torch

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.ops.norms import (
        add_rms_norm,
        add_rms_norm_plain,
        rms_norm,
    )

    on_gpu = device == "cuda"
    cfg = cfg or full_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    out, varies, torch_varies, faults = {}, {}, {}, []
    worst_rel, worst_abs = 0.0, 0.0
    for width, extra in ((cfg.encoder.dim, ()),
                         (cfg.decoder.dim, tuple(b * ROWINV_PREFILL_ROWS
                                                 for b in ROWINV_PREFILL_B))):
        norm_rows = sorted(set(rows_list) | set(range(1, 81)) | set(extra))
        n_max = max(norm_rows) + ROWINV_SHIFT
        for dt, mode in itertools.product((torch.bfloat16, torch.float32),
                                          NORM_MODES):
            x, w, kw = _norm_inputs(gen, mode, n_max, width, dt, device)
            n0 = rms_norm.launches
            full = add_rms_norm(x, w, **kw)
            calls = 1
            again = add_rms_norm(x, w, **kw)
            bad = []
            for n in norm_rows:
                for lo in (0, ROWINV_SHIFT):
                    part = add_rms_norm(
                        x[lo: lo + n], w,
                        **{k: v[lo: lo + n] if k == "y" else v
                           for k, v in kw.items()})
                    if not all(torch.equal(a, b[lo: lo + n])
                               for a, b in zip(part, full)):
                        bad.append((n, lo))
            calls += 1 + 2 * len(norm_rows)
            launched = rms_norm.launches - n0
            unfused = norm_unfused(x, w, **kw)
            rms_norm.launches = n0
            plain = add_rms_norm_plain(x, w, **kw)
            want = plain[1].float()
            err_abs = (full[1].float() - want).abs().max().item()
            err = err_abs / want.abs().max().item()
            worst_abs, worst_rel = max(worst_abs, err_abs), max(worst_rel,
                                                                 err)
            tol = RMS_NORM_TOL[str(dt)]
            tag = f"{mode}_{width}_{str(dt)[6:]}"
            same = {"twice": all(map(torch.equal, full, again)),
                    "unfused": all(map(torch.equal, full, unfused)),
                    "x_new": torch.equal(full[0], plain[0])}
            varies[tag] = bad
            out[f"rms_norm_rel_err_{tag}"] = err
            log("norm", f"[n x {width}] {str(dt)[6:]} {mode}: rows 1..80 "
                        f"and {sorted(set(rows_list) | set(extra))} "
                        f"(+{ROWINV_SHIFT} offset) "
                        + ("bitwise equal to the full call" if not bad
                           else f"DIFFER at {bad}")
                        + "; " + ", ".join(
                            f"{k} {'bit-equal' if v else 'DIFFERS'}"
                            for k, v in same.items())
                        + f"; rel {err:.3e} of torch's (tol {tol}); "
                        f"{launched} launches for {calls} calls")
            if on_gpu and (bad or not all(same.values()) or not err <= tol
                           or launched != calls):
                faults.append((tag, bad, same, err, launched, calls))
            if dt == torch.float32 and mode == "norm":
                sq = x * x
                mean = sq.mean(-1)
                torch_varies[width] = [
                    n for n in norm_rows
                    if not torch.equal(sq[:n].mean(-1), mean[:n])]
            del x, kw, full, again, unfused, plain
        log("norm", f"torch's rms_norm [n x {width}]: its f32 mean of "
                    f"squares gives a row other bits than the full call at "
                    f"rows {torch_varies[width] or 'none'}")
    if faults:
        raise AssertionError(f"[norm] the norm kernel: {faults}")
    out.update({"torch_rms_norm_varies_at": torch_varies,
                "rms_norm_varies_at": varies,
                "max_abs_err_rms_norm": worst_abs,
                "max_rel_err_rms_norm": worst_rel})
    if on_gpu:
        out.update(_norm_times(gen, cfg, device))
    return out


# qkv_rope: the kernel's shapes on the main path, name: (B, T, model, bias,
# table shared by the batch, q dtype, k/v dtype): a decode step at B=64, a
# ring encoder chunk at B=56 T=25, a bulk encoder layer at 64 clips of 60 s
QKV_ROPE_SHAPES = {
    "step_b64": (64, 1, "decoder", False, False, "bfloat16", "float32"),
    "ring_b56_t25": (56, 25, "encoder", True, False, "bfloat16", "float32"),
    "bulk_b64_t3196": (64, 3196, "encoder", True, True, "bfloat16",
                       "bfloat16"),
}
# the shape that summarises the kernel in the kernels line
QKV_ROPE_SUMMARY = "step_b64"


def _qkv_rope_bound(rows: int, t: int, heads: int, kv_heads: int, d: int,
                    bias: bool, shared: bool, q_bytes: int, kv_bytes: int,
                    v_written: bool) -> dict:
    """bound of one qkv_rope call: the q and k columns of qkv read once
    (and the v columns where v is written), q, k (and v) written once, the
    cos and sin rows (one set for a shared table) and the bias read once;
    its f32 operations (a rotated element's two products and a sum or
    difference, the bias add) at the card's f32 rate."""
    q_dim, kv_dim = heads * d, kv_heads * d
    cols = q_dim + kv_dim * (1 + v_written)
    n_bytes = (rows * cols * 4 + rows * q_dim * q_bytes
               + rows * kv_dim * kv_bytes * (1 + v_written)
               + (t if shared else rows) * d * 4
               + bias * (q_dim + 2 * kv_dim) * 4)
    n_ops = rows * (3 * (q_dim + kv_dim) + bias * cols)
    return bound(n_bytes, n_ops, F32_FLOPS)


def phase_qkv_rope(device: str = "cuda", cfg=None,
                   shapes=QKV_ROPE_SHAPES) -> dict:
    """The qkv epilogue kernel (csrc/qkv_rope.cu through ops/rope.py:
    qkv_rope) at each of `shapes` with the model's heads and rope theta,
    on seeded qkv, biases and `rope_cos_sin` tables (a row's own at
    staggered positions, or the batch's shared one): q, k and v bit-equal
    to the torch sequence it replaced (qkv_rope_plain) and to a second
    call, one launch a call, v a view of qkv exactly where no bias and an
    f32 v leave nothing to write.  On the card also the graph-replay ms of
    the kernel and of the torch sequence (a layer's call repeated once a
    layer of a pass, twice at the bulk shape), the torch sequence's kernels
    a call, and the bound.  On the CPU both sides are the plain version,
    nothing gated."""
    import torch

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.ops.rope import (
        qkv_rope,
        qkv_rope_plain,
        rope_cos_sin,
    )

    on_gpu = device == "cuda"
    cfg = cfg or full_config()
    gen = torch.Generator(device=device)
    out, faults = {}, []
    for name, (bsz, t, model, has_bias, shared, qdt, kvdt) in shapes.items():
        mc = getattr(cfg, model)
        h, kh, d = mc.n_heads, mc.n_kv_heads, mc.head_dim
        qdt, kvdt = getattr(torch, qdt), getattr(torch, kvdt)
        gen.manual_seed(len(name))
        width = (h + 2 * kh) * d
        qkv = torch.randn((bsz, t, width), generator=gen,
                          device=device) * 3.0
        pos = torch.arange(t, dtype=torch.int32, device=device)
        if not shared:
            pos = pos + torch.randint(0, 3000, (bsz, 1), generator=gen,
                                      dtype=torch.int32, device=device)
        cos, sin = rope_cos_sin(pos, d, mc.rope_theta)
        bias = (torch.randn((width,), generator=gen, device=device) * 0.1
                if has_bias else None)
        kw = dict(n_heads=h, n_kv_heads=kh, head_dim=d, bias=bias,
                  q_dtype=qdt, kv_dtype=kvdt)
        n0 = qkv_rope.launches
        got = qkv_rope(qkv, cos, sin, **kw)
        again = qkv_rope(qkv, cos, sin, **kw)
        launched = qkv_rope.launches - n0
        want = qkv_rope_plain(qkv, cos, sin, **kw)
        view = bias is None and kvdt == torch.float32
        same = {"plain": all(map(torch.equal, got, want)),
                "twice": all(map(torch.equal, got, again)),
                "v_view": (got[2].data_ptr() == qkv.data_ptr()
                           + (h + kh) * d * 4) == view}
        rec = {f"{k}_equal": v for k, v in same.items()}
        rec["launches_per_call"] = launched / 2
        if on_gpu:
            reps = 2 if t > 64 else mc.n_layers
            n1 = qkv_rope.launches
            rec.update({
                "ms": graph_ms(lambda: qkv_rope(qkv, cos, sin, **kw), reps),
                "plain_ms": graph_ms(lambda: qkv_rope_plain(qkv, cos, sin,
                                                            **kw), reps),
                "library_ms": None,
                "plain_kernels": len(device_events(
                    lambda: qkv_rope_plain(qkv, cos, sin, **kw))[0]),
                **_qkv_rope_bound(bsz * t, t, h, kh, d, has_bias, shared,
                                  qdt.itemsize, kvdt.itemsize, not view)})
            qkv_rope.launches = n1
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            if not all(same.values()) or launched != 2:
                faults.append((name, same, launched))
        out.update({f"qkv_rope_{k}_{name}": v for k, v in rec.items()})
        log("qkv_rope", f"{name} [{bsz} x {t} x {width}] {model}"
                        + (" + bias" if has_bias else "")
                        + (", shared table" if shared else "")
                        + f", q {str(qdt)[6:]}, k/v {str(kvdt)[6:]}: "
                        + ", ".join(f"{k} {'bit-equal' if v else 'DIFFERS'}"
                                    for k, v in same.items())
                        + f"; {launched} launches for 2 calls"
                        + (f"; graph replay {rec['ms']:.4f} ms, torch "
                           f"sequence {rec['plain_ms']:.4f} ms "
                           f"({rec['plain_kernels']} kernels); bound "
                           f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                           f"{rec['bound_share']:.1%} of it"
                           if on_gpu else ""))
        del qkv, cos, sin, bias, got, again, want
        if on_gpu:
            torch.cuda.empty_cache()
    if faults:
        raise AssertionError(f"[qkv_rope] the qkv epilogue kernel: {faults}")
    return out


def _decoder_products(gen, device: str = "cuda") -> dict:
    """bf16_mm on the decoder's five products at full width (the route the
    decoder takes since it is row-invariant): at each row count of
    DEC_ROWINV_ROWS rows [0, n) and [SHIFT, SHIFT + n) bitwise equal to
    one call over the most rows, within DEC_MM_REL_TOL of torch.mm;
    graph-replay times at DEC_ROWINV_TIME_ROWS (ROWINV_COPIES weight
    copies rotating) against torch.mm(out_dtype=f32), the path it
    replaced, with bounds, and their sums over a decode step's 105
    products (26 layers and the table)."""
    import torch

    from voxtral_tpu_torch.ops import bf16_mm as bmod

    out = {}
    n_max = max(DEC_ROWINV_ROWS) + ROWINV_SHIFT
    step = {n: {"ms": 0.0, "mm_ms": 0.0} for n in DEC_ROWINV_TIME_ROWS}
    for name, (o, i) in INT4_SHAPES.items():
        w = _randn(gen, (ROWINV_COPIES, o, i), torch.bfloat16, device) * 0.02
        x = _randn(gen, (n_max, i), torch.bfloat16, device)
        n0 = bmod.bf16_mm.launches
        ref = bmod.bf16_mm(x, w[0])
        want = torch.mm(x, w[0].t(), out_dtype=torch.float32)
        rel = ((ref - want).abs().max() / want.abs().max()).item()
        bad = [(n, lo) for n in DEC_ROWINV_ROWS for lo in (0, ROWINV_SHIFT)
               if not torch.equal(bmod.bf16_mm(x[lo: lo + n], w[0]),
                                  ref[lo: lo + n])]
        bmod.bf16_mm.launches = n0
        del want
        if bad or not rel <= DEC_MM_REL_TOL:
            raise AssertionError(f"[rowinv] decoder {name} [{o}x{i}]: rows "
                                 f"differ at {bad} or rel {rel}")
        per = 1 if name == "logits" else INT4_LAYERS
        for n in DEC_ROWINV_TIME_ROWS:
            xn = x[:n]
            tm = {"ms": graph_ms(_rotating(
                lambda li: bmod.bf16_mm(xn, w[li]), ROWINV_COPIES),
                ROWINV_COPIES),
                **{f"{tag}_ms": graph_ms(_rotating(
                    lambda li: bf16_mm_as(xn, w[li], seq, tile),
                    ROWINV_COPIES), ROWINV_COPIES)
                    for tag, seq, tile in (("seq", True, None),
                                           ("cluster", False, 64))},
                "mm_ms": graph_ms(_rotating(
                    lambda li: torch.mm(xn, w[li].t(),
                                        out_dtype=torch.float32),
                    ROWINV_COPIES), ROWINV_COPIES),
                **_bf16_bound([(o, i)], n)}
            bmod.bf16_mm.launches = n0
            for k, v in tm.items():
                out[f"dec_{name}_{k}_rows{n}"] = v
            step[n]["ms"] += per * tm["ms"]
            step[n]["mm_ms"] += per * tm["mm_ms"]
            parent = dict(zip(DEC_ROWINV_TIME_ROWS,
                              PARENT_BF16_DEC_MS.get(name, ()))).get(n)
            log("rowinv", f"decoder {name} [{o}x{i}] at {n} rows: bf16_mm "
                          f"{tm['ms']:.4f} ms (the parent's {parent}; "
                          f"single blocks "
                          f"{tm['seq_ms']:.4f}, clusters "
                          f"{tm['cluster_ms']:.4f}), torch.mm "
                          f"{tm['mm_ms']:.4f} ms "
                          f"({tm['ms'] / tm['mm_ms']:.2f}x), bound "
                          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']})")
        log("rowinv", f"decoder {name} [{o}x{i}]: rows {DEC_ROWINV_ROWS} "
                      f"(+{ROWINV_SHIFT}) bitwise equal to the full call, "
                      f"rel {rel:.3e} of torch.mm (tol {DEC_MM_REL_TOL})")
        del w, x, ref
    shapes105 = ([INT4_SHAPES[k] for k in ("wqkv", "wo", "w13", "w2")]
                 * INT4_LAYERS + [INT4_SHAPES["logits"]])
    for n, tm in step.items():
        tm.update(_bf16_bound(shapes105, n))
        for k, v in tm.items():
            out[f"dec_step105_{k}_rows{n}"] = v
        log("rowinv", f"a decode step's 105 products at {n} rows (summed): "
                      f"bf16_mm {tm['ms']:.3f} ms (the parent's "
                      f"{PARENT_BF16_STEP105_MS.get(n)}), torch.mm "
                      f"{tm['mm_ms']:.3f} ms ({tm['ms'] / tm['mm_ms']:.2f}x),"
                      f" bound {tm['bound_ms']:.3f} ms ({tm['bound_by']})")
    return out


# rowinv: the int8 kernel's row-invariant plan on the decoder's products,
# checked at DEC_ROWINV_ROWS and across its tiles' edges (64-row and
# 128-row tiles), timed at DEC_ROWINV_TIME_ROWS
DEC_INT8_ROWS = tuple(sorted(set(DEC_ROWINV_ROWS)
                             | {2, 63, 65, 127, 128, 129}))


def decoder_shapes(cfg) -> dict:
    """(out, in) of the decoder's five products (INT4_SHAPES at full
    width): a layer's four and the tied table."""
    d = cfg.decoder
    qkv = (d.n_heads + 2 * d.n_kv_heads) * d.head_dim
    return {"wqkv": (qkv, d.dim), "wo": (d.dim, d.n_heads * d.head_dim),
            "w13": (2 * d.hidden, d.dim), "w2": (d.dim, d.hidden),
            "logits": (d.vocab_size, d.dim)}


def _int8_decoder_products(gen, device: str = "cuda", cfg=None) -> dict:
    """The int8 kernel's row-invariant plan (int8_mm(rowinv=True), every
    decoder call of the int8 rung) on the decoder's five products at full
    width, weights quantized from random bf16 ones: at each row count of
    DEC_INT8_ROWS rows [0, n) and [SHIFT, SHIFT + n) bitwise equal to one
    call over the most rows, within INT8_REL_TOL of plain, two calls
    bitwise equal; graph-replay times at DEC_ROWINV_TIME_ROWS (ROWINV_COPIES
    layers rotating) against its row-count plan, torch.mm(out_dtype=f32)
    on the bf16 weights and the bound, and their sums over a decode step's
    105 products.  `cfg` (a tiny config) rehearses it on the CPU, where
    nothing bitwise is gated."""
    import torch

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.models.quant import _quantize
    from voxtral_tpu_torch.ops import quant_mm

    on_gpu = device == "cuda"
    shapes = decoder_shapes(cfg or full_config())
    n_layers = (cfg or full_config()).decoder.n_layers
    out = {}
    n_max = max(DEC_INT8_ROWS) + ROWINV_SHIFT
    keys = ("ms", "rowplan_ms", "mm_ms")
    step = {n: dict.fromkeys(keys, 0.0) for n in DEC_ROWINV_TIME_ROWS}
    mm = quant_mm.int8_mm
    for name, (o, i) in shapes.items():
        copies = 2 if name == "logits" else ROWINV_COPIES
        w = _randn(gen, (copies, o, i), torch.bfloat16, device) * 0.02
        q8, s8 = _quantize(w)
        s8 = s8.squeeze(-1).contiguous()
        x = _randn(gen, (n_max, i), torch.bfloat16, device)
        n0 = mm.launches
        ref = mm(x, q8, s8, 0, rowinv=True)
        same = torch.equal(ref, mm(x, q8, s8, 0, rowinv=True))
        want = quant_mm.int8_mm_plain(x, q8, s8, 0)
        rel = ((ref - want).abs().max() / want.abs().max()).item()
        del want
        bad = [(n, lo) for n in DEC_INT8_ROWS for lo in (0, ROWINV_SHIFT)
               if not torch.equal(mm(x[lo: lo + n], q8, s8, 0, rowinv=True),
                                  ref[lo: lo + n])]
        mm.launches = n0
        if bad and on_gpu or not same or not rel <= INT8_REL_TOL:
            raise AssertionError(f"[rowinv] int8 decoder {name} [{o}x{i}]: "
                                 f"rows differ at {bad}, two calls "
                                 f"{'equal' if same else 'DIFFER'}, rel {rel}")
        log("rowinv", f"int8 decoder {name} [{o}x{i}]: rows {DEC_INT8_ROWS} "
                      f"(+{ROWINV_SHIFT}) "
                      + ("bitwise equal to the full call" if not bad
                         else f"DIFFER at {bad}") + ", "
                      f"two calls equal, rel {rel:.3e} of plain (tol "
                      f"{INT8_REL_TOL})")
        out[f"int8_dec_{name}_rel_err"] = rel
        per = 1 if name == "logits" else n_layers
        for n in DEC_ROWINV_TIME_ROWS if on_gpu else ():
            xn = x[:n]
            tm = {"ms": graph_ms(_rotating(
                      lambda li: mm(xn, q8, s8, li, rowinv=True), copies),
                      copies),
                  "rowplan_ms": graph_ms(_rotating(
                      lambda li: mm(xn, q8, s8, li), copies), copies),
                  "mm_ms": graph_ms(_rotating(
                      lambda li: torch.mm(xn, w[li].t(),
                                          out_dtype=torch.float32), copies),
                      copies),
                  **_int8_bound([(o, i)], n)}
            mm.launches = n0
            for k, v in tm.items():
                out[f"int8_dec_{name}_{k}_rows{n}"] = v
            for k in keys:
                step[n][k] += per * tm[k]
            log("rowinv", f"int8 decoder {name} [{o}x{i}] at {n} rows: "
                          f"row-invariant plan {tm['ms']:.4f} ms, row-count "
                          f"plan {tm['rowplan_ms']:.4f}, torch.mm (bf16 "
                          f"weights) {tm['mm_ms']:.4f}, bound "
                          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']})")
        del w, q8, s8, x, ref
    shapes105 = ([shapes[k] for k in ROWINV_LAYER] * n_layers
                 + [shapes["logits"]])
    for n, tm in (step.items() if on_gpu else ()):
        tm.update(_int8_bound(shapes105, n))
        for k, v in tm.items():
            out[f"int8_dec_step105_{k}_rows{n}"] = v
        log("rowinv", f"int8: a decode step's 105 products at {n} rows "
                      f"(summed): row-invariant plan {tm['ms']:.3f} ms, "
                      f"row-count plan {tm['rowplan_ms']:.3f}, torch.mm "
                      f"(bf16 weights) {tm['mm_ms']:.3f}, bound "
                      f"{tm['bound_ms']:.3f} ms ({tm['bound_by']})")
    return out


def phase_rowinv(device: str = "cuda", cfg=None,
                 rows_list=ROWINV_ROWS) -> dict:
    """The row-invariant products of the streaming encoder side: (H)
    bf16_mm (csrc/bf16_mm.cu) on every product of `rowinv_shapes` (full
    width unless `cfg`), and the int8 and int4 kernels on their
    row-invariant plans on a layer's four products.  At each row count n
    of `rows_list` each kernel's rows [0, n) and [SHIFT, SHIFT + n) must be
    bitwise equal to the same rows of one call over max(n) + SHIFT rows,
    and row n - 1 computed alone to its row there; the full call within
    tolerance of the plain version, two calls bitwise equal, one launch a
    call.  It prints at which row counts torch.mm gives a row other bits
    than the full call (the fault the kernels repair), and fails if the
    norm kernel (ops/norms.py:rms_norm) does so at any row count up to 80
    or of `rows_list`.  On the card also the plans against
    the card's occupancy and graph-replay times at every shape and row
    count (layer copies rotating): bf16_mm against
    torch.mm(out_dtype=f32), each int kernel's row-invariant plan against
    its row-count plan, each with its bound.  A tiny CPU config rehearses
    it (plain functions; nothing bitwise is gated: CPU products are not
    row-invariant)."""
    import torch

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.models.quant import _quantize, _quantize4
    from voxtral_tpu_torch.ops import bf16_mm as bmod
    from voxtral_tpu_torch.ops import cuda_lib, quant_mm

    on_gpu = device == "cuda"
    cfg = cfg or full_config()
    shapes = rowinv_shapes(cfg)
    n_max = max(rows_list) + ROWINV_SHIFT
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    out = {}
    worst = {"bf16": 0.0, "int8": 0.0, "int4": 0.0}
    if on_gpu:
        sms = cuda_lib.sm_count(0)
        lib = cuda_lib.kernels()
        for (tr, seq), w_t in itertools.product(BF16_VARIANTS,
                                                (False, True)):
            got = lib.vt_bf16_mm_occupancy(int(seq), int(w_t), tr)
            assumed = bmod.bf16_mm_blocks_per_sm(tr, seq)
            log("rowinv", f"bf16_mm {tr}-row tile, "
                          f"{'single blocks' if seq else 'cluster'} "
                          f"{'[K, out]' if w_t else '[out, K]'} weights, "
                          f"{bmod.bf16_mm_stages(tr, seq)} stages: "
                          f"{bmod.bf16_mm_smem(tr, seq)} bytes of shared "
                          f"memory, {got} blocks per SM (the launch assumes "
                          f"{assumed})")
            if got < assumed:
                raise AssertionError(f"[rowinv] bf16_mm {tr} rows seq={seq} "
                                     f"w_t={w_t}: the card holds {got} "
                                     f"blocks per SM, the plan assumes "
                                     f"{assumed}")
        for name, (o, i) in shapes.items():
            plans = [f"bf16 {bmod.bf16_mm_plan(o, i, sms)}"]
            if name in ROWINV_LAYER:
                plans += [f"int8 {quant_mm.int8_mm_rowinv_plan(o, i, sms)}",
                          f"int4 {quant_mm.int4_mm_rowinv_plan(o, i // 2, sms)}"]
            log("rowinv", f"plans {name} [{o}x{i}]: " + "; ".join(plans))

    def kinds(name, o, i):
        """(kind, kernel(x, li), plain(x, li), row-count plan or None,
        weight(li) [o, i]) of the product `name`, on ROWINV_COPIES layers of
        random weights; the conv stem's stored [i, o] as the model holds
        them, read through their transpose views."""
        if name in ROWINV_CONV:
            wk = _randn(gen, (ROWINV_COPIES, i, o), torch.bfloat16,
                        device) * 0.02
            wv = lambda li: wk[li].t()  # noqa: E731
        else:
            w = _randn(gen, (ROWINV_COPIES, o, i), torch.bfloat16,
                       device) * 0.02
            wv = lambda li: w[li]  # noqa: E731
        yield ("bf16", lambda x, li: bmod.bf16_mm(x, wv(li)),
               lambda x, li: bmod.bf16_mm_plain(x, wv(li)), None, wv)
        if name not in ROWINV_LAYER:
            return
        q8, s8 = _quantize(w)
        s8 = s8.squeeze(-1).contiguous()
        yield ("int8",
               lambda x, li: quant_mm.int8_mm(x, q8, s8, li, rowinv=True),
               lambda x, li: quant_mm.int8_mm_plain(x, q8, s8, li),
               lambda x, li: quant_mm.int8_mm(x, q8, s8, li), wv)
        q4, s4 = _quantize4(w)
        yield ("int4",
               lambda x, li: quant_mm.int4_mm(x, q4, s4, li, rowinv=True),
               lambda x, li: quant_mm.int4_mm_plain(x, q4, s4, li),
               lambda x, li: quant_mm.int4_mm(x, q4, s4, li), wv)

    counter = {"bf16": bmod.bf16_mm, "int8": quant_mm.int8_mm,
               "int4": quant_mm.int4_mm}
    mm_varies, checked = {}, 0
    for name, (o, i) in shapes.items():
        x = _randn(gen, (n_max, i), torch.bfloat16, device)
        for kind, fn, plain, row_plan, wv in kinds(name, o, i):
            wrapper = counter[kind]
            n0 = wrapper.launches
            ref = fn(x, 0)
            again = fn(x, 0)
            if on_gpu and wrapper.launches != n0 + 2:
                raise AssertionError(f"[rowinv] {kind} {name}: "
                                     f"{wrapper.launches - n0} launches for "
                                     "two calls")
            want = plain(x, 0)
            if not bool(torch.isfinite(ref).all()):
                raise AssertionError(f"[rowinv] {kind} {name}: non-finite")
            err = (ref - want).abs().max().item()
            rel = err / want.abs().max().item()
            worst[kind] = max(worst[kind], err)
            bad = []
            for n in rows_list:
                for lo in (0, ROWINV_SHIFT):
                    if not torch.equal(fn(x[lo: lo + n], 0), ref[lo: lo + n]):
                        bad.append((n, lo))
                if not torch.equal(fn(x[n - 1: n], 0), ref[n - 1: n]):
                    bad.append((n, "alone"))
                checked += 1
            log("rowinv", f"{kind} {name} [{o}x{i}] at rows {rows_list} "
                          f"(+{ROWINV_SHIFT} offset, the last row alone): "
                          f"{'bitwise equal to the full call' if not bad else f'DIFFERS at {bad}'}"
                          f"; rel {rel:.3e} of plain (tol "
                          f"{BF16_MM_REL_TOL}), two calls "
                          f"{'equal' if torch.equal(ref, again) else 'DIFFER'}")
            if on_gpu and (bad or not torch.equal(ref, again)
                           or not rel <= BF16_MM_REL_TOL):
                raise AssertionError(f"[rowinv] {kind} {name}: rows differ "
                                     f"{bad} or rel {rel} or two calls "
                                     "differ")
            if kind == "bf16" and on_gpu:
                full = torch.mm(x, wv(0).t(), out_dtype=torch.float32)
                mm_varies[name] = [
                    n for n in rows_list
                    if not torch.equal(torch.mm(x[:n], wv(0).t(),
                                                out_dtype=torch.float32),
                                       full[:n])]
            if not on_gpu:
                continue
            if kind == "bf16":
                # the split's two ways to run (the cluster on its 64-row
                # tile), bitwise, and the weights' two layouts
                bad = [n for n in rows_list
                       if not torch.equal(bf16_mm_as(x[:n], wv(0), True),
                                          bf16_mm_as(x[:n], wv(0), False,
                                                     64))]
                flip = (wv(0).t().contiguous().t() if wv(0).is_contiguous()
                        else wv(0).contiguous())
                if bad or not torch.equal(bmod.bf16_mm(x, flip), ref):
                    raise AssertionError(f"[rowinv] bf16 {name}: single "
                                         f"blocks and clusters differ at "
                                         f"rows {bad}, or the two weight "
                                         "layouts differ")
            for n in rows_list:
                xn = x[:n]
                if kind == "bf16":   # both ways timed; "ms" the one it takes
                    tm = {f"{tag}_ms": graph_ms(_rotating(
                        lambda li: bf16_mm_as(xn, wv(li), seq, tile),
                        ROWINV_COPIES), ROWINV_COPIES)
                        for tag, seq, tile in (("seq", True, None),
                                               ("cluster", False, 64))}
                    tm["ms"] = tm["seq_ms" if bmod.bf16_mm_seq(
                        n, o, i, sms) else "cluster_ms"]
                else:
                    tm = {"ms": graph_ms(_rotating(lambda li: fn(xn, li),
                                                   ROWINV_COPIES),
                                         ROWINV_COPIES)}
                if kind == "bf16":
                    tm["mm_ms"] = graph_ms(_rotating(
                        lambda li: torch.mm(xn, wv(li).t(),
                                            out_dtype=torch.float32),
                        ROWINV_COPIES), ROWINV_COPIES)
                    tm.update(_bf16_bound([(o, i)], n))
                else:
                    tm["rowplan_ms"] = graph_ms(_rotating(
                        lambda li: row_plan(xn, li), ROWINV_COPIES),
                        ROWINV_COPIES)
                    tm.update((_int8_bound if kind == "int8" else _int4_bound)(
                        [(o, i)], n))
                for k, v in tm.items():
                    out[f"{kind}_{k}_{name}_rows{n}"] = v
        del x
    # the norms (csrc/rms_norm.cu, every mode of add_rms_norm)
    out.update(phase_norm(device, cfg, rows_list))
    if on_gpu:
        log("rowinv", "torch.mm(out_dtype=f32) gives a row other bits than "
                      "the full call at rows: " + "; ".join(
                          f"{k} {v}" for k, v in mm_varies.items()))
    out.update({"torch_mm_varies_at": mm_varies,
                "checked": checked, "max_abs_err_bf16": worst["bf16"],
                "max_abs_err_int8": worst["int8"],
                "max_abs_err_int4": worst["int4"]})
    if on_gpu:
        _rowinv_summary(out, shapes, rows_list)
        out.update(_decoder_products(gen, device))
    out.update(_int8_decoder_products(gen, device,
                                      None if on_gpu else cfg))
    _zero_rowinv()
    quant_mm.int8_mm.launches = quant_mm.int4_mm.launches = 0
    return out


# the previous design's times (PERF.md section 6, runs F6 and C4: the
# 64-row tile, both warpgroups loading and computing) printed beside this
# run's: an encoder layer's four products by rows, a decode step's 105 and
# each decoder product by rows
PARENT_BF16_LAYER_MS = {1: 0.0554, 64: 0.0572, 512: 0.1541, 1696: 0.3794}
PARENT_BF16_STEP105_MS = {16: 3.269, 56: 3.332, 64: 3.365}
PARENT_BF16_DEC_MS = {  # the decoder's products by rows 16 / 56 / 64
    "wqkv": (0.0266, 0.0275, 0.0278), "wo": (0.0141, 0.0142, 0.0143),
    "w13": (0.0477, 0.0490, 0.0496), "w2": (0.0258, 0.0265, 0.0268),
    "logits": (0.2965, 0.2848, 0.2865)}


# the bf16_mm sweep (--bf16): every product of the streaming encoder side
# at these rows, the decoder's at a decode step's and the prefills'
BF16_SWEEP_ENC_ROWS = (1, 16, 64, 100, 124, 128, 192, 256, 512, 1024, 1696)
BF16_SWEEP_DEC_ROWS = (16, 56, 64, 128, 608, 2432)
# its variants: (tile rows, single blocks); the clusters run the 64-row
# tile only
BF16_VARIANTS = ((64, True), (64, False), (128, True))
# the rows at which --bf16 ROOT compares this tree's bits with ROOT's
BF16_PARENT_ROWS = (1, 64, 124, 512)

_BF16_OTHER_TREE = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from voxtral_tpu_torch.ops.bf16_mm import bf16_mm
shapes, rows = eval(sys.argv[2]), eval(sys.argv[3])
outs = {}
for name, (o, i) in shapes.items():
    g = torch.Generator(device="cuda").manual_seed(o * 7 + i)
    w = (torch.randn((o, i), generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    x = torch.randn((max(rows), i), generator=g, device="cuda").to(
        torch.bfloat16)
    for n in rows:
        outs[(name, n)] = bf16_mm(x[:n], w).cpu()
torch.save(outs, sys.argv[4])
"""


def phase_bf16_sweep(root=None) -> dict:
    """`--bf16 [ROOT]`: bf16_mm (csrc/bf16_mm.cu) at each tile height and
    each way of running the split (BF16_VARIANTS), forced, at every
    product of the
    streaming encoder side (BF16_SWEEP_ENC_ROWS) and of the decoder
    (BF16_SWEEP_DEC_ROWS), beside the wrapper's own choice and
    torch.mm(out_dtype=f32): graph-replay ms, weight copies rotating.
    Every variant's rows are gated bit-equal to the wrapper's call (the
    choice moves only time); the data the tile-height and split rules of
    ops/bf16_mm.py are read off.  With ROOT (another checkout's package,
    e.g. the parent unpacked with git archive), that package's bf16_mm
    runs in a subprocess on the same seeded inputs at BF16_PARENT_ROWS and
    its rows are compared with this tree's bit for bit (printed: the bits
    move where the plan's K ranges do)."""
    import tempfile

    import torch

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.ops import bf16_mm as bmod

    shapes = {**rowinv_shapes(full_config()),
              **{f"dec_{k}": v for k, v in INT4_SHAPES.items()}}
    out, bad = {}, []
    for name, (o, i) in shapes.items():
        rows_list = (BF16_SWEEP_DEC_ROWS if name.startswith("dec_")
                     else BF16_SWEEP_ENC_ROWS)
        copies = 2 if name == "dec_logits" else ROWINV_COPIES
        w = (torch.randn((copies, o, i), device="cuda") * 0.02).to(
            torch.bfloat16)
        x = torch.randn((max(rows_list), i), device="cuda").to(torch.bfloat16)
        full = bmod.bf16_mm(x, w[0])
        for n in rows_list:
            xn, rec = x[:n], {}
            for tile, seq in BF16_VARIANTS:
                if not torch.equal(bf16_mm_as(xn, w[0], seq, tile),
                                   full[:n]):
                    bad.append((name, n, tile, seq))
                rec[f"{tile}_{'seq' if seq else 'cluster'}_ms"] = graph_ms(
                    _rotating(lambda li, t=tile, sq=seq: bf16_mm_as(
                        xn, w[li], sq, t), copies), copies)
            rec["ms"] = graph_ms(_rotating(
                lambda li: bmod.bf16_mm(xn, w[li]), copies), copies)
            rec["mm_ms"] = graph_ms(_rotating(
                lambda li: torch.mm(xn, w[li].t(), out_dtype=torch.float32),
                copies), copies)
            lp = bmod.bf16_mm_launch(n, o, i)
            rec["takes"] = f"{lp.tile_rows}_{'seq' if lp.seq else 'cluster'}"
            out[f"{name}_rows{n}"] = rec
            fastest = min((k for k in rec if k[:2] in ("64", "12")),
                          key=rec.get)
            log("bf16", f"{name} [{o}x{i}] at {n} rows: " + ", ".join(
                f"{k[:-3]} {v:.4f}" for k, v in rec.items()
                if k.endswith("_ms")) + f" ms; takes {rec['takes']}, "
                f"fastest {fastest[:-3]}")
        del w, x, full
    bmod.bf16_mm.launches = 0
    if bad:
        raise AssertionError(f"[bf16] variants differ from the call: {bad}")
    if root:
        # the other tree's bf16_mm on the same seeded inputs
        path = os.path.join(tempfile.gettempdir(), "bf16_other_tree.pt")
        run = subprocess.run(
            [sys.executable, "-c", _BF16_OTHER_TREE, root, repr(shapes),
             repr(BF16_PARENT_ROWS), path], capture_output=True, text=True,
            timeout=900)
        if run.returncode:
            raise AssertionError(f"[bf16] {root}: {run.stderr[-2000:]}")
        other = torch.load(path)
        os.remove(path)
        same = {}
        for name, (o, i) in shapes.items():
            g = torch.Generator(device="cuda").manual_seed(o * 7 + i)
            w = (torch.randn((o, i), generator=g, device="cuda")
                 * 0.02).to(torch.bfloat16)
            x = torch.randn((max(BF16_PARENT_ROWS), i), generator=g,
                            device="cuda").to(torch.bfloat16)
            same[name] = [n for n in BF16_PARENT_ROWS
                          if torch.equal(bmod.bf16_mm(x[:n], w).cpu(),
                                         other[(name, n)])]
        bmod.bf16_mm.launches = 0
        log("bf16", f"bit-equal to {root}'s bf16_mm at rows: " + "; ".join(
            f"{k} {v}" for k, v in same.items()))
        out["same_bits_as_root"] = same
    return out


def int8_mm_as(x, w, s, li: int, split: int, seq: bool, tile_rows: int):
    """csrc/int8_mm.cu's launch with the K split, the way to run it (seq
    True: single blocks, False: clusters; single blocks of the 64-row tile
    take split 1 only) and the tile height given, for the sweep's checks
    that each way and height gives the same bits and for the times of
    each; not counted."""
    import torch

    from voxtral_tpu_torch.ops import cuda_lib
    from voxtral_tpu_torch.ops import quant_mm as qmod

    (rows, k), n = x.shape, w.shape[1]
    sms = cuda_lib.sm_count(x.device)
    n_tiles = -(-n // qmod.RING_BLOCK_N) * -(-rows // tile_rows)
    blocks = (min(n_tiles, sms * qmod.int8_mm_blocks_per_sm(tile_rows))
              if seq else n_tiles)
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    cuda_lib.check(cuda_lib.kernels().vt_int8_mm(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), rows, n, k,
        li, split, int(seq), blocks, tile_rows,
        cuda_lib.stream_handle(x.device)), "int8_mm")
    return out


# the int8 sweep (--int8): the decoder's products at these rows (a B=1
# step, the B=16, 32, 56, 64 steps, a tile's edge, the B=16, 56, 64
# prefills)
INT8_SWEEP_ROWS = (1, 16, 32, 56, 64, 128, 608, 2128, 2432)
# the K splits it times besides the plans' own
INT8_SWEEP_SPLITS = (1, 2, 4, 8)

_INT8_OTHER_TREE = r"""
import inspect, json, sys, torch
sys.path.insert(0, sys.argv[1])
from voxtral_tpu_torch.ops.quant_mm import int8_mm
shapes, rows_list = eval(sys.argv[2]), eval(sys.argv[3])
plans = ((False, True) if "rowinv" in inspect.signature(int8_mm).parameters
         else (False,))

def graph_ms(fn, iters, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(); fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * iters)

out = {}
for name, (o, i) in shapes.items():
    copies = 2 if name == "logits" else 4
    w = torch.randint(-127, 128, (copies, o, i), device="cuda",
                      dtype=torch.int8)
    s = torch.rand((copies, o), device="cuda") * 0.02 + 0.001
    x = torch.randn((max(rows_list), i), device="cuda").to(torch.bfloat16)
    for n in rows_list:
        xn = x[:n]
        for ri in plans:
            kw = {"rowinv": True} if ri else {}
            calls = iter(range(10 ** 9))
            out[f"{name}_rows{n}_{'rowinv' if ri else 'rowplan'}"] = graph_ms(
                lambda: int8_mm(xn, w, s, next(calls) % copies, **kw), copies)
json.dump(out, open(sys.argv[4], "w"))
"""


def phase_int8_sweep(root=None) -> dict:
    """`--int8 [ROOT]`: the int8 kernel (csrc/int8_mm.cu) on the decoder's
    five products at INT8_SWEEP_ROWS, each tile height (64 rows; 128 above
    64 rows) x way of running the split (single blocks; clusters on the
    64-row tile) x K split (INT8_SWEEP_SPLITS and the two plans';
    single blocks of the 64-row tile take no split), forced,
    beside the wrapper's two plans: graph-replay ms, layers rotating, and
    a decode step's 105 summed.  Every way and height of one split is gated
    bit-equal to the others, and the row-invariant plan's call to its
    split's (the choice moves only time); the data the rules of
    ops/quant_mm.py (INT8_*: the split's aim, the tile height, clusters)
    are read off.  With ROOT (another checkout's package, e.g. the parent
    unpacked with git archive), that package's int8_mm on both of its plans
    is timed at the same shapes in a subprocess, in this call."""
    import tempfile

    import torch

    from voxtral_tpu_torch.ops import quant_mm as qmod

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, bad = {}, []
    step = {}
    for name, (o, i) in INT4_SHAPES.items():
        copies = 2 if name == "logits" else ROWINV_COPIES
        w = torch.randint(-127, 128, (copies, o, i), device="cuda",
                          dtype=torch.int8)
        s = torch.rand((copies, o), device="cuda") * 0.02 + 0.001
        x = torch.randn((max(INT8_SWEEP_ROWS), i), device="cuda").to(
            torch.bfloat16)
        per = 1 if name == "logits" else INT4_LAYERS
        for n in INT8_SWEEP_ROWS:
            xn, rec = x[:n], {}
            ri_cs = qmod.int8_mm_rowinv_plan(o, i, sms).cs
            rp_cs = qmod.int8_mm_plan(n, o, i, sms).cs
            for ri, tag in ((True, "rowinv"), (False, "rowplan")):
                rec[f"{tag}_ms"] = graph_ms(_rotating(
                    lambda li, r=ri: qmod.int8_mm(xn, w, s, li, rowinv=r),
                    copies), copies)
            got = qmod.int8_mm(xn, w, s, 0, rowinv=True)
            for cs in sorted(set(INT8_SWEEP_SPLITS) | {ri_cs, rp_cs}):
                if cs > i // qmod.INT8_K_CHUNK:
                    continue
                first = None
                for tile, seq in ((64, True), (64, False), (128, True)):
                    if (tile == 128 and n <= 64) or (tile, seq, cs > 1) == (
                            64, True, True):
                        continue
                    y = int8_mm_as(xn, w, s, 0, cs, seq, tile)
                    if first is None:
                        first = y
                    elif not torch.equal(y, first):
                        bad.append((name, n, cs, tile, seq))
                    if cs == ri_cs and not torch.equal(y, got):
                        bad.append((name, n, "rowinv", tile, seq))
                    rec[f"{tile}_{'seq' if seq else 'cluster'}_cs{cs}_ms"] = \
                        graph_ms(_rotating(
                            lambda li, c=cs, sq=seq, t=tile: int8_mm_as(
                                xn, w, s, li, c, sq, t), copies), copies)
            lp = qmod.int8_mm_launch(n, o, i, sms, True)
            rec["takes"] = (f"{lp.tile_rows}_{'seq' if lp.seq else 'cluster'}"
                            f"_cs{len(lp.ranges)}")
            rec.update(_int8_bound([(o, i)], n))
            out[f"{name}_rows{n}"] = rec
            forced = {k: v for k, v in rec.items()
                      if k[:2] in ("64", "12") and k.endswith("_ms")}
            fastest = min(forced, key=forced.get)
            for k in ("rowinv_ms", "rowplan_ms", "bound_ms"):
                step.setdefault((n, k), 0.0)
                step[(n, k)] += per * rec[k]
            step.setdefault((n, "fastest_ms"), 0.0)
            step[(n, "fastest_ms")] += per * forced[fastest]
            log("int8", f"sweep {name} [{o}x{i}] at {n} rows: row-invariant "
                        f"plan {rec['rowinv_ms']:.4f} ms (takes "
                        f"{rec['takes']}), row-count plan "
                        f"{rec['rowplan_ms']:.4f}; fastest {fastest[:-3]} "
                        f"{forced[fastest]:.4f}; bound {rec['bound_ms']:.4f} "
                        f"({rec['bound_by']}); " + ", ".join(
                            f"{k[:-3]} {v:.4f}" for k, v in forced.items()))
        qmod.int8_mm.launches = 0
        del w, s, x
    for n in INT8_SWEEP_ROWS:
        out[f"step105_rows{n}"] = {k: step[(n, k)] for k in
                                   ("rowinv_ms", "rowplan_ms", "fastest_ms",
                                    "bound_ms")}
        log("int8", f"sweep: a decode step's 105 products at {n} rows "
                    f"(summed): row-invariant plan "
                    f"{step[(n, 'rowinv_ms')]:.4f} ms, row-count plan {step[(n, 'rowplan_ms')]:.4f}, each "
                    f"product's fastest variant {step[(n, 'fastest_ms')]:.4f}"
                    f", bound {step[(n, 'bound_ms')]:.4f}")
    if bad:
        raise AssertionError(f"[int8] variants differ from each other or "
                             f"from the call: {bad}")
    if root:
        path = os.path.join(tempfile.gettempdir(), "int8_other_tree.json")
        run = subprocess.run(
            [sys.executable, "-c", _INT8_OTHER_TREE, root, repr(INT4_SHAPES),
             repr(INT8_SWEEP_ROWS), path], capture_output=True, text=True,
            timeout=900)
        if run.returncode:
            raise AssertionError(f"[int8] {root}: {run.stderr[-2000:]}")
        with open(path) as f:
            other = json.load(f)
        os.remove(path)
        for n in INT8_SWEEP_ROWS:
            for tag in ("rowinv", "rowplan"):
                keys = [f"{k}_rows{n}_{tag}" for k in INT4_SHAPES]
                if not all(k in other for k in keys):
                    continue
                them = sum((1 if k.startswith("logits") else INT4_LAYERS)
                           * other[k] for k in keys)
                out[f"step105_rows{n}"][f"root_{tag}_ms"] = them
                log("int8", f"{root} at {n} rows, its {tag} plan: a decode "
                            f"step's 105 {them:.4f} ms (this tree's "
                            f"{out[f'step105_rows{n}'][f'{tag}_ms']:.4f}); "
                            + ", ".join(f"{k.split('_')[0]} "
                                        f"{other[k]:.4f}" for k in keys))
        out["root"] = other
    return out


def _rowinv_summary(out: dict, shapes: dict, rows_list) -> None:
    """Sums of the rowinv phase's times: a layer's four products and all
    eight at each row count, each kernel against its yardstick."""
    layer = [n for n in shapes if n in ROWINV_LAYER]
    for n in rows_list:
        for group, names in (("layer", layer), ("all", list(shapes))):
            b = _bf16_bound([shapes[k] for k in names], n)
            ms = sum(out[f"bf16_ms_{k}_rows{n}"] for k in names)
            mm = sum(out[f"bf16_mm_ms_{k}_rows{n}"] for k in names)
            out.update({f"bf16_{group}_ms_rows{n}": ms,
                        f"bf16_{group}_mm_ms_rows{n}": mm,
                        f"bf16_{group}_bound_ms_rows{n}": b["bound_ms"],
                        f"bf16_{group}_bound_by_rows{n}": b["bound_by"]})
            seq = sum(out[f"bf16_seq_ms_{k}_rows{n}"] for k in names)
            clu = sum(out[f"bf16_cluster_ms_{k}_rows{n}"] for k in names)
            parent = (PARENT_BF16_LAYER_MS.get(n) if group == "layer"
                      else None)
            log("rowinv", f"bf16 {group} ({len(names)} products) at {n} "
                          f"rows: kernel {ms:.4f} ms (single blocks "
                          f"{seq:.4f}, clusters {clu:.4f}"
                          + (f"; the parent's {parent}" if parent else "")
                          + f"), torch.mm {mm:.4f} ms ({ms / mm:.2f}x), "
                          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        for kind in ("int8", "int4"):
            ms = sum(out[f"{kind}_ms_{k}_rows{n}"] for k in layer)
            rp = sum(out[f"{kind}_rowplan_ms_{k}_rows{n}"] for k in layer)
            bd = sum(out[f"{kind}_bound_ms_{k}_rows{n}"] for k in layer)
            out.update({f"{kind}_layer_ms_rows{n}": ms,
                        f"{kind}_layer_rowplan_ms_rows{n}": rp})
            log("rowinv", f"{kind} layer (4 products) at {n} rows: "
                          f"row-invariant plan {ms:.4f} ms, row-count plan "
                          f"{rp:.4f} ms ({ms / rp:.2f}x), bound >= {bd:.4f}"
                          " ms (the products' bounds summed)")


# the stream phase's fp8 runs: an e4m3 encoder ring of the bench's
# load-ring size (bench.py load_rows)
STREAM_FP8_ENC_RING = 896
STREAM_RUNS = (("1s_at_2s", True, 1.0, None),
               ("0.5s_at_0.5s", True, 0.5, 0.5),
               ("1s_at_2s_unfused", False, 1.0, None))


def _stream_once(engine, clip, feed_s: float, interval, on_gpu: bool,
                 probe: tuple, seconds=None):
    """One VoxStream over `clip` (its first `seconds` if given) fed
    `feed_s` seconds at a time at `interval` (None: the default), with
    encoder_probe(*probe) active: (the stream, feed() walls, wall
    seconds, the probe's calls and rows)."""
    import torch

    from voxtral_tpu_torch.config import SAMPLE_RATE
    from voxtral_tpu_torch.runtime.stream import VoxStream

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    feed_n = int(feed_s * SAMPLE_RATE)
    if seconds is not None:
        clip = clip[: int(seconds * SAMPLE_RATE)]
    s = VoxStream(engine)
    s.record_ids = True
    if interval is not None:
        s.set_processing_interval(interval)
    walls = []
    sync()
    w0 = time.monotonic()
    with encoder_probe(*probe) as (calls, rows):
        for i in range(0, len(clip), feed_n):
            f0 = time.monotonic()
            s.feed(clip[i: i + feed_n])
            sync()
            walls.append(time.monotonic() - f0)
        s.finish()
        sync()
    return s, walls, time.monotonic() - w0, calls, rows


def _pairs(names):
    return [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]


def _first_id_diff(a, b) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def teacher_forced_agreement(engine, samples, ids,
                             zero_attn_layer=None) -> float:
    """The offline path teacher-forced on `ids` (a streaming run's): the
    clip's bulk-encoded rows, the prompt prefilled, then one decoder pass
    over the decode positions with each position's previous id taken from
    `ids` (the function a Jacobi window verifies); the share of those
    positions whose argmax is the id `ids` holds there.  Unlike two
    free-running greedy decodes, a near-tie that the two encoders'
    rounding tips changes one position, not every position after it.
    `zero_attn_layer`: that decoder layer's attention output projection
    zeroed (a broken decoder, the gate's negative control)."""
    import torch

    from voxtral_tpu_torch.config import TOKEN_STREAMING_PAD
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models.quant import embed_rows
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    dev, cfg = engine.device, engine.cfg
    rows = engine.encode_clip_bulk(padded_clip_mel(engine, samples)[None])
    plen = engine.prompt_len
    m = min(len(ids), rows.shape[1] - (plen - 1),
            engine.dec_kv_ring - (plen - 1))
    if m <= 0:
        return 0.0
    dp = engine.params["decoder"]
    if zero_attn_layer is not None:
        wo = dp["layers"]["wo"].clone()
        wo[zero_attn_layer] = 0
        dp = {**dp, "layers": {**dp["layers"], "wo": wo}}
    cache = engine.new_dec_cache()
    dec_mod.prefill(dp, cfg, engine.prompt_embeds(rows[:, : plen - 1]),
                    cache, 0, engine.ada())
    prev = torch.tensor([TOKEN_STREAMING_PAD, *ids[: m - 1]],
                        dtype=torch.int32, device=dev)
    embeds = (rows[:, plen - 1: plen - 1 + m].float()
              + embed_rows(dp, prev)[None])
    x, _ = dec_mod.decoder_forward(
        dp, cfg, embeds, cache,
        torch.full((1,), plen - 1, dtype=torch.int32, device=dev),
        engine.ada())
    pred = dec_mod.final_logits(dp, cfg, x)[0].argmax(-1)
    return float((pred.cpu() == torch.tensor(ids[:m])).float().mean())


def phase_stream(cfg, params, device: str, seconds: float = 11.0) -> dict:
    """Drives the streaming path at B=1: VoxStream on an engine built as
    the CLI builds it (buckets (64, 16, 4, 1), adaptive decoder ring, the
    encoder ring the engine sizes, decode_mode "auto", the CLI's warm-up),
    one synthetic clip fed three ways (STREAM_RUNS): 1 s at a time at the
    default 2 s interval, 0.5 s at a time at -I 0.5, and 1 s at a time
    with fused_streaming=False.  Checks the exact launch counts of each run
    (the row-invariant kernels' too) and records the streaming encoder
    side's rows by encoder position (encoder_probe: the conv stem, the
    final norm, the adapter).  On the card's row-invariant route (bf16)
    the three runs' rows must be bitwise equal and their ids equal; the
    offline path (bulk encoder: the banded softmax order and torch.mm,
    rows that differ by rounding) teacher-forced on each run's ids must
    predict them on STREAM_FORCED_MIN of positions
    (teacher_forced_agreement), and the same with its middle decoder
    layer's attention zeroed must not (the gate's negative control);
    transcribe_offline_ids' free-running agreement is printed beside it.
    Then, ungated, the same three runs through the cuBLAS route
    (cublas_stream: torch.mm, torch's norm, T == 1 on ring_attention) with
    their agreement, the
    first stage at which their rows differ and their timings, and eager
    runs over the clip's first STREAM_LOCATE_S seconds of each route,
    probed inside every layer, which name the first stage (product, norm,
    attention) whose rows part.  Last, an int8 and an int4 pair (the
    encoder's layers quantized, so their products take the int kernels'
    row-invariant plans; the decoder quantized as the engine's rungs do):
    two chunkings each, rows bitwise equal and ids equal on the card.
    main() runs it at full width on the card; a tiny CPU config rehearses
    it (plain functions counted, as for phase_slice; nothing bitwise is
    gated on the CPU, whose products are not row-invariant)."""
    import torch

    from voxtral_tpu_torch.config import STREAM_DEFAULT_INTERVAL_S
    from voxtral_tpu_torch.models.decoder import _use_rowinv
    from voxtral_tpu_torch.models.quant import quantize_params
    from voxtral_tpu_torch.ops.quant_mm import int4_mm, int8_mm
    from voxtral_tpu_torch.runtime.engine import (
        VoxtralEngine,
        adaptive_dec_ring,
    )
    from voxtral_tpu_torch.runtime.offline import transcribe_offline_ids

    on_gpu = device == "cuda"
    counters = _stream_counters()
    exact = on_gpu and _use_rowinv(cfg.cdtype, "stream")
    tok = byte_tokenizer(cfg.decoder.vocab_size)
    clip = make_audio(seconds, seed=7)
    ring = adaptive_dec_ring(cfg, len(clip))

    def engine(p, fused, quantize=False):
        return VoxtralEngine(cfg, p, tokenizer=tok, dec_kv_ring=ring,
                             buckets=(64, 16, 4, 1), decode_mode="auto",
                             fused_streaming=fused, quantize=quantize)

    engines = {fused: engine(params, fused) for fused in (True, False)}
    eng = engines[True]
    warm = eng.warmup(interval_s=STREAM_DEFAULT_INTERVAL_S)
    log("stream", f"engine: enc ring {eng.enc_kv_ring}, dec ring "
                  f"{eng.dec_kv_ring}, buckets {eng.buckets}, fused buckets "
                  f"{eng.fused_buckets}; warm-up {warm:.1f} s")

    def agreement(ids, rows, tag):
        agree, first = {}, {}
        for a, b in _pairs(list(ids)):
            agree[f"{a}~{b}"] = _agreement(ids[a], ids[b])
            # where the two greedy decodes part (a flipped near-tie feeds
            # back, so the ids after it differ more)
            first[f"{a}~{b}"] = _first_id_diff(ids[a], ids[b])
        rows_diff = {f"{a}~{b}": first_row_diff(rows[a], rows[b])
                     for a, b in _pairs(list(rows))}
        log("stream", f"{tag} id agreement: " + ", ".join(
            f"{k} {v:.3f} (first differs at {first[k]})"
            for k, v in agree.items()))
        log("stream", f"{tag} rows by encoder position (conv stem, encoder, "
                      "adapter): " + ", ".join(
                          f"{k} {'bit-equal' if d is None else d}"
                          for k, d in rows_diff.items()))
        return agree, first, rows_diff

    def locate(tag):
        """Eager runs over the clip's first seconds, probed inside every
        layer: the first stage whose rows part between each pair."""
        rows = {}
        for name, fused, feed_s, interval in STREAM_RUNS:
            engines[fused].cuda_graphs = False
            try:
                *_, rows[name] = _stream_once(
                    engines[fused], clip, feed_s, interval, on_gpu,
                    probe=(cfg, True), seconds=STREAM_LOCATE_S)
            finally:
                engines[fused].cuda_graphs = True
        first = {f"{a}~{b}": first_row_diff(rows[a], rows[b])
                 for a, b in _pairs(list(rows))}
        log("stream", f"{tag} eager over the first {STREAM_LOCATE_S:g} s, "
                      f"{len(rows[STREAM_RUNS[0][0]])} stages probed: first "
                      "differing stage " + ", ".join(
                          f"{k} {'none' if d is None else d}"
                          for k, d in first.items()))
        return first

    # the phase's parts' walls (s), to see what its time goes to
    part_s, t_part = {}, [time.monotonic()]

    def part(name):
        now = time.monotonic()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    table, ids, rows = [], {}, {}
    for name, fused, feed_s, interval in STREAM_RUNS:
        for f in counters:
            f.launches = 0
        _zero_rowinv()
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        js0 = engines[fused].jacobi_steps
        s, feed_walls, wall, calls, rows[name] = _stream_once(
            engines[fused], clip, feed_s, interval, on_gpu,
            probe=(cfg, False))
        launches = {f.__name__: f.launches for f in counters}
        # Jacobi bursts ("auto" takes bursts of >= 64 rows) run the plain
        # ring path: only the sequential steps launch flash-decode
        j_steps = engines[fused].jacobi_steps - js0
        _check_stream_launches("stream", cfg, launches, s.n_enc_chunk_calls,
                               s.n_decode_steps - j_steps)
        rowinv_launches = _check_rowinv(f"stream {name}", cfg, calls,
                                        on_gpu)
        vocab = cfg.decoder.vocab_size
        if not s.generated_ids or not all(0 <= t < vocab
                                          for t in s.generated_ids):
            raise AssertionError(f"[stream] {name}: no ids or ids out of "
                                 "range")
        ids[name] = s.generated_ids
        rec = {
            "run": name, "fused": fused, "feed_s": feed_s,
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
            "launches": launches, "rowinv_launches": rowinv_launches,
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
                      f"{rec['peak_gib']:.2f} GiB; launches {launches}, "
                      f"{rowinv_launches}")
    for f in counters:
        f.launches = 0
    _zero_rowinv()
    part("runs")
    agree, first_diff, rows_diff = agreement(ids, rows, "row-invariant")
    stream_ids = dict(ids)
    ids["offline"] = transcribe_offline_ids(eng, clip)
    part("offline")
    forced = {}
    for a in stream_ids:
        key = f"{a}~offline"
        agree[key] = _agreement(ids[a], ids["offline"])
        first_diff[key] = _first_id_diff(ids[a], ids["offline"])
        forced[key] = teacher_forced_agreement(eng, clip, ids[a])
    # the negative control: the first run's ids against the offline path
    # with its middle decoder layer's attention zeroed
    first_run = next(iter(stream_ids))
    broken = teacher_forced_agreement(eng, clip, stream_ids[first_run],
                                      zero_attn_layer=cfg.decoder.n_layers
                                      // 2)
    log("stream", "against offline, teacher-forced on each run's ids: "
        + ", ".join(f"{k} {v:.3f}" for k, v in forced.items())
        + f" (min {STREAM_FORCED_MIN}); with layer "
        f"{cfg.decoder.n_layers // 2}'s attention zeroed {broken:.3f} "
        f"(must stay below {STREAM_FORCED_MIN}); free-running: "
        + ", ".join(
            f"{a}~offline {agree[f'{a}~offline']:.3f} (first differs at "
            f"{first_diff[f'{a}~offline']})" for a in stream_ids))
    low = {k: v for k, v in forced.items() if not v >= STREAM_FORCED_MIN}
    low.update({k: v for k, v in agree.items()
                if "offline" not in k and not v >= STREAM_AGREE_MIN})
    if low or not broken < STREAM_FORCED_MIN:
        raise AssertionError(f"[stream] id agreement below its bar "
                             f"(teacher-forced {STREAM_FORCED_MIN}, between "
                             f"runs {STREAM_AGREE_MIN}): {low}; or the "
                             f"broken decoder's {broken} not below "
                             f"{STREAM_FORCED_MIN}")
    parted = {k: d for k, d in rows_diff.items() if d is not None}
    unequal = {k: v for k, v in agree.items()
               if "offline" not in k and v != 1.0}
    if exact and (parted or unequal):
        raise AssertionError(f"[stream] the row-invariant route's runs "
                             f"differ: rows {parted}, ids {unequal}")
    first_stage = None if not parted else locate("row-invariant")
    part("locate")

    # the cuBLAS route, through stand-ins (ungated)
    cublas = {"runs": {}}
    with cublas_stream():
        c_ids, c_rows = {}, {}
        for rec, (name, fused, feed_s, interval) in zip(table, STREAM_RUNS):
            s, walls, wall, _, c_rows[name] = _stream_once(
                engines[fused], clip, feed_s, interval, on_gpu,
                probe=(cfg, False))
            c_ids[name] = s.generated_ids
            c = cublas["runs"][name] = {
                "wall_s": wall,
                "encoder_ms_per_feed": s.encoder_ms / len(walls),
                "feed_p50_ms": _percentile(walls, 50) * 1e3,
                "feed_p90_ms": _percentile(walls, 90) * 1e3}
            log("stream", f"cublas {name}: encoder "
                          f"{c['encoder_ms_per_feed']:.2f} ms/feed (issue), "
                          f"feed() wall p50 {c['feed_p50_ms']:.2f} p90 "
                          f"{c['feed_p90_ms']:.2f} ms; row-invariant "
                          f"{rec['encoder_ms_per_feed']:.2f}, p50 "
                          f"{rec['feed_p50_ms']:.2f}, p90 "
                          f"{rec['feed_p90_ms']:.2f}")
        (cublas["agreement"], cublas["first_diff"],
         cublas["rows_diff"]) = agreement(c_ids, c_rows, "cublas")
        part("cublas_runs")
        cublas["first_stage"] = locate("cublas")
        part("cublas_locate")
    for f in counters:
        f.launches = 0
    _zero_rowinv()

    # the int rungs: the encoder's layer products on the int kernels'
    # row-invariant plans
    quant = {}
    for bits, kernel in ((8, int8_mm), (4, int4_mm)):
        tag = f"int{bits}"
        qeng = engine(quantize_params(params, decoder=False, bits=bits),
                      True, quantize=tag)
        q_ids, q_rows = {}, {}
        for name, fused, feed_s, interval in STREAM_RUNS[:2]:
            kernel.launches = 0
            _zero_rowinv()
            s, _, wall, calls, q_rows[name] = _stream_once(
                qeng, clip, feed_s, interval, on_gpu, probe=(cfg, False))
            _check_rowinv(f"stream {tag} {name}", cfg, calls, on_gpu,
                          quantized=True)
            n_enc = 4 * cfg.encoder.n_layers * calls["encoder"]
            if on_gpu and not kernel.launches >= n_enc > 0:
                raise AssertionError(f"[stream] {tag} {name}: {kernel.launches}"
                                     f" {tag} launches, the encoder alone "
                                     f"takes {n_enc}")
            q_ids[name] = s.generated_ids
        q_agree, _, q_diff = agreement(q_ids, q_rows, tag)
        quant[tag] = {"agreement": q_agree, "rows_diff": q_diff}
        if exact and (set(q_agree.values()) != {1.0}
                      or any(d is not None for d in q_diff.values())):
            raise AssertionError(f"[stream] {tag}: the chunkings differ: "
                                 f"ids {q_agree}, rows {q_diff}")
        del qeng
        if on_gpu:
            torch.cuda.empty_cache()
        part(tag)
    # fp8 encoder rings (the bench's load-ring rows; any fp8kv config
    # streamed without an encoder override): the three chunkings on an
    # e4m3 encoder ring of STREAM_FP8_ENC_RING slots under "auto", where
    # flash-encode reads e4m3 (gated as the bf16 runs are), and on the
    # parent's route, the encoder's plain attention (attn_impl "xla" on
    # the encoder alone; printed, with the first stage and row where its
    # rows part: on the card the encoder's output at row 442 of the 748,
    # past the reach of the eager localisation over the first seconds)
    fp8 = {}
    for route, impl in (("auto", "auto"), ("parent", "xla")):
        fcfg = cfg.replace(enc_kv_dtype="float8_e4m3fn",
                           encoder=dataclasses.replace(cfg.encoder,
                                                       attn_impl=impl))
        f_eng = {fused: VoxtralEngine(
            fcfg, params, tokenizer=tok, dec_kv_ring=ring,
            enc_kv_ring=STREAM_FP8_ENC_RING, buckets=(64, 16, 4, 1),
            decode_mode="auto", fused_streaming=fused)
            for fused in (True, False)}
        f_ids, f_rows, f_runs = {}, {}, {}
        for name, fused, feed_s, interval in STREAM_RUNS:
            for f in counters:
                f.launches = 0
            _zero_rowinv()
            js0 = f_eng[fused].jacobi_steps
            s, walls, wall, calls, f_rows[name] = _stream_once(
                f_eng[fused], clip, feed_s, interval, on_gpu,
                probe=(fcfg, False))
            launches = {f.__name__: f.launches for f in counters}
            tag = f"stream fp8 ring {route} {name}"
            if route == "auto":
                _check_stream_launches(
                    tag, fcfg, launches, s.n_enc_chunk_calls,
                    s.n_decode_steps - (f_eng[fused].jacobi_steps - js0))
                _check_rowinv(tag, fcfg, calls, on_gpu)
            elif launches["flash_bulk_attention_batched"]:
                raise AssertionError(f"[{tag}] the plain route launched "
                                     "flash-encode")
            f_ids[name] = s.generated_ids
            f_runs[name] = {
                "wall_s": wall, "ids": len(s.generated_ids),
                "encoder_chunks": s.n_enc_chunk_calls,
                "encoder_ms_per_feed": s.encoder_ms / len(walls),
                "feed_p50_ms": _percentile(walls, 50) * 1e3,
                "feed_p90_ms": _percentile(walls, 90) * 1e3,
                "launches": launches}
            log("stream", f"{tag}: {len(s.generated_ids)} ids, "
                          f"{s.n_enc_chunk_calls} encoder chunks, encoder "
                          f"{f_runs[name]['encoder_ms_per_feed']:.2f} "
                          f"ms/feed (issue), feed() wall p50 "
                          f"{f_runs[name]['feed_p50_ms']:.2f} p90 "
                          f"{f_runs[name]['feed_p90_ms']:.2f} ms; launches "
                          f"{launches}")
        f_agree, f_first, f_diff = agreement(f_ids, f_rows,
                                             f"fp8 ring {route}")
        parted = {k: d for k, d in f_diff.items() if d is not None}
        fp8[route] = {"enc_kv_ring": STREAM_FP8_ENC_RING, "attn_impl": impl,
                      "agreement": f_agree, "first_diff": f_first,
                      "rows_diff": f_diff, "runs": f_runs}
        if route == "auto" and exact and (
                parted or set(f_agree.values()) != {1.0}):
            raise AssertionError(f"[stream] fp8 encoder ring under auto: "
                                 f"the chunkings differ: ids {f_agree}, rows "
                                 f"{parted}")
        del f_eng
        part(f"fp8_{route}")
    for f in counters:
        f.launches = 0
    _zero_rowinv()
    log("stream", "parts (s): " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in part_s.items()))
    int8_mm.launches = int4_mm.launches = 0
    _zero_rowinv()
    for f in counters:
        f.launches = 0
    return {"runs": table, "agreement": agree, "first_diff": first_diff,
            "teacher_forced_offline": forced,
            "teacher_forced_offline_broken": broken,
            "rows_diff": rows_diff, "first_stage": first_stage,
            "cublas": cublas, **quant, "fp8_enc_ring": fp8,
            "part_s": part_s,
            "launches": {f.__name__: sum(r["launches"][f.__name__]
                                         for r in table) for f in counters},
            "rowinv_launches": {k: sum(r["rowinv_launches"][k]
                                       for r in table)
                                for k in table[0]["rowinv_launches"]}}


def _gate_b1(tag: str, who: str, cfg, on_gpu: bool, agree: float, m: int,
             rows_diff, dec_diff) -> None:
    """The promise that sharing a call cannot change a transcript, on the
    card's row-invariant route (decoder._use_rowinv): a stream inside a
    batch or a pool gives exactly the ids of a B=1 VoxStream of the same
    audio (over the ids both have), its encoder side's rows and its
    decoder's K/V rows bit-equal by position."""
    from voxtral_tpu_torch.models.decoder import _use_rowinv

    if not (on_gpu and _use_rowinv(cfg.cdtype, "decoder")):
        return
    if agree != 1.0 or m <= 0 or rows_diff is not None \
            or dec_diff is not None:
        raise AssertionError(f"[{tag}] {who} against a B=1 VoxStream: ids "
                             f"{agree:.3f} equal over {m}, encoder rows "
                             f"{rows_diff}, decoder rows {dec_diff}")


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
    _zero_rowinv()
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    tr = BatchedTranscriber(engine, n_streams, dec_kv_ring=dec_ring)
    sync()
    w0 = time.monotonic()
    with encoder_probe(cfg) as (calls, rows0):
        toks = tr.transcribe(mel, interval_frames=interval_frames)
    sync()
    wall = time.monotonic() - w0
    launches = {f.__name__: f.launches for f in counters}
    _check_stream_launches("bstream", cfg, launches, tr.n_enc_chunk_calls,
                           tr.decode_steps)
    rowinv_launches = _check_rowinv("bstream", cfg, calls, on_gpu)
    vocab = cfg.decoder.vocab_size
    if not all(toks) or not all(0 <= t < vocab for s in toks for t in s):
        raise AssertionError("[bstream] a stream without ids, or ids out of "
                             "range")
    # stream 0 alone through VoxStream (1 s feeds, default interval); its
    # encoder side's rows against stream 0's in the batch
    s = VoxStream(engine)
    s.record_ids = True
    with encoder_probe(cfg) as (_, rows_b1):
        for i in range(0, len(clips[0]), 16000):
            s.feed(clips[0][i: i + 16000])
        s.finish()
    m = min(len(toks[0]), len(s.generated_ids))
    agree_b1 = _agreement(toks[0][:m], s.generated_ids[:m])
    rows_diff = first_row_diff(rows0, rows_b1)
    # the decoder's rows by step: the K/V rows each layer wrote at each
    # position, in the batch's rings and the B=1 stream's
    dec_diff = ring_rows_diff(tr.dec_cache, 0, tr.gen_pos, s.dec_cache, 0,
                              s.dec_pos)
    _gate_b1("bstream", "stream 0", cfg, on_gpu, agree_b1, m, rows_diff,
             dec_diff)
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
           "stream0_rows_diff_b1": rows_diff,
           "stream0_dec_rows_diff_b1": dec_diff,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if on_gpu else 0.0),
           "launches": launches, "rowinv_launches": rowinv_launches}
    log("bstream", f"B={n_streams} x {seconds:.1f} s in {wall:.3f} s "
                   f"({rec['x_realtime_aggregate']:.2f}x realtime aggregate); "
                   f"encode {rec['encode_ms']:.1f} ms, decode "
                   f"{rec['decode_ms']:.1f} ms ({rec['decode_ms_per_step']:.3f}"
                   f" ms/step over {tr.decode_steps} steps), "
                   f"{tr.n_enc_chunk_calls} encoder chunks, {rec['tokens']} "
                   f"ids; stream 0 vs B=1 VoxStream {agree_b1:.3f} over {m} "
                   f"ids, its rows by position (mel, conv stem, encoder, "
                   f"adapter) "
                   f"{'bit-equal' if rows_diff is None else rows_diff}, "
                   f"its decoder's K/V rows by position "
                   f"{'bit-equal' if dec_diff is None else dec_diff}; peak "
                   f"{rec['peak_gib']:.2f} GiB; launches {launches}, "
                   f"{rowinv_launches}")
    for f in counters:
        f.launches = 0
    _zero_rowinv()
    return rec


def parent_flash_plan(span: int, bsz: int, kv_heads: int):
    """The parent's flash-decode plan, for the A/B and the localisation:
    one cluster of S blocks, one range each, with S = WAVE_BLOCKS // (B x
    KH) capped at 8 and at span / 64 (a function of the batch size), run
    on this kernel (its c = S mapping is the parent's algorithm)."""
    from voxtral_tpu_torch.ops import flash_decode as fd

    n = max(1, min(fd.MAX_SPLITS, fd.WAVE_BLOCKS // (bsz * kv_heads),
                   span // fd.MIN_SPLIT_SLOTS))
    return fd.FlashPlan(n, -(-span // n), n)


@contextlib.contextmanager
def flash_plan(plan_fn, counted: bool = False):
    """flash_decode's launches on `plan_fn(span, B, KH)` for the duration;
    uncounted unless `counted` (comparison launches do not count)."""
    from voxtral_tpu_torch.ops import flash_decode as fd

    saved, n0 = fd.flash_decode_plan, fd.flash_decode.launches
    fd.flash_decode_plan = plan_fn
    try:
        yield
    finally:
        fd.flash_decode_plan = saved
        if not counted:
            fd.flash_decode.launches = n0


@contextlib.contextmanager
def parent_decoder_route():
    """The decoder as the parent ran it: the float products on torch.mm
    (cuBLAS, whose algorithm follows the row count), the int kernels on
    their row-count plans, the prefill's attention batched over B, and
    flash-decode on the parent's batch-dependent split (parent_flash_plan),
    the norms and the residual adds around them on torch's
    (add_rms_norm_plain, uncounted) and the qkv epilogue on torch's
    (qkv_rope_plain, uncounted); the streaming encoder side keeps its
    route.  The kernels' launches count as usual."""
    import torch

    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.ops.norms import add_rms_norm_plain

    saved = dec_mod._use_rowinv, dec_mod.add_rms_norm
    dec_mod._use_rowinv = (lambda cdtype, call: call == "stream"
                           and cdtype == torch.bfloat16)
    dec_mod.add_rms_norm = _uncounted(add_rms_norm_plain)
    try:
        with flash_plan(parent_flash_plan, counted=True), \
                plain_qkv_rope(("decoder",)):
            yield
    finally:
        dec_mod._use_rowinv, dec_mod.add_rms_norm = saved


# batchinv: the batch sizes of stream 0's graphed step (bit-equal at each),
# the sizes timed on both routes, stream 0's position (its live window
# spans both ranges of an 896-slot ring), the prefill's batch
BATCHINV_SIZES = (1, 3, 16, 64)
BATCHINV_TIME_SIZES = (16, 56, 64)
BATCHINV_POS = 600
BATCHINV_PREFILL_B = (4, 64)
BATCHINV_ROUTES = ("parent", "rowinv")


def phase_batchinv(cfg, params, device: str = "cuda",
                   sizes=BATCHINV_SIZES, time_sizes=BATCHINV_TIME_SIZES,
                   dec_ring: int = 896, rungs=RUNGS,
                   pos: int = BATCHINV_POS,
                   prefill_b=BATCHINV_PREFILL_B) -> dict:
    """Whether a stream's decoder rows depend on how many streams share
    its call, on each rung (bf16, fp8kv, int8, int4), on the port's
    route and on the parent's (parent_decoder_route) in this call:
      * one graphed step (embed, every layer, logits, argmax) of stream 0
        at B in `sizes`, its inputs (adapter row, previous id, position
        `pos`, ring) identical and the other streams' random: its logits
        and the K/V rows it wrote bit-equal to B=1's (gated on the port's
        route); eagerly under decoder_probe (with 2 alternatives: the
        softmax), the first stage where its rows part from B=1's;
      * stream 0's 38-row prompt prefill alone and inside batches of
        `prefill_b`: its rings and its rows by stage bit-equal (gated on
        the port's route);
      * the graphed step's ms at B in `time_sizes` on both routes in turns
        (parent, port, port, parent), CUDA events over replays, and the
        prefill's at the largest of them.
    main() runs it at full width on the card; a tiny CPU config rehearses
    it."""
    import torch

    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models.quant import embed_rows
    from voxtral_tpu_torch.ops.graphs import GraphStore
    from voxtral_tpu_torch.parallel import serving as sv
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine

    on_gpu = device == "cuda"
    tok = byte_tokenizer(cfg.decoder.vocab_size)
    dim, vocab = cfg.decoder.dim, cfg.decoder.vocab_size
    plen = None
    routes = {"rowinv": contextlib.nullcontext,
              "parent": parent_decoder_route}
    all_sizes = sorted(set(sizes) | set(time_sizes))
    table = []

    def step_inputs(bsz: int, seed: int):
        """Stream 0's fixed inputs, the others' from `seed`."""
        g0 = torch.Generator(device=device).manual_seed(5)
        row0 = torch.randn((1, dim), generator=g0, device=device)
        g = torch.Generator(device=device).manual_seed(seed)
        rows = torch.cat([row0, torch.randn((bsz - 1, dim), generator=g,
                                            device=device)])
        prev = torch.randint(0, vocab, (bsz,), generator=g, device=device,
                             dtype=torch.int32)
        prev[0] = 32
        at = torch.randint(0, 3 * dec_ring, (bsz,), generator=g,
                           device=device, dtype=torch.int32)
        at[0] = pos
        return rows, prev, at

    def fill(cache, seed: int):
        """Rings of random rows: stream 0's fixed, the others' from
        `seed`."""
        for i, t in enumerate((cache.k, cache.v)):
            g0 = torch.Generator(device=device).manual_seed(7 + i)
            t[0].copy_(torch.randn(t.shape[1:], generator=g0, device=device)
                       * 0.5)
            g = torch.Generator(device=device).manual_seed(seed + i)
            if t.shape[0] > 1:
                t[1:].copy_(torch.randn((t.shape[0] - 1, *t.shape[1:]),
                                        generator=g, device=device) * 0.5)

    for name, kv, quantize in rungs:
        rcfg = cfg if kv is None else cfg.replace(kv_dtype=kv,
                                                  enc_kv_dtype="bfloat16")
        engine = VoxtralEngine(rcfg, params, tokenizer=tok,
                               dec_kv_ring=dec_ring, buckets=(64, 16, 4, 1),
                               quantize=quantize)
        dp, ada = engine.params["decoder"], engine.ada()
        plen = engine.prompt_len
        rec = {"rung": name}
        kept = {}                 # (route, B) -> (graph, inputs), timed
        for route in BATCHINV_ROUTES:
            ref = None
            for bsz in all_sizes:
                with routes[route]():
                    cache = sv.batched_dec_cache(rcfg, bsz, dec_ring,
                                                 device=device)
                    fill(cache, 100 + bsz)
                    base = (cache.k.clone(), cache.v.clone())
                    rows, prev, at = step_inputs(bsz, 200 + bsz)

                    def step(row, prev_s, at_s, cache=cache):
                        embed = (row.float() + embed_rows(dp, prev_s))[:, None]
                        x, _ = dec_mod.decoder_forward(dp, rcfg, embed, cache,
                                                       at_s, ada)
                        lg = dec_mod.final_logits(dp, rcfg, x)[:, 0]
                        return lg, torch.argmax(lg, dim=-1)

                    graph, _ = cache.graphs.call(("batchinv", bsz), step,
                                                 (rows, prev, at))
                    cache.k.copy_(base[0])
                    cache.v.copy_(base[1])
                    lg, am = graph(rows, prev, at)
                    slot = pos % dec_ring
                    got = {"logits": lg[0].clone(), "argmax": int(am[0]),
                           "k": cache.k[0, :, :, slot].clone(),
                           "v": cache.v[0, :, :, slot].clone()}
                    if bsz in sizes:
                        # eagerly, under the probe, with 2 alternatives
                        eager = dec_mod.KVCache(base[0].clone(),
                                                base[1].clone())
                        with decoder_probe() as probed:
                            dec_mod._step(dp, rcfg, rows, prev, at, eager,
                                          ada, 2)
                        got["rows"] = dict(probed)
                        del eager
                if bsz in time_sizes:
                    kept[(route, bsz)] = (graph, (rows, prev, at), cache)
                else:
                    del cache, graph
                if bsz not in sizes:
                    continue
                if ref is None:
                    ref = got
                    continue
                same = (torch.equal(got["logits"], ref["logits"])
                        and torch.equal(got["k"].view(torch.uint8),
                                        ref["k"].view(torch.uint8))
                        and torch.equal(got["v"].view(torch.uint8),
                                        ref["v"].view(torch.uint8)))
                diff = first_row_diff(ref["rows"], got["rows"])
                rec[f"step_{route}_b{bsz}_equal"] = same
                rec[f"step_{route}_b{bsz}_first_diff"] = diff
                rec[f"step_{route}_b{bsz}_argmax_equal"] = (
                    got["argmax"] == ref["argmax"])
                log("batchinv", f"{name} {route}: stream 0's graphed step at "
                                f"B={bsz} against B=1: logits and ring rows "
                                f"{'bit-equal' if same else 'DIFFER'}, "
                                f"argmax {'equal' if got['argmax'] == ref['argmax'] else 'DIFFERS'}; "
                                f"eager rows by stage "
                                f"{'bit-equal' if diff is None else diff}")
                if route == "rowinv" and on_gpu and not (same and diff is None):
                    raise AssertionError(
                        f"[batchinv] {name}: stream 0's step at B={bsz} "
                        f"parts from B=1 (logits and rings {same}, rows "
                        f"{diff})")
            # the prefill: stream 0 alone and inside batches
            gp = torch.Generator(device=device).manual_seed(9)
            emb0 = torch.randn((1, plen - 1, dim), generator=gp,
                               device=device)
            pre = {}
            with routes[route]():
                for bsz in (1, *prefill_b):
                    e = torch.cat([emb0, torch.randn(
                        (bsz - 1, plen - 1, dim), generator=gp,
                        device=device)])
                    c = sv.batched_dec_cache(rcfg, bsz, dec_ring,
                                             device=device, graphs=False)
                    with decoder_probe() as probed:
                        sv.bprefill(dp, rcfg, e, c, torch.zeros(
                            bsz, dtype=torch.int32, device=device), ada)
                    pre[bsz] = (c, dict(probed))
            for bsz in prefill_b:
                rdiff = ring_rows_diff(pre[1][0], 0, plen - 1, pre[bsz][0],
                                       0, plen - 1)
                diff = first_row_diff(pre[1][1], pre[bsz][1])
                rec[f"prefill_{route}_b{bsz}_rings_diff"] = rdiff
                rec[f"prefill_{route}_b{bsz}_first_diff"] = diff
                log("batchinv", f"{name} {route}: stream 0's prefill alone "
                                f"and inside B={bsz}: rings "
                                f"{'bit-equal' if rdiff is None else rdiff}, "
                                f"rows by stage "
                                f"{'bit-equal' if diff is None else diff}")
                if route == "rowinv" and on_gpu and (rdiff or diff):
                    raise AssertionError(f"[batchinv] {name}: stream 0's "
                                         f"prefill parts inside B={bsz} "
                                         f"({rdiff}, {diff})")
            del pre
        # both routes' graphed steps in turns, and the prefill's ms
        if on_gpu:
            for bsz in time_sizes:
                ms = {r: [] for r in BATCHINV_ROUTES}
                for r in ("parent", "rowinv", "rowinv", "parent"):
                    graph, inputs, _ = kept[(r, bsz)]
                    ms[r].append(cuda_ms(lambda: graph(*inputs), 20))
                for r in BATCHINV_ROUTES:
                    rec[f"step_ms_{r}_b{bsz}"] = float(np.mean(ms[r]))
                log("batchinv", f"{name} graphed step B={bsz}: port's route "
                                f"{rec[f'step_ms_rowinv_b{bsz}']:.3f} ms, "
                                f"parent's {rec[f'step_ms_parent_b{bsz}']:.3f}"
                                f" ms ({rec[f'step_ms_rowinv_b{bsz}'] / rec[f'step_ms_parent_b{bsz}']:.3f}x)")
            bsz = max(time_sizes)
            e = torch.randn((bsz, plen - 1, dim), device=device)
            c = sv.batched_dec_cache(rcfg, bsz, dec_ring, device=device,
                                     graphs=False)
            z = torch.zeros(bsz, dtype=torch.int32, device=device)
            for r in ("parent", "rowinv", "rowinv", "parent"):
                with routes[r]():
                    rec.setdefault(f"prefill_ms_{r}_b{bsz}", []).append(
                        cuda_ms(lambda: sv.bprefill(dp, rcfg, e, c, z, ada),
                                2, warmup=1))
            for r in BATCHINV_ROUTES:
                rec[f"prefill_ms_{r}_b{bsz}"] = float(np.mean(
                    rec[f"prefill_ms_{r}_b{bsz}"]))
            log("batchinv", f"{name} prefill B={bsz} x {plen - 1}: port's "
                            f"route {rec[f'prefill_ms_rowinv_b{bsz}']:.2f} "
                            f"ms, parent's "
                            f"{rec[f'prefill_ms_parent_b{bsz}']:.2f} ms")
            del c, e
        del kept, engine, dp
        table.append(rec)
        if on_gpu:
            torch.cuda.empty_cache()
    from voxtral_tpu_torch.ops import graphs as graphs_mod

    for f in graphs_mod.counted_wrappers():
        f.launches = 0
    return {"rungs": table, "sizes": list(sizes),
            "time_sizes": list(time_sizes), "pos": pos,
            "prefill_b": list(prefill_b)}


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
        _zero_rowinv()
        it0, js0 = len(eng.jacobi_iters), eng.jacobi_steps
        stats: dict = {}
        ids[mode] = transcribe_offline_ids(eng, clip, timings=stats)
        steps = stats["decode_steps"]
        iters = sum(eng.jacobi_iters[it0:])
        j_steps = eng.jacobi_steps - js0
        launches = {"banded_attention_batched":
                    banded_attention_batched.launches,
                    "flash_decode": flash_decode.launches,
                    **_rowinv_launches()}
        # bf16_mm, the norms and the qkv epilogue: the decoder's passes
        # (the prefill, each sequential step, each Jacobi iteration),
        # counted by DECODER_CALLS, and the clip's bulk encoder pass
        want = {"banded_attention_batched": cfg.encoder.n_layers,
                "flash_decode": cfg.decoder.n_layers * (steps - j_steps),
                "bf16_mm": _dec_rowinv_want(cfg, on_gpu),
                "rms_norm": _norms_want(cfg),
                "qkv_rope": _qkv_rope_want(cfg)}
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
    _zero_rowinv()
    if on_gpu:
        torch.cuda.empty_cache()
    return {"clip_s": seconds, "runs": runs, "agree": agree,
            "first_diff": first, "f32_checks": checks,
            "launches_flash_decode": sum(r["launches"]["flash_decode"]
                                         for r in runs.values()),
            "launches_bf16_mm": sum(r["launches"]["bf16_mm"]
                                    for r in runs.values()),
            "launches_rms_norm": sum(r["launches"]["rms_norm"]
                                     for r in runs.values()),
            "launches_qkv_rope": sum(r["launches"]["qkv_rope"]
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


def _int8_step_ab(engine, cfg, n_streams: int, dec_ring: int,
                  extra_steps: int, device: str) -> dict:
    """The int8 rung's graphed decode step at mid fill (position 500, as
    phase_graphs' bursts) with its products on the plain path (under
    plain_kernels: each weight widened to bf16, then torch.mm, the path
    csrc/int8_mm.cu replaced; the norms and qkv epilogues torch's too) and
    on the kernel, in this call, in the order
    plain, kernel, kernel, plain: ms/step (CUDA events over bursts of
    `extra_steps`), device ms/step (8 profiled steps) and the memory the
    burst's graph and temporaries take beyond what was allocated before it
    (GiB), each variant's mean over its two runs; and the share of the
    last burst's ids the two variants agree on."""
    import torch

    from voxtral_tpu_torch.parallel import serving as sv

    on_gpu = device == "cuda"
    dp = engine.params["decoder"]
    runs, ids = {}, {}
    for variant in ("plain", "kernel", "kernel", "plain"):
        cache = sv.batched_dec_cache(cfg, n_streams, dec_ring, device=device,
                                     graphs=True)
        chunk = torch.zeros((n_streams, extra_steps, cfg.decoder.dim),
                            device=device)
        prev = torch.full((n_streams,), 32, dtype=torch.int32, device=device)
        pos = torch.full((n_streams,), 500, dtype=torch.int32, device=device)
        last = [None]

        def burst(n=extra_steps):
            last[0] = sv.bdecode_burst(dp, cfg, chunk[:, :n], prev, cache,
                                       pos, engine.ada())[0]

        ctx = plain_kernels() if variant == "plain" else contextlib.nullcontext()
        with ctx:
            if on_gpu:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(burst, 2, warmup=1) / extra_steps
                gib = (torch.cuda.max_memory_allocated() - base) / 2**30
                ev, _, _ = profiled(lambda: burst(8))
                dms = sum(e.time_range.elapsed_us() for e in ev) / 8e3
                runs.setdefault(variant, []).append((ms, dms, gib))
            else:
                burst()
        ids[variant] = last[0].tolist()
        del cache
    out = {"ab_agree_ids": _agreement(ids["plain"], ids["kernel"])}
    for variant, vals in runs.items():
        for i, key in enumerate(("step_ms", "device_ms", "burst_gib")):
            out[f"ab_{variant}_{key}"] = sum(v[i] for v in vals) / len(vals)
    if on_gpu:
        log("graphs", "int8 graphed step at mid fill, plain (widen + mm) -> "
                      f"kernel, in this call (plain, kernel, kernel, plain): "
                      f"{out['ab_plain_step_ms']:.3f} -> "
                      f"{out['ab_kernel_step_ms']:.3f} ms/step, device "
                      f"{out['ab_plain_device_ms']:.3f} -> "
                      f"{out['ab_kernel_device_ms']:.3f} ms, burst memory "
                      f"{out['ab_plain_burst_gib']:.3f} -> "
                      f"{out['ab_kernel_burst_gib']:.3f} GiB; ids agree "
                      f"{out['ab_agree_ids']:.3f}")
    return out


# the rungs whose whole serve also runs eagerly in the graphs phase (the
# script's time limit: the other rungs' graphs are held to eager by their
# mid-fill bursts and one step's logits)
GRAPHS_EAGER_SERVE = ("bf16",)
def phase_graphs(cfg, params, device: str, n_streams: int = 16,
                 seconds: float = 30.0, dec_ring: int = 896,
                 extra_steps: int = 32, stream_seconds: float = 11.0,
                 jacobi_seconds: float = 30.0) -> dict:
    """The engine's CUDA graphs (ops/graphs.py) against eager, both in this
    call, on engines that differ only in `cuda_graphs`:
      * serve_clips at B=`n_streams` x `seconds` on the bf16, fp8kv, int8
        and int4 rungs, graphed, and eagerly on GRAPHS_EAGER_SERVE: ids
        bit-equal, exact launch counts both ways, decode ms/step; at mid
        fill (position 500, bursts of
        `extra_steps`) decode ms/step, device ms/step, device events and
        the host's launch calls into the runtime per step (LAUNCH_CALLS)
        and the busy share, the bursts' ids bit-equal; on fp8kv also under
        attn_impl "xla" (the row-write kernel); on int8 the graphed step on
        the plain products against the kernel's (_int8_step_ab); one
        step's f32 logits and rings bit-equal (_step_logits_bit_equal);
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
    wrappers = [f for f in graphs.counted_wrappers()
                if f not in DECODER_CALLS + ENCODER_CALLS]
    names = [f.__name__ for f in wrappers]
    totals = dict.fromkeys(names, 0)
    nl, el = cfg.decoder.n_layers, cfg.encoder.n_layers

    def zero():
        for f in wrappers:
            f.launches = 0
        _zero_rowinv()

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
        qmm = f"{quantize}_mm" if quantize else None   # int4_mm, int8_mm
        rec, ids = {"rung": name}, {}
        for graphed in ((False, True) if name in GRAPHS_EAGER_SERVE
                        else (True,)):
            tag = "graph" if graphed else "eager"
            engine.cuda_graphs = graphed
            zero()
            c0 = graphs.GraphedCall.captures
            ids[tag], run = sv.serve_clips(engine, mel)
            steps = run["decode_steps"]
            take(f"{name} serve {tag}", {
                "banded_attention_batched": el, "flash_decode": nl * steps,
                qmm: 4 * nl + (4 * nl + 1) * steps,
                "bf16_mm": (4 * nl + (4 * nl + 1) * steps)
                * (_dec_route(rcfg, on_gpu) and not quantize),
                "rms_norm": 2 * nl + (2 * nl + 1) * steps + 2 * el + 1,
                "qkv_rope": nl * (1 + steps) + el})
            rec[f"serve_decode_ms_per_step_{tag}"] = (run["decode_s"] * 1e3
                                                     / steps)
            rec[f"serve_wall_s_{tag}"] = (run["encode_s"] + run["prefill_s"]
                                          + run["decode_s"])
            rec[f"serve_captures_{tag}"] = graphs.GraphedCall.captures - c0
        if "eager" in ids:
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
                        f"busy_mid_fill_{tag}": (busy_us(ev) / 8e3
                                                 / step_ms)})
                else:
                    burst()
                    burst()
                sync()
                n = ran[0]
                got = take(f"{name} {tag} mid fill", {
                    "flash_decode": nl * n * (impl == "auto"),
                    "ring_rows_write": nl * n * (impl == "xla"),
                    qmm: (4 * nl + 1) * n,
                    "bf16_mm": (4 * nl + 1) * n
                    * (_dec_route(rcfg, on_gpu) and not quantize),
                    "rms_norm": (2 * nl + 1) * n, "qkv_rope": nl * n})
                if impl == "xla" and graphed:
                    rec["launches_xla_mid_fill_graph"] = got
                burst_ids[graphed] = last[0].tolist()
                del xcache
            both(f"{name} {impl} mid fill", burst_ids[False], burst_ids[True])
        if quantize == "int8":   # the kernel against the path it replaced
            rec.update(_int8_step_ab(engine, rcfg, n_streams, dec_ring,
                                     extra_steps, device))
            zero()
        rec["logits_bit_equal"] = _step_logits_bit_equal(engine, rcfg,
                                                         n_streams, device)
        if not rec["logits_bit_equal"]:
            raise AssertionError(f"[graphs] {name}: the graphed step's "
                                 "logits or rings differ from eager")
        table.append(rec)
        log("graphs", f"{name}: serve B={n_streams} x {seconds:.0f} s ids "
                      + ("bit-equal" if "eager" in ids else "graphed only")
                      + f" ({steps} steps, {rec['tokens']} ids), logits "
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
        with encoder_probe(cfg, record=False) as (calls, _):
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
                                  - (eng.jacobi_steps - js0)),
            **_rowinv_expect(cfg, calls, on_gpu)})
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
            "flash_decode": nl * (st["decode_steps"] - j_steps),
            "bf16_mm": _dec_rowinv_want(cfg, on_gpu),
            "rms_norm": _norms_want(cfg), "qkv_rope": _qkv_rope_want(cfg)})
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
# the bench's load-ring row (bench.py load_rows: 8 slots at -I 0.5, e4m3
# encoder ring of 896, e4m3 decoder ring of 1024), one round of 8 ticks
# each side of the churn; the engine's config holds the rings' dtypes, so
# slot 0's B=1 VoxStream reads the same rings
POOL_RING_FP8 = dict(tag="pool_ring_fp8", n_slots=8, enc_mode="ring",
                     interval_s=0.5, n_ticks=8, dec_ring=1024,
                     enc_kv_ring=896,
                     cfg_kw=dict(kv_dtype="float8_e4m3fn",
                                 enc_kv_dtype="float8_e4m3fn"))
POOL_WINDOW = dict(tag="pool_window", n_slots=32, enc_mode="window",
                   interval_s=2.0, n_ticks=8, dec_ring=1024,
                   dec_kv_dtype="float8_e4m3fn")


def _pool_counters():
    from voxtral_tpu_torch.ops.quant_mm import int4_mm
    from voxtral_tpu_torch.ops.ring import ring_rows_write

    return _stream_counters() + (int4_mm, ring_rows_write)


def phase_pool(cfg, params, device: str, tag: str, n_slots: int,
               enc_mode: str, interval_s: float, n_ticks: int,
               dec_ring: int, dec_kv_dtype=None, ref_ids=None,
               enc_kv_ring=None, cfg_kw=None, enc_attn=None) -> dict:
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
    `ref_ids` (window mode, the ring pool's slot 0).  `cfg_kw` replaces
    fields of the config (the rings' dtypes), `enc_kv_ring` sizes the
    encoder ring, `enc_attn` sets the encoder's attn_impl ("xla": the
    plain attention, whose slot 0 is printed against the B=1 stream, not
    gated).  main() runs it at full width on the card; a tiny CPU config
    rehearses it."""
    import torch

    from voxtral_tpu_torch.config import SAMPLE_RATE
    from voxtral_tpu_torch.parallel.scheduler import StreamPool
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.stream import VoxStream

    from voxtral_tpu_torch.models.decoder import _use_flash

    on_gpu = device == "cuda"
    counters = _pool_counters()

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    cfg = cfg.replace(**(cfg_kw or {}))
    if enc_attn is not None:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                      attn_impl=enc_attn))
    tok = byte_tokenizer(cfg.decoder.vocab_size)
    engine = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=dec_ring,
                           enc_kv_ring=enc_kv_ring, buckets=(64, 16, 4, 1))
    flash_enc = enc_mode == "ring" and _use_flash(
        cfg.encoder, torch.zeros(1, dtype=cfg.enc_kvdtype))
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
    _zero_rowinv()
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    e0, b0, r0 = pool.n_enc_calls, pool.n_bursts, pool.burst_rows
    ticks, enc_ms, dec_ms, toks, bursts = [], [], [], [], []
    with encoder_probe(cfg) as (calls, rows0):
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
    rowinv_launches = _check_rowinv(tag, cfg, calls, on_gpu)
    n_enc, rows = pool.n_enc_calls - e0, pool.burst_rows - r0
    want = {"flash_bulk_attention_batched":
            cfg.encoder.n_layers * n_enc * flash_enc,
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
    rows_diff = dec_diff = None
    if ref_ids is None:   # slot 0's audio through a B=1 VoxStream
        s = VoxStream(engine)
        s.record_ids = True
        s.set_processing_interval(gate)
        s.set_continuous(True)
        with encoder_probe(cfg) as (_, rows_b1):
            for at in range(0, 2 * n_ticks * feed_n, feed_n):
                s.feed(clips[0][at: at + feed_n])
        ref_ids, ref = s.generated_ids, "b1_voxstream"
        rows_diff = first_row_diff(rows0, rows_b1)
        dec_diff = ring_rows_diff(pool.dec_cache, 0, pool.slots[0].dec_pos,
                                  s.dec_cache, 0, s.dec_pos)
    else:
        ref = "pool_ring"
    m = min(len(ids0), len(ref_ids))
    agree = _agreement(ids0[:m], ref_ids[:m])
    if ref == "b1_voxstream" and enc_attn is None:
        _gate_b1(tag, "slot 0", cfg, on_gpu, agree, m, rows_diff, dec_diff)
    n_t = len(ticks)
    rec = {"slots": n_slots, "enc_mode": pool.enc_mode,
           "interval_s": interval_s, "gate_s": gate, "ticks": n_t,
           "dec_ring": dec_ring, "enc_ring": engine.enc_kv_ring,
           "enc_kv_dtype": str(cfg.enc_kvdtype)[6:],
           "enc_attn_impl": cfg.encoder.attn_impl,
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
           "slot0_rows_diff_b1": rows_diff,
           "slot0_dec_rows_diff_b1": dec_diff,
           "launches": launches, "rowinv_launches": rowinv_launches}
    log(tag, f"{n_slots} slots {pool.enc_mode}, -I {interval_s} (gate "
             f"{gate:.1f}), {n_t} ticks in {wall:.2f} s: tick p50 "
             f"{rec['tick_p50_ms']:.1f} p90 {rec['tick_p90_ms']:.1f} ms "
             f"(encode p50 {rec['encode_p50_ms']:.1f}, decode p50 "
             f"{rec['decode_p50_ms']:.1f}), {rec['tokens_per_tick']:.1f} "
             f"tokens and {rec['bursts_per_tick']:.2f} bursts per tick, "
             f"{rec['restarts']} restarts; peak {rec['peak_gib']:.2f} GiB "
             f"(pool {rec['pool_gib']:.2f}); slot 0 vs {ref} {agree:.3f} "
             f"over {m} ids"
             + ("" if ref != "b1_voxstream" else
                f", its rows by position (mel, conv stem, encoder, adapter) "
                f"{'bit-equal' if rows_diff is None else rows_diff}, its "
                f"decoder's K/V rows by position "
                f"{'bit-equal' if dec_diff is None else dec_diff}")
             + f"; launches {launches}")
    for f in counters:
        f.launches = 0
    rec["slot0_ids"] = ids0
    del pool
    if on_gpu:
        torch.cuda.empty_cache()
    return rec


def _print_profile(tag: str, events: list, wall_s: float, steps: int,
                   unit: str = "step") -> None:
    """Per-step device time (summed kernel time), busy share (the union
    of the kernels' intervals over the wall: busy_us) and the largest
    device items."""
    from collections import defaultdict

    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    total = sum(us for us, _ in by_name.values())
    log("profile", f"{tag}: wall {wall_s * 1e3 / steps:.3f} ms/{unit} "
                   f"profiled, device {total / 1e3 / steps:.3f} ms/{unit}, "
                   f"busy {busy_us(events) / 1e6 / wall_s:.3f}, "
                   f"device events "
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
# (a) runs full_config() cut to this (encoder, decoder) depth: the eager
# tp runs over gloo are the run's slowest per layer, and the tp collectives
# and kernel shapes are the same at every depth
MESH_LAYERS = (8, 8)


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


def mesh_rank(rank: int, fn_name: str, on_gpu: bool, *args) -> dict:
    """dryrun.<fn_name>(rank, *args) in a spawned rank (mesh_serve or
    mesh_pool; args[2] is the config), counted by _mesh_counted."""
    from voxtral_tpu_torch import dryrun

    return _mesh_counted(getattr(dryrun, fn_name), args[2], on_gpu, rank,
                         *args)


def _mesh_counted(fn, cfg, on_gpu: bool, *args, **kwargs) -> dict:
    """fn(*args, **kwargs), a dryrun run (run_serving, run_pool, or a rank
    of them) whose result's `launches` then also hold bf16_mm's and the
    norm kernel's, and whose `rowinv_want` holds what they must be: the
    model's passes (decoder_calls) and the streaming encoder side's calls
    (encoder_probe) are counted from where the run zeroes its counters,
    and _rowinv_expect reads them (the norms 0 off the card: the ranks
    take no stand-ins)."""
    from voxtral_tpu_torch import dryrun

    reset = dryrun._reset_launches
    with decoder_calls(), encoder_probe(cfg, record=False) as (calls, _):
        def zero():
            reset()
            _zero_rowinv()
            calls.update(dict.fromkeys(calls, 0))

        dryrun._reset_launches = zero
        try:
            out = fn(*args, **kwargs)
        finally:
            dryrun._reset_launches = reset
        out["launches"].update(_rowinv_launches())
        want = _rowinv_expect(cfg, calls, on_gpu)
        out["rowinv_want"] = {k: v * on_gpu for k, v in want.items()}
        out["calls"] = {**calls, **{c.__name__: c.launches for c in
                                    DECODER_CALLS + ENCODER_CALLS}}
    return out


def _check_rank_launches(tag: str, outs, want_fn) -> None:
    """Every rank's launches against want_fn(rank's result) for the four
    kernels dryrun counts, and against the rank's own model of its calls
    (_mesh_counted) for bf16_mm and the norm kernel."""
    for o in outs:
        want = {**want_fn(o), **o["rowinv_want"]}
        if o["launches"] != want:
            raise AssertionError(f"[mesh] {tag} rank {o['rank']}: launches "
                                 f"{o['launches']} != {want} (calls "
                                 f"{o['calls']})")


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
    ref = _mesh_counted(dryrun.run_serving, cfg, on_gpu, eng, mel,
                        clips=True)
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
    outs = run_ranks(mesh_rank, MESH_TP,
                     ("mesh_serve", on_gpu, 1, MESH_TP, cfg, 0, mel, kw,
                      device, "gloo", True),
                     device=device, backend="gloo")
    spawn_s = time.monotonic() - t0
    steps = ref["decode_steps"]
    n_enc, n_dec = cfg.encoder.n_layers, cfg.decoder.n_layers
    want = _launch_dict(banded=n_enc, flash=n_dec * steps) if on_gpu \
        else _launch_dict()
    if ref["launches"] != {**want, **ref["rowinv_want"]}:
        raise AssertionError(f"[mesh] tp 1: launches {ref['launches']} != "
                             f"{want}, {ref['rowinv_want']}")
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
            outs = run_ranks(mesh_rank, dp * tp,
                             ("mesh_serve", on_gpu, dp, tp, cfg, 0, mel, kw,
                              device, "gloo"),
                             device=device, backend="gloo")
            steps = outs[0]["decode_steps"]
            _check_rank_launches(
                f"{tag} serve", outs, lambda o: _launch_dict(
                    flash=n_dec * o["decode_steps"] * on_gpu,
                    enc=n_enc * o["enc_chunk_calls"] * on_gpu))
            runs.append(("serve", ref["tokens"], outs))
            rec["serve_decode_steps_per_rank"] = steps
        ref = dryrun.run_pool(eng, audios, pool_kw)
        outs = run_ranks(mesh_rank, dp * tp,
                         ("mesh_pool", on_gpu, dp, tp, cfg, 0, audios, kw,
                          pool_kw, device, "gloo"),
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
        flash_decode_plan,
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
            "plan": list(flash_decode_plan(cap, bsz, kh)), "max_abs_err": err,
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


def phase_mesh(cfg, params, device: str = "cuda", seconds: float = 5.0,
               n_streams: int = 4, layers=None) -> dict:
    """Multi-device serving on one card: ranks spawned by
    parallel/mesh.py run_ranks share it over gloo (NCCL takes one card per
    rank).  (a) `cfg` with `params` (init_params(seed=0) on `device`) at
    dp 1 x tp 2 against the same clips unsharded: exact per-rank launch
    counts (banded once per layer of the bulk encode at 16 heads,
    flash-decode once per layer per step at 16q/4kv, bf16_mm and the norm
    kernel from the rank's own count of its passes, _mesh_counted), the
    prefill's last
    hidden state against an f32 witness (MESH_HIDDEN_REL_TOL,
    MESH_WITNESS_FACTOR), the ids' agreement printed;
    (b) small_config at dp 2 x tp 2 (_mesh_small); (c) on the card, the
    kernels at one rank's shapes (_rank_shape_times).  main() runs it at
    full width on the card, (a) cut to `layers` (encoder, decoder) depth
    with its own init_params(seed=0); a tiny config rehearses it on the
    CPU (no kernel launches there, none expected)."""
    if layers:
        cfg = cfg.replace(
            encoder=dataclasses.replace(cfg.encoder, n_layers=layers[0]),
            decoder=dataclasses.replace(cfg.decoder, n_layers=layers[1]))
        params = make_params(cfg, device)
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
# bf16 (its "inc" encode, every decode; the int8 product in its int8 step
# probe; on the card in a bf16 config also the row-invariant product, the
# "inc" encode's), the int4 product in int4
BENCH_KERNELS = {"bf16": ("flash_decode", "flash_bulk_attention_batched",
                          "int8_mm", "rms_norm", "qkv_rope"),
                 "int4": ("int4_mm", "rms_norm", "qkv_rope")}
# bench.step_probe's decode steps: one warm burst of 64, then 4 timed
BENCH_PROBE_STEPS = 5 * 64


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
    a value <= 0, no launch of its kernels (BENCH_KERNELS) or int8
    launches other than its int8 step probe's.  Then
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
        rowinv = (("bf16_mm",) if tag == "bf16"
                  and _dec_route(cfg, device == "cuda") else ())
        faults += [f"no {k} launch" for k in BENCH_KERNELS[tag] + rowinv
                   if not got[k] > 0]
        # the int8 probe (bf16 mode): int8 layer stacks beside the bf16
        # table, 4 products a layer and step
        st = bench.settings(e)
        want8 = (4 * cfg.decoder.n_layers * BENCH_PROBE_STEPS
                 if st.mode == "bf16" and st.int8 else 0)
        if got["int8_mm"] != want8:
            faults.append(f"int8_mm launches {got['int8_mm']} != {want8}")
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
    # "inc" again through the cuBLAS route (torch.mm on the encoder
    # side): the row-invariant products' cost in this encode
    with cublas_stream():
        inc_cublas = bench.run_once(engine, dataclasses.replace(s, enc="inc"),
                                    mel, "inc", log=blog)
    bench.reset_launches()
    log("bench", f"inc encode B={bulk_streams} x {s.seconds:g} s: "
                 f"row-invariant {inc['encode_s'] * 1e3:.1f} ms, cublas "
                 f"{inc_cublas['encode_s'] * 1e3:.1f} ms (host clock, "
                 f"device synced); ids agree "
                 f"{min(_agreement(a, b) for a, b in zip(inc['tokens'], inc_cublas['tokens'])):.3f}")
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
                "bulk_steps": bulk["steps"], "launches": launches,
                "inc_encode_ms": inc["encode_s"] * 1e3,
                "inc_encode_ms_cublas": inc_cublas["encode_s"] * 1e3})
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
    """The ckpt phase's kernels (flash-encode, flash-decode, banded, int4,
    the norm, the qkv epilogue) by name."""
    from voxtral_tpu_torch.ops.norms import rms_norm
    from voxtral_tpu_torch.ops.rope import qkv_rope

    return {f.__name__: f for f in (*_pool_counters()[:4], rms_norm,
                                    qkv_rope)}


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
            "flash_decode": "offline", "int4_mm": "int4",
            "rms_norm": "offline", "qkv_rope": "offline"}
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


# the rowinv phase's row count that summarises a kernel in the kernels
# line: a B=1 stream's 1 s feed (50 encoder positions a chunk)
ROWINV_SUMMARY_ROWS = 50


def _rowinv_kernel(rowinv: dict, by_path: dict) -> dict:
    """The kernels line's entry of the row-invariant product: launches by
    path (the streaming encoder side's and the decoder's), and the rowinv
    phase's times at ROWINV_SUMMARY_ROWS (all eight shapes summed;
    torch.mm(out_dtype=f32) is both its plain version and the library
    call), with every row count's."""
    n = ROWINV_SUMMARY_ROWS
    return {"name": "bf16_mm", "route": "cuda",
            "source": "voxtral_tpu_torch/csrc/bf16_mm.cu",
            # no Pallas kernel: the float einsum XLA compiles
            "replaces": "voxtral_tpu/models/quant.py:227",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "ms": rowinv[f"bf16_all_ms_rows{n}"],
            "plain_ms": rowinv[f"bf16_all_mm_ms_rows{n}"],
            "library_ms": rowinv[f"bf16_all_mm_ms_rows{n}"],
            "bound_ms": rowinv[f"bf16_all_bound_ms_rows{n}"],
            "bound_by": rowinv[f"bf16_all_bound_by_rows{n}"],
            "max_abs_err": rowinv["max_abs_err_bf16"],
            **{k: v for k, v in rowinv.items() if k.startswith("bf16_")},
            "torch_mm_varies_at": rowinv["torch_mm_varies_at"]}


def _norm_kernel(rowinv: dict, by_path: dict) -> dict:
    """The kernels line's entry of the row-invariant norm: launches by path
    (every norm of the model: the decoder's, the streaming and the bulk
    encoder's), the rowinv phase's check and times at a B=16 step's
    ffn_norm (the residual add, the norm and the ada scale in one call):
    its plain version is torch's sequence; no PyTorch call computes the
    fused function, so library_ms is null and F.rms_norm, the library's
    norm alone, stands beside it as `library_ms_norm_alone`."""
    k = "dec16"
    return {"name": "rms_norm", "route": "cuda",
            "source": "voxtral_tpu_torch/csrc/rms_norm.cu",
            # no Pallas kernel: the residual add, norm and ada scale XLA
            # fuses into the layers
            "replaces": "voxtral_tpu/ops/norms.py:13",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "ms": rowinv[f"norm_ms_{k}"],
            "plain_ms": rowinv[f"norm_plain_ms_{k}"],
            "library_ms": None,
            "library_ms_norm_alone": rowinv[f"norm_library_ms_{k}"],
            "bound_ms": rowinv[f"norm_bound_ms_{k}"],
            "bound_by": rowinv[f"norm_bound_by_{k}"],
            "max_abs_err": rowinv["max_abs_err_rms_norm"],
            "max_rel_err": rowinv["max_rel_err_rms_norm"],
            **{k: v for k, v in rowinv.items() if k.startswith("norm_")},
            "torch_rms_norm_varies_at": rowinv["torch_rms_norm_varies_at"]}


def _qkv_rope_kernel(qr: dict, by_path: dict) -> dict:
    """The kernels line's entry of the qkv epilogue: launches by path (one
    a layer of every decoder and encoder pass), the qkv_rope phase's check
    and times at QKV_ROPE_SUMMARY with every shape's: its plain version is
    torch's sequence; no PyTorch call computes the fused function, so
    library_ms is null."""
    k = QKV_ROPE_SUMMARY
    return {"name": "qkv_rope", "route": "cuda",
            "source": "voxtral_tpu_torch/csrc/qkv_rope.cu",
            # no Pallas kernel: the bias add, rotation and casts XLA fuses
            # into the layers
            "replaces": "voxtral_tpu/ops/rope.py:28",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "ms": qr[f"qkv_rope_ms_{k}"],
            "plain_ms": qr[f"qkv_rope_plain_ms_{k}"],
            "library_ms": None,
            "bound_ms": qr[f"qkv_rope_bound_ms_{k}"],
            "bound_by": qr[f"qkv_rope_bound_by_{k}"],
            "max_abs_err": 0.0, **qr}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# the phases `--only` runs by name (after device and build), in this order
ONLY_PHASES = ("banded", "flash", "flash_enc", "f32_auto", "int4", "int8",
               "rows", "rowinv", "norm", "qkv_rope", "slice", "serve",
               "batchinv",
               "graphs", "stream", "bstream", "jacobi", "pool_ring",
               "pool_ring_fp8", "pool_window",
               "mesh", "mel_device", "bench", "ckpt", "ckpt_full")


def pool_ring_fp8(cfg, params, device: str = "cuda") -> dict:
    """The ring pool at the bench's load-ring settings (POOL_RING_FP8):
    under "auto", flash-encode on the e4m3 encoder ring, slot 0 gated
    against a B=1 VoxStream; then the parent's route in the same call (the
    encoder's plain attention), slot 0's agreement printed, ungated."""
    auto = phase_pool(cfg, params, device, **POOL_RING_FP8)
    parent = phase_pool(cfg, params, device,
                        **{**POOL_RING_FP8, "tag": "pool_ring_fp8_parent"},
                        enc_attn="xla")
    for rec in (auto, parent):
        rec.pop("slot0_ids")
    return {**auto, "parent_route": parent}


def run_only(names) -> dict:
    """The named phases alone (a quick check of some phases on the card;
    the full run is what proves the port); run from main(), under
    decoder_calls."""
    from voxtral_tpu_torch.config import full_config

    out, cfg, params = {}, full_config(), None
    for name in ONLY_PHASES:
        if name not in names:
            continue
        if name in ("slice", "serve", "batchinv", "graphs", "stream",
                    "bstream", "jacobi", "pool_ring", "pool_ring_fp8",
                    "pool_window", "mesh", "bench") and params is None:
            params = make_params(cfg, "cuda")
        if name == "slice":
            out[name] = phase_slice(cfg, params, "cuda", (4.0, 11.0, 30.0))
        elif name == "serve":
            out[name] = phase_serve(cfg, params, "cuda", n_streams=16,
                                    seconds=30.0, dec_ring=896)
        elif name == "batchinv":
            out[name] = phase_batchinv(cfg, params, "cuda")
        elif name == "bstream":
            out[name] = phase_bstream(cfg, params, "cuda")
        elif name == "graphs":
            out[name] = phase_graphs(cfg, params, "cuda")
        elif name == "stream":
            out[name] = phase_stream(cfg, params, "cuda")
        elif name == "mesh":
            out[name] = phase_mesh(cfg, params, "cuda", layers=MESH_LAYERS)
        elif name == "jacobi":
            out[name] = phase_jacobi(cfg, params, "cuda")
        elif name == "bench":
            out[name] = phase_bench(cfg, params, "cuda")
        elif name == "pool_ring":
            out[name] = phase_pool(cfg, params, "cuda", **POOL_RING)
        elif name == "pool_ring_fp8":
            out[name] = pool_ring_fp8(cfg, params)
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
            or (argv[:1] in (["--int4"], ["--bf16"], ["--int8"], ["--norm"])
                and len(argv) <= 2)
            or (argv[:1] == ["--only"] and len(argv) == 2
                and set(argv[1].split(",")) <= set(ONLY_PHASES))):
        raise SystemExit(f"usage: {sys.argv[0]} [--profile | --int4 [ROOT] "
                         f"| --bf16 [ROOT] | --int8 [ROOT] | --norm [ROOT] "
                         f"| --only PHASE[,PHASE..] of {ONLY_PHASES}]")
    if argv[1:2] and argv[0] == "--int4":
        # the package of another checkout (an A/B of two trees in one call)
        sys.path.insert(0, argv[1])
    t_start = time.monotonic()
    smi = phase_device()
    log("device", f"nvidia-smi: {smi}")
    phase_build()
    with decoder_calls():
        return _run_phases(argv, smi, t_start)


def _run_phases(argv: list[str], smi: str, t_start: float) -> int:
    """main()'s phases after the build, with the decoder's calls counted
    (decoder_calls)."""
    import torch

    if argv[:1] == ["--int4"]:
        import voxtral_tpu_torch

        log("device", f"package {voxtral_tpu_torch.__file__}")
        print(json.dumps({"int4": phase_int4(), "rows": phase_rows(),
                          "total_s": time.monotonic() - t_start}))
        return 0
    if argv[:1] == ["--only"]:
        print(json.dumps(run_only(argv[1].split(","))))
        return 0
    if argv[:1] == ["--bf16"]:
        print(json.dumps({"bf16": phase_bf16_sweep(*argv[1:2]),
                          "total_s": time.monotonic() - t_start}))
        return 0
    if argv[:1] == ["--int8"]:
        print(json.dumps({"int8": phase_int8_sweep(*argv[1:2]),
                          "total_s": time.monotonic() - t_start}))
        return 0
    if argv[:1] == ["--norm"]:
        out = {"norm": phase_norm()}
        if argv[1:]:
            out["other_tree"] = phase_norm_other_tree(argv[1])
        print(json.dumps({**out, "total_s": time.monotonic() - t_start}))
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
    int8 = timed("int8", phase_int8)
    rows = timed("rows", phase_rows)
    rowinv = timed("rowinv", phase_rowinv)
    qr = timed("qkv_rope", phase_qkv_rope)
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
    bi = timed("batchinv", phase_batchinv, cfg, params, "cuda")
    streamed = {k: st["launches"][k] + bst["launches"][k]
                for k in st["launches"]}
    # the e4m3 encoder ring's runs under "auto" (the stream phase's)
    stream_fp8 = sum(r["launches"]["flash_bulk_attention_batched"]
                     for r in st["fp8_enc_ring"]["auto"]["runs"].values())
    streamed.update({k: st["rowinv_launches"][k] + bst["rowinv_launches"][k]
                     for k in st["rowinv_launches"]})
    jac = timed("jacobi", phase_jacobi, cfg, params, "cuda")
    pr = timed("pool_ring", phase_pool, cfg, params, "cuda", **POOL_RING)
    pr8 = timed("pool_ring_fp8", pool_ring_fp8, cfg, params)
    pw = timed("pool_window", phase_pool, cfg, params, "cuda", **POOL_WINDOW,
               ref_ids=pr.pop("slot0_ids"))
    pw.pop("slot0_ids")
    ms = timed("mesh", phase_mesh, cfg, params, "cuda", layers=MESH_LAYERS)
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
                      + stream_fp8
                      + graphed["flash_bulk_attention_batched"]
                      + pr["launches"]["flash_bulk_attention_batched"]
                      + pr8["launches"]["flash_bulk_attention_batched"]
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
         "launches_stream_fp8": stream_fp8,
         "launches_pool_ring_fp8":
             pr8["launches"]["flash_bulk_attention_batched"],
         **flash_enc, **rank_keys(shapes["flash_encode"], "tp2_rank"),
         **f32_enc},
        {"name": "int4_mm", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/int4_mm.cu",
         "replaces": "voxtral_tpu/ops/quant_mm.py:44",
         "launches": (served["int4_mm"] + graphed["int4_mm"] + ckpt["int4_mm"]
                      + benched["int4_mm"]),
         "launches_bench": benched["int4_mm"],
         "launches_ckpt": ckpt["int4_mm"],
         "launches_graphs": graphed["int4_mm"], **int4,
         **{k: v for k, v in rowinv.items() if k.startswith("int4_")}},
        {"name": "int8_mm", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/int8_mm.cu",
         # no Pallas kernel: the int8 einsum whose convert XLA fuses
         "replaces": "voxtral_tpu/models/quant.py:223",
         "launches": (served["int8_mm"] + graphed["int8_mm"]
                      + benched["int8_mm"]),
         "launches_serve": served["int8_mm"],
         "launches_bench": benched["int8_mm"],
         # `ms` the row-count plan's, `rowinv_ms` the row-invariant
         # plan's (the decoder's every int8 call)
         "launches_graphs": graphed["int8_mm"], **int8,
         **{k: v for k, v in rowinv.items() if k.startswith("int8_")}},
        {"name": "ring_rows_write", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/ring_rows_write.cu",
         "replaces": "voxtral_tpu/ops/ring.py:88",
         "launches": served["ring_rows_write"] + graphed["ring_rows_write"],
         "launches_graphs": graphed["ring_rows_write"], **rows},
        _rowinv_kernel(rowinv, {
            "slice": sl["launches"][2], "serve": served["bf16_mm"],
            "graphs": graphed["bf16_mm"],
            "stream": st["rowinv_launches"]["bf16_mm"],
            "bstream": bst["rowinv_launches"]["bf16_mm"],
            "jacobi": jac["launches_bf16_mm"],
            "pool_ring": pr["rowinv_launches"]["bf16_mm"],
            "pool_window": pw["rowinv_launches"]["bf16_mm"],
            "mesh": meshed["bf16_mm"], "bench": benched["bf16_mm"]}),
        _norm_kernel(rowinv, {
            "slice": sl["launches"][3], "serve": served["rms_norm"],
            "graphs": graphed["rms_norm"],
            "stream": st["rowinv_launches"]["rms_norm"],
            "bstream": bst["rowinv_launches"]["rms_norm"],
            "jacobi": jac["launches_rms_norm"],
            "pool_ring": pr["rowinv_launches"]["rms_norm"],
            "pool_window": pw["rowinv_launches"]["rms_norm"],
            "mesh": meshed["rms_norm"], "ckpt": ckpt["rms_norm"],
            "bench": benched["rms_norm"]}),
        _qkv_rope_kernel(qr, {
            "slice": sl["launches"][4], "serve": served["qkv_rope"],
            "graphs": graphed["qkv_rope"],
            "stream": st["rowinv_launches"]["qkv_rope"],
            "bstream": bst["rowinv_launches"]["qkv_rope"],
            "jacobi": jac["launches_qkv_rope"],
            "pool_ring": pr["rowinv_launches"]["qkv_rope"],
            "pool_window": pw["rowinv_launches"]["qkv_rope"],
            "mesh": meshed["qkv_rope"], "ckpt": ckpt["qkv_rope"],
            "bench": benched["qkv_rope"]}),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    idle = [p for p, n in kernels[1]["launches_by_path"].items() if n <= 0]
    if idle:   # every rung decodes through it, the fp8 ones included
        raise AssertionError(f"flash_decode: no launch on {idle}")
    if not (kernels[2]["launches_stream"] > 0
            and kernels[2]["launches_bstream"] > 0
            and kernels[2]["launches_pool_ring"] > 0
            and kernels[2]["launches_stream_fp8"] > 0
            and kernels[2]["launches_pool_ring_fp8"] > 0):
        raise AssertionError("flash_encode: no launch on stream, bstream, "
                             "pool_ring or their e4m3 encoder rings")
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
    idle = [f"{k['name']} {path}" for k in kernels[-3:]
            for path, n in k["launches_by_path"].items() if n <= 0]
    if idle:   # the streaming encoder side, the decoder of every path
        raise AssertionError(f"no launch on {idle}")
    idle = [k["name"] for k in kernels if k.get("launches_bench") == 0]
    if idle:   # #1 (bulk, the window rows), #4, #6 (int4), #7 ("inc"),
               # int8 (the int8 step probe)
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
                      "bstream": bst, "batchinv": bi, "jacobi": jac,
                      "pool_ring": pr, "pool_ring_fp8": pr8,
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
