#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voxtral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases below
    python3 chip_smoke.py --profile    # device, build, then the profile

Phases, in order, each printing its own lines; any failure raises and the
script exits non-zero:

  1. device   torch/CUDA versions and the card's name and power limit;
               no CUDA device -> non-zero exit, no CPU fallback
  2. build    nvcc builds the hand-written kernels from
               voxtral_tpu_torch/csrc/*.cu for sm_90a
  3. banded   kernel (A) against its plain PyTorch version at the
               full-width encoder shape (H=KH=32, D=64, window 750), up to
               the serve phase's B=16 padded 30 s clips
  4. flash    kernel (B) against its plain version at the full-width decoder
               shape (H=32, KH=8, D=128, L=26), with and without the row
               write, bf16 and f32 rings, up to the serve phase's B=16
               rings of 896 slots
  5. int4     kernel (C) against its plain version at the five
               full-width int4 matrices (wqkv, wo, w13, w2, logits table)
               at 1, 16 and 608 rows
  6. rows     kernel (D) against its plain version on [16, 26, 8, 896,
               128] rings in fp8, bf16 and f32 (bit-equal rings)
  7. slice    full_config() bf16 with seeded random weights: three
               synthetic clips through transcribe_offline_ids on one
               VoxtralEngine, with launch counts, timings and checks
  8. serve    the batched serving pipeline at B=16 (bulk encode of all
               streams, bprefill, bdecode_burst bursts), once per rung of
               the dtype ladder bf16 / fp8kv / int8 / int4, with launch
               counts, timings, decode ms/step at mid-clip fill and checks;
               then once on the int4 weights dequantized to bf16 (plain
               matmuls), whose ids must agree with the int4 rung's

The line before the last is a JSON object with one entry per kernel (and
the slice and serve tables); the last line is {"ok": true, "device": {...}}.
`--profile` instead prints torch.profiler's breakdown of the serve
pipeline at B=16 (encode, prefill, decode per rung).  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
# (C): bf16 x int4 products are exact; only the f32 summation order differs
# (the WMMA tiles and K splits against cuBLAS), compared relative to max
# |plain|; measured up to 3.005e-7 on an H100 80GB HBM3 (700 W)
INT4_REL_TOL = 1e-5
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


def device_events(fn, iters: int = 1) -> tuple[list, float]:
    """The device events (kernels, copies) torch.profiler records over
    `iters` calls of fn(), after one unprofiled call, and the host wall of
    the profiled calls in seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # "Command Buffer Full" marks the host waiting on a full launch queue
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and "Command Buffer Full" not in e.name]
    if not events:
        raise AssertionError("torch.profiler recorded no device time")
    return events, wall


def device_ms(fn, iters: int, with_events: bool = False):
    """Mean device time of fn() in ms: the summed durations of its device
    events over `iters` calls (and, `with_events`, the events per call).
    Unlike cuda_ms it has no host gaps, which dominate when the host issues
    small kernels slower than the device runs them."""
    events, _ = device_events(fn, iters)
    ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    return (ms, len(events) / iters) if with_events else ms


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


def phase_build() -> None:
    import os

    from voxtral_tpu_torch.ops import cuda_lib

    t0 = time.monotonic()
    lib_path = cuda_lib.build()
    cuda_lib.kernels()
    log("build", f"{lib_path} in {time.monotonic() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("build", line.strip())


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


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
    cases = [  # (B, T, kv_lo)
        (1, 1500, [0]),          # a 30 s clip
        (1, 1013, [0]),          # ragged: not a multiple of the 64-row tile
        (2, 777, [0, 300]),      # leading keys hidden for stream 1
        (16, t_serve, [0] * 16),  # the serve phase's B=16 padded 30 s clips
    ]
    worst = 0.0
    times = None
    for bsz, t, lo in cases:
        q = _randn(gen, (bsz, t, h, d), torch.bfloat16)
        k = _randn(gen, (bsz, t, h, d), torch.bfloat16)
        v = _randn(gen, (bsz, t, h, d), torch.bfloat16)
        kv_lo = torch.tensor(lo, dtype=torch.int32, device="cuda")
        got = banded_attention_batched(q, k, v, kv_lo, window=window,
                                       out_dtype=torch.float32)
        # the plain version one stream at a time (its [T, T] scores per
        # head would take 5.9 GB at B=16)
        want = torch.cat([banded_attention_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_lo[i:i + 1],
            window=window, out_dtype=torch.float32) for i in range(bsz)])
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[banded] non-finite output B={bsz} T={t}")
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        ok = err <= BANDED_TOL
        log("banded", f"B={bsz} T={t} kv_lo={lo}: max_abs_err {err:.3e} "
                      f"(tol {BANDED_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[banded] B={bsz} T={t} err {err}")
        if times is None:   # the 30 s clip shape, bf16 out as on the path
            kern = cuda_ms(lambda: banded_attention_batched(
                q, k, v, kv_lo, window=window, out_dtype=torch.bfloat16), 20)
            plain = cuda_ms(lambda: banded_attention_plain(
                q, k, v, kv_lo, window=window, out_dtype=torch.bfloat16), 5)
            times = (kern, plain)
            log("banded", f"B=1 T={t}: kernel {kern:.4f} ms, plain "
                          f"{plain:.4f} ms per call (CUDA events)")
    # the kernel alone at the serve shape (the last case's tensors)
    kern16 = cuda_ms(lambda: banded_attention_batched(
        q, k, v, kv_lo, window=window, out_dtype=torch.bfloat16), 10)
    log("banded", f"B=16 T={t_serve}: kernel {kern16:.4f} ms per call "
                  f"(CUDA events)")
    banded_attention_batched.launches = 0
    return {"max_abs_err": worst, "ms": times[0], "plain_ms": times[1],
            "ms_b16": kern16}


def serve_encoder_len(seconds: float) -> int:
    """Encoder positions of one padded clip of `seconds` in the serve
    phase: padded mel frames / 2 (the conv stem's stride)."""
    import types

    from voxtral_tpu_torch.config import full_config
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    eng = types.SimpleNamespace(delay_tokens=full_config().delay_tokens)
    return padded_clip_mel(eng, make_audio(seconds, seed=0)).shape[0] // 2


def phase_flash() -> dict:
    import torch

    from voxtral_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_plain,
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
    cases.append((16, 896, [0, 448, 896 + 123]
                  + [(97 * i) % (3 * 896) for i in range(3, 16)]))
    worst = 0.0
    for rdt in (torch.bfloat16, torch.float32):
        for bsz, cap, pos_l in cases:
            shape = (bsz, n_layers, kh, cap, d)
            k_all = _randn(gen, shape, rdt)
            v_all = _randn(gen, shape, rdt)
            q = _randn(gen, (bsz, h, d), torch.float32)
            k_rows = _randn(gen, (bsz, kh, d), torch.float32)
            v_rows = _randn(gen, (bsz, kh, d), torch.float32)
            pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
            kw = dict(window=window, out_dtype=torch.float32)
            # attention only (the function of Pallas #2/#3)
            got = flash_decode(q, k_all, v_all, li, pos, **kw)
            want = flash_decode_plain(q, k_all, v_all, li, pos, **kw)
            # row write + attention (Pallas #4), each on its own ring copy
            kk, vk = k_all.clone(), v_all.clone()
            kp, vp = k_all, v_all
            got_w = flash_decode(q, kk, vk, li, pos, k_rows, v_rows, **kw)
            want_w = flash_decode_plain(q, kp, vp, li, pos, k_rows, v_rows,
                                        **kw)
            torch.cuda.synchronize()
            err = max((got - want).abs().max().item(),
                      (got_w - want_w).abs().max().item())
            rings_equal = torch.equal(kk, kp) and torch.equal(vk, vp)
            worst = max(worst, err)
            ok = err <= FLASH_TOL and rings_equal
            log("flash", f"{str(rdt)[6:]} B={bsz} cap={cap} pos={pos_l[:3]}: "
                         f"max_abs_err {err:.3e} (tol {FLASH_TOL}), rings "
                         f"{'equal' if rings_equal else 'DIFFER'} "
                         f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[flash] {rdt} B={bsz} cap={cap} "
                                     f"pos={pos_l} err {err}")
            del k_all, v_all, kk, vk, kp, vp
    # times at slice shapes: B=1 bf16, a 30 s clip's ring (512) mid-clip and
    # a full 8192 window
    times = {}
    for cap, p in ((512, 300), (8192, 8191)):
        shape = (1, n_layers, kh, cap, d)
        k_all = _randn(gen, shape, torch.bfloat16)
        v_all = _randn(gen, shape, torch.bfloat16)
        q = _randn(gen, (1, h, d), torch.bfloat16)
        k_rows = _randn(gen, (1, kh, d), torch.float32)
        v_rows = _randn(gen, (1, kh, d), torch.float32)
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        kw = dict(window=window, out_dtype=torch.bfloat16)
        for mode, rows in (("write+attend", (k_rows, v_rows)),
                           ("attend", ())):
            kern = cuda_ms(lambda: flash_decode(
                q, k_all, v_all, li, pos, *rows, **kw), 50)
            plain = cuda_ms(lambda: flash_decode_plain(
                q, k_all, v_all, li, pos, *rows, **kw), 20)
            times[cap, mode] = (kern, plain)
            log("flash", f"B=1 bf16 cap={cap} pos={p} {mode}: kernel "
                         f"{kern:.4f} ms, plain {plain:.4f} ms per call")
    flash_decode.launches = 0
    out = {"max_abs_err": worst, "ms": times[512, "write+attend"][0],
           "plain_ms": times[512, "write+attend"][1]}
    for (cap, mode), (kern, plain) in times.items():
        tag = f"{mode.replace('+', '_')}_cap{cap}"
        out[f"ms_{tag}"], out[f"plain_ms_{tag}"] = kern, plain
    return out


# full-width int4 matrices: (out, in) of the decoder's four layer weights
# and the tied logits table
INT4_SHAPES = {"wqkv": (6144, 3072), "wo": (3072, 4096),
               "w13": (18432, 3072), "w2": (3072, 9216),
               "logits": (131072, 3072)}


def phase_int4() -> dict:
    import torch

    from voxtral_tpu_torch.models.quant import quantize_layer_stack
    from voxtral_tpu_torch.ops.quant_mm import int4_mm, int4_mm_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    worst_abs, worst_rel = 0.0, 0.0
    times = {}
    for name, (out_dim, in_dim) in INT4_SHAPES.items():
        # a 2-layer stack read at layer 1 (the table: one layer)
        n_layers = 1 if name == "logits" else 2
        w = _randn(gen, (n_layers, out_dim, in_dim), torch.bfloat16)
        q = quantize_layer_stack({"wqkv": w}, bits=4)
        p, sc = q["wqkv"], q["wqkv_scale"]
        del w, q
        li = n_layers - 1
        for rows in (1, 16, 608):
            x = _randn(gen, (rows, in_dim), torch.bfloat16)
            got = int4_mm(x, p, sc, li)
            want = int4_mm_plain(x, p, sc, li)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"[int4] non-finite {name} rows={rows}")
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            ok = rel <= INT4_REL_TOL
            log("int4", f"{name} [{out_dim}x{in_dim}] rows={rows}: max_abs_err "
                        f"{err:.3e}, rel {rel:.3e} (tol {INT4_REL_TOL}) "
                        f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[int4] {name} rows={rows} rel {rel}")
            if rows in (16, 608):
                kern = cuda_ms(lambda: int4_mm(x, p, sc, li), 20)
                plain = cuda_ms(lambda: int4_mm_plain(x, p, sc, li), 5)
                dkern = device_ms(lambda: int4_mm(x, p, sc, li), 10)
                dplain = device_ms(lambda: int4_mm_plain(x, p, sc, li), 5)
                times[name, rows] = (kern, plain, dkern, dplain)
                gbs = p[li].numel() / dkern / 1e6
                log("int4", f"{name} rows={rows}: kernel {kern:.4f} ms, "
                            f"plain {plain:.4f} ms per call (CUDA events); "
                            f"device kernel {dkern:.4f} ms ({gbs:.0f} GB/s "
                            f"of packed weights), plain {dplain:.4f} ms "
                            f"(profiler)")
        del p, sc
    int4_mm.launches = 0
    # the summary times: one call of each of the five matrices at 16 rows
    # (the B=16 decode shape)
    keys = ("ms", "plain_ms", "device_ms", "plain_device_ms")
    out = {"max_abs_err": worst_abs, "max_rel_err": worst_rel}
    for i, k in enumerate(keys):
        out[k] = sum(times[n, 16][i] for n in INT4_SHAPES)
    for (name, rows), vals in times.items():
        for k, v in zip(keys, vals):
            out[f"{k}_{name}_rows{rows}"] = v
    return out


def phase_rows() -> dict:
    import torch

    from voxtral_tpu_torch.ops.ring import (
        ring_rows_write,
        ring_rows_write_plain,
    )

    # torch's own cast on the card, for the record: torch 2.11 makes NaN
    # past 464 where the kernel saturates, so the plain version clamps first
    # (ops/ring.py:to_ring_dtype)
    probe = torch.tensor([500.0, -1000.0, 449.0, 464.0, 480.0, 0.3],
                         device="cuda")
    log("rows", f"torch cuda .to(float8_e4m3fn) of {probe.tolist()}: "
                f"{probe.to(torch.float8_e4m3fn).float().tolist()}")
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

        times[rdt] = (cuda_ms(kern_call, 50), cuda_ms(plain_call, 50),
                      device_ms(kern_call, 20), device_ms(plain_call, 20))
        log("rows", f"{str(rdt)[6:]} B={bsz}: kernel {times[rdt][0]:.4f} ms, "
                    f"plain {times[rdt][1]:.4f} ms per call (CUDA events); "
                    f"device kernel {times[rdt][2]:.4f} ms, plain "
                    f"{times[rdt][3]:.4f} ms (profiler)")
        del kk, vk, kp, vp
    ring_rows_write.launches = 0
    # the summary times: fp8 rings, as the fp8 rungs write them
    keys = ("ms", "plain_ms", "device_ms", "plain_device_ms")
    out = {"max_abs_err": 0.0,
           **dict(zip(keys, times[torch.float8_e4m3fn]))}
    for rdt, vals in times.items():
        for k, v in zip(keys, vals):
            out[f"{k}_{str(rdt)[6:]}"] = v
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
    their plain PyTorch versions for the duration (the reference side of
    a kernel-path check; attn_impl="xla" keeps flash-decode off)."""
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.ops import quant_mm, ring

    saved = quant_mm.int4_mm, dec_mod.ring_rows_write
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


def phase_serve(cfg, params, device: str, n_streams: int, seconds: float,
                dec_ring: int, rungs=SERVE_RUNGS,
                extra_steps: int = 64) -> dict:
    """The batched serving pipeline (bench.py run_once): B lockstep
    streams of `seconds` synthetic audio, each from its own seed, through
    bulk encode of all streams -> bprefill -> bdecode_burst bursts of
    (64, 16, 4, 1), once per rung on its own engine built from `params`.
    The "dequant4" rung runs the int4 weights dequantized (dequantize4) and
    must agree with the int4 rung on DEQUANT_AGREE_MIN of its ids.
    main() runs it at full width on the card; a tiny CPU config rehearses
    it (with the plain functions counted, as for phase_slice)."""
    import torch

    from voxtral_tpu_torch.config import SAMPLE_RATE, TOKEN_EOS
    from voxtral_tpu_torch.models import decoder as dec_mod
    from voxtral_tpu_torch.models.quant import embed_rows, quantize_params
    from voxtral_tpu_torch.ops.banded_encode import banded_attention_batched
    from voxtral_tpu_torch.ops.flash_decode import flash_decode
    from voxtral_tpu_torch.ops.quant_mm import int4_mm
    from voxtral_tpu_torch.ops.ring import ring_rows_write
    from voxtral_tpu_torch.parallel import serving as sv
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine, decompose
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
            sync()
            w0 = time.monotonic()
            rows = engine.encode_clips_bulk(mel)         # [B, n, dim] f32
            sync()
            w1 = time.monotonic()
            n_audio = rows.shape[1]
            cache = sv.batched_dec_cache(rcfg, n_streams, engine.dec_kv_ring,
                                         device=device)
            prompt = engine.prompt_embeds(rows[:, :plen])
            sv.bprefill(dp, rcfg, prompt[:, : plen - 1], cache,
                        torch.zeros(n_streams, dtype=torch.int32,
                                    device=device), engine.ada())
            sync()
            w2 = time.monotonic()
            prev = torch.full((n_streams,), 32, dtype=torch.int32,
                              device=device)
            pos, steps, parts = plen - 1, 0, []
            for b in decompose(n_audio - pos, (64, 16, 4, 1)):
                toks, _, _, _, cache = sv.bdecode_burst(
                    dp, rcfg, rows[:, pos: pos + b], prev, cache,
                    torch.full((n_streams,), pos, dtype=torch.int32,
                               device=device), engine.ada())
                parts.append(toks)
                prev = toks[:, -1]
                pos, steps = pos + b, steps + b
            all_toks = torch.cat(parts, dim=1).tolist()   # one fetch
            w3 = time.monotonic()
            ids = [t[: t.index(TOKEN_EOS)] if TOKEN_EOS in t else t
                   for t in all_toks]
            st = {"encode_ms": (w1 - w0) * 1e3, "prefill_ms": (w2 - w1) * 1e3,
                  "decode_ms_per_step": (w3 - w2) * 1e3 / max(steps, 1),
                  "wall_s": w3 - w0, "decode_steps": steps,
                  "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                               if on_gpu else 0.0),
                  "launches": {f.__name__: f.launches for f in counters}}
            return ids, rows, st

        # the first run warms the allocator and cuBLAS for these shapes;
        # the second is timed and must give the same ids
        ids, rows, first = run_once()
        again, _, st = run_once()
        if again != ids:
            raise AssertionError(f"[serve] {name}: second run gave other ids")
        steps = st["decode_steps"]
        dur = len(clips[0]) / SAMPLE_RATE
        st["x_realtime_aggregate"] = n_streams * dur / st["wall_s"]
        # checks: launch counts of both runs, id range, finite adapter rows
        want = {
            "banded_attention_batched": cfg.encoder.n_layers,
            "flash_decode": n_layers * steps if kv is None else 0,
            "ring_rows_write": 0 if kv is None else n_layers * steps,
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

        # decode ms/step at mid-clip fill (bench.py step_extra): 4 bursts
        # of 64 steps at position 500 from a fresh cache, CUDA events
        xcache = sv.batched_dec_cache(rcfg, n_streams, engine.dec_kv_ring,
                                      device=device)
        xchunk = torch.zeros((n_streams, extra_steps, cfg.decoder.dim),
                             device=device)
        xprev = torch.full((n_streams,), 32, dtype=torch.int32,
                           device=device)
        xpos = torch.full((n_streams,), 500, dtype=torch.int32,
                          device=device)

        def burst():
            sv.bdecode_burst(dp, rcfg, xchunk, xprev, xcache, xpos,
                             engine.ada())

        if on_gpu:
            st["step_ms_mid_fill"] = cuda_ms(burst, 4, warmup=1) / extra_steps
            xchunk = xchunk[:, :8]    # device time over 8 profiled steps
            dms, n_ev = device_ms(burst, 1, with_events=True)
            st["device_ms_per_step_mid_fill"] = dms / 8
            st["device_events_per_step_mid_fill"] = n_ev / 8
            st["busy_mid_fill"] = (st["device_ms_per_step_mid_fill"]
                                   / st["step_ms_mid_fill"])
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
                          "stream0_agree_b1", "agree_bf16", "agree_int4")
                         if k in st)
        log("serve", f"{name}: B={n_streams} x {dur:.1f} s, {steps} decode "
                     f"steps, {st['tokens']} ids; encode "
                     f"{st['encode_ms']:.2f} ms, prefill "
                     f"{st['prefill_ms']:.2f} ms, decode "
                     f"{st['decode_ms_per_step']:.3f} ms/step, "
                     f"{st['x_realtime_aggregate']:.2f}x realtime aggregate, "
                     f"peak {st['peak_gib']:.2f} GiB{extras}; launches "
                     f"{st['launches']}; second run identical ids")
        del engine, dp, rows
        if on_gpu:
            torch.cuda.empty_cache()
    for f in counters:
        f.launches = 0
    return {"rungs": table, "launches": launch_totals}


def _print_profile(tag: str, events: list, wall_s: float, steps: int) -> None:
    """Per-step device time, busy share and the largest device items."""
    from collections import defaultdict

    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    total = sum(us for us, _ in by_name.values())
    log("profile", f"{tag}: wall {wall_s * 1e3 / steps:.3f} ms/step "
                   f"profiled, device {total / 1e3 / steps:.3f} ms/step, busy "
                   f"{total / 1e6 / wall_s:.3f}, device events "
                   f"{len(events) / steps:.1f}/step")
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:12]:
        log("profile", f"  {us / 1e3 / steps:8.4f} ms/step {cnt / steps:7.1f}"
                       f" calls/step {100 * us / total:5.1f} %  {name[:80]}")


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

        def burst():
            sv.bdecode_burst(dp, rcfg, chunk, prev, cache, pos, eng.ada())

        burst()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        burst()
        torch.cuda.synchronize()
        plain_wall = time.monotonic() - t0
        log("profile", f"{name}: unprofiled {plain_wall * 1e3 / steps:.3f} "
                       f"ms/step")
        ev, wall = device_events(burst)
        _print_profile(f"{name} decode B={n_streams} pos 500", ev, wall,
                       steps)
        del eng, dp, cache
        torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv: list[str]) -> int:
    import torch

    if argv not in ([], ["--profile"]):
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    t_start = time.monotonic()
    smi = phase_device()
    log("device", f"nvidia-smi: {smi}")
    phase_build()
    if argv == ["--profile"]:
        from voxtral_tpu_torch.config import full_config

        cfg = full_config()
        phase_profile(cfg, make_params(cfg, "cuda"))
        return 0
    banded = phase_banded()
    flash = phase_flash()
    from voxtral_tpu_torch.config import full_config

    int4 = phase_int4()
    rows = phase_rows()
    cfg = full_config()
    params = make_params(cfg, "cuda")
    sl = phase_slice(cfg, params, "cuda", (4.0, 11.0, 30.0))
    # bench.py's serving shape: decoder ring 896, bursts (64, 16, 4, 1)
    sv = phase_serve(cfg, params, "cuda", n_streams=16, seconds=30.0,
                     dec_ring=896)
    served = sv["launches"]
    kernels = [
        {"name": "banded_attention", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/banded_attention.cu",
         "replaces": "voxtral_tpu/ops/banded_encode.py:56",
         "launches": sl["launches"][0] + served["banded_attention_batched"],
         **banded},
        {"name": "flash_decode", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/flash_decode.cu",
         "replaces": "voxtral_tpu/ops/flash_decode.py:232",
         "launches": sl["launches"][1] + served["flash_decode"], **flash},
        {"name": "int4_mm", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/int4_mm.cu",
         "replaces": "voxtral_tpu/ops/quant_mm.py:44",
         "launches": served["int4_mm"], **int4},
        {"name": "ring_rows_write", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/ring_rows_write.cu",
         "replaces": "voxtral_tpu/ops/ring.py:88",
         "launches": served["ring_rows_write"], **rows},
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    total_s = time.monotonic() - t_start
    log("done", f"all phases in {total_s:.1f} s")
    print(json.dumps({"kernels": kernels, "clips": sl["clips"],
                      "step_rel_err": sl["step_rel_err"],
                      "serve": sv["rungs"], "total_s": total_s}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
