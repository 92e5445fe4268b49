#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voxtral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each printing its own lines; any failure raises and the
script exits non-zero:

  1. device   torch/CUDA versions and the card's name and power limit;
               no CUDA device -> non-zero exit, no CPU fallback
  2. build    nvcc builds the hand-written kernels from
               voxtral_tpu_torch/csrc/*.cu for sm_90a
  3. banded   kernel (A) against its plain PyTorch version at the
               full-width encoder shape (H=KH=32, D=64, window 750)
  4. flash    kernel (B) against its plain version at the full-width decoder
               shape (H=32, KH=8, D=128, L=26), with and without the row
               write, bf16 and f32 rings
  5. slice    full_config() bf16 with seeded random weights: three
               synthetic clips through transcribe_offline_ids on one
               VoxtralEngine, with launch counts, timings and checks

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

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
# slice: one decoder step through the kernel path and through the plain
# path, bf16 hidden state compared relative to its max magnitude
STEP_REL_TOL = 5e-2


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
    cases = [  # (B, T, kv_lo)
        (1, 1500, [0]),          # a 30 s clip
        (1, 1013, [0]),          # ragged: not a multiple of the 64-row tile
        (2, 777, [0, 300]),      # leading keys hidden for stream 1
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
        want = banded_attention_plain(q, k, v, kv_lo, window=window,
                                      out_dtype=torch.float32)
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
    banded_attention_batched.launches = 0
    return {"max_abs_err": worst, "ms": times[0], "plain_ms": times[1]}


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
            log("flash", f"{str(rdt)[6:]} B={bsz} cap={cap} pos={pos_l}: "
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


def make_audio(seconds: float, seed: int) -> np.ndarray:
    """440 Hz tone under a 3 Hz envelope plus noise (the tests' recipe)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t) * np.sin(2 * np.pi * 3.0 * t)
    noise = 0.05 * rng.standard_normal(n)
    return (tone + noise).astype(np.float32)


def phase_slice(cfg, device: str, clip_seconds) -> dict:
    """Drives the offline path: `cfg` with seeded random weights on
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
    from voxtral_tpu_torch.models.params import init_params
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
    from voxtral_tpu_torch.tokenizer import TekkenTokenizer

    on_gpu = device == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    t0 = time.monotonic()
    params = init_params(cfg, seed=0, device=device)
    sync()
    n_params = sum(x.numel() for grp in params.values()
                   for x in _leaves(grp))
    log("slice", f"init_params(seed=0) {n_params / 1e9:.3f} B params on "
                 f"{device} in {time.monotonic() - t0:.1f} s")
    vocab = cfg.decoder.vocab_size
    tok = TekkenTokenizer([bytes([i % 256]) for i in range(vocab - 1000)],
                          1000)
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    smi = phase_device()
    log("device", f"nvidia-smi: {smi}")
    phase_build()
    banded = phase_banded()
    flash = phase_flash()
    from voxtral_tpu_torch.config import full_config

    sl = phase_slice(full_config(), "cuda", (4.0, 11.0, 30.0))
    kernels = [
        {"name": "banded_attention", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/banded_attention.cu",
         "replaces": "voxtral_tpu/ops/banded_encode.py:56",
         "launches": sl["launches"][0], **banded},
        {"name": "flash_decode", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/flash_decode.cu",
         "replaces": "voxtral_tpu/ops/flash_decode.py:232",
         "launches": sl["launches"][1], **flash},
    ]
    print(json.dumps({"kernels": kernels, "clips": sl["clips"],
                      "step_rel_err": sl["step_rel_err"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
