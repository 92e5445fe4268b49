"""Offline batch transcription: whole clips through the port's
`parallel/serving.py:serve_clips`, batch after batch, closed loop.

Traffic file keys: streams (clips a batch), clip_seconds, buckets (the
engine's decode bursts), dec_kv_ring (decoder ring slots a stream),
check_clips (clips of a batch the reference judges).

Set-up makes the weights and the clips from the seed, builds the engine,
makes each clip's padded log mel with the port's
`runtime/offline.py:padded_clip_mel` (on the host, once: every batch
serves the same clips) and serves one batch to warm up.  The window then
runs `serve_clips(engine, mel)` back to back until `seconds` have passed;
the batch that started before then finishes.  A traced run profiles the
window's last batch (the first that is due to end past `seconds`, by the
warm-up batch's wall) and ends the window with it.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import audio, reference, trace, weights, work


def port_config(model: dict):
    """The program's VoxtralConfig of a configuration file."""
    from voxtral_tpu_torch.config import (DecoderConfig, EncoderConfig,
                                          VoxtralConfig)

    enc = EncoderConfig(**model["encoder"])
    dec = DecoderConfig(**model["decoder"])
    return VoxtralConfig(
        encoder=enc, decoder=dec, adapter_hidden=model["adapter_hidden"],
        delay_tokens=model["delay_tokens"], param_dtype=model["param_dtype"],
        compute_dtype=model["compute_dtype"], kv_dtype=model["kv_dtype"],
        enc_kv_dtype=model["enc_kv_dtype"])


def build_engine(model: dict, traffic: dict, params):
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine

    return VoxtralEngine(
        port_config(model), params, buckets=tuple(traffic["buckets"]),
        dec_kv_ring=traffic["dec_kv_ring"],
        quantize=model["quantize"] or False)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(model, traffic, seed, dev, check):
    """(engine, the batch's padded mel on the device, the judged clips'
    samples) of a seed: weights and clips drawn from it, each clip's mel
    made by the port's padded_clip_mel on the host."""
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    n = traffic["streams"]
    engine = build_engine(model, traffic, weights.make_params(
        model, seed, dev))
    clips = audio.clips(seed, n, traffic["clip_seconds"], dev)
    host = clips.cpu().numpy()
    kept_audio = clips[check].clone()
    del clips
    mel = torch.from_numpy(np.stack(
        [padded_clip_mel(engine, host[i]) for i in range(n)])).to(dev)
    return engine, mel, kept_audio


def run(ctx) -> dict:
    """One run (ctx: model, traffic, seed, seconds, trace, device,
    t_start).  Returns the run's record (what the metric readers read), its
    end-to-end values, attempted / failed, the peak and the check."""
    from voxtral_tpu_torch.ops.graphs import GraphedCall
    from voxtral_tpu_torch.parallel.serving import serve_clips

    model, traffic, dev = ctx.model, ctx.traffic, ctx.device
    n, secs = traffic["streams"], traffic["clip_seconds"]
    rng = np.random.default_rng(ctx.seed)
    check = sorted(rng.choice(n, size=traffic["check_clips"], replace=False))
    engine, mel, kept_audio = setup(model, traffic, ctx.seed, dev, check)
    tw = time.monotonic()
    serve_clips(engine, mel)                       # warm-up: one batch
    _sync(dev)
    est = time.monotonic() - tw                    # a batch's wall, about
    setup_s = time.monotonic() - ctx.t_start

    batches, served, kept_rows, prof = [], [], [], None
    t0 = time.monotonic()
    while not batches or time.monotonic() - t0 < ctx.seconds:
        s0 = GraphedCall.capture_s
        tb = time.monotonic() - t0
        if ctx.trace and tb + est >= ctx.seconds:
            # the window's last batch, traced; the profiler's start and
            # stop around it are not timed
            (ids, st), prof, wall = trace.profiled(
                lambda: serve_clips(engine, mel))
            te = tb + wall
        else:
            ids, st = serve_clips(engine, mel)
            te = time.monotonic() - t0
        rows = st.pop("adapter_rows")
        kept_rows.append((rows[check].clone(),
                          st.pop("prefill_last_hidden")[check].clone()))
        del rows
        served.append([ids[i] for i in check])
        batches.append(dict(st, wall_s=te - tb, end_s=te,
                            capture_s=GraphedCall.capture_s - s0,
                            answered=len(ids)))
        if prof is not None:
            break
    window_s = batches[-1]["end_s"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    summary = None
    if prof is not None:
        summary = trace.summarize(trace.profiler_events(prof))
        del prof
    steps = batches[0]["decode_steps"]
    mel_frames = mel.shape[1]
    rec = {
        "kind": "offline", "model": model, "traffic": traffic,
        "streams": n, "mel_frames": mel_frames,
        "prompt_len": engine.prompt_len, "batches": batches,
        "window_s": window_s, "trace": summary,
        "clip_flops": work.offline_clip_flops(model, mel_frames,
                                              engine.prompt_len),
    }
    attempted = n * len(batches)
    failed = sum(n - b["answered"] for b in batches)
    e2e = {"x_realtime": attempted * secs / window_s}

    # the program is done: free it, then judge a sample of what it served
    del engine, mel
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    j = int(rng.integers(len(batches)))
    numbers = judge(model, ctx.seed, dev, kept_audio, *kept_rows[j],
                    served[j], steps, reference.Precision(**model["precision"]))
    return {"record": rec, "e2e": e2e, "attempted": attempted,
            "failed": failed, "setup_s": setup_s, "peak_bytes": peak,
            "numbers": numbers}


def _worst(a: float, b: float) -> float:
    """The larger reading; not a number reads as infinitely bad."""
    return float("inf") if b != b else max(a, b)


@torch.no_grad()
def judge(model, seed, dev, clip_audio, rows, hidden, served, steps, prec,
          control=None) -> dict:
    """The check's numbers for the judged clips, each the worst clip's:
    `rows_rel_err`, the relative distance (Frobenius) of the adapter rows
    from the reference's; `hidden_rel_err`, the same of the prefill's
    hidden state at the prompt's last position; `logit_gap`, the widest
    gap by which a served token's logit lies below the reference's best.
    A clip cut at EOS is judged up to and with its EOS.  With `control` (a
    Precision), the reference computed that way stands in the program's
    place: its rows, its hidden state, and at each position of the same
    prompts and served tokens the token it puts first."""
    params = weights.make_params(model, seed, dev)
    worst = dict.fromkeys(("rows_rel_err", "hidden_rel_err", "logit_gap"),
                          0.0)

    def rel(a, b):
        return float((a.float() - b).norm() / b.norm())

    with reference.exact_f32():
        for c in range(clip_audio.shape[0]):
            mel = reference.padded_mel(clip_audio[c], model["delay_tokens"])
            ref_rows = reference.encode(params, model, mel, prec)
            toks = list(served[c])
            if len(toks) < steps:
                toks.append(reference.TOKEN_EOS)
            logits, ref_h = reference.decoder_logits(params, model, ref_rows,
                                                     toks, prec)
            if control is None:
                prog_rows, prog_h, chosen = rows[c], hidden[c], toks
            else:
                prog_rows = reference.encode(params, model, mel, control)
                lg, prog_h = reference.decoder_logits(params, model,
                                                      prog_rows, toks,
                                                      control)
                chosen = lg.argmax(-1).tolist()
                del lg
            if prog_rows.shape != ref_rows.shape:
                return dict.fromkeys(worst, float("inf"))
            for k, v in (("rows_rel_err", rel(prog_rows, ref_rows)),
                         ("hidden_rel_err", rel(prog_h, ref_h)),
                         ("logit_gap", float(reference.logit_gaps(
                             logits, chosen).max()))):
                worst[k] = _worst(worst[k], v)
            del logits
    return worst


def token_spread(served) -> dict:
    """How much the served tokens vary: distinct tokens, and the share of
    positions at which two judged clips' tokens differ."""
    flat = [t for s in served for t in s]
    n = min(len(s) for s in served)
    differ = sum(served[0][i] != served[-1][i] for i in range(n))
    return {"distinct": len(set(flat)), "differ_share": differ / max(n, 1)}
