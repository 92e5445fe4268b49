"""Fidelity differential through the real loader: the engine (bf16, on the
card) against the independent float32 oracle, token for token on >= 50
decoded steps.

PyTorch counterpart of tools/fidelity_check.py.  The CPU tests hold the
math at tiny size; this holds the wiring at the checkpoint's size: the
name -> tree mapping of `models/params.py:load_params`, the merged QKV and
w13 offsets, the conv im2col, the vocabulary-sized logits, the rings.

The engine side runs as a stream does: `load_params` and
`TekkenTokenizer.load` from the model directory, the fused streaming
encoder over `fused_sizes` (flash-encode), `prefill`, and greedy
`decode_burst`s over `decompose(.., (64, 16, 4, 1))` (flash-decode).  The
oracle (tools/oracle.py) builds its tree from the checkpoint with its own
name mapping, so a loader fault is caught, not mirrored, and replays the
engine's schedule teacher-forced on the engine's tokens: greedy decoding
would part for good at one bf16-against-f32 tie.  Each step's argmax must
agree, except at near-ties (the oracle's own relative top-2 gap below
TIE_REL_EPS).  A wiring fault gives ~0 % agreement; rounding gives a few
flagged flips.

Usage:

    python -m voxtral_tpu_torch.tools.fidelity_check [model_dir] [seconds]
        [--device cuda|cpu]

model_dir defaults to $VOXTRAL_MODEL_DIR, seconds to 7.  Exit 0 = PASS.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import pick_device, sync

# the JAX tool's gates (tools/fidelity_check.py:34-36), unchanged
MIN_STEPS = 50
MIN_EXACT_AGREE = 0.90     # ties may flip a few argmaxes between bf16/f32
TIE_REL_EPS = 0.02         # a disagreement must be a near-tie in the oracle
ADAPTER_REL_TOL = 0.05     # engine adapter rows against the oracle's


def log(msg):
    print(f"[fidelity] {msg}", file=sys.stderr, flush=True)


def synthetic_speech(seconds: float) -> np.ndarray:
    """The JAX tool's deterministic speech-band audio (seed 7)."""
    rng = np.random.default_rng(7)
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000.0
    return (0.25 * np.sin(2 * np.pi * 210 * tt) * np.sin(2 * np.pi * 1.7 * tt)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def clip_mel(cfg, audio: np.ndarray) -> np.ndarray:
    """The clip's log-mel with the stream's left pad and the offline right
    pad, as the JAX tool builds it: [frames, 128]."""
    from ..audio.mel import MelContext
    from ..config import (
        N_LEFT_PAD_TOKENS,
        RAW_AUDIO_LENGTH_PER_TOK,
        n_right_pad_tokens,
    )

    n = len(audio)
    ctx = MelContext(N_LEFT_PAD_TOKENS * RAW_AUDIO_LENGTH_PER_TOK)
    ctx.feed(audio)
    align = (RAW_AUDIO_LENGTH_PER_TOK - (n % RAW_AUDIO_LENGTH_PER_TOK)) \
        % RAW_AUDIO_LENGTH_PER_TOK
    pad = align + n_right_pad_tokens(cfg.delay_tokens) * RAW_AUDIO_LENGTH_PER_TOK
    ctx.feed(np.zeros(pad, np.float32))
    ctx.finish(0)
    return ctx.data()


def engine_side(model_dir: str, cfg, mel: np.ndarray, n_samples: int, dev):
    """The engine's adapter rows [N, 3072] (f32, host) and its greedy
    tokens after the prompt, through the real loader on `dev`, with the
    load seconds and the weights' resident GiB."""
    import torch

    from ..models.fused_stream import ConvTails
    from ..models.params import load_params
    from ..runtime.engine import VoxtralEngine, adaptive_dec_ring, decompose
    from ..tokenizer import TekkenTokenizer

    t0 = time.monotonic()
    params = load_params(model_dir, cfg, device=dev, verbose=True)
    tok = TekkenTokenizer.load(os.path.join(model_dir, "tekken.json"))
    sync(dev)
    load_s = time.monotonic() - t0
    engine = VoxtralEngine(cfg, params, tokenizer=tok, buckets=(64, 16, 4, 1),
                           dec_kv_ring=adaptive_dec_ring(cfg, n_samples))
    gib = engine.memory_ledger()["params_total"] / 2**30
    log(f"engine weights on {dev} (+{load_s:.0f}s, {gib:.2f} GiB)")

    tails = ConvTails.create(cfg, device=dev)
    enc_cache = engine.new_enc_cache()
    rows_out = []
    q_total = (mel.shape[0] // 8) * 8
    i = enc_pos = 0
    with torch.no_grad():
        for q in engine.fused_sizes(q_total):
            rows, tails, enc_cache = engine.fused_encode(
                mel[None, i: i + q], tails, enc_cache, enc_pos)
            enc_pos += q // 2
            rows_out.append(rows)
            i += q
        rows = torch.cat(rows_out, dim=1)                 # [1, N, 3072]
        adapter_rows = rows[0].float().cpu().numpy()
        log(f"engine adapter rows: {adapter_rows.shape}")

        L = engine.prompt_len
        dec_cache = engine.new_dec_cache()
        engine.prefill(engine.prompt_embeds(rows[:, : L - 1]), dec_cache, 0)
        n_audio = rows.shape[1]
        tokens = []
        prev = 32  # STREAMING_PAD
        pos = L - 1
        for b in decompose(n_audio - pos, (64, 16, 4, 1)):
            toks, _, _, _, _ = engine.decode_burst(rows[:, pos: pos + b],
                                                   prev, dec_cache, pos)
            toks = toks[0].tolist()
            tokens.extend(toks)
            prev = toks[-1]
            pos += b
    log(f"engine decoded {len(tokens)} steps")
    return adapter_rows, tokens, q_total, {"load_s": load_s,
                                           "weights_gib": gib}


def oracle_side(model_dir: str, cfg, mel: np.ndarray, q_total: int,
                engine_tokens: list, dev):
    """The oracle's adapter rows and its teacher-forced replay of the
    engine's schedule: (adapter rows, agreeing steps, near-tie flips as
    (step, engine token, oracle token, oracle relative gap))."""
    from .oracle import exact_f32

    with exact_f32(dev):
        return _oracle_replay(model_dir, cfg, mel, q_total, engine_tokens,
                              dev)


def _oracle_replay(model_dir: str, cfg, mel: np.ndarray, q_total: int,
                   engine_tokens: list, dev):
    import torch

    from .oracle import (
        OracleDecoder,
        oracle_adapter,
        oracle_conv_stem,
        oracle_encoder,
        oracle_tree_from_checkpoint,
    )

    t0 = time.monotonic()
    otree = oracle_tree_from_checkpoint(model_dir, cfg.encoder.n_layers,
                                        cfg.decoder.n_layers, device=dev)
    log(f"oracle tree built (+{time.monotonic() - t0:.0f}s)")
    t0 = time.monotonic()
    conv = oracle_conv_stem(otree["encoder"], cfg, mel[:q_total])
    enc = oracle_encoder(otree["encoder"], cfg, conv)
    usable = (len(enc) // 4) * 4
    o_adapter = oracle_adapter(otree["adapter"], cfg, enc[:usable])
    log(f"oracle adapter rows: {tuple(o_adapter.shape)} "
        f"(+{time.monotonic() - t0:.0f}s)")

    L = cfg.prompt_len
    dec = OracleDecoder(otree["decoder"], cfg)
    emb = otree["decoder"]["tok_embeddings"]
    a = o_adapter
    prompt_ids = torch.tensor([1] + [32] * (L - 1), device=dev)
    prefix = a[:L] + emb[prompt_ids]
    agree = 0
    flips = []
    t0 = time.monotonic()
    with torch.no_grad():
        dec.forward(prefix[: L - 1], 0)
        prev = 32
        for step, eng_tok in enumerate(engine_tokens):
            p = L - 1 + step
            e = (a[p] + emb[prev]).unsqueeze(0)
            lg = dec.logits(dec.forward(e, p))[0]
            o_tok = int(lg.argmax())
            if o_tok == eng_tok:
                agree += 1
            else:
                top = float(lg.max())
                gap = (top - float(lg[eng_tok])) / (abs(top) + 1e-9)
                flips.append((step, eng_tok, o_tok, gap))
            prev = eng_tok  # teacher-force the engine's token
            if (step + 1) % 16 == 0:
                log(f"oracle step {step + 1}/{len(engine_tokens)} "
                    f"(+{time.monotonic() - t0:.0f}s)")
    return o_adapter.cpu().numpy(), agree, flips


def fidelity(model_dir: str, seconds: float, dev, cfg) -> dict:
    """Both sides on `dev` and the gates: a dict with `ok`, `agree`,
    `steps`, `flips`, `adapter_rel_err`, `load_s`, `weights_gib`."""
    mel = clip_mel(cfg, synthetic_speech(seconds))
    log(f"{seconds:.1f}s audio -> {mel.shape[0]} padded mel frames")
    adapter_rows, tokens, q_total, load = engine_side(
        model_dir, cfg, mel, int(seconds * 16000), dev)
    res = {"steps": len(tokens), "agree": 0, "flips": [],
           "adapter_rel_err": float("nan"), **load}
    if len(tokens) < MIN_STEPS:
        log(f"only {len(tokens)} decoded steps (< {MIN_STEPS})")
        return {**res, "ok": False}
    o_adapter, agree, flips = oracle_side(model_dir, cfg, mel, q_total,
                                          tokens, dev)
    if o_adapter.shape != adapter_rows.shape:
        raise RuntimeError(f"adapter rows {adapter_rows.shape} against the "
                           f"oracle's {o_adapter.shape}")
    rel = np.abs(adapter_rows - o_adapter) / (np.abs(o_adapter).max() + 1e-9)
    res["adapter_rel_err"] = float(rel.max())
    log(f"adapter rel err: max {rel.max():.4f}")
    if not rel.max() < ADAPTER_REL_TOL:
        log("adapter outputs diverge: wiring fault upstream")
    n = len(tokens)
    log(f"agreement: {agree}/{n} = {agree / n:.3f}")
    for step, et, ot, gap in flips:
        log(f"  flip @step {step}: engine {et} vs oracle {ot} "
            f"(oracle rel gap {gap:.4f})")
    ok = (rel.max() < ADAPTER_REL_TOL and agree / n >= MIN_EXACT_AGREE
          and all(g < TIE_REL_EPS for _, _, _, g in flips))
    return {**res, "agree": agree, "flips": flips, "ok": bool(ok)}


def verdict(res: dict) -> str:
    return (f"FIDELITY {'PASS' if res['ok'] else 'FAIL'}: "
            f"{res['agree']}/{res['steps']} exact, "
            f"{len(res['flips'])} near-tie flips")


def main(argv=None, cfg=None) -> int:
    """Runs the check; `cfg` (default full_config()) lets tests and the
    smoke run check a smaller or shallower checkpoint."""
    p = argparse.ArgumentParser(prog="fidelity_check")
    p.add_argument("model_dir", nargs="?",
                   default=os.environ.get("VOXTRAL_MODEL_DIR"))
    p.add_argument("seconds", nargs="?", type=float, default=7.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if not args.model_dir:
        p.error("model_dir (or VOXTRAL_MODEL_DIR) is required")
    dev = pick_device(args.device, "fidelity")
    if dev is None:
        return 1
    from ..config import full_config

    res = fidelity(args.model_dir, args.seconds, dev, cfg or full_config())
    print(verdict(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
