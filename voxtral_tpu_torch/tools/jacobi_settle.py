"""Measure the Jacobi decode settle rate (tokens settled per iteration).

PyTorch counterpart of tools/jacobi_settle.py.  Jacobi burst decoding
(models/jacobi.py) runs the decoder once per ITERATION over a whole
window; its gain over sequential decode is the average number of tokens
that settle per iteration.  That rate is a property of the weights, so
with random weights it is bracketed:

  adversarial - random weights: logits are chaotic functions of the
      guessed prefix, each iteration settles about one token, and Jacobi
      costs sequential plus the fixpoint overhead (the LOWER bound);
  favorable  - token-independent logits (tok_embeddings zeroed, so a
      position's argmax does not depend on the token guessed before it):
      every token settles in the first pass and the second only checks
      (the UPPER bound, W/2 tokens per iteration for window W).

Usage:

    python -m voxtral_tpu_torch.tools.jacobi_settle [n_tokens] [window]
        [--device cuda|cpu]

Prints one line per regime (iterations, tokens/iter, ms/token) and the
sequential path's ms/token on the same device, then where the Jacobi ids
first part from the sequential ones, if they do (bf16 near-ties).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import pick_device, sync


def log(msg):
    print(f"[jacobi] {msg}", file=sys.stderr, flush=True)


def main(argv=None, cfg=None) -> int:
    """Runs the tool; `cfg` (default full_config()) lets tests use a small
    model."""
    p = argparse.ArgumentParser(prog="jacobi_settle")
    p.add_argument("n_tokens", nargs="?", type=int, default=256)
    p.add_argument("window", nargs="?", type=int, default=64)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    dev = pick_device(args.device, "jacobi")
    if dev is None:
        return 1
    n_tokens, window = args.n_tokens, args.window

    from ..config import full_config
    from ..models.jacobi import decode_burst_jacobi
    from ..models.params import init_params
    from ..runtime.engine import VoxtralEngine

    cfg = cfg or full_config()
    log("building random params")
    params = init_params(cfg, seed=3, device=dev)
    buckets = tuple(sorted({n_tokens, 64, 16, 4, 1}, reverse=True))
    engine = VoxtralEngine(cfg, params, buckets=buckets, dec_kv_ring=2048,
                           decode_mode="jacobi", jacobi_window=window,
                           fused_streaming=False)
    rng = np.random.default_rng(11)
    adapter = torch.from_numpy((rng.standard_normal(
        (n_tokens, cfg.decoder.dim)) * 0.05).astype(np.float32))[None].to(dev)

    def run(label, dparams):
        args_ = (dparams, cfg, adapter, 32)
        decode_burst_jacobi(*args_, engine.new_dec_cache(), 0, engine.ada(),
                            window=window)                       # warm
        cache = engine.new_dec_cache()
        sync(dev)
        t0 = time.monotonic()
        toks, _, _, _, _, iters = decode_burst_jacobi(
            *args_, cache, 0, engine.ada(), window=window)
        toks = toks[0].cpu().numpy()
        dt = time.monotonic() - t0
        print(f"{label}: {n_tokens} tokens, window {window}: {iters} "
              f"iterations -> {n_tokens / iters:.2f} tokens/iter, "
              f"{1000 * dt / n_tokens:.2f} ms/token")
        return toks

    t_adv = run("adversarial(random)", params["decoder"])
    fav = dict(params["decoder"])
    fav["tok_embeddings"] = torch.zeros_like(fav["tok_embeddings"])
    run("favorable(token-independent)", fav)

    # the sequential burst on the same rows (ids and ms/token)
    eng_seq = VoxtralEngine(cfg, params, buckets=buckets, dec_kv_ring=2048,
                            fused_streaming=False)
    eng_seq.decode_burst(adapter, 32, eng_seq.new_dec_cache(), 0)   # warm
    cache = eng_seq.new_dec_cache()
    sync(dev)
    t0 = time.monotonic()
    toks_seq = eng_seq.decode_burst(adapter, 32, cache, 0)[0][0].cpu().numpy()
    dt = time.monotonic() - t0
    print(f"sequential: {1000 * dt / n_tokens:.2f} ms/token")
    # Jacobi gives the greedy ids in exact arithmetic; in bf16 its passes
    # run W-row products where the sequential burst runs 1-row ones, so a
    # near-tied argmax can flip at one position and the suffix then differs
    mism = np.nonzero(t_adv != toks_seq)[0]
    if len(mism) == 0:
        print("jacobi==sequential: exact")
        return 0
    first = int(mism[0])
    print(f"jacobi==sequential: prefix-exact for {first}/{n_tokens} tokens, "
          f"first flip @ {first} (the suffix follows the flipped token)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
