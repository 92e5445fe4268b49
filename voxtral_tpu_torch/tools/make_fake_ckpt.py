"""Write a synthetic Voxtral checkpoint (random weights) at full width.

PyTorch counterpart of tools/make_fake_ckpt.py: a `consolidated.safetensors`
with random tensors in the reference's exact names and layouts (torch
[out, in] Linear, conv [C_out, C_in, K]), a `tekken.json` with the full
131072-token vocabulary and a SYNTHETIC marker (runtest.sh keys off it),
so `load_params` and `TekkenTokenizer.load` run the real load path.  At
the same seed the file is byte for byte the JAX tool's: the same numpy
stream, and bf16 rounded to nearest even through torch, as ml_dtypes
rounds.

Tensors are written one at a time (header first, then the blobs), so peak
host memory is one tensor (the 0.8 GB bf16 embedding, 1.6 GB in f32 while
it is drawn), not the 8.9 GB file.

Usage:

    python -m voxtral_tpu_torch.tools.make_fake_ckpt OUT_DIR [seed]

seed defaults to 0.  The full-depth file is 8.9 GB.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import struct
import sys

import numpy as np
import torch

# safetensors dtype codes of the two dtypes a checkpoint holds
_ST_DTYPE = {"bfloat16": "BF16", "float32": "F32"}
_ITEMSIZE = {"bfloat16": 2, "float32": 4}


def tensor_specs(cfg):
    """(name, shape, dtype name) in the reference checkpoint's order and
    layout (reference tensor names: voxtral_encoder.c:50-117,
    voxtral_decoder.c:49-108, voxtral.c:102-110)."""
    bf, f32 = "bfloat16", "float32"
    e, d = cfg.encoder, cfg.decoder
    out = []

    p = "mm_streams_embeddings.embedding_module.whisper_encoder"
    out += [
        (f"{p}.conv_layers.0.conv.weight", (e.dim, e.n_mel, 3), bf),
        (f"{p}.conv_layers.0.conv.bias", (e.dim,), f32),
        (f"{p}.conv_layers.1.conv.weight", (e.dim, e.dim, 3), bf),
        (f"{p}.conv_layers.1.conv.bias", (e.dim,), f32),
    ]
    for i in range(e.n_layers):
        lp = f"{p}.transformer.layers.{i}"
        out += [
            (f"{lp}.attention_norm.weight", (e.dim,), f32),
            (f"{lp}.attention.wq.weight", (e.qkv_dim, e.dim), bf),
            (f"{lp}.attention.wq.bias", (e.qkv_dim,), f32),
            (f"{lp}.attention.wk.weight", (e.qkv_dim, e.dim), bf),
            (f"{lp}.attention.wv.weight", (e.qkv_dim, e.dim), bf),
            (f"{lp}.attention.wv.bias", (e.qkv_dim,), f32),
            (f"{lp}.attention.wo.weight", (e.dim, e.qkv_dim), bf),
            (f"{lp}.attention.wo.bias", (e.dim,), f32),
            (f"{lp}.ffn_norm.weight", (e.dim,), f32),
            (f"{lp}.feed_forward.w1.weight", (e.hidden, e.dim), bf),
            (f"{lp}.feed_forward.w2.weight", (e.dim, e.hidden), bf),
            (f"{lp}.feed_forward.w2.bias", (e.dim,), f32),
            (f"{lp}.feed_forward.w3.weight", (e.hidden, e.dim), bf),
        ]
    out.append((f"{p}.transformer.norm.weight", (e.dim,), f32))

    mm = "mm_streams_embeddings.embedding_module"
    out += [
        (f"{mm}.audio_language_projection.0.weight",
         (cfg.adapter_hidden, 4 * e.dim), bf),
        (f"{mm}.audio_language_projection.2.weight",
         (d.dim, cfg.adapter_hidden), bf),
        (f"{mm}.tok_embeddings.weight", (d.vocab_size, d.dim), bf),
        ("norm.weight", (d.dim,), f32),
    ]
    for i in range(d.n_layers):
        lp = f"layers.{i}"
        out += [
            (f"{lp}.attention_norm.weight", (d.dim,), f32),
            (f"{lp}.attention.wq.weight", (d.q_dim, d.dim), bf),
            (f"{lp}.attention.wk.weight", (d.kv_dim, d.dim), bf),
            (f"{lp}.attention.wv.weight", (d.kv_dim, d.dim), bf),
            (f"{lp}.attention.wo.weight", (d.dim, d.q_dim), bf),
            (f"{lp}.ffn_norm.weight", (d.dim,), f32),
            (f"{lp}.feed_forward.w1.weight", (d.hidden, d.dim), bf),
            (f"{lp}.feed_forward.w2.weight", (d.dim, d.hidden), bf),
            (f"{lp}.feed_forward.w3.weight", (d.hidden, d.dim), bf),
            (f"{lp}.ada_rms_norm_t_cond.0.weight", (d.ada_dim, d.dim), bf),
            (f"{lp}.ada_rms_norm_t_cond.2.weight", (d.dim, d.ada_dim), bf),
        ]
    return out


def checkpoint_bytes(specs) -> int:
    """Bytes of the tensor data of a checkpoint of `specs` (the file adds
    its header)."""
    return sum(int(np.prod(shape)) * _ITEMSIZE[dt] for _, shape, dt in specs)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the raw bits (uint16) of bfloat16, rounded to nearest
    even (torch's cast, as ml_dtypes')."""
    return torch.from_numpy(x).to(torch.bfloat16).view(torch.uint16).numpy()


def write_streaming(path: str, specs, seed: int):
    meta = {}
    offset = 0
    for name, shape, dt in specs:
        n = int(np.prod(shape)) * _ITEMSIZE[dt]
        meta[name] = {
            "dtype": _ST_DTYPE[dt],
            "shape": list(shape),
            "data_offsets": [offset, offset + n],
        }
        offset += n
    header = json.dumps(meta).encode()
    header += b" " * ((-len(header)) % 8)

    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for name, shape, dt in specs:
            arr = (rng.standard_normal(shape, dtype=np.float32) * 0.02)
            f.write(np.ascontiguousarray(
                bf16_bits(arr) if dt == "bfloat16" else arr).tobytes())
            if arr.nbytes > (1 << 26):
                print(f"  {name} ({arr.nbytes >> 20} MiB f32)", flush=True)
    print(f"wrote {path} ({offset / (1 << 30):.2f} GiB)")


def write_tekken(path: str, vocab_size: int, n_special: int = 1000):
    """Word-like unique token bytes: enough structure that transcripts look
    like text and decode_seq round-trips UTF-8 cleanly."""
    syll = ["ba", "co", "di", "en", "fu", "ga", "hi", "jo", "ka", "lu",
            "ma", "ne", "or", "pa", "qu", "ri", "sa", "te", "ul", "vo",
            "wa", "xe", "yi", "zo"]
    vocab = []
    for i in range(vocab_size - n_special):
        if i < 256:
            b = bytes([i])          # byte-fallback range, like real Tekken
        else:
            j, word = i, []
            while True:
                j, r = divmod(j, len(syll))
                word.append(syll[r])
                if j == 0:
                    break
            b = (" " + "".join(word)).encode()
        vocab.append({"rank": i,
                      "token_bytes": base64.b64encode(b).decode()})
    with open(path, "w") as f:
        json.dump({"config": {"default_num_special_tokens": n_special},
                   "vocab": vocab}, f)
    print(f"wrote {path} ({vocab_size} tokens)")


def main(argv=None, cfg=None) -> int:
    """Writes the checkpoint; `cfg` (default full_config()) lets tests and
    the smoke run write a smaller or shallower one."""
    from ..config import full_config

    p = argparse.ArgumentParser(prog="make_fake_ckpt")
    p.add_argument("out_dir")
    p.add_argument("seed", nargs="?", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = cfg or full_config()
    # marker: runtest.sh skips the golden-phrase phases (random weights
    # can't produce the Italian corpus) but still runs the fixture phase
    with open(os.path.join(args.out_dir, "SYNTHETIC"), "w") as f:
        f.write(f"random weights, seed {args.seed} "
                "(voxtral_tpu_torch.tools.make_fake_ckpt)\n")
    write_tekken(os.path.join(args.out_dir, "tekken.json"),
                 cfg.decoder.vocab_size)
    write_streaming(os.path.join(args.out_dir, "consolidated.safetensors"),
                    tensor_specs(cfg), args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
