"""Standalone benchmark of the int4 matmul kernel on the card.

PyTorch counterpart of tools/int4_kernel_bench.py.  Times one
decode-shaped product per decoder matrix (`rows` rows, 16 by default)
three ways: the bf16 product, the int8 product (csrc/int8_mm.cu through
ops/quant_mm.py int8_mm, the counterpart of the int8 convert XLA fuses in
the JAX package) and the int4 kernel (csrc/int4_mm.cu, TPU kernel #6),
without the engine, so nothing else is resident.  Each way runs a chain over the 26
layers of a random stack, captured in one CUDA graph and replayed between
CUDA events; the time is per product.  The floors are the bytes each way
must read over the H100's 3.35 TB/s (HBM_BYTES_PER_S): bf16 2 bytes an
element, int8 1, int4 0.5.

Usage:

    python -m voxtral_tpu_torch.tools.int4_kernel_bench [rows] [matrix ...]
        [--device cuda|cpu]

(default matrix: w13, the largest read; "all" for every matrix)
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import HBM_BYTES_PER_S, graph_time, pick_device

MATRICES = ("wqkv", "wo", "w13", "w2")


def matrices(cfg) -> dict:
    """[out, in] of each decoder matrix of `cfg` (full_config(): wqkv
    6144 x 3072, wo 3072 x 4096, w13 18432 x 3072, w2 3072 x 9216)."""
    d = cfg.decoder
    return {"wqkv": (d.q_dim + 2 * d.kv_dim, d.dim), "wo": (d.dim, d.q_dim),
            "w13": (2 * d.hidden, d.dim), "w2": (d.dim, d.hidden)}


def main(argv=None, cfg=None) -> int:
    """Runs the tool; `cfg` (default full_config()) lets tests use small
    matrices."""
    p = argparse.ArgumentParser(prog="int4_kernel_bench")
    p.add_argument("rows", nargs="?", type=int, default=16)
    p.add_argument("matrix", nargs="*", choices=MATRICES + ("all",))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    dev = pick_device(args.device, "int4_kernel_bench")
    if dev is None:
        return 1

    from ..config import full_config
    from ..models.quant import _quantize, _quantize4, matmul_f32
    from ..ops.quant_mm import int4_mm, int8_mm

    cfg = cfg or full_config()
    n_layers = cfg.decoder.n_layers
    rows = args.rows
    mats = matrices(cfg)
    pick = args.matrix or ["w13"]
    if pick != ["all"]:
        mats = {k: v for k, v in mats.items() if k in pick}
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device={dev} rows={rows}", file=sys.stderr)
    for name, (o, i) in mats.items():
        w = (torch.randn((n_layers, o, i), generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
        x = torch.randn((rows, i), generator=gen, device=dev).to(
            torch.bfloat16)
        packed = [_quantize4(w[li]) for li in range(n_layers)]
        p4 = torch.stack([a for a, _ in packed])
        s4 = torch.stack([b for _, b in packed])
        q8, s8 = _quantize(w)
        s8 = s8.squeeze(-1)
        del packed

        # one product per layer, each reduced over all its columns into
        # the running sum, as the JAX tool's chain does
        def chain(step):
            def run():
                acc = torch.zeros((rows, 1), device=dev)
                for li in range(n_layers):
                    acc = acc + step(li).sum(dim=1, keepdim=True)
                return acc
            return run

        t16 = graph_time(chain(lambda li: matmul_f32(x, w[li].t())),
                         1, dev) / n_layers
        t8 = graph_time(chain(lambda li: int8_mm(x, q8, s8, li)),
                        1, dev) / n_layers
        t4 = graph_time(chain(lambda li: int4_mm(x, p4, s4, li)),
                        1, dev) / n_layers
        per_us = HBM_BYTES_PER_S / 1e6          # bytes a microsecond
        gb = o * i                               # per-layer elements
        print(f"{name} [{o}x{i}]: bf16 {t16*1e6:.0f} us "
              f"(floor {gb*2/per_us:.0f}) | int8 {t8*1e6:.0f} us "
              f"(floor {gb/per_us:.0f}) | int4-cuda {t4*1e6:.0f} us "
              f"(floor {gb/2/per_us:.0f})", flush=True)
        del w, p4, s4, q8, s8
    return 0


if __name__ == "__main__":
    sys.exit(main())
