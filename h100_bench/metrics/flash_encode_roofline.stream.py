"""flash-encode (ops/flash_encode.py, csrc/flash_encode.cu) over the traced
ticks: the roofline time of the pool's encoder chunks (work.flash_encode_
work: every slot of each call, riders included, at its own encoder
position) over its kernels' summed device time, in %."""

from h100_bench import trace, work

RING = {"bfloat16": "bf16", "float8_e4m3fn": "e4m3"}


def read(rec):
    tr = rec.get("trace") if rec.get("kind") == "stream" else None
    if not tr:
        return None
    launches, secs = trace.kernel_seconds(tr, "flash_encode_kernel")
    if not launches or not rec["encode_calls"]:
        return None
    ring = RING[rec["model"]["enc_kv_dtype"]]
    nb = nf = 0.0
    for q, positions in rec["encode_calls"]:
        b, f = work.flash_encode_work(rec["model"], q // 2, positions, ring)
        nb, nf = nb + b, nf + f
    return 100.0 * work.roofline_s(nb, nf) / secs
