"""flash-decode (ops/flash_decode.py, csrc/flash_decode.cu) over the
traced batch: the roofline time of its work (work.flash_decode_work: 26
launches a step, K/V at each step's own fill) over its kernels' summed
device time, in %."""

from h100_bench import trace, work


def read(rec):
    tr = rec.get("trace") if rec.get("kind") == "offline" else None
    if not tr:
        return None
    launches, secs = trace.kernel_seconds(tr, "flash_decode_kernel")
    if not launches:
        return None
    b0 = rec["batches"][0]
    p0 = rec["prompt_len"] - 1
    positions = range(p0, p0 + b0["decode_steps"])
    kv = rec["model"]["precision"]["decoder_kv"]
    nb, nf = work.flash_decode_work(rec["model"], rec["streams"],
                                    positions, kv)
    return 100.0 * work.roofline_s(nb, nf) / secs
