"""The int8 product (ops/quant_mm.py, csrc/int8_mm.cu), the decoder's
products of an int8 configuration, over the traced batch: the roofline
time of the prefill's 104 products and each decode step's 105
(work.decoder_mm_work, a byte a weight plus its row's scale; operations
at the bf16 peak, onto which the weights are widened) over its kernels'
summed device time, in %."""

from h100_bench import trace, work


def read(rec):
    tr = rec.get("trace") if rec.get("kind") == "offline" else None
    if not tr:
        return None
    launches, secs = trace.kernel_seconds(tr, "int8_mm_kernel")
    if not launches or \
            rec["model"]["precision"]["decoder_weights"] != "int8":
        return None
    b0 = rec["batches"][0]
    nb, nf = work.decoder_mm_work(rec["model"], rec["streams"],
                                  b0["decode_steps"], rec["prompt_len"],
                                  "int8")
    return 100.0 * work.roofline_s(nb, nf) / secs
