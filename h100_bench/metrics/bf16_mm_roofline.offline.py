"""bf16_mm (ops/bf16_mm.py, csrc/bf16_mm.cu), the decoder's products of a
bf16 configuration, over the traced batch: the roofline time of the
prefill's 104 products and each decode step's 105 (work.decoder_mm_work)
over its kernels' summed device time, in %."""

from h100_bench import trace, work


def read(rec):
    tr = rec.get("trace") if rec.get("kind") == "offline" else None
    if not tr:
        return None
    launches, secs = trace.kernel_seconds(tr, "bf16_mm_kernel")
    if not launches or \
            rec["model"]["precision"]["decoder_weights"] != "bf16":
        return None
    b0 = rec["batches"][0]
    nb, nf = work.decoder_mm_work(rec["model"], rec["streams"],
                                  b0["decode_steps"], rec["prompt_len"],
                                  "bf16")
    return 100.0 * work.roofline_s(nb, nf) / secs
