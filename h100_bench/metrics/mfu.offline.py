"""The whole model's share of the bf16 peak over the window: the model
operations of every clip completed (work.offline_clip_flops, from the
configuration's shapes) over window seconds x 989 TFLOP/s, in %."""

from h100_bench import work


def read(rec):
    b = rec.get("batches") if rec.get("kind") == "offline" else None
    if not b:
        return None
    flops = rec["clip_flops"] * rec["streams"] * len(b)
    return 100.0 * flops / (rec["window_s"] * work.BF16_FLOPS)
