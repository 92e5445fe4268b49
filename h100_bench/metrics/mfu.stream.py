"""The whole model's share of the bf16 peak while the pool ticks: the
model operations of the window's untraced ticks (each slot's new encoder
positions, prefills and decode steps, from the configuration's shapes:
work.encoder_flops, work.decoder_flops) over their summed walls x 989
TFLOP/s, in %."""

from h100_bench import work


def read(rec):
    t = rec.get("tick_ms") if rec.get("kind") == "stream" else None
    if not t:
        return None
    return 100.0 * sum(rec["tick_flops"]) / (1e-3 * sum(t) * work.BF16_FLOPS)
