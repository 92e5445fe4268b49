"""The host blocked on the card for the bursts' tokens, ms a traced tick:
the `pool.decode.fetch` spans (the one host read a burst, which waits for
every kernel issued before it) summed over each `pool.tick`, the mean."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and _spans.per_root(ticks, "pool.decode.fetch",
                                     lambda s: s.host_ms)
