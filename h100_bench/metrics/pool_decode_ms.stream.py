"""The pool's decode bursts, host ms a traced tick: the `pool.decode`
spans (one a burst: the launch, the token read, the tokens' host
handling) summed over each `pool.tick`, the mean."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and _spans.per_root(ticks, "pool.decode",
                                     lambda s: s.host_ms)
