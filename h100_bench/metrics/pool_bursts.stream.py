"""Decode bursts a traced tick: the `pool.decode` spans of each `pool.tick`,
the mean.  Each burst pays its launches and one blocking token read."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and _spans.per_root(ticks, "pool.decode", lambda s: 1)
