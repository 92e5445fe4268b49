"""The pool's encoder passes, host ms a traced tick: the `pool.encode`
spans (parallel/scheduler.py `_encode_pass`: the takers' host mel, the
upload, the launch; the host's issue time, not the device's), summed over
each `pool.tick` span of the traced ticks and the tail's, the mean."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and _spans.per_root(ticks, "pool.encode",
                                     lambda s: s.host_ms)
