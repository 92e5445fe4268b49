"""The pool's decode bursts on the device, ms a traced tick: from the
first `pool.decode` span's start marker to the last one's end marker in
each `pool.tick`, the mean; 0 in a tick without a burst."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and _spans.phase_device_ms(ticks, "pool.decode")
