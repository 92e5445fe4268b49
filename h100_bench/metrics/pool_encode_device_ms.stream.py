"""The pool's encoder on the device, ms a traced tick: from the first
`pool.encode` span's start marker (a CUDA event) to the last one's end
marker in each `pool.tick`, the mean; 0 in a tick without an encoder
pass."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and _spans.phase_device_ms(ticks, "pool.encode")
