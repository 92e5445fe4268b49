"""The caching allocator's cudaMalloc calls in the traced ticks and the
tail's: the change in `torch.cuda.memory_stats()["num_device_alloc"]`
across each `pool.tick` span, summed."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and _spans.root_allocs(ticks)
