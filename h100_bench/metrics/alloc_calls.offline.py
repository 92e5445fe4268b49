"""The caching allocator's cudaMalloc calls in the traced batch: the change
in `torch.cuda.memory_stats()["num_device_alloc"]` across its
`serve.clips` span."""

from h100_bench.metrics import _spans


def read(rec):
    batches = _spans.trees(rec, "offline", "serve.clips")
    return batches and _spans.root_allocs(batches)
