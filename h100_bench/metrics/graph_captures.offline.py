"""CUDA graphs captured in the traced batch: the `graphs.capture` spans
inside its `serve.clips` span.  serve_clips makes a new decoder cache a
call, and the decode step's graph is keyed by the batch and the cache,
not the burst length: one capture a batch, the step's."""

from h100_bench.metrics import _spans


def read(rec):
    batches = _spans.trees(rec, "offline", "serve.clips")
    return batches and sum(len(kids.get("graphs.capture", ()))
                           for _, kids in batches)
