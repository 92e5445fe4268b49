"""CUDA graphs captured in the traced ticks and the tail's: the
`graphs.capture` spans (ops/graphs.py GraphedCall) inside the `pool.tick`
spans.  The pool's caches live as long as it does, and the decode step's
graph is keyed by the cache, not the burst length, so what a window
captures is the ring encoder's new chunk shapes."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    return ticks and sum(len(kids.get("graphs.capture", ()))
                         for _, kids in ticks)
