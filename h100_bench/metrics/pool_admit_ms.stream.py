"""An admission's prompt prefill (one slot, eager), host ms: the mean of
the `pool.admit` spans of the traced ticks; None where no admission fell
in them."""

from h100_bench.metrics import _spans


def read(rec):
    ticks = _spans.trees(rec, "stream", "pool.tick")
    admits = [s for _, kids in ticks or () for s in kids.get("pool.admit", ())]
    return sum(s.host_ms for s in admits) / len(admits) if admits else None
