"""The pool's tick (StreamPool.tick: encode every eligible backlog, then
decode every row backlog), the harness's clock around the call, median
over the window's untraced ticks, ms."""

import numpy as np


def read(rec):
    t = rec.get("tick_ms") if rec.get("kind") == "stream" else None
    return float(np.percentile(t, 50)) if t else None
