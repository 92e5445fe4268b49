"""How late the feeds ran: a tick's start after the moment it was due, 95th
percentile over the window's untraced ticks, ms.  Near 0 while the pool
keeps up; it grows when ticks outlast the feed interval."""

import numpy as np


def read(rec):
    t = rec.get("late_ms") if rec.get("kind") == "stream" else None
    return float(np.percentile(t, 95)) if t else None
