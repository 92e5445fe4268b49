"""What the program's span recorder (voxtral_tpu_torch/runtime/spans.py)
kept in this process while the profiler ran, grouped for the per-layer
readers.  The recorder is on exactly while a torch profiler records, so it
holds the traced window's spans alone: the traced batch, or the stream's
traced ticks and its tail's.  A record of another kind, a run without a
trace, and a program without the recorder all give None."""


def kept(rec: dict, kind: str):
    """The spans kept, in the order they opened, or None."""
    if rec.get("kind") != kind or not rec.get("trace"):
        return None
    try:
        from voxtral_tpu_torch.runtime import spans
    except ImportError:
        return None
    return spans.recorded()["spans"]


def trees(rec: dict, kind: str, root: str):
    """[(a `root` span, {name: [its descendants of that name]}), ...], or
    None when no `root` span was kept."""
    got = kept(rec, kind)
    if not got:
        return None
    by_id = {s.id: s for s in got}
    out = {s.id: (s, {}) for s in got if s.name == root}
    if not out:
        return None
    for s in got:
        top = s
        while top.parent is not None and top.parent in by_id:
            top = by_id[top.parent]
        if top.id in out and top is not s:
            out[top.id][1].setdefault(s.name, []).append(s)
    return list(out.values())


def per_root(groups, name: str, value) -> float:
    """The mean over the roots of the sum of `value(span)` over each root's
    `name` spans (0 in a root without them)."""
    return sum(sum(value(s) for s in kids.get(name, ()))
               for _, kids in groups) / len(groups)


def phase_device_ms(groups, name: str):
    """Device ms a root between the first and the last device marker of its
    `name` spans (0 in a root without them), the mean over the roots; None
    where the spans carry no markers (no card)."""
    total = 0.0
    for _, kids in groups:
        ph = kids.get(name)
        if not ph:
            continue
        if any(s.dev_start_ms is None for s in ph):
            return None
        total += max(s.dev_end_ms for s in ph) - min(s.dev_start_ms
                                                      for s in ph)
    return total / len(groups)


def root_allocs(groups):
    """cudaMalloc calls summed over the roots (None off a card)."""
    calls = [root.alloc_calls for root, _ in groups]
    return None if None in calls else sum(calls)
