"""The traced span: torch.profiler over one stated span of the window,
reduced in memory to per-kernel sums, the device's busy time and the idle
gaps (no trace file is written).

Busy time is the union of the device operations' intervals, so kernels
that overlap (a programmatic dependent launch starts before the kernel
ahead of it ends) count once: the arithmetic of the port's
`chip_smoke.py:busy_us`, copied.  An idle gap is named by what the host
was doing at its middle: the innermost host event open there.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

SPAN = "h100_bench.span"
# gaps shorter than this are the launch seams inside a CUDA graph
MIN_GAP_NS = 10_000
TOP = 10


def profiled(fn):
    """(fn(), the profiler, the host seconds fn took) with fn traced on the
    host and the device inside one named span that ends after a device
    sync.  The seconds leave out the profiler's start and its stop, where
    it collects its records."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN):
            t_in = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t_in
    return out, prof, wall


def start():
    """(a running profiler, the open span): for a span that covers several
    calls (`end_span` closes it; stop the profiler after)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    span = torch.profiler.record_function(SPAN)
    span.__enter__()
    return prof, span


def end_span(span):
    torch.cuda.synchronize()
    span.__exit__(None, None, None)


def union_ns(spans) -> tuple[int, list]:
    """(total length, merged intervals) of [start, end) intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _short(name: str, n: int = 96) -> str:
    name = " ".join(name.split())
    return name if len(name) <= n else name[: n - 3] + "..."


def summarize(events) -> dict:
    """Reduce profiler events, given as (name, on_device, start_ns, end_ns),
    to: the span's length, the device's busy time in it, each device
    operation's count and summed seconds, and the longest idle gaps by
    host activity."""
    dev, host, span = [], [], None
    for name, on_device, a, b in events:
        if name == SPAN:
            if not on_device:
                span = (a, b)
            continue
        if on_device:
            if "Command Buffer Full" not in name:
                dev.append((name, a, b))
        else:
            host.append((a, b, name))
    if span is None:
        raise RuntimeError("the profiler recorded no traced span")
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    lo, hi = span
    busy, merged = union_ns([(max(a, lo), min(b, hi)) for _, a, b in dev
                             if b > lo and a < hi])
    ops = defaultdict(lambda: [0, 0.0])
    for name, a, b in dev:
        o = ops[name]
        o[0] += 1
        o[1] += (b - a) * 1e-9
    host.sort()
    starts = [a for a, _, _ in host]
    gaps = defaultdict(lambda: [0, 0.0])
    edges = [lo] + [x for m in merged for x in m] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a < MIN_GAP_NS:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        label = "no host event"
        for j in range(i - 1, max(i - 2000, -1), -1):
            ha, hb, hname = host[j]
            if hb > mid:
                label = hname          # the latest-starting open event
                break
        g = gaps[_short(label, 64)]
        g[0] += 1
        g[1] += (b - a) * 1e-9
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "span_s": (hi - lo) * 1e-9,
        "busy_s": busy * 1e-9,
        "ops": {name: (n, s) for name, (n, s) in ops.items()},
        "breakdown": {
            "device_ops": [[_short(n), s] for n, (_, s) in top_ops],
            "idle_gaps": [[f"{n} (x{c})", s] for n, (c, s) in top_gaps],
        },
    }


def profiler_events(prof) -> list:
    """(name, on_device, start_ns, end_ns) of every event the profiler
    kept, read from its raw results (building torch's event objects for a
    batch's half a million kernels takes minutes)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        a = e.start_ns()
        out.append((e.name(), on_device, a, a + e.duration_ns()))
    return out


def kernel_seconds(summary: dict, marker: str) -> tuple[int, float]:
    """(launches, summed device seconds) of the kernels whose name holds
    `marker`."""
    n = s = 0
    for name, (c, t) in summary["ops"].items():
        if marker in name:
            n += c
            s += t
    return n, s
