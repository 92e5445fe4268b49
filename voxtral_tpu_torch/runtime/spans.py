"""Spans of the port's phases, on the profiler's timeline.

`span(name, **attrs)` is on exactly while a torch profiler records
(`torch.autograd.profiler._is_profiler_enabled`): the window a device
trace covers.  An operator turns them on by profiling the
way they already do, and reads what they kept with `drain()`:

    with torch.profiler.profile(activities=[...CPU, ...CUDA]):
        pool.tick()
    for s in spans.drain()["spans"]:
        print(s.name, s.request, s.host_ms, s.device_ms, s.alloc_calls)

Off, `span` returns one shared object that does nothing (one flag check, no
allocation, no clock read).  The callers'
timers then read the monotonic clock as they would without spans:

    t0 = time.monotonic()
    with spans.span("pool.encode", device=True) as sp:
        ...
    self.encoder_ms += 1e3 * sp.elapsed(t0)

On, a span is entered as a RecordFunction of its name, so it stands in
kineto's host timeline beside the aten ops and the device's operations,
and is kept in memory as a `Span` (name, id, parent id, request id, start, end,
attributes) whose start and end are on the profiler's clock (Unix epoch
ns: the monotonic clock plus an offset read when its outermost span
opens).  `elapsed` then returns the span's own length, so a timer fed from
it and the span never disagree.  With `device=True` a span also records a
CUDA event on the current stream at each boundary (read when drained,
never on the hot path: nothing synchronizes), and with `mem=True` it notes
the allocator's cudaMalloc calls (`num_device_alloc`) and the change in
`memory_reserved()` across it.  A span's request id is the one it is given
(a tick number), its parent's, or for an outermost span a number the
recorder counts (serve_clips' batches).

The RecordFunction is the profiler's function scope
(`torch._C._profiler._RecordFunctionFast`), not the user scope of
`torch.profiler.record_function`: kineto draws a user-scope range a second
time on the device's timeline (`gpu_user_annotation`) over the kernels
launched inside it, and a trace that takes every device event for an
operation would count the span as device work.

Spans sit at phase and burst boundaries only: never inside a CUDA graph's
captured body, nor in a loop over slots or layers.  The store is bounded
(`MAX_SPANS`; later spans are still profiled and timed, not kept) and no
file is written.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 18


@dataclass(eq=False)
class Span:
    """One closed span, as kept (see the module docstring)."""

    name: str
    id: int = 0
    parent: Optional[int] = None
    request: Optional[int] = None
    start_ns: int = 0            # the profiler's clock (Unix epoch ns)
    end_ns: int = 0
    attrs: dict = field(default_factory=dict)
    alloc_calls: Optional[int] = None     # cudaMalloc calls across it (mem)
    reserved_bytes: Optional[int] = None  # change in memory_reserved() (mem)
    # device markers (device=True on a card): ms after the store's first
    # marker, so that two spans' markers can be subtracted
    dev_start_ms: Optional[float] = None
    dev_end_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's markers (None without markers)."""
        if self.dev_start_ms is None:
            return None
        return self.dev_end_ms - self.dev_start_ms


def _rf_enter(name: str):
    """Opens the span's host event in the profiler (module docstring);
    returns its handle."""
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


def _rf_exit(handle) -> None:
    handle.__exit__(None, None, None)


def _mem_now() -> tuple[int, int]:
    """(cudaMalloc calls so far, bytes reserved) of the current device, read
    from the allocator's nested stats: `memory_stats()` flattens them in
    Python (0.145 ms a call against 0.024 on an H100 machine's host)."""
    st = torch.cuda.memory_stats_as_nested_dict()
    return st.get("num_device_alloc", 0), \
        st.get("reserved_bytes", {}).get("all", {}).get("current", 0)


class _Recorder:
    """The kept spans of this process."""

    def __init__(self):
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        self.spans: list[Span] = []
        self.dropped = 0
        self.next_id = 0
        self.next_request = 0
        self.origin = None           # the first device marker kept
        self.pending = []            # (span, origin, start event, end event)

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def settle(self) -> None:
        """Reads the device markers of the kept spans (waits for the card)."""
        if not self.pending:
            return
        torch.cuda.synchronize()
        for sp, origin, e0, e1 in self.pending:
            sp.dev_start_ms = origin.elapsed_time(e0)
            sp.dev_end_ms = origin.elapsed_time(e1)
        self.pending = []

    def record(self) -> dict:
        self.settle()
        return {"spans": sorted(self.spans, key=lambda s: s.id),
                "dropped": self.dropped}


_REC = _Recorder()


class _Open:
    """A span being recorded (returned by `span` while the profiler is
    on)."""

    __slots__ = ("span", "device", "mem", "off", "m0", "m1", "rf", "ev",
                 "mem0", "origin")

    def __init__(self, name, device, mem, request, attrs):
        self.span = Span(name, request=request, attrs=attrs)
        self.device, self.mem = device, mem
        self.ev = self.mem0 = None

    def __enter__(self):
        rec, sp = _REC, self.span
        stack = rec.stack()
        if stack:
            top = stack[-1]
            sp.parent, self.off = top.span.id, top.off
            if sp.request is None:
                sp.request = top.span.request
        else:
            self.off = time.time_ns() - time.monotonic_ns()
            if sp.request is None:
                sp.request = rec.next_request
                rec.next_request += 1
        sp.id = rec.next_id
        rec.next_id += 1
        stack.append(self)
        keep = len(rec.spans) < MAX_SPANS
        cuda = torch.cuda.is_initialized()
        self.m0 = time.monotonic_ns()
        self.rf = _rf_enter(sp.name)
        if self.mem and cuda:
            self.mem0 = _mem_now()
        if self.device and cuda and keep:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
            if rec.origin is None:
                rec.origin = self.ev[0]
            self.origin = rec.origin
        return self

    def __exit__(self, *exc):
        rec, sp = _REC, self.span
        if self.ev is not None:
            self.ev[1].record()
        if self.mem0 is not None:
            n, r = _mem_now()
            sp.alloc_calls, sp.reserved_bytes = n - self.mem0[0], \
                r - self.mem0[1]
        _rf_exit(self.rf)
        self.m1 = time.monotonic_ns()
        rec.stack().pop()
        sp.start_ns, sp.end_ns = self.m0 + self.off, self.m1 + self.off
        if len(rec.spans) < MAX_SPANS:
            rec.spans.append(sp)
            if self.ev is not None:
                rec.pending.append((sp, self.origin, *self.ev))
        else:
            rec.dropped += 1
        return False

    def note(self, **attrs) -> None:
        """Adds attributes known only once the span is open."""
        self.span.attrs.update(attrs)

    def elapsed(self, t0: float) -> float:
        """The span's own length in seconds (t0 is not read)."""
        return (self.m1 - self.m0) * 1e-9


class _Off:
    """What `span` returns while no profiler records: nothing happens."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        pass

    @staticmethod
    def elapsed(t0: float) -> float:
        """Seconds since t0 (a `time.monotonic()` reading)."""
        return time.monotonic() - t0


OFF = _Off()


def span(name: str, *, device: bool = False, mem: bool = False,
         request: Optional[int] = None, **attrs):
    """A context manager for the phase `name` (module docstring): device
    markers with `device`, allocator counts with `mem`, `request` the
    request id (default: the parent's, or the recorder's next)."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Open(name, device, mem, request, attrs)


def recorded() -> dict:
    """What has been kept, without clearing it: {"spans": [Span, ...] in
    the order they opened, "dropped": spans not kept}.
    Reads the device markers first (a device sync)."""
    return _REC.record()


def drain() -> dict:
    """`recorded()`, then clears the store."""
    out = _REC.record()
    _REC.clear()
    return out
