"""The port's span recorder (runtime/spans.py) on the CPU: off without a
profiler (nothing kept, no record_function), nesting and request ids under
one, the spans' clock against kineto's own events, a tiny StreamPool's
tick and serve_clips split into spans that feed their timers, and the
benchmark's span readers (h100_bench/metrics) on spans made by hand.  The
device markers are checked on the card (tests/test_torch_cuda.py)."""

import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import make_audio
from h100_bench import run
from voxtral_tpu_torch import runtime as runtime_pkg
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.params import init_params
from voxtral_tpu_torch.parallel import serving
from voxtral_tpu_torch.parallel.scheduler import StreamPool
from voxtral_tpu_torch.runtime import spans
from voxtral_tpu_torch.runtime.engine import VoxtralEngine
from voxtral_tpu_torch.runtime.offline import padded_clip_mel
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_store():
    spans.drain()
    yield
    spans.drain()


@pytest.fixture(scope="module")
def tiny_engine():
    cfg = tiny_config()
    return VoxtralEngine(
        cfg, init_params(cfg, seed=0, device="cpu"),
        tokenizer=TekkenTokenizer([bytes([i]) for i in range(256)], 1000),
        buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(kept):
    out = {}
    for s in kept:
        out.setdefault(s.name, []).append(s)
    return out


# --- the switch ----------------------------------------------------------

def test_off_without_a_profiler_keeps_nothing_and_enters_no_record_function(
        monkeypatch, tiny_engine):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(spans, "_rf_enter", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    t0 = time.monotonic()
    with spans.span("x", device=True, mem=True, request=3, a=1) as sp:
        sp.note(b=2)
    assert sp is spans.OFF and 0.0 <= sp.elapsed(t0) < 10.0
    pool = StreamPool(tiny_engine, 2, dec_kv_ring=64, enc_mode="ring")
    i = pool.add_stream()
    pool.feed(i, make_audio(1.5, seed=4))
    pool.tick()
    assert pool.encoder_ms > 0 and pool.n_enc_calls > 0
    assert spans.drain() == {"spans": [], "dropped": 0}


# --- nesting, ids ------------------------------------------------------------

def test_spans_nest_with_parent_and_request_ids():
    with cpu_profile():
        with spans.span("a", request=7, mem=True) as a:
            with spans.span("b"):
                with spans.span("c", k=1) as c:
                    c.note(m="x")
        with spans.span("d"):
            with spans.span("e", request=5):
                pass
        with spans.span("f"):
            pass
    t0 = time.monotonic()
    assert a.elapsed(t0) == pytest.approx(
        (a.span.end_ns - a.span.start_ns) * 1e-9, abs=1e-12)
    got = spans.drain()
    s = {x.name: x for x in got["spans"]}
    assert [x.name for x in got["spans"]] == list("abcdef")
    assert (s["a"].parent, s["b"].parent, s["c"].parent) == (
        None, s["a"].id, s["b"].id)
    assert s["a"].request == s["b"].request == s["c"].request == 7
    # an outermost span without a request id takes the recorder's next
    assert s["d"].request == 0 and s["f"].request == 1
    assert s["e"].parent == s["d"].id and s["e"].request == 5
    assert s["c"].attrs == {"k": 1, "m": "x"}
    assert got["dropped"] == 0
    for x in got["spans"]:
        assert x.start_ns <= x.end_ns
    assert s["a"].start_ns <= s["b"].start_ns <= s["c"].start_ns
    assert s["c"].end_ns <= s["b"].end_ns <= s["a"].end_ns
    # no card: no markers, no allocator counts
    assert s["a"].alloc_calls is None and s["a"].device_ms is None
    assert spans.recorded()["spans"] == []


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "MAX_SPANS", 3)
    with cpu_profile():
        for i in range(5):
            with spans.span(f"s{i}"):
                pass
    got = spans.drain()
    assert [x.name for x in got["spans"]] == ["s0", "s1", "s2"]
    assert got["dropped"] == 2


# --- the clock ---------------------------------------------------------------

def test_span_times_are_on_the_profilers_clock():
    """Each kept span starts and ends within 50 us of its own host event
    in kineto's events.  A preempted thread can
    part one pair by more, so the measurement is repeated up to three
    times; one attempt must hold for every span."""
    worst = []
    for attempt in range(3):
        spans.drain()
        with cpu_profile() as prof:
            for i in range(12):
                with spans.span(f"clock.{attempt}.{i}"):
                    with spans.span(f"clock.{attempt}.{i}.inner"):
                        torch.randn(64, 64) @ torch.randn(64, 64)
        ev = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()}
        kept = spans.drain()["spans"]
        assert len(kept) == 24
        off = [max(abs(s.start_ns - ev[s.name][0]),
                   abs(s.end_ns - ev[s.name][1])) for s in kept]
        worst.append(max(off))
        if worst[-1] <= 50_000:
            return
    pytest.fail(f"spans off kineto's clock by up to {worst} ns")


# --- the pool's tick and serve_clips --------------------------------------

def test_pool_tick_is_split_into_spans_that_feed_its_timers(tiny_engine):
    pool = StreamPool(tiny_engine, 3, dec_kv_ring=64, enc_mode="ring")
    pool.record_ids = True
    slots = [pool.add_stream() for _ in range(2)]
    for i in slots:
        pool.set_processing_interval(i, 0.25)
        pool.set_continuous(i, True)
    audios = [make_audio(3.0, seed=1), make_audio(2.2, seed=2)]
    step = 8000
    with cpu_profile():
        n = 0
        for off in range(0, 48000, step):
            for i, a in zip(slots, audios):
                if off < len(a):
                    pool.feed(i, a[off: off + step])
            pool.tick()
            n += 1
    got = spans.drain()
    names = by_name(got["spans"])
    ticks = names["pool.tick"]
    assert [t.request for t in ticks] == list(range(n))
    assert all(t.parent is None for t in ticks)
    ids = {s.id: s for s in got["spans"]}
    for s in got["spans"]:
        if s.name != "pool.tick":
            top = s
            while top.parent is not None:
                top = ids[top.parent]
            assert top.name == "pool.tick" and s.request == top.request
    for child, parent in (("pool.encode.gather", "pool.encode"),
                          ("pool.encode.launch", "pool.encode"),
                          ("pool.decode.launch", "pool.decode"),
                          ("pool.decode.fetch", "pool.decode"),
                          ("pool.decode.tokens", "pool.decode"),
                          ("pool.encode", "pool.tick"),
                          ("pool.decode", "pool.tick"),
                          ("pool.admit", "pool.tick"),
                          ("pool.restart", "pool.tick")):
        assert names[child] and all(ids[s.parent].name == parent
                                    for s in names[child]), child
    assert len(names["pool.restart"]) == n
    assert sorted(s.attrs["slot"] for s in names["pool.admit"])[:2] == [0, 1]

    def host(name):
        return sum(s.host_ms for s in names.get(name, ()))

    assert pool.encoder_ms == pytest.approx(host("pool.encode"), abs=1e-9)
    assert pool.decoder_ms == pytest.approx(
        host("pool.admit") + host("pool.decode") + host("pool.restart"),
        abs=1e-9)
    assert pool.fetch_ms == pytest.approx(host("pool.decode.fetch"),
                                          abs=1e-9)
    assert pool.n_enc_calls == len(names["pool.encode"])
    assert pool.n_bursts == len(names["pool.decode"])


def test_serve_clips_is_split_into_spans_that_feed_its_stats(tiny_engine):
    mel = torch.from_numpy(np.stack([
        padded_clip_mel(tiny_engine, make_audio(1.2, seed=s))
        for s in (5, 6)]))
    with cpu_profile():
        ids, st = serving.serve_clips(tiny_engine, mel)
        serving.serve_clips(tiny_engine, mel)
    names = by_name(spans.drain()["spans"])
    a, b = names["serve.clips"]
    assert (a.request, b.request) == (0, 1)
    for part, key in (("serve.encode", "encode_s"),
                      ("serve.prefill", "prefill_s"),
                      ("serve.decode", "decode_s")):
        first = names[part][0]
        assert first.parent == a.id and first.request == 0
        assert first.host_ms == pytest.approx(1e3 * st[key], abs=1e-9)
    dec = names["serve.decode"][0]
    bursts = [s for s in names["serve.burst"] if s.parent == dec.id]
    assert sum(s.attrs["rows"] for s in bursts) == st["decode_steps"]
    assert [s.parent for s in names["serve.fetch"]] == [
        d.id for d in names["serve.decode"]]
    assert len(ids) == 2


# --- the benchmark's readers ------------------------------------------------

def hand_spans():
    """Two traced ticks and one traced batch, made by hand (ms: host
    lengths; device markers in ms)."""
    out = []

    def add(name, parent, host, dev=None, **kw):
        s = spans.Span(name, id=len(out), parent=parent, start_ns=0,
                       end_ns=int(host * 1e6), **kw)
        if dev:
            s.dev_start_ms, s.dev_end_ms = dev
        out.append(s)
        return s.id

    t0 = add("pool.tick", None, 80.0, request=0, alloc_calls=3)
    add("pool.encode", t0, 10.0, (0.0, 8.0))
    add("pool.encode", t0, 5.0, (9.0, 12.0))
    add("pool.admit", t0, 4.0, (12.5, 13.0), attrs={"slot": 1})
    d = add("pool.decode", t0, 20.0, (13.0, 30.0))
    add("pool.decode.fetch", d, 6.0)
    la = add("pool.decode.launch", d, 2.0)
    add("graphs.capture", la, 1.5)
    t1 = add("pool.tick", None, 60.0, request=1, alloc_calls=1)
    add("pool.encode", t1, 6.0, (100.0, 105.0))
    for host, dev, fetch in ((7.0, (106.0, 110.0), 2.0),
                             (8.0, (111.0, 115.0), 3.0)):
        d = add("pool.decode", t1, host, dev)
        add("pool.decode.fetch", d, fetch)
    b = add("serve.clips", None, 900.0, request=0, alloc_calls=26)
    e = add("serve.decode", b, 700.0)
    add("graphs.capture", e, 30.0)
    add("graphs.capture", e, 20.0)
    return out


STREAM = {"kind": "stream", "trace": {"busy_s": 1.0, "span_s": 2.0}}
OFFLINE = {"kind": "offline", "trace": {"busy_s": 1.0, "span_s": 2.0}}


@pytest.mark.parametrize("name, rec, want", [
    ("pool_encode_ms.stream", STREAM, (15.0 + 6.0) / 2),
    ("pool_encode_device_ms.stream", STREAM, (12.0 + 5.0) / 2),
    ("pool_decode_ms.stream", STREAM, (20.0 + 15.0) / 2),
    ("pool_fetch_ms.stream", STREAM, (6.0 + 5.0) / 2),
    ("pool_decode_device_ms.stream", STREAM, (17.0 + 9.0) / 2),
    ("pool_admit_ms.stream", STREAM, 4.0),
    ("pool_bursts.stream", STREAM, 1.5),
    ("alloc_calls.stream", STREAM, 4),
    ("graph_captures.stream", STREAM, 1),
    ("alloc_calls.offline", OFFLINE, 26),
    ("graph_captures.offline", OFFLINE, 2),
])
def test_span_readers(monkeypatch, name, rec, want):
    kept = hand_spans()
    monkeypatch.setattr(spans, "recorded", lambda: {"spans": kept})
    assert run.read_metric(name, rec) == pytest.approx(want)
    other = OFFLINE if rec is STREAM else STREAM
    assert run.read_metric(name, other) is None
    assert run.read_metric(name, dict(rec, trace=None)) is None
    # a program without the recorder (the parent of this change)
    monkeypatch.delattr(runtime_pkg, "spans")
    monkeypatch.setitem(sys.modules, "voxtral_tpu_torch.runtime.spans", None)
    assert run.read_metric(name, rec) is None


@pytest.mark.parametrize("name", ["pool_encode_device_ms.stream",
                                  "pool_decode_device_ms.stream",
                                  "alloc_calls.stream",
                                  "pool_admit_ms.stream"])
def test_span_readers_without_a_card_or_admissions(monkeypatch, name):
    """Spans kept on the CPU carry no markers and no allocator counts, and
    ticks may hold no admission: those readers find nothing."""
    kept = [s for s in hand_spans() if s.name != "pool.admit"]
    for s in kept:
        s.dev_start_ms = s.dev_end_ms = s.alloc_calls = None
    monkeypatch.setattr(spans, "recorded", lambda: {"spans": kept})
    assert run.read_metric(name, STREAM) is None
