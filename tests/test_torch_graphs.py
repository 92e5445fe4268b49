"""The port's CUDA-graph layer (ops/graphs.py) on the CPU: the rule of
which calls replay as graphs (decoder._use_graph), the launch-counter
bookkeeping of a capture and its replays, a capture that fails, and a
rehearsal of every graphed path with a stand-in for torch.cuda.CUDAGraph
that replays by running the captured body again: the decode step (with
and without alternatives), the streaming encoder chunk and the Jacobi
window give the ids of the eager paths, which the other torch tests hold
to the JAX package.  The card's own graphs are checked against eager in
tests/test_torch_cuda.py."""

import gc
import types
import weakref

import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu_torch.config import TOKEN_STREAMING_PAD, tiny_config
from voxtral_tpu_torch.models import decoder as dec_mod
from voxtral_tpu_torch.models import encoder as enc_mod
from voxtral_tpu_torch.models import jacobi as jac_mod
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops import graphs
from voxtral_tpu_torch.ops.flash_decode import flash_decode
from voxtral_tpu_torch.ops.graphs import GraphedCall, GraphStore
from voxtral_tpu_torch.ops.quant_mm import int4_mm
from voxtral_tpu_torch.parallel.scheduler import StreamPool
from voxtral_tpu_torch.parallel.serving import BatchedTranscriber
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime.offline import transcribe_offline_ids
from voxtral_tpu_torch.runtime.stream import VoxStream
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)

KW = dict(buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)
CUDA = types.SimpleNamespace(device=torch.device("cuda"))


class FakeGraph:
    """A stand-in for torch.cuda.CUDAGraph: the capture API, no device.  On
    the CPU the captured body runs; a capture runs nothing on the card, so
    the stand-in puts the static inputs back as they were before it."""

    def __init__(self, static):
        self.static, self.captured, self.replays = static, False, 0

    def capture_begin(self, capture_error_mode):
        assert capture_error_mode == "global"
        self.saved = [x.clone() for x in self.static]

    def capture_end(self):
        for x, s in zip(self.static, self.saved):
            x.copy_(s)
        self.captured = True

    def replay(self):
        assert self.captured
        self.replays += 1


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.fixture
def stand_in(monkeypatch):
    """GraphedCall on FakeGraph, replaying by running its body again into
    the captured outputs (the body's in-place writes are the replay's)."""
    replay, init = GraphedCall.replay, GraphedCall.__init__

    def keep_body(self, body, inputs, store, *key):
        self.body = body          # the stand-in replays by running it
        init(self, body, inputs, store, *key)

    def rerun(self):
        counts = graphs._counts()
        new = self.body(*self.static)
        graphs._set_counts(counts)     # a replay's launches are its deltas
        for o, n in zip(_leaves(self.out), _leaves(new)):
            o.copy_(n)
        return replay(self)

    monkeypatch.setattr(GraphedCall, "new_graph",
                        lambda self: FakeGraph(self.static))
    monkeypatch.setattr(GraphedCall, "replay", rerun)
    monkeypatch.setattr(GraphedCall, "__init__", keep_body)
    graphs.reset_stats()


@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.fixture(scope="module")
def ttok():
    return TekkenTokenizer([bytes([i]) for i in range(256)], 1000)


# --- the rule -----------------------------------------------------------------

def _cache(graphs_on=True):
    return types.SimpleNamespace(graphs=GraphStore() if graphs_on else None)


@pytest.mark.parametrize("call,x,cfg,graphs_on,want", [
    ("step", CUDA, "plain", True, True),
    ("encoder", CUDA, "plain", True, True),
    ("jacobi", CUDA, "plain", True, True),
    ("step", torch.zeros(1), "plain", True, False),          # the CPU
    ("encoder", torch.zeros(1), "plain", True, False),
    ("step", CUDA, "tp2", True, False),                      # tp > 1
    ("encoder", CUDA, "tp2", True, False),
    ("prefill", CUDA, "plain", True, False),                 # decoder T > 1
    ("bulk", CUDA, "plain", True, False),                    # bulk encoder
    ("step", CUDA, "plain", False, False),                   # the switch
    ("jacobi", CUDA, "plain", False, False),
])
def test_graph_rule(call, x, cfg, graphs_on, want):
    c = tiny_config()
    if cfg == "tp2":
        c = types.SimpleNamespace(tp=object())     # a tp group of a mesh
    assert dec_mod._use_graph(c, _cache(graphs_on), x, call) is want


def test_engine_switch_makes_caches_without_graphs(tparams, ttok):
    on = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok, **KW)
    off = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                             cuda_graphs=False, **KW)
    for eng, want in ((on, True), (off, False)):
        for cache in (eng.new_dec_cache(), eng.new_enc_cache(2)):
            assert (cache.graphs is not None) is want
        bt = BatchedTranscriber(eng, 2)
        assert (bt.dec_cache.graphs is not None) is want
        assert (bt.enc_cache.graphs is not None) is want


# --- the bookkeeping ------------------------------------------------------------

def test_capture_and_replays_count_the_captured_launches(stand_in):
    """The first call runs (its launches count), the capture records what
    its body launched and takes it back, every replay adds it again."""
    flash_decode.launches, int4_mm.launches = 5, 7

    def body(x, y):
        flash_decode.launches += 2        # as the wrappers count launches
        int4_mm.launches += 1
        y.add_(1)
        return x * 2

    store = GraphStore()
    key = ("t", 1)
    g, out = store.call(key, body, (torch.ones(3), torch.zeros(1)))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert (flash_decode.launches, int4_mm.launches) == (7, 8)
    assert g.launches[1] == 2 and g.launches[3] == 1 and sum(g.launches) == 3
    assert g.graph.captured and g.graph.replays == 0
    for i in range(4):
        g2, out = store.call(key, body, (torch.full((3,), float(i)), None))
        assert g2 is g and torch.equal(out, torch.full((3,), 2.0 * i))
    assert g.graph.replays == 4
    assert (flash_decode.launches, int4_mm.launches) == (7 + 8, 8 + 4)
    assert float(g.static[1]) == 1 + 4         # the first call, 4 replays
    assert graphs.GraphedCall.captures == 1 and len(store) == 1


def test_a_capture_that_fails_raises(stand_in):
    """A body the capture refuses raises out of the call: no graph is
    kept, no eager result stands in for it, the counters are restored."""
    flash_decode.launches = 3
    runs = []

    def body(x):
        runs.append(1)
        flash_decode.launches += 1
        if len(runs) == 2:           # the capture
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1

    store = GraphStore()
    with pytest.raises(RuntimeError, match="capturing"):
        store.call(("t",), body, (torch.zeros(2),))
    assert flash_decode.launches == 4 and len(store) == 0


def test_a_cache_and_its_graphs_go_without_a_collection(monkeypatch):
    """A graph keeps no reference to its body, whose closure holds the
    cache: dropping the cache frees it and its graphs at once, with the
    cyclic collector off (a graph freed by a collection that ran inside
    another capture would break that capture)."""
    monkeypatch.setattr(GraphedCall, "new_graph",
                        lambda self: FakeGraph(self.static))
    cache = dec_mod.KVCache(torch.zeros(2), torch.zeros(2), GraphStore())
    cache.graphs.call(("t",), lambda x: cache.k.add_(x), (torch.ones(2),))
    gone = weakref.ref(cache)
    graph = weakref.ref(cache.graphs.lookup(("t",)))
    gc.disable()
    try:
        del cache
        assert gone() is None and graph() is None
    finally:
        gc.enable()


# --- the graphed paths against eager ------------------------------------------

def _eager_and_graphed(monkeypatch, run):
    """run(cuda_graphs) with the eager rule, then with the graphed one."""
    eager = run(False)
    for mod in (dec_mod, enc_mod, jac_mod):
        monkeypatch.setattr(mod, "_use_graph", lambda cfg, cache, x, call:
                            dec_mod.GRAPHED_CALLS.count(call) > 0
                            and cache.graphs is not None)
    graphed = run(True)
    return eager, graphed


def test_decode_step_graph_equals_eager(tparams, ttok, stand_in, monkeypatch):
    """Bursts of 4, 1 and 16 at B=3 on one cache, n_alt 0 and 2: tokens,
    alternatives and probabilities equal the eager loop's, the ring equal
    bit for bit; one capture per (cache, n_alt), every later step a
    replay."""
    cfg = tiny_config()
    eng = teng.VoxtralEngine(cfg, tparams, tokenizer=ttok, **KW)
    rng = np.random.default_rng(5)
    chunks = [torch.from_numpy((rng.standard_normal(
        (3, t, cfg.decoder.dim)) * 0.5).astype(np.float32)) for t in (4, 1, 16)]

    def run(on):
        outs = []
        for n_alt in (0, 2):
            cache = eng.new_dec_cache(3)
            if not on:
                cache.graphs = None
            prev = torch.full((3,), TOKEN_STREAMING_PAD, dtype=torch.int32)
            pos = torch.tensor([0, 5, 9], dtype=torch.int32)
            for ch in chunks:
                o = dec_mod.decode_burst(eng.params["decoder"], cfg, ch, prev,
                                         cache, pos, eng.ada(), n_alt=n_alt)
                outs.append(o[:4])
                prev, pos = o[0][:, -1], pos + ch.shape[1]
            outs.append((cache.k, cache.v))
            if on:
                assert len(cache.graphs) == 1
        return outs

    eager, graphed = _eager_and_graphed(monkeypatch, run)
    for a, b in zip(eager, graphed):
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y)
    assert graphs.GraphedCall.captures == 2


def test_streaming_paths_graphed_equal_eager(tparams, ttok, stand_in,
                                             monkeypatch):
    """A VoxStream (fused and bucketed encoder chunks, alternatives), a
    B=2 BatchedTranscriber and a ring-mode StreamPool with a late joiner:
    the graphed encoder chunks and steps give the eager ids."""
    a, b = make_audio(2.0, seed=3), make_audio(1.6, seed=4)

    def run(on):
        eng = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                                 cuda_graphs=on, **KW)
        s = VoxStream(eng)
        s.set_processing_interval(0.25)
        s.set_alt(2, 0.9)
        for i in range(0, len(a), 5000):
            s.feed(a[i: i + 5000])
        s.finish()
        bt = BatchedTranscriber(eng, 2)
        mel = np.random.default_rng(6).standard_normal(
            (2, 480, 128)).astype(np.float32)
        bt.transcribe(mel, interval_frames=72)
        pool = StreamPool(eng, 2, dec_kv_ring=64, enc_mode="ring")
        ia = pool.add_stream()
        for i in range(0, len(a), 8000):
            pool.feed(ia, a[i: i + 8000])
            if i == 8000:
                ib = pool.add_stream()
            if i >= 8000:
                pool.feed(ib, b[i - 8000: i])
            pool.tick()
        pool.finish(ia)
        pool.finish(ib)
        if on:
            assert len(s.enc_cache.graphs) > 1 and len(s.dec_cache.graphs) > 0
        return (s.get_alt(), bt.all_tokens(), pool.get(ia), pool.get(ib))

    eager, graphed = _eager_and_graphed(monkeypatch, run)
    assert len(eager[0]) > 5 and graphed == eager


def test_jacobi_window_graph_equals_eager(tparams, ttok, stand_in,
                                          monkeypatch):
    """Offline "jacobi" decoding (8-row windows over the 16-bucket, the
    ring wide enough not to wrap): the graphed window pass gives the
    eager ids and iteration counts."""
    audio = make_audio(1.6, seed=41)

    def run(on):
        eng = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                                 decode_mode="jacobi", jacobi_window=8,
                                 cuda_graphs=on, **dict(KW, dec_kv_ring=128))
        cache = eng.new_dec_cache()
        ids = transcribe_offline_ids(eng, audio, dec_cache=cache)
        if on:
            assert any(k[0] == "jacobi" for k in cache.graphs)
        return ids, eng.jacobi_iters

    eager, graphed = _eager_and_graphed(monkeypatch, run)
    assert len(eager[0]) > 10 and graphed == eager
