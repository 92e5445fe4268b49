"""CUDA graphs: the port's counterpart of the JAX engine's compiled programs.

The JAX engine runs each hot call as one cached XLA program per shape
(voxtral_tpu/runtime/engine.py).  Run eagerly, the same call costs the
host one launch per kernel (about 1,300 for a full-width decode step), and
the card waits on the host.  Here a hot call on a CUDA device is captured
once per shape key as a CUDA graph and then replayed: one launch replays
the whole call, with the same kernels and cuBLAS calls, so the results are
bit-equal to eager.

Which calls replay as graphs, and which stay eager, is one rule
(`models/decoder.py:_use_graph`):
  * graphed: the decoder step ("step": the embed, every layer, the logits
    and the argmax or the alternatives), the streaming encoder chunk
    ("encoder": the ring-cache layers of `models/encoder.py
    encoder_layers`) and the Jacobi window pass ("jacobi");
  * eager: CPU tensors (nothing to capture); the prefill, which runs once
    per cache, so a graph would be captured and replayed once; the bulk
    encoder and the window pool's `window_encode_chunk`, which are
    device-bound; any mesh with tp > 1, whose all-reduces go through gloo
    on the host and cannot be captured (a dp-only mesh captures); and a
    cache made with graphs off (`VoxtralEngine(cuda_graphs=False)`, for
    tests and A/Bs).

A graph is bound to the buffers it was captured on, so graphs belong to
the cache object they write (`KVCache.graphs`, `EncKVCache.graphs`: a
`GraphStore`) and die with it.  The key holds everything a replay cannot
change: the call, the weights' and the ada scales' identity (the entry
keeps both alive, so the ids stay unique), the config (dtypes, attn_impl),
the shapes (B, T, n_alt), the input dtypes and the TF32 flags (a graph
replays the cuBLAS calls chosen under the flags it was captured with).

Capture (`GraphedCall`): the key's first call runs eagerly on the store's
side stream, on static copies of its inputs: it is the real call (it
writes the cache), and it is torch's warm-up before capture, so every
lazy host step (the kernel build, `sm_count`, the shared-memory opt-ins,
the int4 kernel's `cuTensorMapEncodeTiled` lookup, cuBLAS handles) has
happened before the capture.  Then the same body is captured on the same stream in global
capture mode, where it runs nothing.  A call that the capture refuses
raises; nothing falls back to eager.  Later calls copy their inputs into
the static buffers and replay.  Every address a kernel captured (the int4
kernel's tensor maps bake in x's) stays fixed: static inputs belong to the
entry and intermediates to the graph's private pool.

Launch counters: the kernel wrappers count in Python as they launch
(`flash_decode.launches`, ...), and a capture launches nothing.  So a
capture records the counts its body added, takes them back, and every
replay adds them again: a run's counts stay exact with graphs on.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Sequence

import torch


def counted_wrappers() -> tuple:
    """The kernel wrappers whose `launches` attribute counts launches."""
    from .banded_encode import banded_attention_batched
    from .flash_decode import flash_decode
    from .flash_encode import flash_bulk_attention_batched
    from .quant_mm import int4_mm
    from .ring import ring_rows_write

    return (banded_attention_batched, flash_decode,
            flash_bulk_attention_batched, int4_mm, ring_rows_write)


def _counts() -> list[int]:
    return [f.launches for f in counted_wrappers()]


def _set_counts(counts: Sequence[int]) -> None:
    for f, n in zip(counted_wrappers(), counts):
        f.launches = n


def graph_key(call: str, params, ada, cfg, *shape) -> tuple:
    """The key of one graph of `call` (module docstring)."""
    return (call, id(params), id(ada), cfg,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, *shape)


class GraphedCall:
    """`body` captured as one CUDA graph over static copies of `inputs`.

    Creating it runs the call's first time (eagerly, on `store`'s side
    stream; `first` holds its outputs) and captures it.  Calling it copies
    the inputs given (None keeps a static input as it is) into the static
    buffers and replays; the outputs are the graph's static tensors,
    rewritten by the next replay.  It keeps no reference to `body`, whose
    closure holds the cache that holds this graph: the cache and its
    graphs then go as soon as their last user drops them, never in a
    collection that could fall inside another capture."""

    # captures since the last reset, their host seconds and the bytes the
    # capture added to the allocator's reserve (the graphs' private pools)
    captures = 0
    capture_s = 0.0
    pool_bytes = 0

    def __init__(self, body: Callable, inputs: Sequence[torch.Tensor],
                 store: "GraphStore"):
        dev = inputs[0].device
        self.static = [x.clone() for x in inputs]
        self.graph = self.new_graph()
        side = store.side_stream(dev)
        cuda = dev.type == "cuda"
        on_side = torch.cuda.stream(side) if cuda else contextlib.nullcontext()
        if cuda:
            side.wait_stream(torch.cuda.current_stream(dev))
        with on_side:
            self.first = body(*self.static)
        counts = _counts()
        reserved = torch.cuda.memory_reserved(dev) if cuda else 0
        t0 = time.perf_counter()
        # no collection inside the capture: freeing a graph there (one held
        # in a reference cycle) is an operation a capture refuses
        collecting = gc.isenabled()
        gc.disable()
        try:
            with on_side:
                self.graph.capture_begin(capture_error_mode="global")
                try:
                    self.out = body(*self.static)
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            added = [a - b for a, b in zip(_counts(), counts)]
            _set_counts(counts)      # the capture launched nothing
        self.launches = added
        if cuda:
            torch.cuda.current_stream(dev).wait_stream(side)
        GraphedCall.captures += 1
        GraphedCall.capture_s += time.perf_counter() - t0
        GraphedCall.pool_bytes += (torch.cuda.memory_reserved(dev) - reserved
                                   if cuda else 0)

    def new_graph(self):
        """An empty graph (the CPU tests put a stand-in here)."""
        return torch.cuda.CUDAGraph()

    def replay(self):
        """Replays the graph as it stands; adds its launches to the
        counters.  Returns the static outputs."""
        self.graph.replay()
        _set_counts([n + d for n, d in zip(_counts(), self.launches)])
        return self.out

    def __call__(self, *inputs):
        for s, x in zip(self.static, inputs):
            if x is not None:
                s.copy_(x)
        return self.replay()


class GraphStore(dict):
    """The graphs captured on one cache, by `graph_key`; each entry also
    holds what its key names by identity (weights, ada scales)."""

    def __init__(self):
        super().__init__()
        self._stream = None

    def side_stream(self, device):
        if device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def call(self, key: tuple, body: Callable,
             inputs: Sequence[torch.Tensor], keep=()) -> tuple:
        """`body(*inputs)` through the key's graph: (graph, outputs).  The
        key's first call captures it and returns the eager outputs of that
        call (which ran); later calls replay."""
        entry = self.get(key)
        if entry is None:
            g = GraphedCall(body, inputs, self)
            self[key] = (g, keep)
            out, g.first = g.first, None
            return g, out
        return entry[0], entry[0](*inputs)

    def lookup(self, key: tuple):
        """The key's graph, or None before its first call."""
        entry = self.get(key)
        return None if entry is None else entry[0]


def reset_stats() -> None:
    GraphedCall.captures = 0
    GraphedCall.capture_s = 0.0
    GraphedCall.pool_bytes = 0
