"""Multi-stream batched serving: N concurrent transcriptions per device.

PyTorch counterpart of the batched subset of voxtral_tpu/parallel/
serving.py.  The decode step is bound by weight reads, so B streams through
one step cost little more than one: the GEMMs read each weight once for
every stream (the int4 kernel folds the streams into its rows).

The JAX package writes its models for one stream and `jax.vmap`s them over
a stream axis; custom_vmap rules then route the per-stream Pallas calls
(row write, flash-decode, int4 matmul) to batched launches.  The port's
decoder is batched-first (`[B, ...]` everywhere, per-stream positions
int [B]), so these are thin callers of models/decoder.py and every launch
already serves the whole batch.  The JAX bprefill's unrolled layer loop
(which keeps XLA's vmapped cache updates in place) has no counterpart:
the port's layer loop is eager and its cache updates are in place.

Attention dispatch of `bdecode_burst` is the port's attn_impl="auto"
(models/decoder.py): the flash-decode kernel at every B, for rings of a
>= 2-byte float type and for fp8 rings, where the JAX batched path sends
fp8 rings to the plain `ring_rows_write` + `ring_attention` (a TPU
measurement; attn_impl="xla" keeps that path).  The batched streaming
encoder (`bencode`) takes the flash-encode kernel for every chunk of
T > 1 rows on such rings (models/encoder.py).

`BatchedTranscriber` feeds B equal-schedule streams through the streaming
encoder and the decoder in lockstep; `serve_clips` runs B whole clips
through the offline pipeline bench.py measures (bulk encode, batched
prefill, decode bursts).

On a dp x tp mesh (the engine's `mesh`, parallel/mesh.py) both take all B
streams' input on every rank and serve this rank's contiguous block of
B/dp streams (the JAX P("dp") split), at the engine's per-rank head
counts: the caches hold KH/tp heads.  The ranks of a tp group run the same
host logic on the same ids; `gather_streams` concatenates the blocks'
results in dp order into the B-stream results.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..config import TOKEN_EOS, TOKEN_STREAMING_PAD, VoxtralConfig
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..models.decoder import KVCache
from ..models.encoder import EncKVCache
from ..runtime import spans
from ..runtime.engine import decompose
from ..runtime.stream import _take_rows
from .mesh import batch_shardings, gather_streams

PyTree = Any


def batched_dec_cache(cfg: VoxtralConfig, batch: int,
                      cap: Optional[int] = None, device="cpu",
                      graphs: bool = True) -> KVCache:
    """Zeroed decoder rings [batch, L, KH, cap, D] in cfg.kvdtype (with
    `graphs`, the decoder's CUDA graphs on them: ops/graphs.py)."""
    return KVCache.create(cfg.decoder, cfg.kvdtype, cap, batch=batch,
                          device=device, graphs=graphs)


def batched_enc_cache(cfg: VoxtralConfig, batch: int,
                      cap: Optional[int] = None, device="cpu",
                      graphs: bool = True) -> EncKVCache:
    """Zeroed encoder rings [batch, L, KH, cap, D] in cfg.enc_kvdtype."""
    return EncKVCache.create(cfg.encoder, cfg.enc_kvdtype, cap, batch=batch,
                             device=device, graphs=graphs)


@torch.no_grad()
def bconv0(enc_params: PyTree, cfg: VoxtralConfig, mel: torch.Tensor,
           tail: torch.Tensor):
    """mel [B, T, 128], tail [B, 2, 128] -> ([B, T, 1280], new tail)."""
    return enc_mod.conv0_chunk(enc_params, mel, tail, cfg.cdtype)


@torch.no_grad()
def bconv1(enc_params: PyTree, cfg: VoxtralConfig, feed: torch.Tensor,
           tail: torch.Tensor):
    """feed [B, 2T, 1280], tail [B, 2, 1280] -> ([B, T, 1280], new tail)."""
    return enc_mod.conv1_chunk(enc_params, feed, tail, cfg.cdtype)


@torch.no_grad()
def bencode(enc_params: PyTree, cfg: VoxtralConfig, x: torch.Tensor,
            cache: EncKVCache, pos0: torch.Tensor):
    """x [B, T, 1280] at per-stream encoder positions pos0 int [B]:
    (y [B, T, 1280], cache updated in place)."""
    return enc_mod.encode_chunk(enc_params, cfg, x, cache, pos0)


@torch.no_grad()
def badapter(adapter_params: PyTree, cfg: VoxtralConfig,
             x: torch.Tensor) -> torch.Tensor:
    """[B, 4G, 1280] -> [B, G, 3072] in the compute dtype."""
    return enc_mod.adapter_forward(adapter_params, cfg, x)


@torch.no_grad()
def bprefill(dec_params: PyTree, cfg: VoxtralConfig, embeds: torch.Tensor,
             cache: KVCache, pos0: torch.Tensor, ada: torch.Tensor) -> KVCache:
    """Prompt prefill of B streams: embeds [B, T, dim] at per-stream
    positions pos0 int [B]; writes the cache in place and returns it."""
    return dec_mod.prefill(dec_params, cfg, embeds, cache, pos0, ada)


@torch.no_grad()
def bdecode_burst(dec_params: PyTree, cfg: VoxtralConfig, chunks, prev,
                  cache: KVCache, pos0, ada, n_alt: int = 0):
    """Greedy bursts of B streams: chunks [B, T, dim], prev int [B], pos0
    int [B].  Returns (tokens [B, T], alt_ids, alt_probs, best_probs,
    cache) on the device; the cache is updated in place."""
    return dec_mod.decode_burst(dec_params, cfg, chunks, prev, cache, pos0,
                                ada, n_alt=n_alt)


@torch.no_grad()
def serve_clips(engine, mel):
    """The B=N offline serving pipeline (bench.py run_once) over padded
    clips of one length, mel [B, Tm, 128] for every stream: bulk encode of
    this rank's streams, batched prompt prefill, then greedy bursts of the
    engine's bucket sizes up to the last adapter row.  Returns (ids of this rank's
    streams, each cut at EOS, stats), where stats holds the host walls of
    the three parts (each ends with a device sync) in seconds, the decode
    steps, `adapter_rows`, this rank's bulk-encoded rows [b, n, dim] f32,
    and `prefill_last_hidden`, the prefill's hidden state at its last
    position [b, dim] (replicated over tp).  Under a profiler the call is
    the span `serve.clips` over `serve.encode`, `serve.prefill` and
    `serve.decode` (its `serve.burst`s and `serve.fetch`), whose lengths
    are the three walls (runtime/spans.py)."""
    with spans.span("serve.clips", mem=True):
        return _serve_clips(engine, mel)


def _serve_clips(engine, mel):
    cfg, dev = engine.cfg, engine.device
    streams = batch_shardings(engine.mesh, mel.shape[0])
    mel = engine._tensor(mel[streams], torch.float32)
    bsz = mel.shape[0]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dparams, plen = engine.params["decoder"], engine.prompt_len
    sync()
    t0 = time.monotonic()
    with spans.span("serve.encode", mem=True) as sp:
        rows = engine.encode_clips_bulk(mel)              # [b, n, dim] f32
        sync()
    encode_s = sp.elapsed(t0)
    t1 = time.monotonic()
    with spans.span("serve.prefill", mem=True) as sp:
        cache = batched_dec_cache(cfg, bsz, engine.dec_kv_ring, device=dev,
                                  graphs=engine.cuda_graphs)
        prompt = engine.prompt_embeds(rows[:, : plen - 1])
        zero = torch.zeros(bsz, dtype=torch.int32, device=dev)
        x, _ = dec_mod.decoder_forward(dparams, cfg, prompt, cache, zero,
                                       engine.ada())
        sync()
    prefill_s = sp.elapsed(t1)
    t2 = time.monotonic()
    with spans.span("serve.decode", mem=True) as sp:
        prev = torch.full((bsz,), TOKEN_STREAMING_PAD, dtype=torch.int32,
                          device=dev)
        pos, parts = plen - 1, []
        for b in decompose(rows.shape[1] - pos, engine.buckets):
            with spans.span("serve.burst", rows=b):
                toks, _, _, _, cache = bdecode_burst(
                    dparams, cfg, rows[:, pos: pos + b], prev, cache,
                    torch.full((bsz,), pos, dtype=torch.int32, device=dev),
                    engine.ada())
            parts.append(toks)
            prev = toks[:, -1]
            pos += b
        with spans.span("serve.fetch"):
            host = torch.cat(parts, dim=1).tolist() if parts else [[]] * bsz
    decode_s = sp.elapsed(t2)
    ids = [t[: t.index(TOKEN_EOS)] if TOKEN_EOS in t else t for t in host]
    return ids, {"encode_s": encode_s, "prefill_s": prefill_s,
                 "decode_s": decode_s, "decode_steps": pos - (plen - 1),
                 "adapter_rows": rows, "prefill_last_hidden": x[:, -1]}


class BatchedTranscriber:
    """Lockstep batched streaming transcription of B equal-schedule streams
    (the 16-streams-per-device serving shape).  On a mesh, this rank's
    block of the B streams (module docstring): `b` streams of them,
    `tokens` theirs, `all_tokens()` every stream's."""

    def __init__(self, engine, batch: int, dec_kv_ring: Optional[int] = None):
        self.eng = engine
        self.cfg = cfg = engine.cfg
        self.batch = batch
        self.streams = batch_shardings(engine.mesh, batch)
        self.b = batch = self.streams.stop - self.streams.start
        dev = self.device = engine.device
        self.dec_ring = dec_kv_ring or engine.dec_kv_ring
        self.enc_cache = batched_enc_cache(cfg, batch, engine.enc_kv_ring,
                                           device=dev,
                                           graphs=engine.cuda_graphs)
        self.dec_cache = batched_dec_cache(cfg, batch, self.dec_ring,
                                           device=dev,
                                           graphs=engine.cuda_graphs)
        self.c0_tail = torch.zeros((batch, 2, cfg.encoder.n_mel), device=dev)
        self.c1_tail = torch.zeros((batch, 2, cfg.encoder.dim),
                                   dtype=cfg.cdtype, device=dev)
        self.enc_pos = 0
        self.c0_backlog: list = []    # device tensors [B, t, 1280]
        self.enc_backlog: list = []
        self.adapter_bufs: list = []  # device tensors [B, g, dim] f32
        self.total_adapter = 0
        self.decoder_started = False
        self.gen_pos = 0
        self.prev = torch.full((batch,), TOKEN_STREAMING_PAD,
                               dtype=torch.int32, device=dev)
        self.done = np.zeros(batch, bool)
        self.tokens: list[list[int]] = [[] for _ in range(batch)]
        self.decode_steps = 0
        self.decode_time = 0.0
        self.encode_time = 0.0
        # bencode calls that take the chunk attention (encoder.py
        # chunk_attention: T > 1, any T on the row-invariant route)
        self.n_enc_chunk_calls = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_tokens(self) -> list[list[int]]:
        """Every stream's tokens (all ranks' blocks, in dp order)."""
        return gather_streams(self.eng.mesh, self.tokens)

    def feed_mel(self, mel):
        """mel: [B, T, 128] new frames for every stream (lockstep); this
        rank takes its block."""
        eng, cfg = self.eng, self.cfg
        encp = eng.params["encoder"]
        t0 = time.monotonic()
        if mel.shape[0] != self.batch:
            raise ValueError(f"mel for {mel.shape[0]} streams, the "
                             f"transcriber serves {self.batch}")
        mel = mel[self.streams]
        if isinstance(mel, np.ndarray):
            mel = torch.from_numpy(mel)
        mel = mel.to(device=self.device, dtype=torch.float32)
        i = 0
        for b in decompose(mel.shape[1], eng.buckets):
            out, self.c0_tail = bconv0(encp, cfg, mel[:, i: i + b],
                                       self.c0_tail)
            self.c0_backlog.append(out)
            i += b
        avail = sum(a.shape[1] for a in self.c0_backlog)
        for b in decompose(avail // 2, eng.buckets):
            feed = _take_rows(self.c0_backlog, 2 * b)
            c1, self.c1_tail = bconv1(encp, cfg, feed, self.c1_tail)
            y, self.enc_cache = bencode(
                encp, cfg, c1, self.enc_cache,
                torch.full((self.b,), self.enc_pos, dtype=torch.int32,
                           device=self.device))
            self.enc_pos += b
            self.n_enc_chunk_calls += enc_mod.chunk_attention(b, cfg.cdtype)
            self.enc_backlog.append(y)
        avail_e = sum(a.shape[1] for a in self.enc_backlog)
        for g in decompose(avail_e // 4, eng.buckets):
            rows = badapter(eng.params["adapter"], cfg,
                            _take_rows(self.enc_backlog, 4 * g))
            self.adapter_bufs.append(rows.float())
            self.total_adapter += g
        self._sync()
        self.encode_time += time.monotonic() - t0

    def run_decoder(self):
        eng, cfg = self.eng, self.cfg
        L = eng.prompt_len
        if not self.decoder_started:
            if self.total_adapter < L:
                return
            raw = _take_rows(self.adapter_bufs, L)          # [B, L, dim]
            # row L-1 is also the first burst's adapter row (the burst step
            # at position L-1 adds tok_embed(PAD) itself): push it back raw
            self.adapter_bufs.insert(0, raw[:, L - 1:])
            prompt = eng.prompt_embeds(raw[:, : L - 1])     # [B, L-1, dim]
            t0 = time.monotonic()
            self.dec_cache = bprefill(
                eng.params["decoder"], cfg, prompt, self.dec_cache,
                torch.zeros(self.b, dtype=torch.int32, device=self.device),
                eng.ada())
            self._sync()
            self.decode_time += time.monotonic() - t0
            self.gen_pos = L - 1
            self.decoder_started = True
        while self.gen_pos < self.total_adapter:
            avail = self.total_adapter - self.gen_pos
            b = next(x for x in eng.buckets if x <= avail)
            chunk = _take_rows(self.adapter_bufs, b)
            t0 = time.monotonic()
            toks, _, _, _, self.dec_cache = bdecode_burst(
                eng.params["decoder"], cfg, chunk, self.prev, self.dec_cache,
                torch.full((self.b,), self.gen_pos, dtype=torch.int32,
                           device=self.device), eng.ada())
            host = toks.tolist()                            # [B][b], one sync
            self.decode_time += time.monotonic() - t0
            self.decode_steps += b
            for s in range(self.b):
                if self.done[s]:
                    continue
                for t in host[s]:
                    if t == TOKEN_EOS:
                        self.done[s] = True
                        break
                    self.tokens[s].append(t)
            self.prev = toks[:, -1]
            self.gen_pos += b

    def transcribe(self, mel_batches, interval_frames: int = 200):
        """mel_batches: [B, T_total, 128] full padded mel per stream.  Feeds
        `interval_frames` at a time, decoding after each chunk."""
        t = mel_batches.shape[1]
        i = 0
        while i < t:
            n = min(interval_frames, t - i)
            self.feed_mel(mel_batches[:, i: i + n])
            self.run_decoder()
            i += n
        return self.tokens
