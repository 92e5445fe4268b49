"""Engine: loaded parameters + CUDA graphs + the shape-bucket policy.

PyTorch counterpart of voxtral_tpu/runtime/engine.py.  It holds the weights
on one device and exposes the calls of the offline path (bulk encode,
prompt prefill, burst decode) and of the streaming path (conv chunks with
tails, the ring-cache encoder, the adapter, the fused audio side).
Everything is batched-first: tensors carry a leading stream axis B (B=1
for one clip or stream).

Chunks keep the JAX package's greedy bucket decomposition, so a stream is
cut into the same calls in both packages.  Where the JAX engine compiles
one program per shape, the port captures one CUDA graph per shape key on
the cache it writes (ops/graphs.py): the decoder step, the streaming
encoder chunk (each bucket and fused size) and the Jacobi window pass, at
their first call on a CUDA device.  The prefill, the bulk encoder, the CPU
and tp > 1 meshes run eagerly (models/decoder.py `_use_graph`);
`cuda_graphs=False` runs every call eagerly (the caches it makes carry no
graphs), for tests and A/Bs.

`quantize=` ("int8"/True or "int4") quantizes the decoder only, as the JAX
engine does (models/quant.py); the encoder stays exact.

`decode_mode` picks the decode of each burst as the JAX engine does:
"sequential" (the default), "jacobi" (models/jacobi.py) or "auto" (Jacobi
for bursts of at least `jacobi_window` rows).  Jacobi runs one stream: at
B > 1 "auto" decodes sequentially and "jacobi" raises.  Unlike the JAX
engine, "auto" also decodes sequentially where a Jacobi window would lose
keys: its window writes all W rows before its queries attend, so on a
ring shorter than the attention window + W - 1 whose burst wraps, late
rows overwrite slots that early queries still read (ROADMAP.md section 3,
a deliberate divergence).  "jacobi" keeps the reference's function.

`mesh=` (parallel/mesh.py `make_mesh`) serves on a dp x tp mesh of
processes: the engine keeps this rank's slices of the weights and runs at
the per-rank head counts of `rank_config`, the model code summing its
row-parallel products over tp; the callers (BatchedTranscriber, the
StreamPool) take this rank's block of the streams.  Without a mesh nothing
changes: no collective, no extra launch.  At tp > 1 the quantized rungs and
Jacobi decoding raise (not ported to a mesh, ROADMAP.md); at tp = 1 the
quantized weights are replicated and the streams split over dp.

Not ported (ROADMAP.md): encoder weight paging
(`offload_encoder`/`restore_encoder`).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import (
    RAW_AUDIO_LENGTH_PER_TOK,
    TOKEN_BOS,
    TOKEN_STREAMING_PAD,
    VoxtralConfig,
    delay_tokens_from_ms,
    n_right_pad_tokens,
)
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..models.decoder import KVCache, _positions, ada_scales
from ..models.encoder import EncKVCache
from ..models.quant import embed_rows, quantize_params
from ..parallel.mesh import rank_config, shard_params, tensor_parallel
from ..tokenizer import TekkenTokenizer

DEFAULT_BUCKETS = (256, 64, 16, 4, 1)


def _pow2ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


def adaptive_dec_ring(cfg: VoxtralConfig, n_samples: int, slack: int = 64) -> int:
    """Smallest 128-aligned decoder ring that holds a whole clip of
    `n_samples` (prompt + audio tokens + right padding), capped at the
    attention window (the reference's grow-to-fit KV cache for offline
    clips, voxtral_decoder.c:214-311).  Ring index math is modular, so any
    cap works; a 60 s clip rides an 896-slot ring."""
    toks = (n_samples + RAW_AUDIO_LENGTH_PER_TOK - 1) // RAW_AUDIO_LENGTH_PER_TOK
    total = (1 + 32 + cfg.delay_tokens) + toks + n_right_pad_tokens(cfg.delay_tokens)
    return min(cfg.decoder.window, max(256, -(-(total + slack) // 128) * 128))


def decompose(n: int, buckets: Sequence[int]) -> list[int]:
    """Greedy largest-first decomposition of n into bucket sizes (buckets must
    include 1 so every n is representable)."""
    out = []
    for b in sorted(buckets, reverse=True):
        while n >= b:
            out.append(b)
            n -= b
    if n != 0:
        raise ValueError(f"buckets {tuple(buckets)} cannot represent {n}")
    return out


class VoxtralEngine:
    """Holds the weights on one device plus everything shape-static. One
    engine serves many streams (vox_ctx_t analog, voxtral.h:150-210)."""

    def __init__(
        self,
        cfg: VoxtralConfig,
        params,
        tokenizer: Optional[TekkenTokenizer] = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        dec_kv_ring: Optional[int] = None,
        enc_kv_ring: Optional[int] = None,
        decode_mode: str = "sequential",   # | "jacobi" | "auto"
        jacobi_window: int = 64,
        fused_streaming: bool = True,      # one-call audio side for aligned chunks
        quantize: bool | str = False,      # False | True/"int8" | "int4"
        mesh=None,                         # parallel/mesh.py make_mesh
        cuda_graphs: bool = True,          # False: every call eager
    ):
        if decode_mode not in ("sequential", "jacobi", "auto"):
            raise ValueError(f"decode_mode {decode_mode!r}")
        tp = tensor_parallel(mesh)
        if tp is not None and quantize:
            raise ValueError(f"quantize={quantize!r} at tp={tp.size}: the "
                             "int8/int4 layouts do not split by heads "
                             "(run the quantized rungs at tp = 1)")
        if tp is not None and decode_mode != "sequential":
            raise ValueError(f"decode_mode {decode_mode!r} at tp={tp.size}: "
                             "Jacobi decoding is not ported to a mesh")
        # float32 products stay float32 on the card (the reference
        # numerics); both flags are process-wide torch settings
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mesh = mesh
        if mesh is not None:
            # this rank's slices (the caller may free the full tree)
            params = shard_params(params, cfg, mesh)
        if tp is not None:
            cfg = rank_config(cfg, tp)
        self.cfg = cfg
        if quantize:
            # decoder only (where decode reads its bytes); a new tree, so
            # the caller's params stay as they were
            params = quantize_params(params, encoder=False,
                                     bits=4 if quantize == "int4" else 8)
        self.quantized = quantize
        self.cuda_graphs = cuda_graphs
        self.params = params
        self.tokenizer = tokenizer
        self.decode_mode = decode_mode
        self.jacobi_window = jacobi_window
        # per Jacobi burst: its iteration count; and the rows decoded by
        # Jacobi bursts (their windows launch no flash-decode)
        self.jacobi_iters: list[int] = []
        self.jacobi_steps = 0
        self.buckets = tuple(sorted(buckets, reverse=True))
        if self.buckets[-1] != 1:
            raise ValueError(f"buckets must include 1, got {self.buckets}")
        self.dec_kv_ring = dec_kv_ring or cfg.decoder.kv_ring
        self.fused_streaming = fused_streaming
        # the encoder ring covers the window plus the largest chunk written
        # on top: the smallest power of two that does (1024 for the real
        # config with 64-buckets)
        min_enc = cfg.encoder.window + self.buckets[0]
        self.enc_kv_ring = enc_kv_ring or min(cfg.encoder.kv_ring,
                                              _pow2ceil(min_enc))
        if self.enc_kv_ring < min_enc:
            raise ValueError(f"encoder ring {self.enc_kv_ring} < window + "
                             f"largest bucket ({min_enc})")
        # fused buckets are MEL frames (an encoder chunk is bucket/2
        # positions); only sizes the ring holds beside its window
        self.fused_buckets = tuple(
            b for b in (1024, 512, 256)
            if cfg.encoder.window + b // 2 <= self.enc_kv_ring)
        dparams = params["decoder"]
        self.device = dparams["tok_embeddings"].device

        self.delay_tokens = cfg.delay_tokens
        self._ada = {self.delay_tokens: ada_scales(dparams, cfg)}
        # [dim] f32, on the device
        self.embed_bos = embed_rows(
            dparams, torch.tensor(TOKEN_BOS, device=self.device), tp=tp)
        self.embed_pad = embed_rows(
            dparams, torch.tensor(TOKEN_STREAMING_PAD, device=self.device),
            tp=tp)

    # -- config ------------------------------------------------------------
    @property
    def prompt_len(self) -> int:
        return 1 + 32 + self.delay_tokens

    def set_delay(self, delay_ms: int):
        """vox_set_delay analog (voxtral.c:1629-1635)."""
        self.delay_tokens = delay_tokens_from_ms(delay_ms)

    def ada(self) -> torch.Tensor:
        d = self.delay_tokens
        if d not in self._ada:
            cfg = self.cfg.replace(delay_tokens=d)
            self._ada[d] = ada_scales(self.params["decoder"], cfg)
        return self._ada[d]

    # -- memory accounting -----------------------------------------------------
    def memory_ledger(self) -> dict:
        """Shape-derived device byte ledger (the vox_metal_memory_used
        analog, printed at startup voxtral.c:247-249): weights by param
        group (quantized storage counts its packed bytes), derived
        constants, and per-stream KV-cache bytes at this engine's ring
        geometry.  All values are bytes."""
        def nbytes(tree) -> int:
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            if isinstance(tree, (list, tuple)):
                return sum(nbytes(v) for v in tree)
            return tree.numel() * tree.element_size()

        d, e = self.cfg.decoder, self.cfg.encoder
        led = {f"params_{k}": nbytes(v) for k, v in self.params.items()}
        led["derived_consts"] = nbytes(
            [self.embed_bos, self.embed_pad, list(self._ada.values())])
        led["params_total"] = sum(
            v for k, v in led.items() if k.startswith("params_")
        ) + led["derived_consts"]
        led["dec_cache_bytes_per_stream"] = (
            2 * d.n_layers * d.n_kv_heads * self.dec_kv_ring * d.head_dim
            * self.cfg.kvdtype.itemsize)
        led["enc_cache_bytes_per_stream"] = (
            2 * e.n_layers * e.n_kv_heads * self.enc_kv_ring * e.head_dim
            * self.cfg.enc_kvdtype.itemsize)
        return led

    # -- cache factories -----------------------------------------------------
    def new_dec_cache(self, batch: int = 1) -> KVCache:
        return KVCache.create(self.cfg.decoder, self.cfg.kvdtype,
                              self.dec_kv_ring, batch=batch,
                              device=self.device, graphs=self.cuda_graphs)

    def new_enc_cache(self, batch: int = 1) -> EncKVCache:
        return EncKVCache.create(self.cfg.encoder, self.cfg.enc_kvdtype,
                                 self.enc_kv_ring, batch=batch,
                                 device=self.device, graphs=self.cuda_graphs)

    # -- dispatch planning ---------------------------------------------------
    def fused_sizes(self, q_total: int) -> list[int]:
        """Dispatch plan (mel-frame chunk sizes) for a quantum-aligned
        chunk: the power-of-two fused buckets, then ONE exact-size call for
        the tail, split only where the encoder ring cannot hold window +
        chunk."""
        cap = 2 * (self.enc_kv_ring - self.cfg.encoder.window)
        cap -= cap % 8
        out = []
        for b in self.fused_buckets:
            while q_total >= b:
                out.append(b)
                q_total -= b
        while q_total > 0:
            q = min(q_total, cap)
            out.append(q)
            q_total -= q
        return out

    def burst_size(self, avail: int) -> int:
        """Decode-burst size for `avail` pending adapter rows: small
        backlogs (the steady state at any -I <= 2.5 s) decode in ONE
        exact-size burst, large ones take the power buckets."""
        if avail < 32:
            return avail
        return next(x for x in self.buckets if x <= avail)

    # -- phases ----------------------------------------------------------------
    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=self.device, dtype=dtype)

    # -- streaming encoder calls (batched-first, B = 1 for one stream) ------
    def conv0(self, mel, tail):
        """mel [B, T, 128] f32, tail [B, 2, 128] -> ([B, T, 1280], tail)."""
        return enc_mod.conv0_chunk(self.params["encoder"],
                                   self._tensor(mel, torch.float32), tail,
                                   self.cfg.cdtype)

    def conv1(self, feed, tail):
        """feed [B, 2T, 1280], tail [B, 2, 1280] -> ([B, T, 1280], tail)."""
        return enc_mod.conv1_chunk(self.params["encoder"], feed, tail,
                                   self.cfg.cdtype)

    def encode(self, x, cache: EncKVCache, pos0):
        """Ring-cache encoder over x [B, T, 1280] at pos0 (int or int [B]):
        (y [B, T, 1280], cache updated in place)."""
        return enc_mod.encode_chunk(self.params["encoder"], self.cfg, x,
                                    cache, pos0)

    def adapter(self, enc_out) -> torch.Tensor:
        """[B, 4G, 1280] -> [B, G, 3072] in the compute dtype."""
        return enc_mod.adapter_forward(self.params["adapter"], self.cfg,
                                       enc_out)

    def fused_encode(self, mel, tails, cache: EncKVCache, enc_pos):
        """One call of conv stem + encoder + adapter for quantum-aligned
        mel chunks (models/fused_stream.py): (rows, tails, cache)."""
        from ..models.fused_stream import fused_encode_chunk

        mel = self._tensor(mel, torch.float32)
        return fused_encode_chunk(
            self.params["encoder"], self.params["adapter"], self.cfg, mel,
            tails, cache, _positions(enc_pos, mel.shape[0], self.device))

    def encode_clip_bulk(self, mel) -> torch.Tensor:
        """Whole-clip offline encode with NO ring state (the reference's
        batch vox_encoder_forward, voxtral_encoder.c:135-312): padded mel
        [B, Tm, 128] -> [B, Tm//8, 3072] f32 adapter rows on the device."""
        from ..models.bulk_encode import bulk_encode_clip

        return bulk_encode_clip(
            self.params["encoder"], self.params["adapter"], self.cfg,
            self._tensor(mel, torch.float32),
        )

    def encode_clips_bulk(self, mel_b) -> torch.Tensor:
        """Batched bulk encode of B clips of one length: [B, Tm, 128] ->
        [B, Tm//8, 3072] f32, one banded-kernel launch per layer for all
        streams (the JAX engine's name for the batched call)."""
        return self.encode_clip_bulk(mel_b)

    def prompt_embeds(self, adapter_rows) -> torch.Tensor:
        """[B, L, dim] adapter rows -> prompt embeddings on the device:
        row 0 + BOS embed, rows 1.. + STREAMING_PAD embed."""
        rows = self._tensor(adapter_rows)
        return torch.cat([rows[:, :1] + self.embed_bos,
                          rows[:, 1:] + self.embed_pad], dim=1)

    def prefill(self, embeds, cache: KVCache, pos0) -> KVCache:
        """Writes the prompt's K/V into `cache` in place and returns it."""
        return dec_mod.prefill(
            self.params["decoder"], self.cfg, self._tensor(embeds), cache,
            pos0, self.ada(),
        )

    def decode_burst(self, adapter_chunk, prev_token, cache: KVCache, pos0,
                     n_alt: int = 0):
        """Greedy burst: (tokens [B, T], alt_ids, alt_probs, best_probs,
        cache), all left on the device; the cache is updated in place.

        The burst's decode follows `decode_mode`: "auto" takes Jacobi for
        bursts of at least `jacobi_window` rows at B=1 (sequential at
        B > 1, for shorter bursts, and where the window would lose keys:
        a ring shorter than the attention window + W - 1 that the burst's
        positions wrap); "jacobi" takes it for every burst and raises
        ValueError at B > 1.  A Jacobi burst's window W is the largest
        divisor of T within `jacobi_window`.  Both give the greedy tokens
        (up to near-tied logits in bf16)."""
        chunk = self._tensor(adapter_chunk)
        bsz, t = chunk.shape[:2]
        w = min(self.jacobi_window, t)
        while w > 1 and t % w:
            w -= 1
        mode = self.decode_mode
        if mode == "auto":
            mode = ("jacobi" if t >= self.jacobi_window and bsz == 1
                    and not self._window_loses_keys(cache, pos0, t, w)
                    else "sequential")
        if mode == "jacobi":
            from ..models.jacobi import decode_burst_jacobi

            if bsz != 1:
                raise ValueError(f"decode_mode 'jacobi' decodes one stream, "
                                 f"got a burst of B={bsz}")
            toks, ai, ap, bp, cache, iters = decode_burst_jacobi(
                self.params["decoder"], self.cfg, chunk,
                torch.as_tensor(prev_token), cache, pos0, self.ada(),
                n_alt=n_alt, window=w)
            self.jacobi_iters.append(iters)
            self.jacobi_steps += t
            return toks, ai, ap, bp, cache
        return dec_mod.decode_burst(
            self.params["decoder"], self.cfg, chunk,
            torch.as_tensor(prev_token), cache, pos0, self.ada(), n_alt=n_alt,
        )

    def _window_loses_keys(self, cache: KVCache, pos0, t: int,
                           w: int) -> bool:
        """Whether a Jacobi burst of t rows at pos0 in windows of w would
        overwrite keys its own queries attend: the ring holds fewer slots
        than the attention window + w - 1, and the burst's positions wrap
        it (the last position reaches a slot written before)."""
        cap = cache.k.shape[3]
        if cap >= self.cfg.decoder.window + w - 1:
            return False
        return int(torch.as_tensor(pos0).reshape(-1)[0]) + t > cap

    # -- warm-up -------------------------------------------------------------
    def warmup(self, n_alt: int = 0, progress=None,
               interval_s: Optional[float] = None) -> float:
        """Builds the CUDA kernels (on a CUDA device) and runs every bucket
        shape once, with the JAX engine's progress lines (there it compiles
        them; here it settles cuBLAS handles and the allocator).  It runs
        eagerly on caches that carry no graphs and captures nothing:
        graphs belong to the cache they write (ops/graphs.py), so each
        stream's caches capture theirs at their own first call of each
        shape (the step, each encoder chunk size, each Jacobi window).  With
        `interval_s`, also the exact-size fused-encode and decode-burst
        shapes of the steady streaming state at that interval.  The bursts
        go through `decode_burst`, so under "auto" or "jacobi" the bucket
        shapes it sends to Jacobi run as Jacobi bursts, as in the JAX
        warm-up.  Returns the seconds taken."""
        from ..models.fused_stream import ConvTails

        cfg, dev = self.cfg, self.device
        t0 = time.monotonic()
        if dev.type == "cuda":
            from ..ops import cuda_lib

            if progress:
                progress("warmup kernel build")
            cuda_lib.kernels()
        enc_cache, dec_cache = self.new_enc_cache(), self.new_dec_cache()
        enc_cache.graphs = dec_cache.graphs = None
        c0_tail = torch.zeros((1, 2, cfg.encoder.n_mel), device=dev)
        c1_tail = torch.zeros((1, 2, cfg.encoder.dim), dtype=cfg.cdtype,
                              device=dev)
        bos = torch.tensor([TOKEN_BOS], dtype=torch.int32, device=dev)
        for b in self.buckets:
            if progress:
                progress(f"warmup bucket {b} (+{time.monotonic() - t0:.0f}s)")
            self.conv0(torch.zeros((1, b, cfg.encoder.n_mel), device=dev),
                       c0_tail)
            self.conv1(torch.zeros((1, 2 * b, cfg.encoder.dim),
                                   dtype=cfg.cdtype, device=dev), c1_tail)
            self.encode(torch.zeros((1, b, cfg.encoder.dim), dtype=cfg.cdtype,
                                    device=dev), enc_cache, 0)
            self.adapter(torch.zeros((1, 4 * b, cfg.encoder.dim),
                                     dtype=cfg.cdtype, device=dev))
            self.decode_burst(torch.zeros((1, b, cfg.decoder.dim),
                                          dtype=cfg.cdtype, device=dev),
                              bos, dec_cache, 0, n_alt=n_alt)
        if progress:
            progress(f"warmup prefill (+{time.monotonic() - t0:.0f}s)")
        self.prefill(torch.zeros((1, self.prompt_len - 1, cfg.decoder.dim),
                                 device=dev), dec_cache, 0)
        fused_qs = list(self.fused_buckets)
        burst_ts = []
        if interval_s is not None:
            # steady-state sizes at this interval: a feed carries ~interval
            # * 100 mel frames; the aligned chunk alternates between q0 and
            # q0 + 8 as the < 8-frame remainder accumulates
            q0 = max(8, (int(interval_s * 100) // 8) * 8)
            fused_qs += [q for q in (q0, q0 + 8) if q not in fused_qs
                         and cfg.encoder.window + q // 2 <= self.enc_kv_ring]
            burst_ts = sorted({q0 // 8, q0 // 8 + 1})
        if self.fused_streaming:
            tails = ConvTails.create(cfg, device=dev)
            for q in fused_qs:
                if progress:
                    progress(f"warmup fused {q} "
                             f"(+{time.monotonic() - t0:.0f}s)")
                _, tails, _ = self.fused_encode(
                    torch.zeros((1, q, cfg.encoder.n_mel), device=dev), tails,
                    enc_cache, 0)
        for t in burst_ts:
            if t in self.buckets:
                continue
            if progress:
                progress(f"warmup burst {t} (+{time.monotonic() - t0:.0f}s)")
            self.decode_burst(torch.zeros((1, t, cfg.decoder.dim),
                                          device=dev),
                              bos, dec_cache, 0, n_alt=n_alt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.monotonic() - t0
