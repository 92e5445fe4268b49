"""StreamPool: dynamic multi-stream serving with per-slot lifecycles.

PyTorch counterpart of voxtral_tpu/parallel/scheduler.py.  BatchedTranscriber
(serving.py) runs B streams in lockstep; the pool keeps B slots whose
streams join, leave, restart, flush and finish on their own, each with
VoxStream's behaviour (runtime/stream.py): classified token-string queues,
alt tokens, the four self-healing watchdog causes with empty-restart
escalation, per-slot flush/finish.  Every tick advances all slots in
uniform batched calls:

  mel (host) -> [pool_encode: conv stem + encoder + adapter, B slots]
            -> per-slot ADAPTER ROW RINGS [B, R, 3072] on the device
            -> [pool_decode_burst: per-slot ring reads + one batched burst]
            -> token ids (one host read per burst; the rest is host logic)

Two encoder modes:
  * "ring":   the exact incremental path (fused_encode_chunk over batched
              encoder KV rings, at per-slot positions), the same function
              as VoxStream; chunks of T > 1 rows take the flash-encode
              kernel on rings of >= 2 bytes (models/encoder.py).
  * "window": window-RECOMPUTE (models/bulk_encode.window_encode_chunk):
              keeps only the last ~window encoder INPUTS per slot and
              re-encodes [context + chunk] with the banded kernel each
              tick, every slot with its own kv_lo.  The standard
              block-streaming APPROXIMATION (deeper layers see truncated
              context); `enc_ctx_extra` keeps more context.  The mode for
              many slots: no per-slot encoder ring.
  "auto" keeps the JAX package's rule, ring at <= 8 slots and window
  above.  That rule was reasoned for a 16 GB TPU; the H100's rule is an
  open question (ROADMAP.md).

On a dp x tp mesh (the engine's `mesh`, parallel/mesh.py) each rank's pool
holds its dp group's n_slots/dp slots at the engine's per-rank head
counts; the caller feeds each dp group its own streams and the same audio
to every tp rank of a group, whose host logic then runs on the same ids
(the wall clock is read for accounting only).  `enc_mode` must be given
("ring"; the window mode is not ported to a mesh, ROADMAP.md).

Riders: slots that do not take part in a call still ride along in it.
The JAX functions restore their state with masked selects; here the caches
are written in place, so
  - conv tails, row rings and (window mode) the context are blended with
    `torch.where` on the takers, so non-takers keep theirs bit for bit;
  - a non-taker's encoder-ring and decoder-ring writes land at its own
    next positions and are rewritten before any read (the decode burst is
    clamped so that a parked rider's writes never displace a row it will
    attend, `_tick_decoder`).
A slot's admission prefill writes a view of that slot's decoder rings in
place: O(slot), the other slots untouched.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import (
    MAX_ALT,
    N_LEFT_PAD_TOKENS,
    RAW_AUDIO_LENGTH_PER_TOK,
    STREAM_DEFAULT_INTERVAL_S,
    STREAM_EMPTY_RESTARTS_FOR_FULL_RESET,
    STREAM_FIRST_CHUNK_MIN_MEL,
    STREAM_MAX_DECODE_KV,
    STREAM_MAX_NO_DECODE_SAMPLES,
    STREAM_MAX_NON_TEXT_STREAK,
    TOKEN_EOS,
    TOKEN_STREAMING_PAD,
    VoxtralConfig,
    n_right_pad_tokens,
)
from ..models import decoder as dec_mod
from ..models.decoder import KVCache
from ..models.fused_stream import ConvTails, fused_encode_chunk
from ..native import make_mel_context
from ..runtime import spans
from ..runtime import stream as stream_mod
from ..runtime.engine import VoxtralEngine
from ..tokenizer import TekkenTokenizer
from . import serving as sv
from .mesh import batch_shardings


# --------------------------------------------------------------------------
# batched calls
# --------------------------------------------------------------------------

def _blend_tails(taker: torch.Tensor, new: ConvTails,
                 old: ConvTails) -> ConvTails:
    m3 = taker[:, None, None]
    return ConvTails(torch.where(m3, new.mel_tail, old.mel_tail),
                     torch.where(m3, new.c0_tail, old.c0_tail))


@torch.no_grad()
def pool_encode_ring(enc_params, adapter_params, cfg: VoxtralConfig,
                     mel, tails: ConvTails, cache, enc_pos, taker,
                     row_ring, w_pos):
    """Batched fused encode (ring mode) + adapter-row ring write.

    mel [B, Q, 128] · tails batched ConvTails · cache batched EncKVCache
    (written in place) · enc_pos/w_pos int [B] · taker bool [B] · row_ring
    [B, R, dim] f32 (written in place).  Non-takers keep their conv tails
    and row rings; their encoder-ring writes park at their own enc_pos
    (rewritten before any read).  Returns (tails, cache, row_ring)."""
    rows, ntails, cache = fused_encode_chunk(
        enc_params, adapter_params, cfg, mel, tails, cache, enc_pos)
    _rows_ring_write(row_ring, rows.float(), w_pos, taker)
    return _blend_tails(taker, ntails, tails), cache, row_ring


@torch.no_grad()
def pool_encode_window(enc_params, adapter_params, cfg: VoxtralConfig,
                       mel, tails: ConvTails, xwin, n_ctx, taker,
                       row_ring, w_pos):
    """Batched window-recompute encode + adapter-row ring write.

    xwin [B, Wp, dim] (the last conv outputs) · n_ctx int [B] valid context
    rows.  Returns (tails, xwin, n_ctx, row_ring), non-takers' unchanged."""
    from ..models.bulk_encode import window_encode_chunk

    rows, mt, ct, nxwin, n_new = window_encode_chunk(
        enc_params, adapter_params, cfg, mel, tails.mel_tail, tails.c0_tail,
        xwin, n_ctx)
    _rows_ring_write(row_ring, rows, w_pos, taker)
    ntails = _blend_tails(taker, ConvTails(mt, ct), tails)
    nxwin = torch.where(taker[:, None, None], nxwin, xwin)
    n_new = torch.where(taker, n_new, n_ctx.to(n_new.device, n_new.dtype))
    return ntails, nxwin, n_new, row_ring


def _rows_ring_write(row_ring, rows, w_pos, taker):
    """Write rows [B, g, dim] into row_ring [B, R, dim] at per-slot offsets
    (w_pos mod R, wrapping) IN PLACE, for the takers (bool [B]) only: the
    others' rows are written back as they were."""
    bsz, r, _ = row_ring.shape
    g = rows.shape[1]
    slots = torch.remainder(
        w_pos.reshape(bsz, 1) + torch.arange(g, device=row_ring.device), r)
    bidx = torch.arange(bsz, device=row_ring.device)[:, None].expand(bsz, g)
    row_ring[bidx, slots] = torch.where(taker[:, None, None],
                                        rows.to(row_ring.dtype),
                                        row_ring[bidx, slots])
    return row_ring


@torch.no_grad()
def pool_decode_burst(dec_params, cfg: VoxtralConfig, row_ring, r_pos, prev,
                      cache: KVCache, pos0, ada, t: int, n_alt: int = 0):
    """Read t adapter rows per slot from its row ring (from r_pos[i] mod R)
    and decode them in one batched greedy burst at per-slot positions pos0
    and previous tokens prev (the sequential burst: flash-decode at B
    slots, parked ones included).  Returns decode_burst's outputs."""
    bsz, r, _ = row_ring.shape
    idx = torch.remainder(
        r_pos.reshape(bsz, 1) + torch.arange(t, device=row_ring.device), r)
    bidx = torch.arange(bsz, device=row_ring.device)[:, None]
    chunks = row_ring[bidx, idx]                              # [B, t, dim]
    return sv.bdecode_burst(dec_params, cfg, chunks, prev, cache, pos0, ada,
                            n_alt=n_alt)


# --------------------------------------------------------------------------
# slot state (mirrors VoxStream's fields, runtime/stream.py)
# --------------------------------------------------------------------------

@dataclass
class _Slot:
    active: bool = False
    finished: bool = False
    continuous: bool = True
    mel_ctx: object = None
    mel_cursor: int = 0
    real_samples_fed: int = 0
    conv_init: bool = False
    enc_pos: int = 0
    # adapter row-ring cursors (monotonic row counts; mod R on the device)
    w_count: int = 0
    r_count: int = 0
    # decoder epoch
    dec_pos: int = 0
    decoder_started: bool = False
    prev_token: int = TOKEN_STREAMING_PAD
    eos_seen: bool = False
    ring_overflow: bool = False
    nontext_streak: int = 0
    text_since_restart: bool = False
    empty_restarts: int = 0
    last_decode_sample: int = 0
    # output
    queue: list = field(default_factory=list)     # tuples like VoxStream's
    alt_cutoff: float = 0.0
    min_new_mel: int = int(STREAM_DEFAULT_INTERVAL_S * 100)
    n_generated: int = 0
    n_text_tokens: int = 0
    n_restarts: int = 0
    # raw ids decoded (with the pool's record_ids on), as VoxStream's
    generated_ids: list = field(default_factory=list)
    # per-tick --monitor accumulators (flushed by StreamPool.tick; only
    # filled while runtime.stream.monitor is on)
    syms: list = field(default_factory=list)
    tick_steps: int = 0
    tick_text: int = 0
    tick_ctl: int = 0
    tick_inv: int = 0
    waiting_prompt: bool = False

    @property
    def backlog(self) -> int:
        return self.w_count - self.r_count


class StreamPool:
    """Serving pool (module docstring).

    n_alt is pool-wide (how many candidates each decode burst extracts);
    per-slot alt CUTOFFS apply at enqueue time, like vox_set_alt.  With
    `record_ids` on, each slot keeps its raw decoded ids in
    `slots[i].generated_ids`."""

    def __init__(self, engine: VoxtralEngine, n_slots: int,
                 dec_kv_ring: int = 2048, row_ring: int = 256,
                 enc_mode: str = "auto", n_alt: int = 0,
                 enc_kv_ring: Optional[int] = None,
                 enc_kv_dtype: Optional[str] = None,
                 dec_kv_dtype: Optional[str] = None,
                 enc_ctx_extra: int = 0):
        """enc_kv_ring/enc_kv_dtype/dec_kv_dtype override the engine's
        cache geometry and storage for THIS pool only (e.g. fp8 rings at a
        tight cap for a dense live pool); transcripts can then flip
        near-ties against the engine's default, the dtype-ladder trade."""
        if not engine.fused_streaming:
            raise ValueError("StreamPool needs an engine with "
                             "fused_streaming on")
        if engine.tokenizer is None:
            raise ValueError("engine has no tokenizer")
        self.eng = engine
        self.tok: TekkenTokenizer = engine.tokenizer
        self.cfg = cfg = engine.cfg
        dev = self.device = engine.device
        if engine.mesh is not None:
            if enc_mode != "ring":
                raise ValueError(f"enc_mode {enc_mode!r} on a mesh: pass "
                                 "'ring' (window mode is not ported to a "
                                 "mesh)")
            part = batch_shardings(engine.mesh, n_slots)
            n_slots = part.stop - part.start
        self.b = n_slots
        self.dec_ring = dec_kv_ring
        self.row_r = row_ring
        self.n_alt = n_alt
        self.record_ids = False
        if enc_mode == "auto":
            enc_mode = "ring" if n_slots <= 8 else "window"
        if enc_mode not in ("ring", "window"):
            raise ValueError(f"enc_mode {enc_mode!r}")
        self.enc_mode = enc_mode
        self.enc_ring = enc_kv_ring or engine.enc_kv_ring
        if self.enc_ring < cfg.encoder.window + 4:
            raise ValueError(f"encoder ring {self.enc_ring} < window + 4")
        cache_cfg = cfg.replace(
            kv_dtype=dec_kv_dtype or cfg.kv_dtype,
            enc_kv_dtype=enc_kv_dtype or cfg.enc_kv_dtype,
        )
        self.tails = ConvTails.create(cfg, batch=n_slots, device=dev)
        if enc_mode == "ring":
            self.enc_cache = sv.batched_enc_cache(
                cache_cfg, n_slots, self.enc_ring, device=dev,
                graphs=engine.cuda_graphs)
            self.xwin = None
        else:
            from ..models.bulk_encode import window_pad

            wp = window_pad(cfg, extra=enc_ctx_extra)
            self.enc_cache = None
            self.xwin = torch.zeros((n_slots, wp, cfg.encoder.dim),
                                    dtype=cfg.cdtype, device=dev)
            self.n_ctx = np.zeros(n_slots, np.int32)
        self.row_ring = torch.zeros((n_slots, row_ring, cfg.decoder.dim),
                                    dtype=torch.float32, device=dev)
        self.dec_cache = sv.batched_dec_cache(cache_cfg, n_slots, dec_kv_ring,
                                              device=dev,
                                              graphs=engine.cuda_graphs)
        self.slots = [_Slot() for _ in range(n_slots)]
        # host ms of the encoder passes (`pool.encode` spans) and of the
        # decoder side (`pool.admit`, `pool.decode`, `pool.restart`); the
        # slot scans that pick each pass's takers and each burst's slots,
        # and the monitor's symbols, are in neither
        self.encoder_ms = 0.0
        self.decoder_ms = 0.0
        self.n_ticks = 0
        # burst accounting (tools/tick_probe.py): every decode burst pays
        # its launches and one token read, so bursts per tick multiply the
        # tick's fixed cost
        self.n_bursts = 0
        self.burst_rows = 0
        self.fetch_ms = 0.0
        self.n_enc_calls = 0

    # ------------------------------------------------------------------
    # lifecycle (vox_stream_init/destroy analogs)
    # ------------------------------------------------------------------
    def add_stream(self) -> int:
        for i, s in enumerate(self.slots):
            if not s.active:
                self._reset_slot(i)
                self.slots[i].active = True
                return i
        raise RuntimeError("no free slots")

    def close(self, slot: int):
        self.slots[slot].active = False

    def set_continuous(self, slot: int, enable: bool):
        self.slots[slot].continuous = bool(enable)

    def set_processing_interval(self, slot: int, seconds: float):
        self.slots[slot].min_new_mel = max(int(max(seconds, 0.0) * 100.0), 1)

    def set_alt_cutoff(self, slot: int, cutoff: float):
        """Per-slot alt cutoff; the pool's n_alt (constructor) fixes how
        many candidates each burst extracts."""
        self.slots[slot].alt_cutoff = min(max(cutoff, 0.0), 1.0)

    def _reset_slot(self, i: int):
        old = self.slots[i]
        s = _Slot()
        s.queue = old.queue
        s.generated_ids = old.generated_ids
        s.continuous = old.continuous
        s.alt_cutoff = old.alt_cutoff
        s.min_new_mel = old.min_new_mel
        s.mel_ctx = make_mel_context(
            N_LEFT_PAD_TOKENS * RAW_AUDIO_LENGTH_PER_TOK)
        self.slots[i] = s
        self.tails.mel_tail[i] = 0.0
        self.tails.c0_tail[i] = 0.0
        if self.enc_mode == "window":
            self.n_ctx[i] = 0
        # KV and row rings need nothing: logical positions hide stale slots

    # ------------------------------------------------------------------
    # audio in / tokens out (vox_stream_feed/get analogs)
    # ------------------------------------------------------------------
    def feed(self, slot: int, samples: np.ndarray) -> int:
        s = self.slots[slot]
        if not s.active or s.finished:
            return -1
        samples = np.asarray(samples, np.float32)
        if samples.size == 0:
            return -1
        s.mel_ctx.feed(samples)
        s.real_samples_fed += len(samples)
        return 0

    def flush(self, slot: int) -> int:
        """Right-pad and force a full pass for this slot, leaving it open
        (vox_stream_flush, voxtral.c:1588-1615).  Runs a pool tick; other
        eligible slots advance too (they share the calls)."""
        s = self.slots[slot]
        if not s.active or s.finished:
            return -1
        align = (RAW_AUDIO_LENGTH_PER_TOK
                 - (s.real_samples_fed % RAW_AUDIO_LENGTH_PER_TOK)
                 ) % RAW_AUDIO_LENGTH_PER_TOK
        pad = align + n_right_pad_tokens(self.eng.delay_tokens) \
            * RAW_AUDIO_LENGTH_PER_TOK
        s.mel_ctx.feed(np.zeros(pad, np.float32))
        saved = s.min_new_mel
        s.min_new_mel = 1
        self.tick()
        s.min_new_mel = saved
        return 0

    def finish(self, slot: int) -> int:
        s = self.slots[slot]
        if not s.active or s.finished:
            return -1
        self.flush(slot)
        s.finished = True
        s.mel_ctx.finish(0)
        s.min_new_mel = 1
        self.tick()
        return 0

    def get(self, slot: int, max_tokens: int = 1 << 30) -> list[str]:
        s = self.slots[slot]
        n = min(max_tokens, len(s.queue))
        out = [s.queue[i][0] for i in range(n)]
        del s.queue[:n]
        return out

    def get_alt(self, slot: int, max_tokens: int = 1 << 30,
                n_alt: int = MAX_ALT) -> list[tuple]:
        s = self.slots[slot]
        n = min(max_tokens, len(s.queue))
        n_alt = min(n_alt, MAX_ALT)
        out = [s.queue[i][:n_alt] for i in range(n)]
        del s.queue[:n]
        return out

    def memory_ledger(self) -> dict:
        """Device byte ledger: the engine's shape-derived weight ledger plus
        this pool's own tensors (KV caches, adapter-row rings, window
        context, conv tails)."""
        led = dict(self.eng.memory_ledger())
        pool = 0
        for name, obj in (
                ("enc_cache", self.enc_cache), ("dec_cache", self.dec_cache),
                ("row_ring", self.row_ring), ("xwin", self.xwin),
                ("tails", self.tails)):
            if obj is None:
                continue
            tensors = ([obj] if isinstance(obj, torch.Tensor)
                       else [x for x in vars(obj).values()
                             if isinstance(x, torch.Tensor)])
            b = sum(x.numel() * x.element_size() for x in tensors)
            led[f"pool_{name}"] = b
            pool += b
        led["pool_total"] = pool
        led["total_resident"] = led["params_total"] + pool
        return led

    def print_stats(self):
        """Pool-level parser-compatible stderr metric lines (the VoxStream
        print_stats analog, voxtral.c:1306-1317) plus one summary line per
        slot at verbose 2."""
        if stream_mod.verbose < 1:
            return
        led = self.memory_ledger()
        gib = 1 << 30
        print(f"Memory: {led['total_resident'] / gib:.2f} GiB resident "
              f"({led['params_total'] / gib:.2f} weights + "
              f"{led['pool_total'] / gib:.2f} pool caches, {self.b} slots)",
              file=sys.stderr)
        total_rows = sum(s.w_count for s in self.slots)
        total_text = sum(s.n_text_tokens for s in self.slots)
        total_gen = sum(s.n_generated for s in self.slots)
        print(f"Encoder: {sum(s.mel_cursor for s in self.slots)} mel -> "
              f"{total_rows} tokens ({self.encoder_ms:.0f} ms)",
              file=sys.stderr)
        if total_text > 0:
            per_step = self.decoder_ms / total_gen if total_gen else 0.0
            print(f"Decoder: {total_text} text tokens ({total_gen} steps) in "
                  f"{self.decoder_ms:.0f} ms ({per_step:.1f} ms/step "
                  f"aggregate)", file=sys.stderr)
        if stream_mod.verbose >= 2:
            for i, s in enumerate(self.slots):
                if s.mel_cursor or s.n_generated:
                    print(f"  slot {i}: {'active' if s.active else 'closed'} "
                          f"{s.mel_cursor} mel, {s.n_text_tokens} text / "
                          f"{s.n_generated} steps, {s.n_restarts} restarts",
                          file=sys.stderr)

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------
    def tick(self):
        """Advance every slot: encode all eligible backlogs, then decode all
        row backlogs, then run the per-slot watchdogs: the batched form of
        one vox_stream_feed pass per slot.  Under a profiler it is the span
        `pool.tick` (request id: the tick number) over the phases' spans
        (runtime/spans.py)."""
        with spans.span("pool.tick", mem=True, request=self.n_ticks):
            self.n_ticks += 1
            # encoder_ms is host time: issuing each encoder pass, and
            # waiting in its uploads (blocking copies) for the pass before;
            # the first burst's uploads wait for the last pass.  The
            # device's split is the spans' markers (pool.encode and
            # pool.decode, device=True).
            self._tick_encoder()
            self._tick_decoder()
            self._mon_flush()

    # -- --monitor symbol stream (VoxStream's table with a slot prefix, one
    # stderr line per tick) -----------------------------------------------
    def _mon_flush(self):
        parts = []
        for i, s in enumerate(self.slots):
            if s.syms:
                parts.append(f"{i}:{''.join(s.syms)}")
            s.syms = []
            s.tick_steps = s.tick_text = s.tick_ctl = s.tick_inv = 0
        if parts and stream_mod.monitor:
            sys.stderr.write(" ".join(parts) + "\n")
            sys.stderr.flush()

    # -- encoder side ---------------------------------------------------
    def _avail_mel(self, s: _Slot) -> tuple[int, int]:
        """(total new mel frames, 8-aligned prefix) for a slot."""
        total = s.mel_ctx.mel_frame_offset + s.mel_ctx.n_frames
        if s.mel_cursor < s.mel_ctx.mel_frame_offset:
            s.mel_cursor = s.mel_ctx.mel_frame_offset
        new = total - s.mel_cursor
        return new, (new // 8) * 8

    def _enc_cap(self) -> int:
        if self.enc_mode == "ring":
            cap = 2 * (self.enc_ring - self.cfg.encoder.window)
            return cap - cap % 8
        return 1024   # window mode: the JAX package's per-tick chunk bound

    def _ints(self, xs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(xs, np.int32), device=self.device)

    def _enc_takers(self, cap: int, gated: set) -> tuple[list, int]:
        """(which slots take part, mel frames q) of one encoder pass; q is 0
        when no slot does.  Once a slot passes its interval gate in a tick
        (`gated`), it drains its WHOLE aligned backlog (VoxStream's
        per-feed semantics)."""
        takers, qs = [], []
        for i, s in enumerate(self.slots):
            ok = False
            q_i = 0
            if s.active:
                new, aligned = self._avail_mel(s)
                need = (STREAM_FIRST_CHUNK_MIN_MEL if not s.conv_init
                        else s.min_new_mel)
                free_rows = self.row_r - s.backlog
                q_i = min(aligned, cap, free_rows * 8)
                # a finished slot bypasses the interval gate (VoxStream
                # processes everything once finished)
                ok = (new >= need or i in gated or s.finished) and q_i >= 8
                if ok:
                    gated.add(i)
            takers.append(ok)
            qs.append(q_i)
        if not any(takers):
            return takers, 0
        return takers, min(q for q, t in zip(qs, takers) if t)

    def _tick_encoder(self):
        cap = self._enc_cap()
        gated: set[int] = set()
        while True:
            takers, q = self._enc_takers(cap, gated)
            if not q:
                return
            t0 = time.monotonic()
            with spans.span("pool.encode", device=True, mem=True) as sp:
                self._encode_pass(takers, q)
            self.encoder_ms += 1e3 * sp.elapsed(t0)

    def _encode_pass(self, takers: list, q: int):
        """One batched encoder call over q mel frames of the takers."""
        eng, cfg = self.eng, self.cfg
        with spans.span("pool.encode.gather"):
            b = self.b
            mel = np.zeros((b, q, cfg.encoder.n_mel), np.float32)
            enc_pos = np.zeros(b, np.int32)
            w_pos = np.zeros(b, np.int32)
            for i, s in enumerate(self.slots):
                if takers[i]:
                    off = s.mel_cursor - s.mel_ctx.mel_frame_offset
                    mel[i] = s.mel_ctx.data()[off: off + q]
                enc_pos[i] = s.enc_pos
                w_pos[i] = s.w_count % self.row_r

        with spans.span("pool.encode.launch"):
            tk = torch.as_tensor(takers, device=self.device)
            mel_t = torch.from_numpy(mel).to(self.device)
            self.n_enc_calls += 1
            # the port keeps the encoder weights resident (no
            # offload_encoder paging, ROADMAP.md), so params are read as is
            encp, adap = eng.params["encoder"], eng.params["adapter"]
            if self.enc_mode == "ring":
                self.tails, self.enc_cache, self.row_ring = pool_encode_ring(
                    encp, adap, cfg, mel_t, self.tails, self.enc_cache,
                    self._ints(enc_pos), tk, self.row_ring,
                    self._ints(w_pos))
            else:
                self.tails, self.xwin, n_new, self.row_ring = \
                    pool_encode_window(
                        encp, adap, cfg, mel_t, self.tails, self.xwin,
                        self._ints(self.n_ctx), tk, self.row_ring,
                        self._ints(w_pos))
                self.n_ctx = n_new.cpu().numpy().astype(np.int32)

        for i, s in enumerate(self.slots):
            if takers[i]:
                s.mel_cursor += q
                s.enc_pos += q // 2
                s.w_count += q // 8
                s.conv_init = True
                s.mel_ctx.discard_before(s.mel_cursor)
                if stream_mod.monitor:
                    s.syms.append("▶")  # ▶ encoder chunk

    # -- decoder side ---------------------------------------------------
    def _admit_prefill(self, i: int):
        """Single-slot prompt prefill at admission/restart: the slot's
        prompt rows gathered from its row ring, prefilled into a view of
        its decoder rings (in place; the other slots are not touched)."""
        eng, cfg = self.eng, self.cfg
        s = self.slots[i]
        L = eng.prompt_len
        r0 = s.r_count % self.row_r
        idx = self._ints((r0 + np.arange(L - 1)) % self.row_r).long()
        rows = self.row_ring[i: i + 1, idx]                   # [1, L-1, dim]
        slot_cache = KVCache(self.dec_cache.k[i: i + 1],
                             self.dec_cache.v[i: i + 1])
        dec_mod.prefill(eng.params["decoder"], cfg, eng.prompt_embeds(rows),
                        slot_cache, 0, eng.ada())
        s.r_count += L - 1
        s.dec_pos = L - 1
        s.prev_token = TOKEN_STREAMING_PAD
        s.decoder_started = True
        s.waiting_prompt = False
        if stream_mod.monitor:
            s.syms.append("·")  # · prefill

    def _burst_len(self, avail: int) -> int:
        """Exact size below 32 (one burst drains the steady-state tick
        backlog, VoxStream's burst_size policy), buckets above.  The burst
        partition cannot change transcripts (chunking invariance; the
        ring-overflow restart point is cap-exact via the clamped burst)."""
        if avail < 32:
            return avail
        return next(x for x in self.eng.buckets if x <= avail)

    def _tick_decoder(self):
        L = self.eng.prompt_len
        for i, s in enumerate(self.slots):
            if (s.active and not s.decoder_started and not s.eos_seen
                    and s.backlog >= L):
                t0 = time.monotonic()
                with spans.span("pool.admit", device=True, mem=True,
                                slot=i) as sp:
                    self._admit_prefill(i)
                self.decoder_ms += 1e3 * sp.elapsed(t0)
            elif (stream_mod.monitor and s.active and not s.decoder_started
                    and not s.waiting_prompt):
                s.syms.append("⌛")  # ⌛ waiting for a prompt-sized backlog
                s.waiting_prompt = True

        t_dec0 = time.monotonic()
        while True:
            cands, q = self._burst_cands()
            if not q:
                break
            t0 = time.monotonic()
            with spans.span("pool.decode", device=True, mem=True) as sp:
                self._decode_burst(cands, self._burst_len(q))
            self.decoder_ms += 1e3 * sp.elapsed(t0)
        if stream_mod.monitor:
            # one decode symbol per slot per tick (VoxStream's table); "slow"
            # uses the tick's aggregate wall per step, the bursts being
            # shared calls
            dec_ms = (time.monotonic() - t_dec0) * 1000.0
            total_steps = sum(s.tick_steps for s in self.slots)
            slow = total_steps > 0 and dec_ms / total_steps > 40
            for s in self.slots:
                if not s.tick_steps:
                    continue
                if s.tick_text > 0:
                    sym = "▸" if slow else "▪"
                elif s.tick_inv > 0:
                    sym = "✘" if slow else "✗"
                elif s.tick_ctl > 0:
                    sym = "▹" if slow else "▫"
                elif s.eos_seen:
                    sym = "◦"  # EOS-only
                else:
                    sym = "▪"
                sev = ""
                if s.tick_text == 0 and (s.tick_ctl or s.tick_inv):
                    if s.nontext_streak >= STREAM_MAX_NON_TEXT_STREAK - 8:
                        sev = "☠"  # critical streak, restart imminent
                    elif s.nontext_streak >= STREAM_MAX_NON_TEXT_STREAK // 2:
                        sev = "⚠"  # elevated streak
                s.syms.append(sym + sev)
        t0 = time.monotonic()
        with spans.span("pool.restart") as sp:
            for i, s in enumerate(self.slots):
                if s.active:
                    self._maybe_restart(i)
        self.decoder_ms += 1e3 * sp.elapsed(t0)

    def _burst_cands(self) -> tuple[list, int]:
        """(which slots decode, rows available to all of them and within
        every rider's ring headroom) of the next burst; 0 rows when no slot
        decodes."""
        cfg = self.cfg
        ring_limited = self.dec_ring < cfg.decoder.window
        cands = []
        headrooms = []   # ring headroom of EVERY rider (see below)
        for i, s in enumerate(self.slots):
            ok = (s.active and s.decoder_started and not s.eos_seen
                  and not s.ring_overflow and s.backlog > 0)
            if ok and ring_limited:
                allowed = self.dec_ring - s.dec_pos
                if allowed <= 0:
                    if not s.continuous:
                        raise RuntimeError(
                            f"slot {i}: decoder KV ring "
                            f"({self.dec_ring}) full at position "
                            f"{s.dec_pos}; enable continuous mode or "
                            f"size the ring to the clip")
                    s.ring_overflow = True
                    ok = False
            cands.append(ok)
            # Parked slots ride along and write garbage K/V at their own
            # dec_pos..dec_pos+t-1.  Below the cap that is invisible
            # (logical < 0 until rewritten), but a write that WRAPS past
            # the cap lands on slots holding real rows at low positions,
            # which the slot's later (pre-overflow) decodes attend.  So
            # t respects every rider's headroom.  Zero-headroom riders
            # are exempt: their only future is the KV-overflow FULL
            # reset (a re-prefill from 0 that makes the whole ring's
            # stale content unreadable), and exempting them avoids a
            # deadlock at t = 0.
            if ring_limited and s.active and s.decoder_started:
                hr = self.dec_ring - s.dec_pos
                if hr > 0:
                    headrooms.append(hr)
            elif s.active and s.decoder_started and not ok:
                # cap >= window: a PARKED rider's garbage write at
                # logical dec_pos+j displaces logical dec_pos+j-cap,
                # inside the window the slot attends after it resumes
                # iff j >= cap-window+1 (and only once dec_pos+j >=
                # cap).  t <= max(cap - dec_pos, cap - window + 1) is
                # always safe, and >= 1 when cap >= window.
                headrooms.append(max(
                    self.dec_ring - s.dec_pos,
                    self.dec_ring - cfg.decoder.window + 1))
        if not any(cands):
            return cands, 0
        return cands, min(
            min(s.backlog for s, c in zip(self.slots, cands) if c),
            *(headrooms or [1 << 30]))

    def _decode_burst(self, cands: list, t: int):
        """One batched burst of t rows; the candidates' tokens handled."""
        eng, cfg = self.eng, self.cfg
        # parking: non-candidates replay their own position (their writes
        # are rewritten before any read; outputs discarded)
        r_pos = [s.r_count % self.row_r for s in self.slots]
        prev = [s.prev_token for s in self.slots]
        pos0 = [s.dec_pos for s in self.slots]
        with spans.span("pool.decode.launch"):
            toks, alt_ids, alt_probs, best_probs, self.dec_cache = \
                pool_decode_burst(
                    eng.params["decoder"], cfg, self.row_ring,
                    self._ints(r_pos), self._ints(prev), self.dec_cache,
                    self._ints(pos0), eng.ada(), t, self.n_alt)
        self.n_bursts += 1
        self.burst_rows += t
        t_f = time.monotonic()
        with spans.span("pool.decode.fetch") as sp:
            toks = toks.cpu().numpy()                  # the one host read
            if self.n_alt:
                alt_ids = alt_ids.cpu().numpy()
                alt_probs = alt_probs.cpu().numpy()
                best_probs = best_probs.cpu().numpy()
        self.fetch_ms += 1e3 * sp.elapsed(t_f)
        with spans.span("pool.decode.tokens"):
            for i, s in enumerate(self.slots):
                if not cands[i]:
                    continue
                s.r_count += t
                self._process_tokens(
                    s, toks[i],
                    alt_ids[i] if self.n_alt else None,
                    alt_probs[i] if self.n_alt else None,
                    best_probs[i] if self.n_alt else None)

    # -- token handling (mirrors VoxStream._process_tokens/_enqueue) ----
    def _enqueue(self, s: _Slot, token: int, alt_ids, alt_probs, best_prob):
        alts = [self.tok.decode(token)] + [None] * (MAX_ALT - 1)
        if self.n_alt > 1 and alt_ids is not None and best_prob > 0:
            found = 1
            for aid, ap in zip(alt_ids, alt_probs):
                if found >= self.n_alt:
                    break
                if int(aid) == token:
                    continue
                r = 1.0 - float(ap) / float(best_prob)
                if r > s.alt_cutoff:
                    break
                alts[found] = self.tok.decode(int(aid))
                found += 1
        s.queue.append(tuple(alts))

    def _process_tokens(self, s: _Slot, tokens, alt_ids, alt_probs,
                        best_probs):
        use_alts = self.n_alt > 1
        for j, tkn in enumerate(tokens):
            tkn = int(tkn)
            s.n_generated += 1
            s.tick_steps += 1
            if self.record_ids:
                s.generated_ids.append(tkn)
            s.last_decode_sample = s.real_samples_fed
            cls = self.tok.classify(tkn)
            if cls == TekkenTokenizer.TOK_TEXT:
                self._enqueue(
                    s, tkn,
                    alt_ids[j] if use_alts else None,
                    alt_probs[j] if use_alts else None,
                    float(best_probs[j]) if use_alts else 0.0)
                s.n_text_tokens += 1
                s.tick_text += 1
                s.text_since_restart = True
                s.empty_restarts = 0
                s.nontext_streak = 0
            elif cls == TekkenTokenizer.TOK_CONTROL:
                s.nontext_streak += 1
                s.tick_ctl += 1
            elif cls == TekkenTokenizer.TOK_INVALID:
                s.nontext_streak += 1
                s.tick_inv += 1
            s.prev_token = tkn
            s.dec_pos += 1
            if tkn == TOKEN_EOS:
                s.eos_seen = True
                return

    # -- watchdogs (mirrors VoxStream._maybe_restart, voxtral.c:1137-1187)
    def _reset_decoder_state(self, i: int):
        s = self.slots[i]
        s.r_count = s.w_count          # drop the pending row backlog
        s.dec_pos = 0
        s.decoder_started = False
        s.prev_token = TOKEN_STREAMING_PAD
        s.eos_seen = False
        s.ring_overflow = False
        s.nontext_streak = 0
        s.text_since_restart = False

    def _maybe_restart(self, i: int):
        s = self.slots[i]
        if not s.continuous:
            return
        need = 0
        if s.eos_seen:
            need = 1
        elif s.decoder_started and (
                s.dec_pos > STREAM_MAX_DECODE_KV or s.ring_overflow):
            need = 2
        elif (s.decoder_started
              and s.nontext_streak >= STREAM_MAX_NON_TEXT_STREAK):
            need = 3
        elif (not s.finished
              and (s.real_samples_fed - s.last_decode_sample)
              >= STREAM_MAX_NO_DECODE_SAMPLES):
            need = 4
        if not need:
            return
        if s.text_since_restart:
            s.empty_restarts = 0
        else:
            s.empty_restarts += 1
        full = (need >= 2
                or s.empty_restarts >= STREAM_EMPTY_RESTARTS_FOR_FULL_RESET)
        s.n_restarts += 1
        if full:
            self._full_reset(i)
            self.slots[i].empty_restarts = 0
        else:
            self._reset_decoder_state(i)
        self.slots[i].last_decode_sample = self.slots[i].real_samples_fed
        if stream_mod.monitor:
            # restart cause + scope (↺ EOS / ⟳ KV-overflow / ↯ non-text
            # streak / ⌚ no-decode watchdog; ♻ full reset, ✂ decoder-only)
            self.slots[i].syms.append(
                {1: "↺", 2: "⟳", 3: "↯", 4: "⌚"}[need]
                + ("♻" if full else "✂"))

    def _full_reset(self, i: int):
        old = self.slots[i]
        self._reset_slot(i)
        s = self.slots[i]
        s.active = old.active
        s.finished = old.finished
        s.queue = old.queue
        s.syms = old.syms          # keep this tick's pending monitor symbols
        s.real_samples_fed = old.real_samples_fed
        s.empty_restarts = old.empty_restarts
        s.n_generated = old.n_generated
        s.n_text_tokens = old.n_text_tokens
        s.n_restarts = old.n_restarts
