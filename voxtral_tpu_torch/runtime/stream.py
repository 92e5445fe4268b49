"""vox_stream_t: the streaming state machine (feed PCM -> token strings).

PyTorch counterpart of voxtral_tpu/runtime/stream.py, itself a port of the
reference's streaming semantics (voxtral.c:409-1615): incremental mel,
conv-stem tails, stride residual, 4x-group residual, adapter queue with
logical offsets, prefill gating, burst decode, alt-tokens, flush/finish
padding, and the continuous-mode self-healing watchdogs.  All compute goes
through the engine's batched-first calls at B=1; the host here is control
logic and the mel frontend.

The conv and encoder backlogs and the adapter queue hold device tensors
[1, rows, dim]: rows never round-trip through the host between the
encoder and the decoder, which reads its tokens once per burst.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import (
    MAX_ALT,
    N_LEFT_PAD_TOKENS,
    RAW_AUDIO_LENGTH_PER_TOK,
    SAMPLE_RATE,
    STREAM_DEFAULT_INTERVAL_S,
    STREAM_EMPTY_RESTARTS_FOR_FULL_RESET,
    STREAM_FIRST_CHUNK_MIN_MEL,
    STREAM_MAX_DECODE_KV,
    STREAM_MAX_NO_DECODE_SAMPLES,
    STREAM_MAX_NON_TEXT_STREAK,
    TOKEN_EOS,
    TOKEN_STREAMING_PAD,
    n_right_pad_tokens,
)
from ..models.encoder import chunk_attention
from ..models.fused_stream import ConvTails
from ..native import make_mel_context
from ..tokenizer import TekkenTokenizer
from .engine import VoxtralEngine, decompose

verbose = 0
monitor = False


def _mon(sym: str):
    if monitor:
        sys.stderr.write(sym)
        sys.stderr.flush()


def _take_rows(backlog: list, n: int) -> torch.Tensor:
    """Pop n leading rows (axis 1) from a list of [B, rows, dim] tensors,
    concatenated; the head is split where n falls inside it."""
    taken, got = [], 0
    while got < n:
        head = backlog[0]
        need = n - got
        if head.shape[1] <= need:
            taken.append(head)
            got += head.shape[1]
            backlog.pop(0)
        else:
            taken.append(head[:, :need])
            backlog[0] = head[:, need:]
            got = n
    return taken[0] if len(taken) == 1 else torch.cat(taken, dim=1)


class VoxStream:
    """One live transcription (vox_stream_init/feed/finish/get analogs).
    Not ported to a mesh: an engine with one raises (ROADMAP.md)."""

    def __init__(self, engine: VoxtralEngine):
        self.engine = engine
        self.cfg = engine.cfg
        if engine.mesh is not None:
            raise ValueError("VoxStream is not ported to a mesh; serve "
                             "streams there with a StreamPool")
        if engine.tokenizer is None:
            raise ValueError("engine has no tokenizer (tekken.json not loaded)")
        self.tok: TekkenTokenizer = engine.tokenizer
        self.device = engine.device

        self.mel_ctx = make_mel_context(N_LEFT_PAD_TOKENS * RAW_AUDIO_LENGTH_PER_TOK)
        self.real_samples_fed = 0
        self.mel_cursor = 0

        # conv stem state
        self._tails = ConvTails.create(self.cfg, device=self.device)
        self._conv_init = False
        self._c0_backlog: list = []   # conv0 outputs pending conv1
        self._enc_backlog: list = []  # encoder outputs pending 4x grouping

        # encoder state
        self.enc_cache = engine.new_enc_cache()
        self.enc_pos = 0

        # adapter row queue: device tensors [1, g, 3072] awaiting the
        # decoder (the reference grows + compacts a host buffer,
        # voxtral.c:436-439, 718-731); in the steady state each fused-encode
        # output feeds exactly one decode burst
        self.adapter_q: list = []
        self.total_adapter = 0      # rows enqueued this decoder epoch
        self.consumed_adapter = 0   # rows consumed by prefill/bursts

        # decoder state
        self.dec_cache = engine.new_dec_cache()
        self.decoder_started = False
        self.gen_pos = 0
        self.prev_token = TOKEN_STREAMING_PAD
        self.dec_pos = 0          # next decode position == kv length
        self.eos_seen = False
        self.nontext_streak = 0
        self.text_since_restart = False
        self.empty_restarts = 0
        self.waiting_prompt = False
        self._ring_overflow = False
        self.last_decode_sample = 0
        self.finished = False
        self.continuous = False

        # token queue: list of tuples (best, alt1.., padded with None)
        self.queue: list[tuple] = []
        self.n_alt = 1
        self.alt_cutoff = 0.0

        self.min_new_mel = int(STREAM_DEFAULT_INTERVAL_S * 100)

        # metrics (stderr lines parser-compatible with benchmark.py:25-30)
        self.encoder_ms = 0.0
        self.decoder_ms = 0.0
        self.prefill_ms = 0.0
        self.n_generated = 0
        self.n_text_tokens = 0
        self.n_control_tokens = 0
        self.n_invalid_tokens = 0
        # encoder calls that take the chunk attention (T > 1 rows, any T
        # on the row-invariant route: models/encoder.py chunk_attention;
        # each runs one flash-encode launch per layer on the card) and
        # decode steps run (one flash-decode
        # launch per layer each; a burst cut short by EOS still ran them
        # all), for launch accounting
        self.n_enc_chunk_calls = 0
        self.n_decode_steps = 0
        # optional raw token-id capture (fidelity fixtures, tests)
        self.record_ids = False
        self.generated_ids: list[int] = []

    # ------------------------------------------------------------------
    # settings
    # ------------------------------------------------------------------
    def set_alt(self, n_alt: int, cutoff: float):
        self.n_alt = min(max(n_alt, 1), MAX_ALT)
        self.alt_cutoff = min(max(cutoff, 0.0), 1.0)

    def set_continuous(self, enable: bool):
        self.continuous = bool(enable)

    def set_processing_interval(self, seconds: float):
        self.min_new_mel = max(int(max(seconds, 0.0) * 100.0), 1)

    # ------------------------------------------------------------------
    # resets (voxtral.c:734-780): ring caches are never zeroed; the
    # logical-position mask hides every slot not written by the new epoch
    # ------------------------------------------------------------------
    def _reset_decoder_state(self):
        self.dec_pos = 0
        self.total_adapter = 0
        self.consumed_adapter = 0
        self.adapter_q = []
        self.gen_pos = 0
        self.decoder_started = False
        self.prev_token = TOKEN_STREAMING_PAD
        self.eos_seen = False
        self.nontext_streak = 0
        self.text_since_restart = False
        self.waiting_prompt = False
        self._ring_overflow = False

    def _reset_full_state(self):
        self.mel_ctx = make_mel_context(N_LEFT_PAD_TOKENS * RAW_AUDIO_LENGTH_PER_TOK)
        self.mel_cursor = 0
        self._tails = ConvTails.create(self.cfg, device=self.device)
        self._conv_init = False
        self._c0_backlog = []
        self._enc_backlog = []
        self.enc_pos = 0
        self._reset_decoder_state()

    # ------------------------------------------------------------------
    # encoder side
    # ------------------------------------------------------------------
    def _run_encoder(self):
        eng = self.engine
        mel_offset = self.mel_ctx.mel_frame_offset
        mel_frames = self.mel_ctx.n_frames
        total_mel = mel_offset + mel_frames
        if self.mel_cursor < mel_offset:
            self.mel_cursor = mel_offset
        mel_start = self.mel_cursor - mel_offset
        new_mel = total_mel - self.mel_cursor
        need = STREAM_FIRST_CHUNK_MIN_MEL if not self._conv_init else self.min_new_mel
        if new_mel < need and not self.finished:
            return
        if new_mel <= 0:
            return

        t0 = time.monotonic()
        mel = torch.from_numpy(
            self.mel_ctx.data()[mel_start: mel_start + new_mel]
        ).to(self.device)[None]                                  # [1, T, 128]

        # Fast path: the quantum-aligned prefix through ONE fused call per
        # chunk (conv0 + conv1 + encoder + adapter, models/fused_stream.py).
        # Valid exactly when no conv/group residuals are pending; the
        # remainder (< 8 frames) waits for the next feed unless finishing.
        if (eng.fused_streaming and not self._c0_backlog
                and not self._enc_backlog):
            q_total = (new_mel // 8) * 8
            i = 0
            for q in eng.fused_sizes(q_total):
                rows, self._tails, self.enc_cache = eng.fused_encode(
                    mel[:, i: i + q], self._tails, self.enc_cache,
                    self.enc_pos)
                self.enc_pos += q // 2
                self.n_enc_chunk_calls += chunk_attention(q // 2,
                                                          eng.cfg.cdtype)
                # rows stay on the device; nothing here waits for it
                # (encoder_ms is issue time, not device time)
                self.adapter_q.append(rows)
                self.total_adapter += rows.shape[1]
                i += q
            self._conv_init = True
            self.mel_cursor += q_total
            rem = new_mel - q_total
            if rem == 0 or not self.finished:
                # any unaligned tail (< 8 frames) waits for the next feed
                self.encoder_ms += (time.monotonic() - t0) * 1000.0
                _mon("▶")
                if verbose >= 2:
                    # per-chunk stat dump (reference voxtral.c:902-904)
                    print(
                        f"  Encoder inc: {q_total} mel -> {q_total // 2} conv"
                        f" -> {q_total // 2} usable (total adapter: "
                        f"{self.total_adapter}, residual: {rem})",
                        file=sys.stderr,
                    )
                self.mel_ctx.discard_before(self.mel_cursor)
                return
            # finishing with an unaligned tail: fall through to the exact
            # bucketed path for the remaining < 8 frames
            mel = mel[:, q_total:]
            new_mel = rem

        self.mel_cursor = total_mel

        # conv0 over bucketed sub-chunks (the tail carries boundary context)
        tails = self._tails
        i = 0
        for b in decompose(new_mel, eng.buckets):
            out, tails.mel_tail = eng.conv0(mel[:, i: i + b], tails.mel_tail)
            self._c0_backlog.append(out)
            i += b
        self._conv_init = True

        # conv1 + encoder transformer on even-sized feeds
        avail = sum(a.shape[1] for a in self._c0_backlog)
        n_enc_new = avail // 2
        for b in decompose(n_enc_new, eng.buckets):
            feed = _take_rows(self._c0_backlog, 2 * b)
            c1_out, tails.c0_tail = eng.conv1(feed, tails.c0_tail)
            enc_out, self.enc_cache = eng.encode(c1_out, self.enc_cache,
                                                 self.enc_pos)
            self.enc_pos += b
            self.n_enc_chunk_calls += chunk_attention(b, eng.cfg.cdtype)
            self._enc_backlog.append(enc_out)

        # adapter on groups of 4 (leftover 0-3 stays in the backlog,
        # voxtral.c:823-890)
        avail_e = sum(a.shape[1] for a in self._enc_backlog)
        groups = avail_e // 4
        for g in decompose(groups, eng.buckets):
            rows = eng.adapter(_take_rows(self._enc_backlog, 4 * g))
            self.adapter_q.append(rows)
            self.total_adapter += rows.shape[1]

        self.encoder_ms += (time.monotonic() - t0) * 1000.0
        _mon("▶")  # ▶ encoder chunk
        if verbose >= 2:
            print(
                f"  Encoder inc: {new_mel} mel -> {n_enc_new} conv -> "
                f"{4 * groups} usable (total adapter: {self.total_adapter})",
                file=sys.stderr,
            )
        self.mel_ctx.discard_before(self.mel_cursor)

    # ------------------------------------------------------------------
    # decoder side
    # ------------------------------------------------------------------
    def _enqueue(self, token: int, alt_ids, alt_probs, best_prob):
        alts = [self.tok.decode(token)] + [None] * (MAX_ALT - 1)
        if self.n_alt > 1 and alt_ids is not None and best_prob > 0:
            found = 1
            for aid, ap in zip(alt_ids, alt_probs):
                if found >= self.n_alt:
                    break
                if int(aid) == token:
                    continue
                r = 1.0 - float(ap) / float(best_prob)
                if r > self.alt_cutoff:
                    break
                alts[found] = self.tok.decode(int(aid))
                found += 1
        self.queue.append(tuple(alts))

    def _process_tokens(self, tokens, alt_ids, alt_probs, best_probs) -> bool:
        """Host-side classification/queueing for one decoded burst.
        Returns True if EOS was hit (voxtral.c:1067-1092)."""
        use_alts = self.n_alt > 1
        for j, t in enumerate(tokens):
            t = int(t)
            self.n_generated += 1
            if self.record_ids:
                self.generated_ids.append(t)
            self.last_decode_sample = self.real_samples_fed
            cls = self.tok.classify(t)
            if cls == TekkenTokenizer.TOK_TEXT:
                self._enqueue(
                    t,
                    alt_ids[j] if use_alts else None,
                    alt_probs[j] if use_alts else None,
                    float(best_probs[j]) if use_alts else 0.0,
                )
                self.n_text_tokens += 1
                self.text_since_restart = True
                self.empty_restarts = 0
                self.nontext_streak = 0
            elif cls == TekkenTokenizer.TOK_CONTROL:
                self.n_control_tokens += 1
                self.nontext_streak += 1
            elif cls == TekkenTokenizer.TOK_INVALID:
                self.n_invalid_tokens += 1
                self.nontext_streak += 1
            self.prev_token = t
            self.gen_pos += 1
            self.dec_pos += 1
            if t == TOKEN_EOS:
                self.eos_seen = True
                return True
        return False

    def _take_adapter(self, n: int) -> torch.Tensor:
        """Pop n device rows [1, n, 3072] from the adapter queue."""
        self.consumed_adapter += n
        return _take_rows(self.adapter_q, n)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_decoder(self):
        eng = self.engine
        prompt_len = eng.prompt_len
        n_alt = self.n_alt if self.n_alt > 1 else 0

        cur_adapter = self.total_adapter - self.consumed_adapter
        if not self.decoder_started:
            if cur_adapter < prompt_len:
                if not self.waiting_prompt:
                    _mon("⌛")  # ⌛ waiting for prompt-sized adapter
                    self.waiting_prompt = True
                return
            self.waiting_prompt = False
            t0 = time.monotonic()
            # rows 0..prompt_len-2 feed the prefill; row prompt_len-1 stays
            # queued as the first burst's adapter row (voxtral.c:969-1062)
            rows = eng.prompt_embeds(self._take_adapter(prompt_len - 1))
            self.dec_cache = eng.prefill(rows, self.dec_cache, 0)
            self._sync()  # attribute the time correctly
            self.dec_pos = prompt_len - 1
            self.gen_pos = prompt_len - 1
            self.prev_token = TOKEN_STREAMING_PAD
            self.decoder_started = True
            pf_ms = (time.monotonic() - t0) * 1000.0
            self.decoder_ms += pf_ms
            self.prefill_ms += pf_ms
            _mon("·")  # · prefill

        if self.decoder_started and not self.eos_seen:
            t0 = time.monotonic()
            gen_before = self.n_generated
            text_before = self.n_text_tokens
            control_before = self.n_control_tokens
            invalid_before = self.n_invalid_tokens
            while self.consumed_adapter < self.total_adapter and not self.eos_seen:
                avail = self.total_adapter - self.consumed_adapter
                b = eng.burst_size(avail)
                if (
                    eng.dec_kv_ring < self.cfg.decoder.window
                    and self.dec_pos + b > eng.dec_kv_ring
                ):
                    if not self.continuous:
                        raise RuntimeError(
                            f"decoder KV ring ({eng.dec_kv_ring}) smaller "
                            f"than the attention window would lose context "
                            f"at position {self.dec_pos + b}; size the ring "
                            f"to the clip or enable continuous mode (which "
                            f"restarts at {STREAM_MAX_DECODE_KV})"
                        )
                    # Clamp the burst to land EXACTLY on the ring cap, then
                    # let _maybe_restart perform the KV-overflow full reset
                    # (voxtral.c:1146-1148): the restart position is then a
                    # function of the cap alone, not of the burst partition.
                    b = eng.dec_kv_ring - self.dec_pos
                    if b <= 0:
                        self._ring_overflow = True
                        break
                chunk = self._take_adapter(b)
                tokens, alt_ids, alt_probs, best_probs, self.dec_cache = (
                    eng.decode_burst(chunk, self.prev_token, self.dec_cache,
                                     self.dec_pos, n_alt=n_alt))
                self.n_decode_steps += b
                if n_alt:
                    alt_ids = alt_ids[0].cpu().numpy()
                    alt_probs = alt_probs[0].cpu().numpy()
                    best_probs = best_probs[0].cpu().numpy()
                self._process_tokens(tokens[0].tolist(), alt_ids, alt_probs,
                                     best_probs)
            if self.n_generated > gen_before:
                dec_ms = (time.monotonic() - t0) * 1000.0
                self.decoder_ms += dec_ms
                if monitor:
                    # full reference symbol table (README.md:109-130,
                    # voxtral.c:1099-1129): text ▪/▸, invalid-decode ✗/✘,
                    # control-only ▫/▹, EOS-only ◦, severity ⚠/☠ appended
                    steps = self.n_generated - gen_before
                    slow = dec_ms / steps > 40
                    text_steps = self.n_text_tokens - text_before
                    control_steps = self.n_control_tokens - control_before
                    invalid_steps = self.n_invalid_tokens - invalid_before
                    if text_steps > 0:
                        sym = "▸" if slow else "▪"
                    elif invalid_steps > 0:
                        sym = "✘" if slow else "✗"
                    elif control_steps > 0:
                        sym = "▹" if slow else "▫"
                    elif self.eos_seen:
                        sym = "◦"  # EOS-only
                    else:
                        sym = "▪"
                    sev = ""
                    if text_steps == 0 and (control_steps > 0 or invalid_steps > 0):
                        if self.nontext_streak >= STREAM_MAX_NON_TEXT_STREAK - 8:
                            sev = "☠"  # critical streak, restart imminent
                        elif self.nontext_streak >= STREAM_MAX_NON_TEXT_STREAK // 2:
                            sev = "⚠"  # elevated streak
                    _mon(sym + sev)

        # adapter compaction (voxtral.c:718-731) is implicit: _take_adapter
        # pops consumed rows from the queue
        self._maybe_restart()

    def _maybe_restart(self):
        """Continuous-mode self-healing (voxtral.c:1137-1187)."""
        if not self.continuous:
            return
        need = 0
        if self.eos_seen:
            need = 1
        elif self.decoder_started and (
            self.dec_pos > STREAM_MAX_DECODE_KV or self._ring_overflow
        ):
            need = 2
        elif self.decoder_started and self.nontext_streak >= STREAM_MAX_NON_TEXT_STREAK:
            need = 3
        elif (
            not self.finished
            and (self.real_samples_fed - self.last_decode_sample)
            >= STREAM_MAX_NO_DECODE_SAMPLES
        ):
            need = 4
        if not need:
            return
        if self.text_since_restart:
            self.empty_restarts = 0
        else:
            self.empty_restarts += 1
        full = need >= 2 or self.empty_restarts >= STREAM_EMPTY_RESTARTS_FOR_FULL_RESET
        sym = {1: "↺", 2: "⟳", 3: "↯", 4: "⌚"}[need]
        _mon(sym + ("♻" if full else "✂"))
        if full:
            self._reset_full_state()
            self.empty_restarts = 0
        else:
            self._reset_decoder_state()
        self.last_decode_sample = self.real_samples_fed

    # ------------------------------------------------------------------
    # public API (voxtral.h:217-302)
    # ------------------------------------------------------------------
    def feed(self, samples: np.ndarray) -> int:
        if self.finished:
            return -1
        samples = np.asarray(samples, dtype=np.float32)
        if samples.size == 0:
            return -1
        self.mel_ctx.feed(samples)
        self.real_samples_fed += len(samples)
        self._run_encoder()
        self._run_decoder()
        return 0

    def flush(self) -> int:
        """Right-pad and force a full pass, leaving the stream open
        (voxtral.c:1588-1615)."""
        if self.finished:
            return -1
        align = (
            RAW_AUDIO_LENGTH_PER_TOK
            - (self.real_samples_fed % RAW_AUDIO_LENGTH_PER_TOK)
        ) % RAW_AUDIO_LENGTH_PER_TOK
        pad = align + n_right_pad_tokens(self.engine.delay_tokens) * RAW_AUDIO_LENGTH_PER_TOK
        self.mel_ctx.feed(np.zeros(pad, dtype=np.float32))
        saved = self.min_new_mel
        self.min_new_mel = 1
        self._run_encoder()
        self._run_decoder()
        self.min_new_mel = saved
        return 0

    def finish(self) -> int:
        if self.finished:
            return -1
        self.flush()
        self.finished = True
        self.mel_ctx.finish(0)
        if verbose >= 2:
            print(
                f"Stream finished: {self.real_samples_fed} real samples "
                f"({self.real_samples_fed / SAMPLE_RATE:.1f} sec)",
                file=sys.stderr,
            )
        self._run_encoder()
        self._run_decoder()
        return 0

    def get(self, max_tokens: int = 1 << 30) -> list[str]:
        n = min(max_tokens, len(self.queue))
        out = [self.queue[i][0] for i in range(n)]
        del self.queue[:n]
        return out

    def get_alt(self, max_tokens: int = 1 << 30, n_alt: int = MAX_ALT) -> list[tuple]:
        n = min(max_tokens, len(self.queue))
        n_alt = min(n_alt, MAX_ALT)
        out = [self.queue[i][:n_alt] for i in range(n)]
        del self.queue[:n]
        return out

    def print_stats(self):
        """Parser-compatible stderr metric lines (voxtral.c:1306-1317,
        benchmark.py:25-30)."""
        if verbose < 1:
            return
        print(
            f"Encoder: {self.mel_cursor} mel -> {self.total_adapter} tokens "
            f"({self.encoder_ms:.0f} ms)",
            file=sys.stderr,
        )
        if self.n_text_tokens > 0:
            gen_ms = self.decoder_ms - self.prefill_ms
            per_step = gen_ms / (self.n_generated - 1) if self.n_generated > 1 else 0.0
            print(
                f"Decoder: {self.n_text_tokens} text tokens "
                f"({self.n_generated} steps) in {self.decoder_ms:.0f} ms "
                f"(prefill {self.prefill_ms:.0f} ms + {per_step:.1f} ms/step)",
                file=sys.stderr,
            )


def transcribe_samples(engine: VoxtralEngine, samples: np.ndarray) -> str:
    """vox_transcribe_audio analog: run the stream end-to-end, join tokens."""
    s = VoxStream(engine)
    s.feed(samples)
    s.finish()
    text = "".join(s.get())
    s.print_stats()
    return text.strip()


def transcribe_tokens(engine: VoxtralEngine, samples: np.ndarray) -> list[str]:
    """Like transcribe_samples but returns the raw token strings."""
    s = VoxStream(engine)
    s.feed(samples)
    s.finish()
    out = s.get()
    s.print_stats()
    return out


def transcribe_file(engine: VoxtralEngine, wav_path: str) -> str:
    """vox_transcribe analog: load a WAV (any rate, any channels), resample
    to 16 kHz, transcribe, return the joined text."""
    from ..io.wav import load_wav

    return transcribe_samples(engine, load_wav(wav_path))
