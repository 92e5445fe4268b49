"""Live captioning: many concurrent sessions through the port's
`parallel/scheduler.py:StreamPool` in ring mode, open loop at 1x realtime.

Traffic file keys: slots, interval_s (the feed cadence), gate_s (each
slot's processing interval), session_s [lo, hi] (uniform session lengths),
enc_kv_ring, dec_kv_ring, buckets (the engine's), stagger_s (the first
sessions' starts), warm_s (paced ticks before the window), tail_s (paced ticks after it, in which the tokens due
in it are still handed out), grace_s (a row still undecoded this long after
its audio was due, at the end, has failed), bank_clips (distinct clips the
sessions read), check_sessions, trace_ticks.

The schedule is the wall clock: tick k is due at k * interval_s.  At each
tick every slot is fed the audio due since its last feed (a late tick
makes the next feed larger), then `tick()` runs, then `get()` for every
slot.  A session that has run its length is closed and a new one joins
the slot (`close` + `add_stream`), due from the moment the old one ended.
The slots' first sessions start at uniform times in the first
`stagger_s` seconds and last a uniform share of a session length, so that
admissions spread over the warm-up and joins over the window.

A token's latency runs from the moment the last audio sample of the
adapter row it was decoded at was due to the `get()` that hands it out.
The model's fixed delay of `delay_tokens` rows is not in it: it is
measured from the row decoded, not from the audio the token describes.
Rows are followed from the pool's public slot state (`generated_ids` with
`record_ids` on, the row cursors, the restarts).  Every text token due in
the window counts in the 95th percentile.  A traced run profiles the
window's last `trace_ticks` ticks.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import audio, reference, trace, weights, work
from .offline import _worst, port_config

SAMPLE_RATE = 16_000


def row_last_sample(r: int) -> int:
    """Index, from the start of a mel context's audio, of the last real
    sample that adapter row r covers: row r needs mel frames up to 8r + 7,
    frame f covers padded samples 160 f .. 160 f + 399, and the padded
    stream starts with 200 + 32 * 1280 zeros.  Negative for rows of the
    left padding."""
    return 160 * (8 * r + 7) + 399 - (reference.N_FFT // 2
                                      + reference.LEFT_PAD_TOKENS
                                      * reference.SAMPLES_PER_TOKEN)


def tokenizer(vocab: int):
    """A byte tokenizer over the whole vocabulary whose every id from 1000
    on decodes to one byte that is not NUL (a text token), as seeded
    weights pick ids anywhere in it."""
    from voxtral_tpu_torch.tokenizer import TekkenTokenizer

    return TekkenTokenizer([bytes([1 + i % 255]) for i in range(vocab - 1000)],
                           1000)


def is_text(tok: int) -> bool:
    """What `get()` hands out under `tokenizer`: every id from 1000 on."""
    return tok >= 1000


class Session:
    def __init__(self, clip: int, start: float, length: float, ids0: int):
        self.clip, self.start, self.length = clip, start, length
        self.fed = 0                 # samples fed
        self.origin = 0              # samples fed before its mel context
        self.ids0 = ids0             # generated_ids index where it began
        self.epoch_end = None        # generated_ids index at its 1st restart
        self.closed_at = None

    def due(self, sample: int) -> float:
        """Schedule time at which the session's `sample` was due."""
        return self.start + (sample + 1) / SAMPLE_RATE

    def row_due(self, r: int) -> float:
        return self.due(self.origin + max(row_last_sample(r), 0))


class LivePool:
    """The pool and its sessions, ticked on the wall clock."""

    def __init__(self, model, traffic, seed, dev):
        from voxtral_tpu_torch.parallel.scheduler import StreamPool
        from voxtral_tpu_torch.runtime.engine import VoxtralEngine

        self.model, self.traffic = model, traffic
        self.rng = np.random.default_rng(seed)
        if dev.type == "cuda":
            # build (or load) the port's kernels now: the first run in a
            # checkout compiles them, and not inside the paced ticks
            from voxtral_tpu_torch.ops import cuda_lib

            cuda_lib.kernels()
        engine = VoxtralEngine(
            port_config(model), weights.make_params(model, seed, dev),
            tokenizer=tokenizer(model["decoder"]["vocab_size"]),
            buckets=tuple(traffic["buckets"]))
        self.prompt_len = engine.prompt_len
        self.bank = audio.clips(seed, traffic["bank_clips"],
                                traffic["session_s"][1], dev).cpu().numpy()
        self.pool = StreamPool(engine, traffic["slots"],
                               dec_kv_ring=traffic["dec_kv_ring"],
                               enc_mode="ring",
                               enc_kv_ring=traffic["enc_kv_ring"])
        self.pool.record_ids = True
        self.sessions = [[] for _ in range(traffic["slots"])]
        for i in range(traffic["slots"]):
            start = self.rng.uniform(0.0, traffic["stagger_s"])
            self._join(i, start, self._length() * self.rng.uniform(0.05, 1.0))
        self.t0 = time.monotonic()
        self.ticks = []     # (due, start, end) of every tick
        self.tokens = []    # (due of the row it was decoded at, handed out)
        self.flops = []     # the model operations of every tick's work
        self.mismatch = 0   # ticks where get() handed out another count

    def _length(self) -> float:
        lo, hi = self.traffic["session_s"]
        return float(self.rng.uniform(lo, hi))

    def _join(self, i: int, start: float, length: float):
        if self.pool.add_stream() != i:
            raise RuntimeError(f"slot {i} did not rejoin")
        self.pool.set_processing_interval(i, self.traffic["gate_s"])
        self.sessions[i].append(Session(
            int(self.rng.integers(self.bank.shape[0])), start, length,
            len(self.pool.slots[i].generated_ids)))

    def now(self) -> float:
        return time.monotonic() - self.t0

    def tick(self, k: int):
        pool, L, model = self.pool, self.prompt_len, self.model
        due = k * self.traffic["interval_s"]
        wait = due - self.now()
        if wait > 0:
            time.sleep(wait)
        start = self.now()
        before = []
        for i, sess in enumerate(self.sessions):
            s = sess[-1]
            if start >= s.start + s.length:            # the session is over
                s.closed_at = start
                pool.close(i)
                self._join(i, s.start + s.length, self._length())
                s = sess[-1]
            upto = min(int(max(start - s.start, 0.0) * SAMPLE_RATE),
                       int(s.length * SAMPLE_RATE))
            if upto > s.fed:
                pool.feed(i, self.bank[s.clip, s.fed: upto])
                s.fed = upto
            sl = pool.slots[i]
            before.append((sl, sl.r_count, sl.decoder_started, sl.enc_pos,
                           sl.dec_pos, len(sl.generated_ids), sl.n_restarts))
        pool.tick()
        end = self.now()
        out = []
        for i in range(len(before)):
            out.append((pool.get(i), self.now()))
        flops = 0.0
        for i, (sl, r0, started, e0, d0, g0, n_r) in enumerate(before):
            handed, t_get = out[i]
            s, now_sl = self.sessions[i][-1], pool.slots[i]
            ids = now_sl.generated_ids[g0:]
            admitted = not started and (sl.decoder_started or ids)
            first = r0 + (L - 1 if admitted else 0)
            text = [first + j for j, tok in enumerate(ids) if is_text(tok)]
            self.tokens += [(s.row_due(r), t_get) for r in text]
            if len(text) != len(handed):
                self.mismatch += 1
            # the tick's model work, from the slot's cursors: its new encoder
            # positions, its prefill at admission, a step a token
            if sl.enc_pos > e0:
                flops += work.encoder_flops(model, 2 * (sl.enc_pos - e0), e0)
            p0 = d0
            if admitted:
                flops += work.decoder_flops(model, range(L - 1), False)
                p0 = L - 1
            flops += work.decoder_flops(model, range(p0, p0 + len(ids)), True)
            if now_sl.n_restarts != n_r and s.epoch_end is None:
                s.epoch_end = len(now_sl.generated_ids)
            if now_sl is not sl:              # a full reset: a new context
                s.origin = s.fed
        self.ticks.append((due, start, end))
        self.flops.append(flops)

    def failed_rows(self, t_end: float, grace: float) -> int:
        """Rows whose audio was due more than `grace` before `t_end` and that
        the program has neither decoded nor dropped by its own rules: of
        each slot's current decoder epoch, the rows from its decode cursor
        to the last its fed mel fills."""
        n = 0
        for i, sl in enumerate(self.pool.slots):
            s = self.sessions[i][-1]
            if not sl.decoder_started:
                continue
            rows = (sl.mel_ctx.mel_frame_offset + sl.mel_ctx.n_frames) // 8
            n += sum(s.row_due(r) < t_end - grace
                     for r in range(sl.r_count, rows))
        return n


class EncodeCalls:
    """The pool's encoder calls while on: (mel frames, each slot's encoder
    position), read from the slots before each call (a wrapper of
    `scheduler.pool_encode_ring` that calls it unchanged)."""

    def __init__(self, pool):
        from voxtral_tpu_torch.parallel import scheduler

        self.mod, self.pool, self.on, self.calls = scheduler, pool, False, []
        self.real = scheduler.pool_encode_ring

        def wrapped(*args):
            if self.on:
                self.calls.append((args[3].shape[1],
                                   [s.enc_pos for s in self.pool.slots]))
            return self.real(*args)

        scheduler.pool_encode_ring = wrapped

    def close(self):
        self.mod.pool_encode_ring = self.real


def run(ctx) -> dict:
    """One run (ctx: model, traffic, seed, seconds, trace, device,
    t_start): the record its metric readers read, its end-to-end values,
    attempted / failed (tokens), the peak, the check's numbers, and the
    judged sessions."""
    d = LivePool(ctx.model, ctx.traffic, ctx.seed, ctx.device)
    enc = EncodeCalls(d.pool)
    try:
        return _run(ctx, d, enc)
    finally:
        enc.close()


def _run(ctx, d: LivePool, enc: EncodeCalls) -> dict:
    model, tr, dev = ctx.model, ctx.traffic, ctx.device
    step = tr["interval_s"]
    n_warm = int(round(tr["warm_s"] / step))
    n_win = int(round(ctx.seconds / step))
    n_tail = int(round(tr["tail_s"] / step))
    n_trace = min(tr["trace_ticks"], n_win) if ctx.trace else 0
    d.t0 = time.monotonic()
    for k in range(n_warm):
        d.tick(k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.monotonic() - ctx.t_start
    w0, w1 = n_warm * step, (n_warm + n_win) * step
    first_traced = n_warm + n_win - n_trace
    prof = span = None
    peak = 0
    for k in range(n_warm, n_warm + n_win + n_tail):
        if k == first_traced and n_trace:
            prof, span = trace.start()
            enc.on = True
        d.tick(k)
        if k == n_warm + n_win - 1:
            enc.on = False
            if prof is not None:
                trace.end_span(span)
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
    t_end = d.now()
    if prof is not None:
        prof.stop()
    lat = [1e3 * (h - u) for u, h in d.tokens if w0 <= u < w1]
    failed = d.failed_rows(t_end, tr["grace_s"]) + d.mismatch
    window = range(n_warm, n_warm + n_win)
    timed = [k for k in window if k < first_traced or not n_trace]
    rec = {
        "kind": "stream", "model": model, "traffic": tr,
        "tick_ms": [1e3 * (d.ticks[k][2] - d.ticks[k][1]) for k in timed],
        "late_ms": [1e3 * (d.ticks[k][1] - d.ticks[k][0]) for k in timed],
        "tick_flops": [d.flops[k] for k in timed],
        "encode_calls": enc.calls,
        "trace": (trace.summarize(trace.profiler_events(prof))
                  if prof is not None else None),
    }
    e2e = {"token_latency_p95_ms": float(np.percentile(lat, 95))
           if lat else float("inf")}
    cases = _judged(d, tr, w0, t_end)
    del d, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge_sessions(model, ctx.seed, dev, cases,
                             reference.Precision(**model["precision"]))
    return {"record": rec, "e2e": e2e, "attempted": len(lat) + failed,
            "failed": failed, "setup_s": setup_s, "peak_bytes": peak,
            "numbers": numbers, "cases": cases}


def _judged(d: LivePool, tr: dict, w0: float, t_end: float) -> list:
    """(samples fed, ids of the first decoder epoch) of the judged
    sessions: the longest that ended in the window or its tail, and
    others drawn from the seed, `check_sessions` in all."""
    done = [(i, n) for i, sess in enumerate(d.sessions)
            for n, s in enumerate(sess)
            if s.closed_at is not None and w0 <= s.closed_at <= t_end]
    if not done:
        return []
    order = sorted(range(len(done)),
                   key=lambda j: -d.sessions[done[j][0]][done[j][1]].length)
    rest = order[1:]
    pick = order[:1] + [rest[j] for j in d.rng.choice(
        len(rest), size=min(len(rest), tr["check_sessions"] - 1),
        replace=False)]
    cases = []
    for j in pick:
        i, n = done[j]
        s, nxt = d.sessions[i][n], d.sessions[i][n + 1]
        end = s.epoch_end if s.epoch_end is not None else nxt.ids0
        ids = list(d.pool.slots[i].generated_ids[s.ids0: end])
        cases.append((d.bank[s.clip, : s.fed].copy(), ids))
    return cases


@torch.no_grad()
def judge_sessions(model, seed, dev, cases, prec, control=None) -> dict:
    """`logit_gap` over the judged sessions' first decoder epochs: the
    reference over the audio each session was fed (the live mel: left
    padding, no right padding), teacher-forced on the ids it served.
    With `control` (a Precision), the token that the reference computed
    that way puts first at each position."""
    cases = [(x, ids) for x, ids in cases if ids]
    if not cases:
        return {"logit_gap": float("inf")}
    params = weights.make_params(model, seed, dev)
    gap = 0.0
    with reference.exact_f32():
        for samples, ids in cases:
            mel = reference.live_mel(torch.as_tensor(samples, device=dev))
            rows = reference.encode(params, model, mel, prec)
            logits, _ = reference.decoder_logits(params, model, rows, ids,
                                                 prec)
            chosen = ids
            if control is not None:
                lg, _ = reference.decoder_logits(
                    params, model, reference.encode(params, model, mel,
                                                    control), ids, control)
                chosen = lg.argmax(-1).tolist()
            gap = _worst(gap, float(reference.logit_gaps(logits,
                                                         chosen).max()))
    return {"logit_gap": gap}
