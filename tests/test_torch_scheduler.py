"""The port's StreamPool (parallel/scheduler.py) and window-recompute encode
(models/bulk_encode.py) on tiny_config() float32 with the JAX package's
weights: ids and queues of both encoder modes equal JAX's StreamPool on the
same feeds; the ring-mode pool equal to the port's VoxStream (itself held
to JAX in test_torch_stream.py), full transcript per slot, through
restarts, parked slots near the ring cap, alt tokens, flush, churn,
finish and cache overrides; the watchdogs, stats, ledger and monitor
symbols; the admission prefill's in-place write of one slot; and
window_encode_chunk / bulk_encode_clips against JAX's with mixed n_ctx."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.models import bulk_encode as jbulk
from voxtral_tpu.parallel.scheduler import StreamPool as JPool
from voxtral_tpu_torch.config import STREAM_MAX_NO_DECODE_SAMPLES, tiny_config
from voxtral_tpu_torch.models import bulk_encode as tbulk
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.parallel.scheduler import StreamPool
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime import stream as tstream
from voxtral_tpu_torch.runtime.stream import VoxStream
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)

KW = dict(buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)


@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.fixture(scope="module")
def ttok():
    return TekkenTokenizer([bytes([i]) for i in range(256)], 1000)


@pytest.fixture(scope="module")
def teng_(tparams, ttok):
    return teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok, **KW)


def _ring_engine(tparams, ttok):
    """A decoder ring (64) smaller than the window (96): continuous slots
    take ring-overflow resets."""
    cfg = tiny_config(dec_window=96, dec_kv_ring=64)
    return teng.VoxtralEngine(cfg, tparams, tokenizer=ttok, **KW)


def run_voxstream(engine, audio, chunk_s=0.5, interval=0.25,
                  continuous=False, n_alt=0, cutoff=0.0, feeds=None):
    s = VoxStream(engine)
    s.set_processing_interval(interval)
    s.set_continuous(continuous)
    if n_alt:
        s.set_alt(n_alt, cutoff)
    if feeds is None:
        step = int(chunk_s * 16000)
        feeds = [audio[i: i + step] for i in range(0, len(audio), step)]
    for chunk in feeds:
        s.feed(chunk)
    s.finish()
    return s.get_alt() if n_alt else [(t,) for t in s.get()]


def drive_pool(pool, audios, chunk_s=0.5, interval=0.25, continuous=False,
               n_alt=0, cutoff=0.0):
    """Feed each slot its own audio in lockstep chunks, tick after each
    round, finish each slot (tests/test_scheduler.py's drive_pool)."""
    slots = []
    for _ in audios:
        i = pool.add_stream()
        pool.set_processing_interval(i, interval)
        pool.set_continuous(i, continuous)
        if n_alt:
            pool.set_alt_cutoff(i, cutoff)
        slots.append(i)
    step = int(chunk_s * 16000)
    for off in range(0, max(len(a) for a in audios), step):
        for i, a in zip(slots, audios):
            if off < len(a):
                pool.feed(i, a[off: off + step])
        pool.tick()
    for i in slots:
        pool.finish(i)
    if n_alt:
        return [pool.get_alt(i) for i in slots]
    return [[(t,) for t in pool.get(i)] for i in slots]


def _record_jax_ids(pool):
    """Per-slot raw ids of a JAX StreamPool (which keeps none), taken where
    its _process_tokens consumes them (up to and including EOS)."""
    ids = {}
    inner = pool._process_tokens

    def wrap(s, tokens, *rest):
        got = ids.setdefault(id(s.queue), [])
        for t in tokens:
            got.append(int(t))
            if int(t) == 2:        # TOKEN_EOS
                break
        return inner(s, tokens, *rest)

    pool._process_tokens = wrap
    return lambda i: ids.get(id(pool.slots[i].queue), [])


# --- against the JAX StreamPool ---------------------------------------------

@pytest.mark.parametrize("mode", ["ring", "window"])
def test_pool_ids_equal_jax(engine, teng_, mode):
    """Both encoder modes: two streams of different lengths, continuous
    (restarts fire on random weights), three slots: every slot's ids and
    token queue equal the JAX StreamPool's on the same feeds."""
    audios = [make_audio(2.4, seed=1), make_audio(1.7, seed=2)]
    jp = JPool(engine, 3, dec_kv_ring=64, enc_mode=mode)
    jids = _record_jax_ids(jp)
    want = drive_pool(jp, audios, continuous=True)
    tp = StreamPool(teng_, 3, dec_kv_ring=64, enc_mode=mode)
    tp.record_ids = True
    got = drive_pool(tp, audios, continuous=True)
    assert tp.enc_mode == mode and (tp.xwin is None) == (mode == "ring")
    for i in range(2):
        assert len(jids(i)) > 20
        assert tp.slots[i].generated_ids == jids(i)
    assert got == want
    assert tp.n_enc_calls == jp.n_enc_calls
    assert tp.n_bursts == jp.n_bursts and tp.burst_rows == jp.burst_rows
    if mode == "window":
        np.testing.assert_array_equal(tp.n_ctx, np.asarray(jp.n_ctx))


def test_window_encode_chunk_equals_jax(cfg, params, tparams):
    """window_encode_chunk over three slots with mixed valid context (0, a
    part, all of it), two chunks in a row: rows, tails, context and n_ctx
    within 1e-5 of JAX's, run one stream at a time there."""
    rng = np.random.default_rng(3)
    wp = jbulk.window_pad(cfg)
    assert wp == tbulk.window_pad(tiny_config()) == 24
    assert tbulk.window_pad(tiny_config(), 2) == jbulk.window_pad(cfg, 2)
    b, e = 3, cfg.encoder
    xwin = rng.standard_normal((b, wp, e.dim)).astype(np.float32)
    mel_tail = rng.standard_normal((b, 2, e.n_mel)).astype(np.float32)
    c0_tail = rng.standard_normal((b, 2, e.dim)).astype(np.float32)
    n_ctx = np.array([0, 9, wp], np.int32)
    jstate = [(jnp.asarray(mel_tail[i]), jnp.asarray(c0_tail[i]),
               jnp.asarray(xwin[i]), jnp.int32(n_ctx[i])) for i in range(b)]
    tstate = tuple(torch.from_numpy(x) for x in (mel_tail, c0_tail, xwin,
                                                 n_ctx))
    for q in (16, 40):
        mel = rng.standard_normal((b, q, e.n_mel)).astype(np.float32)
        trows, *tstate = tbulk.window_encode_chunk(
            tparams["encoder"], tparams["adapter"], tiny_config(),
            torch.from_numpy(mel), *tstate)
        assert trows.shape == (b, q // 8, cfg.decoder.dim)
        for i in range(b):
            jrows, *js = jbulk.window_encode_chunk(
                params["encoder"], params["adapter"], cfg,
                jnp.asarray(mel[i]), *jstate[i])
            jstate[i] = tuple(js)
            np.testing.assert_allclose(trows[i].numpy(), np.asarray(jrows),
                                       rtol=1e-5, atol=1e-5)
            for tx, jx in zip(tstate, js):
                np.testing.assert_allclose(tx[i].numpy(), np.asarray(jx),
                                           rtol=1e-5, atol=1e-5)
    assert tstate[3].tolist() == [wp, wp, wp]


def test_bulk_encode_clips_equals_jax(cfg, params, tparams):
    """bulk_encode_clips (the port's batched bulk_encode_clip under the
    JAX name) against JAX's vmapped one, two clips."""
    assert tbulk.bulk_encode_clips is tbulk.bulk_encode_clip
    mel = np.random.default_rng(4).standard_normal(
        (2, 48, cfg.encoder.n_mel)).astype(np.float32)
    want = jbulk.bulk_encode_clips(params["encoder"], params["adapter"], cfg,
                                   jnp.asarray(mel))
    got = tbulk.bulk_encode_clips(tparams["encoder"], tparams["adapter"],
                                  tiny_config(), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --- against the port's VoxStream --------------------------------------------

def test_pool_full_equality(teng_):
    """Ring-mode pool == VoxStream, full transcript, two streams (the
    shorter one drains early and rides along)."""
    a, b = make_audio(2.4, seed=1), make_audio(1.7, seed=2)
    pool = StreamPool(teng_, 3, dec_kv_ring=64, enc_mode="ring")
    got_a, got_b = drive_pool(pool, [a, b])
    assert got_a == run_voxstream(teng_, a)
    assert got_b == run_voxstream(teng_, b)


def test_pool_restart_mid_pool(tparams, ttok):
    """Continuous slots on a ring smaller than the window take overflow
    full resets (and EOS / non-text restarts) mid-pool; transcripts still
    equal VoxStream's."""
    eng = _ring_engine(tparams, ttok)
    a, b = make_audio(4.5, seed=7), make_audio(4.5, seed=8)
    pool = StreamPool(eng, 2, dec_kv_ring=64, enc_mode="ring")
    got_a, got_b = drive_pool(pool, [a, b], continuous=True)
    assert sum(s.n_restarts for s in pool.slots) > 0, "no restart exercised"
    assert got_a == run_voxstream(eng, a, continuous=True)
    assert got_b == run_voxstream(eng, b, continuous=True)


def test_pool_parked_slot_near_ring_cap(tparams, ttok):
    """A slot parked just below the ring cap while the other bursts: the
    burst is clamped to the parked rider's headroom, so its ride-along
    writes never wrap onto its real low-position rows; transcripts equal
    VoxStream's through the pause, resume and overflow restart."""
    eng = _ring_engine(tparams, ttok)
    a, b = make_audio(3.6, seed=61), make_audio(10.0, seed=62)
    pool = StreamPool(eng, 2, dec_kv_ring=64, enc_mode="ring")
    ia, ib = pool.add_stream(), pool.add_stream()
    for i in (ia, ib):
        pool.set_processing_interval(i, 0.25)
        pool.set_continuous(i, True)
    step, b_feeds = 8000, []

    def feed_b(chunk):
        b_feeds.append(chunk)
        pool.feed(ib, chunk)

    for off in range(0, 32000, step):
        pool.feed(ia, a[off: off + step])
        feed_b(b[off: off + step])
        pool.tick()
    off_b = 32000
    while pool.slots[ib].n_restarts == 0:
        feed_b(b[off_b: off_b + step])
        pool.tick()
        off_b += step
    headroom_a = pool.dec_ring - pool.slots[ia].dec_pos
    assert 0 < headroom_a < 16, "a must park just below the cap"
    low_k = pool.dec_cache.k[ia][:, :, :16].clone()
    feed_b(b[off_b: off_b + 4 * 16000])       # a 16-row burst for b
    pool.tick()
    off_b += 4 * 16000
    assert torch.equal(pool.dec_cache.k[ia][:, :, :16], low_k), \
        "a parked ride-along write wrapped onto real low-position rows"
    for off in range(32000, len(a), step):
        pool.feed(ia, a[off: off + step])
        if off_b < len(b):
            feed_b(b[off_b: off_b + step])
            off_b += step
        pool.tick()
    pool.finish(ia)
    while off_b < len(b):
        feed_b(b[off_b: off_b + step])
        pool.tick()
        off_b += step
    pool.finish(ib)
    assert [(t,) for t in pool.get(ia)] == run_voxstream(eng, a,
                                                         continuous=True)
    assert [(t,) for t in pool.get(ib)] == run_voxstream(
        eng, b, interval=0.25, continuous=True, feeds=b_feeds)


def test_pool_parked_rider_wrap_at_cap_ge_window(teng_):
    """cap (64) >= window (48): a parked rider's burst is bounded by
    max(cap - dec_pos, cap - window + 1), so its writes never displace an
    in-window row; transcripts equal VoxStream's through pause/resume."""
    cap, window = 64, teng_.cfg.decoder.window
    a, b = make_audio(6.5, seed=71), make_audio(8.0, seed=72)
    pool = StreamPool(teng_, 2, dec_kv_ring=cap, enc_mode="ring")
    ia, ib = pool.add_stream(), pool.add_stream()
    for i in (ia, ib):
        pool.set_processing_interval(i, 0.25)
        pool.set_continuous(i, False)
    step, b_feeds = 8000, []

    def feed_b(chunk):
        b_feeds.append(chunk)
        pool.feed(ib, chunk)

    for off in range(0, 72000, step):
        pool.feed(ia, a[off: off + step])
        feed_b(b[off: off + step])
        pool.tick()
    d = pool.slots[ia].dec_pos
    assert d > window and pool.slots[ia].backlog == 0
    live = torch.from_numpy(np.arange(max(d - window + 1, 0), d) % cap)
    k_before = pool.dec_cache.k[ia][:, :, live].clone()
    big = 24 * 8 * 160                         # 24 rows for b alone
    feed_b(b[72000: 72000 + big])
    pool.tick()
    assert torch.equal(pool.dec_cache.k[ia][:, :, live], k_before), \
        "a parked ride-along write displaced in-window rows"
    off_b = 72000 + big
    for off in range(72000, len(a), step):
        pool.feed(ia, a[off: off + step])
        if off_b < len(b):
            feed_b(b[off_b: off_b + step])
            off_b += step
        pool.tick()
    pool.finish(ia)
    while off_b < len(b):
        feed_b(b[off_b: off_b + step])
        pool.tick()
        off_b += step
    pool.finish(ib)
    assert [(t,) for t in pool.get(ia)] == run_voxstream(teng_, a)
    assert [(t,) for t in pool.get(ib)] == run_voxstream(teng_, b,
                                                         feeds=b_feeds)


def test_pool_alt_tokens(teng_):
    """n_alt=3 with a loose cutoff: the alt groups equal VoxStream's."""
    a = make_audio(2.0, seed=11)
    pool = StreamPool(teng_, 2, dec_kv_ring=64, enc_mode="ring", n_alt=3)
    (got,) = drive_pool(pool, [a], n_alt=3, cutoff=0.9)
    assert got == run_voxstream(teng_, a, n_alt=3, cutoff=0.9)
    assert any(len([x for x in g if x]) > 1 for g in got)


def test_pool_flush_midstream(teng_):
    """flush() forces a full pass and leaves the slot open; the final
    transcript equals VoxStream's with the same flush point."""
    a, b = make_audio(1.2, seed=13), make_audio(1.0, seed=14)
    s = VoxStream(teng_)
    s.set_processing_interval(0.25)
    s.feed(a)
    s.flush()
    s.feed(b)
    s.finish()
    pool = StreamPool(teng_, 2, dec_kv_ring=64, enc_mode="ring")
    i = pool.add_stream()
    pool.set_processing_interval(i, 0.25)
    pool.feed(i, a)
    pool.tick()
    pool.flush(i)
    assert not pool.slots[i].finished
    pool.feed(i, b)
    pool.tick()
    pool.finish(i)
    assert pool.get(i) == s.get()
    assert pool.flush(i) == pool.finish(i) == pool.feed(i, a) == -1


def test_pool_join_leave_churn(teng_):
    """Slots join at different times and leave; the freed slot is reused;
    each transcript equals its own VoxStream run."""
    a, b = make_audio(2.2, seed=21), make_audio(1.6, seed=22)
    pool = StreamPool(teng_, 2, dec_kv_ring=64, enc_mode="ring")
    ia = pool.add_stream()
    pool.set_processing_interval(ia, 0.25)
    step = 8000
    for off in range(0, 16000, step):
        pool.feed(ia, a[off: off + step])
        pool.tick()
    ib = pool.add_stream()
    pool.set_processing_interval(ib, 0.25)
    with pytest.raises(RuntimeError, match="no free slots"):
        pool.add_stream()
    off_b = 0
    for off in range(16000, len(a), step):
        pool.feed(ia, a[off: off + step])
        if off_b < len(b):
            pool.feed(ib, b[off_b: off_b + step])
            off_b += step
        pool.tick()
    pool.finish(ia)
    got_a = [(t,) for t in pool.get(ia)]
    pool.close(ia)
    ic = pool.add_stream()
    assert ic == ia
    pool.close(ic)
    while off_b < len(b):
        pool.feed(ib, b[off_b: off_b + step])
        pool.tick()
        off_b += step
    pool.finish(ib)
    assert got_a == run_voxstream(teng_, a)
    assert [(t,) for t in pool.get(ib)] == run_voxstream(teng_, b)


def test_pool_finish_bypasses_interval_gate(teng_):
    """finish() with less pending mel than the interval still flushes
    everything (VoxStream's finished bypass)."""
    a = make_audio(2.3, seed=41)
    pool = StreamPool(teng_, 1, dec_kv_ring=64, enc_mode="ring")
    i = pool.add_stream()
    pool.set_processing_interval(i, 2.0)
    pool.feed(i, a[:32000])
    pool.tick()
    pool.feed(i, a[32000:])       # 0.3 s < the 2.0 s interval
    pool.tick()
    pool.finish(i)
    assert [(t,) for t in pool.get(i)] == run_voxstream(teng_, a, chunk_s=2.3,
                                                        interval=2.0)


def test_pool_cache_overrides(teng_):
    """Per-pool ring overrides (fp8 encoder and decoder rings, a tight
    encoder cap): the pool's caches take them, and the transcript tracks
    the exact pool's (the fp8 ladder's bar)."""
    a = make_audio(1.8, seed=51)
    (ref,) = drive_pool(StreamPool(teng_, 2, dec_kv_ring=64, enc_mode="ring"),
                        [a])
    pool8 = StreamPool(teng_, 2, dec_kv_ring=64, enc_mode="ring",
                       enc_kv_ring=48, enc_kv_dtype="float8_e4m3fn",
                       dec_kv_dtype="float8_e4m3fn")
    assert pool8.enc_cache.k.dtype == torch.float8_e4m3fn
    assert pool8.dec_cache.k.dtype == torch.float8_e4m3fn
    assert pool8.enc_cache.k.shape[3] == 48
    (got,) = drive_pool(pool8, [a])
    assert len(got) > 0
    m = min(len(ref), len(got))
    agree = sum(x == y for x, y in zip(ref[:m], got[:m])) / max(m, 1)
    assert agree >= 0.5, (agree, ref, got)
    with pytest.raises(ValueError, match="encoder ring"):
        StreamPool(teng_, 2, enc_kv_ring=20)
    with pytest.raises(ValueError, match="enc_mode"):
        StreamPool(teng_, 2, enc_mode="paged")


def test_pool_no_decode_watchdog(teng_):
    """Cause 4: a continuous slot fed past STREAM_MAX_NO_DECODE_SAMPLES
    without a decode takes a full reset; EOS restarts without text are
    decoder-only until the second in a row escalates to a full reset."""
    pool = StreamPool(teng_, 1, dec_kv_ring=64, enc_mode="ring")
    assert pool.enc_mode == "ring"
    i = pool.add_stream()
    pool.set_continuous(i, True)
    s = pool.slots[i]
    s.real_samples_fed = STREAM_MAX_NO_DECODE_SAMPLES + 1
    s.enc_pos = 5
    pool._maybe_restart(i)
    s = pool.slots[i]
    assert s.n_restarts == 1 and s.enc_pos == 0 and s.empty_restarts == 0
    assert s.last_decode_sample == s.real_samples_fed
    s.eos_seen = s.decoder_started = True
    s.enc_pos = 7
    pool._maybe_restart(i)
    s = pool.slots[i]
    assert s.n_restarts == 2 and s.empty_restarts == 1 and s.enc_pos == 7
    assert not s.decoder_started                        # decoder-only
    s.eos_seen = True
    pool._maybe_restart(i)
    s = pool.slots[i]
    assert s.n_restarts == 3 and s.empty_restarts == 0 and s.enc_pos == 0


def test_pool_print_stats(teng_, capsys, monkeypatch):
    """print_stats prints the pool's Memory/Encoder/Decoder lines and, at
    verbose 2, one line per slot."""
    pool = StreamPool(teng_, 2, dec_kv_ring=64, enc_mode="ring")
    drive_pool(pool, [make_audio(1.2, seed=71)])
    monkeypatch.setattr(tstream, "verbose", 2)
    pool.print_stats()
    err = capsys.readouterr().err
    assert "Encoder:" in err and "mel ->" in err
    assert "slot 0:" in err
    assert "Memory:" in err and "GiB resident" in err
    monkeypatch.setattr(tstream, "verbose", 0)
    pool.print_stats()
    assert capsys.readouterr().err == ""


def test_memory_ledger(teng_):
    """The pool ledger adds the pool's own tensors to the engine's: the
    per-stream decoder cache formula matches the batched cache; window
    mode counts its context instead of an encoder ring."""
    pool = StreamPool(teng_, 3, dec_kv_ring=64, enc_mode="ring")
    led = pool.memory_ledger()
    cfg = teng_.cfg
    per = (2 * cfg.decoder.n_layers * cfg.decoder.n_kv_heads * 64
           * cfg.decoder.head_dim * pool.dec_cache.k.element_size())
    assert led["pool_dec_cache"] == 3 * per
    assert led["pool_row_ring"] == 3 * 256 * cfg.decoder.dim * 4
    assert led["total_resident"] == led["params_total"] + led["pool_total"]
    led_w = StreamPool(teng_, 3, dec_kv_ring=64,
                       enc_mode="window").memory_ledger()
    assert "pool_xwin" in led_w and "pool_enc_cache" not in led_w
    assert led_w["pool_xwin"] == 3 * 24 * cfg.encoder.dim * 4


def test_pool_monitor_symbol_stream(teng_, monkeypatch):
    """--monitor: slot-prefixed symbols, one line per tick: encoder chunks,
    prefill, decode classes, and the restart cause/scope pairs."""
    monkeypatch.setattr(tstream, "monitor", True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        pool = StreamPool(teng_, 2, dec_kv_ring=64, enc_mode="ring")
        drive_pool(pool, [make_audio(1.2, seed=3), make_audio(1.2, seed=4)],
                   continuous=True)
    text = err.getvalue()
    assert "0:" in text and "1:" in text
    assert "▶" in text and "·" in text and "⌛" in text
    assert any(c in text for c in "▪▸✗✘▫▹◦")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        pool.close(0)
        i = pool.add_stream()
        pool.set_continuous(i, True)
        pool.slots[i].real_samples_fed = STREAM_MAX_NO_DECODE_SAMPLES + 1
        pool._maybe_restart(i)
        s2 = pool.slots[i]
        s2.eos_seen = s2.decoder_started = True
        pool._maybe_restart(i)
        pool._mon_flush()
    text = err.getvalue()
    assert "⌚" in text and "↺" in text
    assert "♻" in text or "✂" in text


def test_pool_monitor_off_accumulates_nothing(teng_):
    pool = StreamPool(teng_, 1, dec_kv_ring=64, enc_mode="ring")
    drive_pool(pool, [make_audio(1.0, seed=5)])
    assert all(not s.syms for s in pool.slots)


def test_admit_prefill_writes_one_slot_in_place(teng_):
    """The admission prefill writes a view of its slot's decoder rings: the
    other slots' rings stay bit-equal, the cache tensors stay the same
    objects, and the slot's rings equal a B=1 prefill of the same rows."""
    pool = StreamPool(teng_, 3, dec_kv_ring=64, enc_mode="ring")
    gen = torch.Generator().manual_seed(0)
    for x in (pool.dec_cache.k, pool.dec_cache.v, pool.row_ring):
        x.copy_(torch.randn(x.shape, generator=gen))
    k0, v0 = pool.dec_cache.k, pool.dec_cache.v
    before_k, before_v = k0.clone(), v0.clone()
    i = pool.add_stream()
    i = pool.add_stream()          # slot 1
    pool.slots[i].w_count = 100
    pool.slots[i].r_count = 50
    pool._admit_prefill(i)
    assert pool.dec_cache.k is k0 and pool.dec_cache.v is v0
    for j in (0, 2):
        assert torch.equal(k0[j], before_k[j]) and torch.equal(v0[j],
                                                               before_v[j])
    assert not torch.equal(k0[i], before_k[i])
    L = teng_.prompt_len
    rows = pool.row_ring[i: i + 1, 50: 50 + L - 1]
    ref = teng_.new_dec_cache()
    ref.k.copy_(before_k[i: i + 1])
    ref.v.copy_(before_v[i: i + 1])
    teng_.prefill(teng_.prompt_embeds(rows), ref, 0)
    assert torch.equal(k0[i], ref.k[0]) and torch.equal(v0[i], ref.v[0])
    assert pool.slots[i].dec_pos == L - 1 and pool.slots[i].decoder_started
