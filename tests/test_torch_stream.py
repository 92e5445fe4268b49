"""The port's streaming path against the JAX package's on tiny_config()
float32 with the same weights: the conv stem chunks with tails, the
ring-cache encoder (attn_impl "xla" and "flash"), the fused audio step
(1e-5), and VoxStream end to end (ids and token strings exactly equal for
every feed chunking, fused and unfused, with alternatives and the monitor
symbols), flush-then-continue and the continuous-mode watchdogs."""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.models import encoder as jenc
from voxtral_tpu.models import fused_stream as jfused
from voxtral_tpu.runtime import engine as jeng
from voxtral_tpu.runtime import stream as jstream
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import encoder as tenc
from voxtral_tpu_torch.models import fused_stream as tfused
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime import stream as tstream
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.fixture(scope="module")
def ttok():
    return TekkenTokenizer([bytes([i]) for i in range(256)], 1000)


def _tcfg(impl="auto", **kw):
    c = tiny_config(**kw)
    return c.replace(encoder=dataclasses.replace(c.encoder, attn_impl=impl))


def _jcfg(cfg, impl):
    return cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                   attn_impl=impl))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# --- the encoder's streaming calls ------------------------------------------

def test_conv_chunks_match(cfg, params, tparams):
    """conv0 then conv1 over three chunks, tails carried, two streams (the
    second stream's inputs are the first's scaled by -0.5)."""
    rng = np.random.default_rng(2)
    jp, tp = params["encoder"], tparams["encoder"]
    jt0 = jnp.zeros((2, cfg.encoder.n_mel), jnp.float32)
    jt1 = jnp.zeros((2, cfg.encoder.dim), jnp.float32)
    tt0 = torch.zeros((2, 2, cfg.encoder.n_mel))
    tt1 = torch.zeros((2, 2, cfg.encoder.dim))
    jt0b, jt1b = jt0, jt1          # stream 1's own JAX chain
    for t in (6, 16, 10):
        mel = rng.standard_normal((t, cfg.encoder.n_mel)).astype(np.float32)
        tc0, tt0 = tenc.conv0_chunk(
            tp, torch.from_numpy(np.stack([mel, -0.5 * mel])), tt0,
            torch.float32)
        tc1, tt1 = tenc.conv1_chunk(tp, tc0, tt1, torch.float32)
        for s, m in ((0, mel), (1, -0.5 * mel)):
            jt0s, jt1s = (jt0, jt1) if s == 0 else (jt0b, jt1b)
            jc0, jt0s = jenc.conv0_chunk(jp, jnp.asarray(m), jt0s, "float32")
            jc1, jt1s = jenc.conv1_chunk(jp, jc0, jt1s, "float32")
            np.testing.assert_allclose(_np(tc0[s]), _np(jc0), **TOL)
            np.testing.assert_allclose(_np(tc1[s]), _np(jc1), **TOL)
            np.testing.assert_allclose(_np(tt0[s]), _np(jt0s), **TOL)
            np.testing.assert_allclose(_np(tt1[s]), _np(jt1s), **TOL)
            if s == 0:
                jt0, jt1 = jt0s, jt1s
            else:
                jt0b, jt1b = jt0s, jt1s
    assert tc1.shape == (2, 5, cfg.encoder.dim)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encode_chunk_two_chunks_match(cfg, params, tparams, impl):
    """Two chunks (8 then 12 rows) through the ring-cache encoder: the
    outputs and both rings equal JAX's with the same attn_impl."""
    jcfg, tcfg = _jcfg(cfg, impl), _tcfg(impl)
    rng = np.random.default_rng(0)
    jcache = jenc.EncKVCache.create(jcfg.encoder, jcfg.enc_kvdtype, 64)
    tcache = tenc.EncKVCache.create(tcfg.encoder, tcfg.enc_kvdtype, 64)
    pos = 0
    for t in (8, 12):
        x = rng.standard_normal((t, cfg.encoder.dim)).astype(np.float32)
        jy, jcache = jenc.encode_chunk(params["encoder"], jcfg,
                                       jnp.asarray(x), jcache,
                                       jnp.int32(pos))
        ty, tcache = tenc.encode_chunk(tparams["encoder"], tcfg,
                                       torch.from_numpy(x)[None], tcache, pos)
        np.testing.assert_allclose(_np(ty[0]), _np(jy), **TOL)
        pos += t
    np.testing.assert_allclose(_np(tcache.k[0]), _np(jcache.k), **TOL)
    np.testing.assert_allclose(_np(tcache.v[0]), _np(jcache.v), **TOL)


def test_fused_encode_chunk_matches(cfg, params, tparams):
    """Two quantum-aligned chunks (16, then 24 mel frames) through the
    fused audio step: adapter rows, tails and rings equal JAX's."""
    rng = np.random.default_rng(4)
    jtails = jfused.ConvTails.create(cfg)
    ttails = tfused.ConvTails.create(tiny_config())
    jcache = jenc.EncKVCache.create(cfg.encoder, cfg.enc_kvdtype, 64)
    tcache = tenc.EncKVCache.create(cfg.encoder, torch.float32, 64)
    pos = 0
    for q in (16, 24):
        mel = rng.standard_normal((q, cfg.encoder.n_mel)).astype(np.float32)
        jrows, jtails, jcache = jfused.fused_encode_chunk(
            params["encoder"], params["adapter"], cfg, jnp.asarray(mel),
            jtails, jcache, jnp.int32(pos))
        trows, ttails, tcache = tfused.fused_encode_chunk(
            tparams["encoder"], tparams["adapter"], tiny_config(),
            torch.from_numpy(mel)[None], ttails, tcache,
            torch.tensor([pos], dtype=torch.int32))
        assert trows.shape == (1, q // 8, cfg.decoder.dim)
        np.testing.assert_allclose(_np(trows[0]), _np(jrows), **TOL)
        np.testing.assert_allclose(_np(ttails.mel_tail[0]),
                                   _np(jtails.mel_tail), **TOL)
        np.testing.assert_allclose(_np(ttails.c0_tail[0]),
                                   _np(jtails.c0_tail), **TOL)
        pos += q // 2
    np.testing.assert_allclose(_np(tcache.k[0]), _np(jcache.k), **TOL)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfused.fused_encode_chunk(
            tparams["encoder"], tparams["adapter"], tiny_config(),
            torch.zeros((1, 12, cfg.encoder.n_mel)), ttails, tcache,
            torch.tensor([pos], dtype=torch.int32))


def test_engine_sizing_matches(cfg, params, tparams, tiny_tokenizer, ttok):
    """Encoder ring sizing, its refusal, the fused buckets, fused_sizes and
    burst_size equal the JAX engine's."""
    import voxtral_tpu.config as jconf

    from voxtral_tpu_torch.config import full_config

    for jc, tc, buckets, ring in (
            (cfg, tiny_config(), (16, 4, 1), 64),
            (jconf.tiny_config(enc_kv_ring=2048, enc_window=750),
             tiny_config(enc_kv_ring=2048, enc_window=750), (64, 16, 4, 1),
             None)):
        je = jeng.VoxtralEngine(jc, params, buckets=buckets,
                                enc_kv_ring=ring, dec_kv_ring=64)
        te = teng.VoxtralEngine(tc, tparams, buckets=buckets,
                                enc_kv_ring=ring, dec_kv_ring=64)
        assert te.enc_kv_ring == je.enc_kv_ring
        assert te.fused_buckets == je.fused_buckets
        for n in (0, 8, 200, 544, 1600, 5000):
            assert te.fused_sizes(n) == je.fused_sizes(n)
        for n in (1, 25, 31, 32, 100):
            assert te.burst_size(n) == je.burst_size(n)
    # the CLI's sizing at full width: 1024 slots, chunks of <= 548 frames
    assert te.enc_kv_ring == 1024 and full_config().encoder.window == 750
    assert max(te.fused_sizes(5000)) <= 548
    with pytest.raises(ValueError, match="encoder ring"):
        teng.VoxtralEngine(tiny_config(), tparams, buckets=(64, 16, 4, 1),
                           dec_kv_ring=64)
    led = te.memory_ledger()
    assert led["enc_cache_bytes_per_stream"] == 2 * 2 * 4 * 1024 * 4 * 4
    assert led["params_total"] > 0


# --- VoxStream end to end ---------------------------------------------------

AUDIO = make_audio(2.2, seed=13)
FEEDS = {"whole": (None, None), "ragged": ([1600, 2000, 400], None),
         "fast": ([8000], 0.1)}


def _run(stream_cls, engine, feed, audio=AUDIO, alt=None):
    sizes, interval = FEEDS[feed]
    s = stream_cls(engine)
    s.record_ids = True
    if interval is not None:
        s.set_processing_interval(interval)
    if alt is not None:
        s.set_alt(4, alt)
    if sizes is None:
        s.feed(audio)
    else:
        i = j = 0
        while i < len(audio):
            n = sizes[j % len(sizes)]
            s.feed(audio[i: i + n])
            i, j = i + n, j + 1
    s.finish()
    out = s.get_alt() if alt is not None else s.get()
    return s.generated_ids, out, s


_JAX_RUNS: dict = {}


def _jax_engine(params, tok, fused):
    return jeng.VoxtralEngine(
        jeng_cfg(), params, tokenizer=tok, buckets=(16, 4, 1),
        enc_kv_ring=64, dec_kv_ring=64, fused_streaming=fused)


def jeng_cfg():
    from voxtral_tpu.config import tiny_config as jt

    return jt()


def _jax_run(params, tok, fused, feed, alt=None):
    """The JAX VoxStream's (ids, tokens), computed once per module."""
    key = (fused, feed, alt)
    if key not in _JAX_RUNS:
        ids, out, _ = _run(jstream.VoxStream, _jax_engine(params, tok, fused),
                           feed, alt=alt)
        _JAX_RUNS[key] = (ids, out)
    return _JAX_RUNS[key]


def _port_engine(tparams, ttok, fused, impl="auto"):
    return teng.VoxtralEngine(_tcfg(impl), tparams, tokenizer=ttok,
                              buckets=(16, 4, 1), enc_kv_ring=64,
                              dec_kv_ring=64, fused_streaming=fused)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("feed", list(FEEDS))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "bucketed"])
def test_voxstream_equals_jax(params, tiny_tokenizer, tparams, ttok, fused,
                              feed, impl):
    """Ids and token strings equal JAX's (whose "auto" is the xla path) for
    every chunking; the port's "auto" is the flash-encode path (its plain
    version on the CPU)."""
    want_ids, want = _jax_run(params, tiny_tokenizer, fused, feed)
    ids, got, s = _run(tstream.VoxStream,
                       _port_engine(tparams, ttok, fused, impl), feed)
    assert len(want_ids) > 20
    assert ids == want_ids
    assert got == want
    assert s.n_enc_chunk_calls > 0


def test_fused_buckets_path_equals_jax(params, tiny_tokenizer, tparams, ttok):
    """Fused buckets (16, 8), as tests/test_stream.py sets them, with odd
    feed sizes: the unaligned-remainder deferral, equal ids."""
    audio = make_audio(2.3, seed=71)
    je = _jax_engine(params, tiny_tokenizer, True)
    te = _port_engine(tparams, ttok, True)
    je.fused_buckets = te.fused_buckets = (16, 8)
    FEEDS["odd"] = ([1601, 1999, 403], None)
    try:
        want = _run(jstream.VoxStream, je, "odd", audio=audio)[0]
        got = _run(tstream.VoxStream, te, "odd", audio=audio)[0]
    finally:
        del FEEDS["odd"]
    assert got == want and len(got) > 20


def test_alternatives_equal_jax(params, tiny_tokenizer, tparams, ttok):
    """--alt style: set_alt(4, 0.5), get_alt() groups equal JAX's."""
    want_ids, want = _jax_run(params, tiny_tokenizer, True, "ragged", alt=0.5)
    ids, got, _ = _run(tstream.VoxStream, _port_engine(tparams, ttok, True),
                       "ragged", alt=0.5)
    assert ids == want_ids
    assert got == want
    assert any(len([a for a in g if a]) > 1 for g in got)


def test_monitor_symbols_and_stats_equal_jax(params, tiny_tokenizer, tparams,
                                             ttok, monkeypatch):
    """The --monitor symbol stream and the print_stats lines' counts match
    JAX's (a decode burst slower than 40 ms/step takes the slow variant of
    its symbol, so those are folded into the fast ones)."""
    fold = str.maketrans({"▸": "▪", "✘": "✗", "▹": "▫"})

    def symbols(mod, stream_cls, engine):
        monkeypatch.setattr(mod, "monitor", True)
        monkeypatch.setattr(mod, "verbose", 1)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            _, _, s = _run(stream_cls, engine, "ragged")
            s.print_stats()
        text = err.getvalue()
        lines = text.splitlines()
        stats = [ln.split("(")[0] for ln in lines if ln.startswith(
            ("Encoder:", "Decoder:"))]
        return text.split("Encoder:")[0].translate(fold), stats

    want = symbols(jstream, jstream.VoxStream,
                   _jax_engine(params, tiny_tokenizer, True))
    got = symbols(tstream, tstream.VoxStream,
                  _port_engine(tparams, ttok, True))
    assert got == want
    assert "▶" in got[0] and "·" in got[0]


def test_transcribe_helpers_equal_jax(params, tiny_tokenizer, tparams, ttok):
    audio = make_audio(1.8, seed=5)
    je = _jax_engine(params, tiny_tokenizer, True)
    te = _port_engine(tparams, ttok, True)
    assert tstream.transcribe_tokens(te, audio) == \
        jstream.transcribe_tokens(je, audio)
    assert tstream.transcribe_samples(te, audio) == \
        jstream.transcribe_samples(je, audio)


def test_flush_then_continue_equals_jax(params, tiny_tokenizer, tparams,
                                        ttok):
    """flush() at a token boundary emits the delayed tokens and leaves the
    stream open; before and after the flush the tokens equal JAX's."""
    audio = make_audio(2.4, seed=17)
    cut = (len(audio) // 2 // 1280) * 1280

    def run(stream_cls, engine):
        s = stream_cls(engine)
        s.feed(audio[:cut])
        s.flush()
        early = list(s.get())
        assert not s.finished
        s.feed(audio[cut:])
        s.finish()
        return early, s.get()

    early, late = run(tstream.VoxStream, _port_engine(tparams, ttok, True))
    assert (early, late) == run(jstream.VoxStream,
                                _jax_engine(params, tiny_tokenizer, True))
    assert len(early) > 0


# --- watchdogs and restarts (tests/test_stream.py's cases) ------------------

@pytest.fixture
def tengine(tparams, ttok):
    return _port_engine(tparams, ttok, True)


def test_restart_counters(tengine):
    s = tstream.VoxStream(tengine)
    s.set_continuous(True)
    s.decoder_started = True
    s.dec_pos = 2001  # > STREAM_MAX_DECODE_KV
    s.total_adapter = 10
    s._maybe_restart()
    # KV overflow forces a full reset
    assert s.dec_pos == 0 and not s.decoder_started
    assert s.total_adapter == 0 and s.enc_pos == 0 and not s._conv_init

    s2 = tstream.VoxStream(tengine)
    s2.set_continuous(True)
    s2.eos_seen = True
    s2.text_since_restart = True
    s2.enc_pos = 5
    s2._maybe_restart()
    # EOS restart is decoder-only
    assert not s2.decoder_started and s2.enc_pos == 5
    assert s2.empty_restarts == 0

    s3 = tstream.VoxStream(tengine)
    s3.set_continuous(True)
    s3.eos_seen = True
    s3.text_since_restart = False
    s3._maybe_restart()
    assert s3.empty_restarts == 1
    s3.eos_seen = True
    s3.text_since_restart = False
    s3.enc_pos = 7
    s3._maybe_restart()
    # the second consecutive empty restart escalates to a full reset
    assert s3.enc_pos == 0 and s3.empty_restarts == 0


@pytest.mark.parametrize("watchdog", ["no_decode", "non_text_streak"])
def test_watchdogs_full_and_decoder_resets(tengine, watchdog):
    s = tstream.VoxStream(tengine)
    s.set_continuous(True)
    s.decoder_started = True
    s.enc_pos = 3
    s.text_since_restart = False
    if watchdog == "no_decode":
        s.real_samples_fed = 16000 * 25
        s.last_decode_sample = 0
    else:
        s.nontext_streak = 64          # STREAM_MAX_NON_TEXT_STREAK
        s.last_decode_sample = s.real_samples_fed = 100
    s._maybe_restart()
    # both are restart types >= 2: a full reset (voxtral.c:1161-1163)
    assert not s.decoder_started and s.enc_pos == 0
    assert s.nontext_streak == 0
    assert s.last_decode_sample == s.real_samples_fed


def test_continuous_ring_overflow_restarts_not_raises(tparams, ttok):
    """A live stream whose backlog would cross the decoder ring restarts
    (the KV-overflow full reset); a non-continuous one raises."""
    cfg = tiny_config(dec_window=96, dec_kv_ring=64)
    eng = teng.VoxtralEngine(cfg, tparams, tokenizer=ttok,
                             buckets=(16, 4, 1), enc_kv_ring=64,
                             dec_kv_ring=64)
    audio = make_audio(8.0, seed=23)
    s = tstream.VoxStream(eng)
    s.set_continuous(True)
    s.set_processing_interval(6.0)
    s.feed(audio)
    assert s._ring_overflow is False     # cleared by the reset
    assert s.dec_pos <= eng.dec_kv_ring
    assert not s.decoder_started or s.dec_pos < 64
    s2 = tstream.VoxStream(eng)
    s2.set_processing_interval(6.0)
    with pytest.raises(RuntimeError, match="KV ring"):
        s2.feed(audio)


def test_stream_needs_a_tokenizer(tparams):
    eng = teng.VoxtralEngine(tiny_config(), tparams, buckets=(16, 4, 1),
                             dec_kv_ring=64)
    with pytest.raises(ValueError, match="tokenizer"):
        tstream.VoxStream(eng)


def test_warmup_runs_every_bucket_on_cpu(tengine):
    lines = []
    secs = tengine.warmup(n_alt=4, progress=lines.append, interval_s=0.5)
    assert secs >= 0
    assert [ln.split(" (")[0] for ln in lines] == [
        "warmup bucket 16", "warmup bucket 4", "warmup bucket 1",
        "warmup prefill", "warmup fused 48", "warmup fused 56",
        "warmup burst 6", "warmup burst 7"]
