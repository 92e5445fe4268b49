"""The port's Jacobi decoding (models/jacobi.py) and the engine's decode_mode
policy against the JAX package on tiny_config() float32 with the same
weights: tokens and iteration counts equal to JAX's, the KV ring within
1e-5, tokens equal to the port's own sequential burst, alts, continuation
across windows at ring wraparound, the "auto" choice by burst length and
stream count, offline "auto" equal to sequential, and a VoxStream on a
Jacobi engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.config import TOKEN_STREAMING_PAD
from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models.jacobi import decode_burst_jacobi as jjacobi
from voxtral_tpu.runtime import engine as jeng
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models.jacobi import decode_burst_jacobi
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)


@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.fixture(scope="module")
def ttok():
    return TekkenTokenizer([bytes([i]) for i in range(256)], 1000)


@pytest.fixture(scope="module")
def tengine(tparams, ttok):
    return teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok, **KW)


def _adapter(seed, t, dim):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, dim)) * 0.5).astype(np.float32)


def _port_jacobi(tengine, adapter, prev, cache, pos0, **kw):
    return decode_burst_jacobi(
        tengine.params["decoder"], tengine.cfg,
        torch.from_numpy(adapter)[None], prev, cache, pos0, tengine.ada(),
        **kw)


def _port_seq(tengine, adapter, prev, cache, pos0, **kw):
    return tdec.decode_burst(
        tengine.params["decoder"], tengine.cfg,
        torch.from_numpy(adapter)[None], torch.tensor([prev]), cache, pos0,
        tengine.ada(), **kw)


# the (t, window) cases of tests/test_jacobi.py
@pytest.mark.parametrize("t,window", [(8, 8), (16, 4), (32, 8), (21, 7)])
def test_jacobi_equals_jax_and_sequential(engine, cfg, tengine, t, window):
    """Tokens and iteration count equal JAX's decode_burst_jacobi, the ring
    within 1e-5 of JAX's; tokens and ring equal the port's sequential
    burst."""
    adapter = _adapter(t * 31 + window, t, cfg.decoder.dim)
    jcache = engine.new_dec_cache()
    jt, _, _, _, jcache, jit = jjacobi(
        engine.params["decoder"], cfg, jnp.asarray(adapter),
        jnp.int32(TOKEN_STREAMING_PAD), jcache, jnp.int32(0), engine.ada(),
        window=window)
    tcache = tengine.new_dec_cache()
    tt, ai, ap, bp, tcache, tit = _port_jacobi(
        tengine, adapter, TOKEN_STREAMING_PAD, tcache, 0, window=window)
    assert tt.shape == (1, t) and ai.shape == (1, t, 0) and bp.shape == (1, t)
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
    assert tit == int(jit) >= 1
    np.testing.assert_allclose(tcache.k[0].numpy(), np.asarray(jcache.k),
                               **TOL)
    np.testing.assert_allclose(tcache.v[0].numpy(), np.asarray(jcache.v),
                               **TOL)

    scache = tengine.new_dec_cache()
    st, _, _, _, scache = _port_seq(tengine, adapter, TOKEN_STREAMING_PAD,
                                    scache, 0)
    torch.testing.assert_close(tt, st, rtol=0, atol=0)
    torch.testing.assert_close(tcache.k, scache.k, **TOL)
    torch.testing.assert_close(tcache.v, scache.v, **TOL)


def test_jacobi_alts_equal_jax_and_sequential(engine, cfg, tengine):
    """n_alt=3: ids, alt ids equal JAX's Jacobi and the port's sequential
    burst; probabilities within 1e-5; the alt pass counts as an
    iteration, as in JAX."""
    t = 12
    adapter = _adapter(5, t, cfg.decoder.dim)
    jt, jai, jap, jbp, _, jit = jjacobi(
        engine.params["decoder"], cfg, jnp.asarray(adapter),
        jnp.int32(TOKEN_STREAMING_PAD), engine.new_dec_cache(), jnp.int32(0),
        engine.ada(), n_alt=3, window=6)
    tt, tai, tap, tbp, _, tit = _port_jacobi(
        tengine, adapter, TOKEN_STREAMING_PAD, tengine.new_dec_cache(), 0,
        n_alt=3, window=6)
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tai[0].numpy(), np.asarray(jai))
    np.testing.assert_allclose(tap[0].numpy(), np.asarray(jap), **TOL)
    np.testing.assert_allclose(tbp[0].numpy(), np.asarray(jbp), **TOL)
    assert tit == int(jit)
    st, sai, sap, sbp, _ = _port_seq(tengine, adapter, TOKEN_STREAMING_PAD,
                                     tengine.new_dec_cache(), 0, n_alt=3)
    torch.testing.assert_close(tt, st, rtol=0, atol=0)
    torch.testing.assert_close(tai, sai, rtol=0, atol=0)
    torch.testing.assert_close(tap, sap, **TOL)
    torch.testing.assert_close(tbp, sbp, **TOL)


def test_jacobi_continues_across_windows(engine, cfg, tengine):
    """Windows chain through the previous token and the KV ring like one
    long burst, across the ring's wraparound (ring 64, 40 positions of
    context, 48 more): equal to the port's sequential burst and to JAX's
    Jacobi, iterations included."""
    warm = _adapter(9, 40, cfg.decoder.dim)
    adapter = (np.random.default_rng(10).standard_normal(
        (48, cfg.decoder.dim)) * 0.5).astype(np.float32)
    seq, jac = tengine.new_dec_cache(), tengine.new_dec_cache()
    tw, _, _, _, _ = _port_seq(tengine, warm, TOKEN_STREAMING_PAD, seq, 0)
    _port_seq(tengine, warm, TOKEN_STREAMING_PAD, jac, 0)
    prev = int(tw[0, -1])
    st, _, _, _, _ = _port_seq(tengine, adapter, prev, seq, 40)
    tt, _, _, _, _, tit = _port_jacobi(tengine, adapter, prev, jac, 40,
                                       window=16)
    torch.testing.assert_close(tt, st, rtol=0, atol=0)
    torch.testing.assert_close(jac.k, seq.k, **TOL)

    jcache = engine.new_dec_cache()
    jw, _, _, _, jcache = jdec.decode_burst(
        engine.params["decoder"], cfg, jnp.asarray(warm),
        jnp.int32(TOKEN_STREAMING_PAD), jcache, jnp.int32(0), engine.ada())
    assert int(np.asarray(jw)[-1]) == prev
    jt, _, _, _, _, jit = jjacobi(
        engine.params["decoder"], cfg, jnp.asarray(adapter),
        jnp.int32(prev), jcache, jnp.int32(40), engine.ada(), window=16)
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
    assert tit == int(jit)


def test_jacobi_refuses_other_shapes(tengine):
    cfg = tengine.cfg
    z = torch.zeros((2, 8, cfg.decoder.dim))
    with pytest.raises(ValueError, match="one stream"):
        decode_burst_jacobi(tengine.params["decoder"], cfg, z, 0,
                            tengine.new_dec_cache(2), 0, tengine.ada())
    with pytest.raises(ValueError, match="multiple of the window"):
        decode_burst_jacobi(tengine.params["decoder"], cfg, z[:1, :7], 0,
                            tengine.new_dec_cache(), 0, tengine.ada(),
                            window=4)


def test_auto_mode_selects_by_burst_length(cfg, params, tiny_tokenizer,
                                           tparams, ttok):
    """decode_mode="auto": window-sized-or-larger bursts take Jacobi
    (jacobi_iters grows, as in the JAX engine), shorter ones sequential;
    both equal a sequential engine and the JAX auto engine."""
    rng = np.random.default_rng(17)
    kw = dict(KW, jacobi_window=8)
    eng_a = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                               decode_mode="auto", **kw)
    eng_s = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                               decode_mode="sequential", **kw)
    jeng_a = jeng.VoxtralEngine(cfg, params, tokenizer=tiny_tokenizer,
                                decode_mode="auto", **kw)
    ca, cs, cj = eng_a.new_dec_cache(), eng_s.new_dec_cache(), \
        jeng_a.new_dec_cache()
    prev, pos = TOKEN_STREAMING_PAD, 0
    for t, n_jacobi in ((4, 0), (16, 1), (12, 2), (5, 2)):
        chunk = (rng.standard_normal((t, cfg.decoder.dim)) * 0.5).astype(
            np.float32)
        ta, _, _, _, ca = eng_a.decode_burst(chunk[None], prev, ca, pos)
        ts, _, _, _, cs = eng_s.decode_burst(chunk[None], prev, cs, pos)
        tj, _, _, _, cj = jeng_a.decode_burst(chunk, prev, cj, pos)
        torch.testing.assert_close(ta, ts, rtol=0, atol=0)
        np.testing.assert_array_equal(ta[0].numpy(), np.asarray(tj))
        assert len(eng_a.jacobi_iters) == len(jeng_a.jacobi_iters) == n_jacobi
        prev, pos = int(ta[0, -1]), pos + t
    assert eng_a.jacobi_iters == [int(i) for i in jeng_a.jacobi_iters]
    assert eng_a.jacobi_steps == 16 + 12          # the 12-row burst: W=6
    assert eng_s.jacobi_iters == [] and eng_s.jacobi_steps == 0


def test_jacobi_mode_at_b_gt_1(tparams, ttok):
    """At B > 1, "auto" decodes sequentially and "jacobi" raises."""
    cfg = tiny_config()
    chunk = torch.randn((2, 16, cfg.decoder.dim),
                        generator=torch.Generator().manual_seed(3)) * 0.5
    prev = torch.full((2,), TOKEN_STREAMING_PAD, dtype=torch.int32)
    seq = teng.VoxtralEngine(cfg, tparams, tokenizer=ttok, **KW)
    auto = teng.VoxtralEngine(cfg, tparams, tokenizer=ttok,
                              decode_mode="auto", jacobi_window=8, **KW)
    want = seq.decode_burst(chunk, prev, seq.new_dec_cache(2), 0)[0]
    got = auto.decode_burst(chunk, prev, auto.new_dec_cache(2), 0)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert auto.jacobi_iters == []
    jac = teng.VoxtralEngine(cfg, tparams, tokenizer=ttok,
                             decode_mode="jacobi", jacobi_window=8, **KW)
    with pytest.raises(ValueError, match="one stream"):
        jac.decode_burst(chunk, prev, jac.new_dec_cache(2), 0)
    with pytest.raises(ValueError, match="decode_mode"):
        teng.VoxtralEngine(cfg, tparams, decode_mode="lockstep", **KW)


def test_offline_auto_equals_sequential_and_jax(engine, cfg, params,
                                                tiny_tokenizer, tparams,
                                                ttok):
    """The offline bulk path under "auto" gives the ids of a sequential
    engine and of the JAX auto engine, with Jacobi bursts taken."""
    from voxtral_tpu.runtime.offline import transcribe_offline_ids as joff
    from voxtral_tpu_torch.runtime.offline import transcribe_offline_ids

    audio = make_audio(1.6, seed=41)
    kw = dict(KW, dec_kv_ring=128, jacobi_window=8)
    ids_s = transcribe_offline_ids(teng.VoxtralEngine(
        tiny_config(), tparams, tokenizer=ttok, decode_mode="sequential",
        **kw), audio)
    eng_a = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                               decode_mode="auto", **kw)
    stats = {}
    ids_a = transcribe_offline_ids(eng_a, audio, timings=stats)
    want = joff(jeng.VoxtralEngine(cfg, params, tokenizer=tiny_tokenizer,
                                   decode_mode="auto", **kw), audio)
    assert len(ids_s) > 10
    assert ids_a == ids_s == want
    assert eng_a.jacobi_steps > 0 and len(eng_a.jacobi_iters) > 0
    assert stats["decode_steps"] >= eng_a.jacobi_steps


def test_stream_with_jacobi_engine(tparams, ttok, tengine):
    """A VoxStream on a "jacobi" engine gives the tokens of one on a
    sequential engine (the JAX package's test_stream_with_jacobi_engine);
    a warm-up under "auto" runs the 16-bucket as a Jacobi burst."""
    from voxtral_tpu_torch.runtime.stream import VoxStream

    audio = make_audio(2.0, seed=33)
    ref = VoxStream(tengine)
    ref.feed(audio)
    ref.finish()
    eng_j = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                               decode_mode="jacobi", jacobi_window=8, **KW)
    s = VoxStream(eng_j)
    s.feed(audio)
    s.finish()
    assert s.get() == ref.get()
    assert len(eng_j.jacobi_iters) > 0
    eng_a = teng.VoxtralEngine(tiny_config(), tparams, tokenizer=ttok,
                               decode_mode="auto", jacobi_window=16, **KW)
    eng_a.warmup()
    assert len(eng_a.jacobi_iters) == 1 and eng_a.jacobi_steps == 16


def test_auto_decodes_sequentially_where_a_window_would_lose_keys(
        params, tiny_tokenizer, tparams, ttok):
    """ROADMAP.md section 3: a Jacobi window writes all W rows before its
    queries attend, so on a ring shorter than the attention window + W - 1
    that the burst wraps, late rows overwrite keys early queries read (in
    the JAX package too).  The port's "auto" decodes such bursts
    sequentially: on tiny_config(enc_kv_ring=128) (decoder window 48, ring
    64, W 64) with an 8 s clip its ids equal the JAX package's sequential
    ids exactly in f32, where the JAX package's "auto" ids do not."""
    from voxtral_tpu.config import tiny_config as jax_tiny
    from voxtral_tpu.runtime.offline import transcribe_offline_ids as joff
    from voxtral_tpu_torch.runtime.offline import transcribe_offline_ids

    audio = make_audio(8.0, seed=2)
    kw = dict(buckets=(64, 16, 4, 1), enc_kv_ring=128)
    jcfg = jax_tiny(enc_kv_ring=128)
    want = joff(jeng.VoxtralEngine(jcfg, params, tokenizer=tiny_tokenizer,
                                   decode_mode="sequential", **kw), audio)
    jauto = joff(jeng.VoxtralEngine(jcfg, params, tokenizer=tiny_tokenizer,
                                    decode_mode="auto", **kw), audio)
    eng = teng.VoxtralEngine(tiny_config(enc_kv_ring=128), tparams,
                             tokenizer=ttok, decode_mode="auto", **kw)
    assert eng.dec_kv_ring < eng.cfg.decoder.window + eng.jacobi_window - 1
    got = transcribe_offline_ids(eng, audio)
    assert len(want) > 64 and got == want
    assert eng.jacobi_iters == []
    assert jauto != want          # the reference's fault, kept by "jacobi"
