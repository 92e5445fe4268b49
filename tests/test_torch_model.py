"""Model layer of the port against the JAX package on tiny_config() float32
with the same weights: bulk encoder + adapter rows, ada scales, prompt
prefill caches, final logits and greedy decode bursts (tokens exactly
equal, for attn_impl "xla" and "flash")."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models.bulk_encode import bulk_encode_clip as jax_bulk
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models.bulk_encode import bulk_encode_clip
from voxtral_tpu_torch.models.params import from_jax_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


def _tcfg(impl="auto"):
    c = tiny_config()
    return c.replace(decoder=dataclasses.replace(c.decoder, attn_impl=impl))


def _jcfg(cfg, impl):
    return cfg.replace(decoder=dataclasses.replace(cfg.decoder,
                                                   attn_impl=impl))


def test_bulk_encode_rows_match(cfg, params, tparams):
    rng = np.random.default_rng(11)
    mel = rng.standard_normal((2, 96, cfg.encoder.n_mel)).astype(np.float32)
    got = bulk_encode_clip(tparams["encoder"], tparams["adapter"], _tcfg(),
                           torch.from_numpy(mel))
    assert got.shape == (2, 12, cfg.decoder.dim) and got.dtype == torch.float32
    for b in range(2):
        want = jax_bulk(params["encoder"], params["adapter"], cfg,
                        jnp.asarray(mel[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_ada_scales_and_time_embedding(cfg, params, tparams):
    np.testing.assert_allclose(
        tdec.time_embedding(6.0, 24).numpy(),
        np.asarray(jdec.time_embedding(6.0, 24)), atol=1e-6)
    np.testing.assert_allclose(
        tdec.ada_scales(tparams["decoder"], _tcfg()).numpy(),
        np.asarray(jdec.ada_scales(params["decoder"], cfg)), atol=1e-6)


def _prompt(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (cfg.prompt_len - 1, cfg.decoder.dim)).astype(np.float32)


@pytest.mark.parametrize("cap", [64, 48])
def test_prefill_caches_match(cfg, params, tparams, cap):
    emb = _prompt(cfg)
    jada = jdec.ada_scales(params["decoder"], cfg)
    jc = jdec.prefill(params["decoder"], cfg, jnp.asarray(emb),
                      jdec.KVCache.create(cfg.decoder, jnp.float32, cap),
                      jnp.int32(0), jada)
    tcfg = _tcfg()
    tc = tdec.KVCache.create(tcfg.decoder, torch.float32, cap)
    out = tdec.prefill(tparams["decoder"], tcfg, torch.from_numpy(emb)[None],
                       tc, 0, tdec.ada_scales(tparams["decoder"], tcfg))
    assert out is tc                                   # updated in place
    np.testing.assert_allclose(tc.k[0].numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_allclose(tc.v[0].numpy(), np.asarray(jc.v), atol=1e-5)


def test_final_logits_and_alts(cfg, params, tparams):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, cfg.decoder.dim)).astype(np.float32)
    want = np.asarray(jdec.final_logits(params["decoder"], cfg,
                                        jnp.asarray(x)))
    got = tdec.final_logits(tparams["decoder"], _tcfg(),
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # ties resolve to the first index in both
    lg = np.round(want, 1)
    lg[:, 1100:1110] = lg.max() + 1.0
    for row in range(3):
        jb, jp, ji, jpr = jdec._alts_from_logits(jnp.asarray(lg[row]), 4)
        tb, tp, ti, tpr = tdec._alts_from_logits(torch.from_numpy(lg[row:row + 1]), 4)
        assert int(tb[0]) == int(jb) == 1100
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
        np.testing.assert_allclose(tpr[0].numpy(), np.asarray(jpr), atol=1e-6)
        np.testing.assert_allclose(float(tp[0]), float(jp), atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_decode_burst_tokens_match(cfg, params, tparams, impl):
    """Prefill, then two bursts (the second continues the first) on a ring
    that wraps: tokens exactly equal, caches equal to f32 rounding."""
    cap, t1, t2 = 48, 6, 17
    jcfg, tcfg = _jcfg(cfg, impl), _tcfg(impl)
    rng = np.random.default_rng(9)
    emb = _prompt(cfg)
    pl = cfg.prompt_len - 1
    chunk = rng.standard_normal((t1 + t2, cfg.decoder.dim)).astype(np.float32)
    chunk *= 3.0   # audio rows dominate the token embeddings, as in use

    jada = jdec.ada_scales(params["decoder"], jcfg)
    jc = jdec.prefill(params["decoder"], jcfg, jnp.asarray(emb),
                      jdec.KVCache.create(cfg.decoder, jnp.float32, cap),
                      jnp.int32(0), jada)
    tada = tdec.ada_scales(tparams["decoder"], tcfg)
    tc = tdec.KVCache.create(tcfg.decoder, torch.float32, cap)
    tdec.prefill(tparams["decoder"], tcfg, torch.from_numpy(emb)[None], tc, 0,
                 tada)

    jprev, tprev = jnp.int32(32), torch.tensor([32])
    pos = pl
    for t in (t1, t2):
        jt, _, _, _, jc = jdec.decode_burst(
            params["decoder"], jcfg, jnp.asarray(chunk[pos - pl: pos - pl + t]),
            jprev, jc, jnp.int32(pos), jada)
        tt, _, _, _, tc = tdec.decode_burst(
            tparams["decoder"], tcfg,
            torch.from_numpy(chunk[pos - pl: pos - pl + t])[None], tprev, tc,
            pos, tada)
        assert tt.shape == (1, t) and tt.dtype == torch.int32
        assert tt[0].tolist() == np.asarray(jt).tolist()
        jprev, tprev = jt[-1], tt[:, -1]
        pos += t
    assert pos > cap   # the ring wrapped
    np.testing.assert_allclose(tc.k[0].numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_allclose(tc.v[0].numpy(), np.asarray(jc.v), atol=1e-5)


def test_decode_burst_alts_match(cfg, params, tparams):
    emb = _prompt(cfg, seed=8)
    chunk = np.random.default_rng(3).standard_normal(
        (5, cfg.decoder.dim)).astype(np.float32)
    jada = jdec.ada_scales(params["decoder"], cfg)
    jc = jdec.prefill(params["decoder"], cfg, jnp.asarray(emb),
                      jdec.KVCache.create(cfg.decoder, jnp.float32, 64),
                      jnp.int32(0), jada)
    jout = jdec.decode_burst(params["decoder"], cfg, jnp.asarray(chunk),
                             jnp.int32(32), jc, jnp.int32(cfg.prompt_len - 1),
                             jada, n_alt=4)
    tcfg = _tcfg()
    tada = tdec.ada_scales(tparams["decoder"], tcfg)
    tc = tdec.KVCache.create(tcfg.decoder, torch.float32, 64)
    tdec.prefill(tparams["decoder"], tcfg, torch.from_numpy(emb)[None], tc, 0,
                 tada)
    tout = tdec.decode_burst(tparams["decoder"], tcfg,
                             torch.from_numpy(chunk)[None], torch.tensor([32]),
                             tc, cfg.prompt_len - 1, tada, n_alt=4)
    for i in (0, 1):   # tokens, alt ids
        np.testing.assert_array_equal(tout[i][0].numpy(), np.asarray(jout[i]))
    for i in (2, 3):   # alt probs, best probs
        np.testing.assert_allclose(tout[i][0].numpy(), np.asarray(jout[i]),
                                   atol=1e-6)
