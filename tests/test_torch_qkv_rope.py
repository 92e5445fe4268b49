"""The attention layers' qkv epilogue on the CPU: ops/rope.py:qkv_rope
(its plain version, which CPU tensors take) against the sequence the
layers ran before it (the bias add, the q/k/v split, `apply_rope_interleaved`
on q and k, the casts), bit for bit; a CPU model of the kernel's indexing
(csrc/qkv_rope.cu: a thread's 8 columns, its table row and pairs) against
the plain version; and the decoder step and prefill, the streaming encoder
chunk and the bulk encoder of tiny_config() through the new call sites
against the JAX package, one call a layer.  The kernel itself is checked
on the card (tests/test_torch_cuda.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models import encoder as jenc
from voxtral_tpu.models.bulk_encode import bulk_encode_clip as jax_bulk
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import bulk_encode, decoder, encoder
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops import rope

torch.set_num_threads(1)


def _heads(model: str, cfg=None):
    """(n_heads, n_kv_heads, head_dim) of the tiny encoder (MHA) or
    decoder (GQA)."""
    c = getattr(cfg or tiny_config(), model)
    return c.n_heads, c.n_kv_heads, c.head_dim


def _case(h, kh, d, bsz, t, bias, shared, seed):
    """Seeded qkv [B, T, W] f32, the tables (shared [T, D/2] or a row's own
    [B, T, D/2] at staggered positions) and a bias [W] or None."""
    gen = torch.Generator().manual_seed(seed)
    width = (h + 2 * kh) * d
    qkv = torch.randn((bsz, t, width), generator=gen) * 3.0
    if shared:
        pos = torch.arange(t, dtype=torch.int32)
    else:
        pos = (torch.tensor([0, 37, 500], dtype=torch.int32)[:bsz, None]
               + torch.arange(t, dtype=torch.int32))
    cos, sin = rope.rope_cos_sin(pos, d, 1e6)
    b = torch.randn((width,), generator=gen) * 0.1 if bias else None
    return qkv, cos, sin, b


def _old_sequence(qkv, cos, sin, h, kh, d, bias, q_dtype, kv_dtype):
    """The call sites' lines before qkv_rope (models/encoder.py,
    bulk_encode.py: `mm(...) + lp["bqkv"]`; decoder.py without a bias),
    the split, the two rope calls and the callers' casts."""
    bsz, t, _ = qkv.shape
    if bias is not None:
        qkv = qkv + bias
    q = qkv[..., : h * d].reshape(bsz, t, h, d)
    k = qkv[..., h * d: (h + kh) * d].reshape(bsz, t, kh, d)
    v = qkv[..., (h + kh) * d:].reshape(bsz, t, kh, d)
    q = rope.apply_rope_interleaved(q, cos, sin)
    k = rope.apply_rope_interleaved(k, cos, sin)
    return q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("shared", [False, True], ids=["per_row", "shared"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("model", ["encoder", "decoder"])
def test_qkv_rope_plain_is_the_old_sequence(model, bias, dtype, shared, t):
    """Bit-equal to the old sequence with q, k and v in the asked dtypes
    (q and k rotated); v without bias in f32 is a view of qkv."""
    h, kh, d = _heads(model)
    qkv, cos, sin, b = _case(h, kh, d, 3, t, bias, shared, seed=t + 7 * bias)
    dt = getattr(torch, dtype)
    got = rope.qkv_rope(qkv, cos, sin, n_heads=h, n_kv_heads=kh, head_dim=d,
                        bias=b, q_dtype=dt, kv_dtype=dt)
    want = _old_sequence(qkv, cos, sin, h, kh, d, b, dt, dt)
    for g, w, heads in zip(got, want, (h, kh, kh)):
        assert g.dtype == dt and g.shape == (3, t, heads, d)
        assert torch.equal(g, w)
    shares = got[2].untyped_storage().data_ptr() == \
        qkv.untyped_storage().data_ptr()
    assert shares == (b is None and dt == torch.float32)
    # mixed: q in bf16, k and v in f32 (the decoder's and ring encoder's)
    got = rope.qkv_rope(qkv, cos, sin, n_heads=h, n_kv_heads=kh, head_dim=d,
                        bias=b, q_dtype=torch.bfloat16,
                        kv_dtype=torch.float32)
    want = _old_sequence(qkv, cos, sin, h, kh, d, b, torch.bfloat16,
                         torch.float32)
    assert all(map(torch.equal, got, want))


# the kernel's thread: 8 consecutive columns of one row
V = 8


def kernel_model(qkv, cos, sin, h, kh, d, bias):
    """A numpy model of csrc/qkv_rope.cu's indexing, in f32: chunk g of a
    row of W / 8 chunks owns columns [8c, 8c + 8); it adds the bias, then
    (q and k columns) rotates its four pairs by table row (r % T when the
    table is shared, else r) at pairs ((col & (D - 1)) >> 1) .. + 4, each
    product, the difference and the sum rounded to f32 (numpy's own
    rounding); the q, k and v columns land at their own offsets."""
    bsz, t, width = qkv.shape
    rows = bsz * t
    q_dim, kv_dim = h * d, kh * d
    x = qkv.numpy().reshape(rows, width // V, V).copy()
    if bias is not None:
        x = x + bias.numpy().reshape(width // V, V)
    tab_c, tab_s = cos.numpy(), sin.numpy()
    shared = tab_c.ndim == 2
    tab_c, tab_s = tab_c.reshape(-1, d // 2), tab_s.reshape(-1, d // 2)
    out = np.empty_like(x)
    for c in range(width // V):
        col = c * V
        if col >= q_dim + kv_dim:
            out[:, c] = x[:, c]
            continue
        trow = np.arange(rows) % t if shared else np.arange(rows)
        p = (col & (d - 1)) >> 1
        cs, sn = tab_c[trow, p: p + 4], tab_s[trow, p: p + 4]
        x1, x2 = x[:, c, 0::2], x[:, c, 1::2]
        out[:, c, 0::2] = x1 * cs - x2 * sn
        out[:, c, 1::2] = x2 * cs + x1 * sn
    out = torch.from_numpy(out.reshape(bsz, t, width))
    return (out[..., :q_dim].reshape(bsz, t, h, d),
            out[..., q_dim: q_dim + kv_dim].reshape(bsz, t, kh, d),
            out[..., q_dim + kv_dim:].reshape(bsz, t, kh, d))


@pytest.mark.parametrize("h,kh,d,bias,shared", [
    (4, 4, 64, True, True),      # the encoder's head size (MHA), bulk tables
    (4, 4, 64, True, False),     # the ring encoder's
    (4, 2, 128, False, False),   # the decoder's (GQA)
    (2, 1, 128, True, True),
])
def test_kernel_indexing_model_equals_the_plain_version(h, kh, d, bias,
                                                        shared):
    """The kernel's chunk, table and pair indexing, modelled in numpy at
    the kernel's head dims, gives the plain version's f32 bits."""
    qkv, cos, sin, b = _case(h, kh, d, 3, 6, bias, shared, seed=d + h)
    got = kernel_model(qkv, cos, sin, h, kh, d, b)
    want = rope.qkv_rope_plain(qkv, cos, sin, n_heads=h, n_kv_heads=kh,
                               head_dim=d, bias=b, q_dtype=torch.float32,
                               kv_dtype=torch.float32)
    assert all(map(torch.equal, got, want))


# --- the call sites ---------------------------------------------------------

@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.fixture
def rope_calls(monkeypatch):
    """Records each qkv_rope call of the model: (module, heads, bias given,
    q_dtype, kv_dtype, table rank)."""
    calls = []

    def recorder(mod):
        def f(qkv, cos, sin, **kw):
            calls.append((mod.__name__.rsplit(".", 1)[-1], kw["n_heads"],
                          kw["n_kv_heads"], kw.get("bias") is not None,
                          kw["q_dtype"], kw["kv_dtype"], cos.dim()))
            return rope.qkv_rope(qkv, cos, sin, **kw)
        return f

    for mod in (decoder, encoder, bulk_encode):
        monkeypatch.setattr(mod, "qkv_rope", recorder(mod))
    return calls


def _cfg():
    c = tiny_config()
    return c.replace(decoder=dataclasses.replace(c.decoder, attn_impl="auto"))


def test_decode_steps_through_qkv_rope(cfg, params, tparams, rope_calls):
    """A prefill and a burst of 6 steps at tiny size: tokens equal to JAX's
    and the cache within f32 rounding; one qkv_rope call a layer of each
    pass, per-row tables, no bias, q in the compute dtype and k, v in f32
    (the row writes round them to the ring's dtype)."""
    cap, steps = 48, 6
    pl = cfg.prompt_len - 1
    rng = np.random.default_rng(19)
    emb = rng.standard_normal((pl, cfg.decoder.dim)).astype(np.float32)
    chunk = 3.0 * rng.standard_normal((steps, cfg.decoder.dim)).astype(
        np.float32)
    jada = jdec.ada_scales(params["decoder"], cfg)
    jc = jdec.prefill(params["decoder"], cfg, jnp.asarray(emb),
                      jdec.KVCache.create(cfg.decoder, jnp.float32, cap),
                      jnp.int32(0), jada)
    jt, _, _, _, jc = jdec.decode_burst(params["decoder"], cfg,
                                        jnp.asarray(chunk), jnp.int32(32), jc,
                                        jnp.int32(pl), jada)
    tcfg = _cfg()
    tada = decoder.ada_scales(tparams["decoder"], tcfg)
    tc = decoder.KVCache.create(tcfg.decoder, torch.float32, cap)
    decoder.prefill(tparams["decoder"], tcfg, torch.from_numpy(emb)[None], tc,
                    0, tada)
    tt, _, _, _, tc = decoder.decode_burst(
        tparams["decoder"], tcfg, torch.from_numpy(chunk)[None],
        torch.tensor([32]), tc, pl, tada)
    assert tt[0].tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tc.k[0].numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_allclose(tc.v[0].numpy(), np.asarray(jc.v), atol=1e-5)
    h, kh, _ = _heads("decoder")
    one = ("decoder", h, kh, False, tcfg.cdtype, torch.float32, 3)
    assert rope_calls == [one] * (cfg.decoder.n_layers * (1 + steps))


def test_encoder_chunks_through_qkv_rope(cfg, params, tparams, rope_calls):
    """Two streaming encoder chunks: rows and rings within the stream
    tests' tolerance of JAX's; one qkv_rope call a layer, with its bias,
    per-row tables, k and v in f32 (the ring writes round them)."""
    tcfg = _cfg()
    rng = np.random.default_rng(3)
    jcache = jenc.EncKVCache.create(cfg.encoder, cfg.enc_kvdtype, 64)
    tcache = encoder.EncKVCache.create(tcfg.encoder, tcfg.enc_kvdtype, 64)
    pos = 0
    for t in (8, 1):
        x = rng.standard_normal((t, cfg.encoder.dim)).astype(np.float32)
        jy, jcache = jenc.encode_chunk(params["encoder"], cfg,
                                       jnp.asarray(x), jcache,
                                       jnp.int32(pos))
        ty, tcache = encoder.encode_chunk(tparams["encoder"], tcfg,
                                          torch.from_numpy(x)[None], tcache,
                                          pos)
        np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        pos += t
    np.testing.assert_allclose(tcache.k[0].numpy(), np.asarray(jcache.k),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache.v[0].numpy(), np.asarray(jcache.v),
                               atol=1e-4, rtol=1e-4)
    h, kh, _ = _heads("encoder")
    one = ("encoder", h, kh, True, tcfg.cdtype, torch.float32, 3)
    assert rope_calls == [one] * (2 * cfg.encoder.n_layers)


def test_bulk_encoder_through_qkv_rope(cfg, params, tparams, rope_calls):
    """The bulk encoder over two clips: adapter rows within 1e-4 of JAX's;
    one qkv_rope call a layer, with its bias, the batch's shared [T, D/2]
    tables, q, k and v in the compute dtype (the banded call reads
    them)."""
    rng = np.random.default_rng(13)
    mel = rng.standard_normal((2, 96, cfg.encoder.n_mel)).astype(np.float32)
    tcfg = _cfg()
    got = bulk_encode.bulk_encode_clip(tparams["encoder"], tparams["adapter"],
                                       tcfg, torch.from_numpy(mel))
    for b in range(2):
        want = jax_bulk(params["encoder"], params["adapter"], cfg,
                        jnp.asarray(mel[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    h, kh, _ = _heads("encoder")
    one = ("bulk_encode", h, kh, True, tcfg.cdtype, tcfg.cdtype, 2)
    assert rope_calls == [one] * cfg.encoder.n_layers
