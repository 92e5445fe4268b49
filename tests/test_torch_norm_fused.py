"""The layers' fused residual add + RMSNorm (+ ada scale) on the CPU:
ops/norms.py:add_rms_norm (its plain version, which CPU tensors take)
against the JAX package's own sequence around its norm (the `jnp` add,
`astype` and ada lines of voxtral_tpu/models/decoder.py:170-173 and
voxtral_tpu/models/encoder.py:149-151 on voxtral_tpu.ops.norms.rms_norm),
bit-equal in bf16 and within 1e-6 in f32, in every mode; a CPU model of
the kernel's sum order (csrc/rms_norm.cu), whose rows do not depend on the
row count; and the decoder step, the streaming encoder chunk and the bulk
encoder of tiny_config() through the fused call sites against the JAX
package.  The kernel itself is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py's rowinv phase)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models import encoder as jenc
from voxtral_tpu.models.bulk_encode import bulk_encode_clip as jax_bulk
from voxtral_tpu.ops import norms as jn
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import bulk_encode, decoder, encoder
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops import norms

torch.set_num_threads(1)
EPS = 1e-5
MODES = ("norm", "add", "bias", "ada")
# the kernel's block: 256 threads, 8 warps of 32 lanes
NT, LANES = 256, 32


def _inputs(mode: str, rows: int, width: int, seed: int):
    """Seeded numpy inputs of one mode: x, weight, y, bias, ada (None where
    the mode has none)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, width)).astype(np.float32)
    w = (rng.random(width) + 0.5).astype(np.float32)
    y = bias = ada = None
    if mode != "norm":
        y = (rng.standard_normal((rows, width)) * 0.5).astype(np.float32)
    if mode == "bias":
        bias = (rng.standard_normal(width) * 0.1).astype(np.float32)
    if mode == "ada":
        ada = (rng.standard_normal(width) * 0.2).astype(np.float32)
    return x, w, y, bias, ada


def _jax_sequence(x, w, y, bias, ada, out_dtype):
    """The JAX package's lines around its norm: the residual add (the bias
    in f32 before the cast, encoder.py:149), the norm, the ada scale
    (decoder.py:172-173) and the cast to the compute dtype."""
    if y is not None:
        x = x + (y if bias is None else y + bias).astype(x.dtype)
    n = jn.rms_norm(x, w, EPS)
    if ada is not None:
        n = n.astype(jnp.float32) * (1.0 + ada)
    return x, n.astype(out_dtype)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("width", [24, 1280, 3072])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", MODES)
def test_add_rms_norm_equals_the_jax_sequence(mode, dtype, width):
    """Every mode at the tiny width and the encoder's and decoder's: the
    new residual and the normed rows equal JAX's bit for bit in bf16,
    within 1e-6 in f32."""
    x, w, y, bias, ada = _inputs(mode, 5, width, seed=width + len(mode))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got_x, got_n = norms.add_rms_norm(_t(x).to(tdt), _t(w), EPS, y=_t(y),
                                      bias=_t(bias), ada=_t(ada))
    want_x, want_n = _jax_sequence(
        jnp.asarray(x).astype(jdt), jnp.asarray(w),
        None if y is None else jnp.asarray(y),
        None if bias is None else jnp.asarray(bias),
        None if ada is None else jnp.asarray(ada), jdt)
    assert got_x.dtype == got_n.dtype == tdt
    assert got_n.shape == got_x.shape == x.shape
    for got, want in ((got_x, want_x), (got_n, want_n)):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(got), want)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_add_rms_norm_is_the_unfused_torch_sequence(mode):
    """The plain version is the sequence the layers ran before the fused
    call, bit for bit in bf16: torch's cast and add, `rms_norm`, torch's
    ada ops; the norm-only case is `rms_norm`; without y x_new is x."""
    x, w, y, bias, ada = (_t(a) for a in _inputs(mode, 7, 1280, seed=3))
    xb = x.to(torch.bfloat16)
    got_x, got_n = norms.add_rms_norm(xb, w, EPS, y=y, bias=bias, ada=ada)
    want_x = xb
    if y is not None:
        want_x = xb + (y if bias is None else y + bias).to(xb.dtype)
    else:
        assert got_x is xb
    n = norms.rms_norm(want_x, w, EPS)
    if ada is not None:
        n = n.float() * (1.0 + ada)
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_n, n.to(torch.bfloat16))
    if mode == "norm":
        assert torch.equal(got_n, norms.rms_norm_plain(xb, w, EPS))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_add_rms_norm_normed_in_x_dtype(dtype):
    """The new residual and the normed rows both come in x's dtype, with
    or without the ada scale; the norm-only case is `rms_norm`."""
    x, w, y, _, ada = (_t(a) for a in _inputs("ada", 3, 64, seed=4))
    xd = x.to(dtype)
    for kw in ({}, {"y": y}, {"y": y, "ada": ada}):
        x_new, n = norms.add_rms_norm(xd, w, EPS, **kw)
        assert x_new.dtype == n.dtype == dtype
    assert torch.equal(norms.add_rms_norm(xd, w, EPS)[1],
                       norms.rms_norm(xd, w, EPS))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) on f32 tensors: a * b is exact in float64 (two 24-bit
    significands), then one rounding to f32 after the add (float64's own
    rounding of the add comes first where the exponents are far apart)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_order_rms_norm(x: torch.Tensor, w: torch.Tensor,
                          eps: float = EPS) -> torch.Tensor:
    """A CPU model of csrc/rms_norm.cu's norm: each row's sum of squares
    in the kernel's order (thread t of 256 sums elements t, t + 256, ... by
    fmaf; each warp folds by butterfly; the 8 warps' sums added in warp
    order), then (x * r) * w in f32, rounded to x.dtype.  Only the
    reciprocal square root is torch's (the card's rsqrtf is its own)."""
    rows, dim = x.shape
    xf = x.float()
    e = -(-dim // NT)
    v = torch.zeros((rows, e * NT))
    v[:, :dim] = xf
    v = v.reshape(rows, e, NT)
    s = torch.zeros((rows, NT))
    for k in range(e):                        # thread t: its elements in order
        s = _fma(v[:, k], v[:, k], s)
    s = s.reshape(rows, NT // LANES, LANES)
    lane = torch.arange(LANES)
    off = LANES // 2
    while off:                                # the butterfly, every lane
        s = s + s[..., lane ^ off]
        off //= 2
    t = torch.zeros(rows)
    for i in range(NT // LANES):              # thread 0: warps in order
        t = t + s[:, i, 0]
    r = torch.rsqrt(t / dim + eps)[:, None]
    return (xf * r * w).to(x.dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width", [1280, 3072])
def test_kernel_order_rows_do_not_depend_on_the_row_count(width, dtype):
    """The model's rows at 1-80 rows and at a decode batch's 56 x 38 are
    the same rows of one call, at two offsets; within one bf16 step (f32:
    1e-5) of the plain norm, whose mean sums in torch's order."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(width)
    x = torch.randn((56 * 38 + 7, width), generator=gen).to(dt)
    w = torch.rand(width, generator=gen) + 0.5
    full = kernel_order_rms_norm(x, w)
    for n in (*range(1, 81), 56 * 38):
        for lo in (0, 7):
            assert torch.equal(kernel_order_rms_norm(x[lo: lo + n], w),
                               full[lo: lo + n])
    want = norms.rms_norm_plain(x, w).float()
    rel = ((full.float() - want).abs().max() / want.abs().max()).item()
    assert rel <= (2 ** -7 if dt == torch.bfloat16 else 1e-5)


# --- the call sites ---------------------------------------------------------

@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.fixture
def fused_calls(monkeypatch):
    """Records each add_rms_norm call of the model: (module, which of y,
    bias and ada it was given)."""
    calls = []

    def recorder(mod):
        real = mod.add_rms_norm

        def f(x, weight, eps=EPS, y=None, bias=None, ada=None):
            calls.append((mod.__name__.rsplit(".", 1)[-1], y is not None,
                          bias is not None, ada is not None))
            return real(x, weight, eps, y, bias, ada)
        return f

    for mod in (decoder, encoder, bulk_encode):
        monkeypatch.setattr(mod, "add_rms_norm", recorder(mod))
    return calls


def _cfg(impl="auto"):
    c = tiny_config()
    return c.replace(decoder=dataclasses.replace(c.decoder, attn_impl=impl))


def test_decode_steps_through_the_fused_norms(cfg, params, tparams,
                                              fused_calls):
    """A prefill and a burst of 6 steps at tiny size: tokens equal to JAX's
    and the cache within f32 rounding; every norm one fused call: layer 0's
    attn_norm the norm alone, every other attn_norm with the previous
    layer's FFN output, every ffn_norm with wo's output and the ada scale,
    the final norm of each step with the last layer's FFN output."""
    cap, steps = 48, 6
    pl = cfg.prompt_len - 1
    rng = np.random.default_rng(9)
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
    nl = cfg.decoder.n_layers
    attn0, attn = ("decoder", False, False, False), ("decoder", True, False,
                                                      False)
    ffn = ("decoder", True, False, True)
    layers = [attn0, ffn] + [attn, ffn] * (nl - 1)
    # the prefill, then each step's layers and its final norm
    assert fused_calls == layers + (layers + [attn]) * steps


def test_decoder_forward_keeps_its_hidden_state(cfg, tparams):
    """decoder_forward's hidden state is decoder_layers' residual plus the
    last FFN output (the one add left in torch), and final_logits of it
    equals final_logits with that add fused in."""
    tcfg = _cfg()
    dp = tparams["decoder"]
    rng = np.random.default_rng(1)
    emb = torch.from_numpy(rng.standard_normal(
        (2, 3, cfg.decoder.dim)).astype(np.float32))
    ada = decoder.ada_scales(dp, tcfg)
    pos = torch.zeros(2, dtype=torch.int32)
    c1 = decoder.KVCache.create(tcfg.decoder, torch.float32, 32, batch=2)
    c2 = decoder.KVCache.create(tcfg.decoder, torch.float32, 32, batch=2)
    h, _ = decoder.decoder_forward(dp, tcfg, emb, c1, pos, ada)
    x, y = decoder.decoder_layers(dp, tcfg, emb, c2, pos, ada)
    assert torch.equal(h, x + y.to(x.dtype))
    assert torch.equal(decoder.final_logits(dp, tcfg, h),
                       decoder.final_logits(dp, tcfg, x, y))


def test_encoder_chunks_through_the_fused_norms(cfg, params, tparams,
                                                fused_calls):
    """Two streaming encoder chunks: rows and rings within the stream
    tests' tolerance of JAX's; each layer's attn_norm takes the previous
    layer's FFN output and its bias (layer 0's the norm alone), each
    ffn_norm wo's output and its bias, the final norm the last FFN output
    and its bias."""
    tcfg = _cfg()
    rng = np.random.default_rng(0)
    jcache = jenc.EncKVCache.create(cfg.encoder, cfg.enc_kvdtype, 64)
    tcache = encoder.EncKVCache.create(tcfg.encoder, tcfg.enc_kvdtype, 64)
    pos = 0
    for t in (8, 12):
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
    ne = cfg.encoder.n_layers
    one = ([("encoder", False, False, False), ("encoder", True, True, False)]
           + [("encoder", True, True, False)] * (2 * (ne - 1))
           + [("encoder", True, True, False)])
    assert fused_calls == one * 2


def test_bulk_encoder_through_the_fused_norms(cfg, params, tparams,
                                              fused_calls):
    """The bulk encoder over two clips: adapter rows within 1e-4 of JAX's,
    its norms fused as the streaming encoder's."""
    rng = np.random.default_rng(11)
    mel = rng.standard_normal((2, 96, cfg.encoder.n_mel)).astype(np.float32)
    got = bulk_encode.bulk_encode_clip(tparams["encoder"], tparams["adapter"],
                                       _cfg(), torch.from_numpy(mel))
    for b in range(2):
        want = jax_bulk(params["encoder"], params["adapter"], cfg,
                        jnp.asarray(mel[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    ne = cfg.encoder.n_layers
    assert fused_calls == (
        [("bulk_encode", False, False, False),
         ("bulk_encode", True, True, False)]
        + [("bulk_encode", True, True, False)] * (2 * (ne - 1) + 1))
