"""models/quant.py and ops/quant_mm.py of the port against the JAX package
on tiny_config() float32 with the same weights: quantized tensors byte for
byte, the unpack, embedding rows, the int8/int4 products (the JAX int4
product through its Pallas kernel in interpret mode) and the quantized
logits, plus the engine's `quantize=` keyword."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models import quant as jq
from voxtral_tpu.ops.quant_mm import int4_mm as jax_int4_mm
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models import quant as tq
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops.quant_mm import int4_mm, int4_mm_plain

torch.set_num_threads(1)

# f32 products summed in another order than XLA's
TOL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.fixture(scope="module", params=[8, 4], ids=["int8", "int4"])
def quantized(request, params, tparams):
    """(bits, JAX quantize_params tree as numpy, the port's own tree)."""
    bits = request.param
    jtree = _np(jq.quantize_params(params, bits=bits))
    return bits, jtree, tq.quantize_params(tparams, bits=bits)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_quantize_params_byte_equal(quantized):
    """Every int8 tensor and every f32 scale equals the JAX result byte for
    byte (encoder and decoder stacks and the embedding table)."""
    bits, jtree, ttree = quantized
    want = dict(_leaves(jtree))
    got = dict(_leaves(ttree))
    assert sorted(got) == sorted(want)
    n_quant = 0
    for name, w in want.items():
        g = got[name]
        assert g.dtype == {np.int8: torch.int8, np.float32: torch.float32}[
            w.dtype.type], name
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      w.view(np.uint8), err_msg=name)
        n_quant += w.dtype == np.int8
    # 4 matrices per stack x 2 stacks + the table
    assert n_quant == 9
    half = 2 if bits == 4 else 1
    assert got["/decoder/tok_embeddings"].shape[-1] == \
        tiny_config().decoder.dim // half


def test_quantized_tree_crosses_from_jax(quantized):
    """from_jax_numpy carries a JAX quantize_params tree bit for bit."""
    _, jtree, _ = quantized
    carried = from_jax_numpy(jtree)
    for (name, w), (_, t) in zip(_leaves(jtree), _leaves(carried)):
        np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                      w.view(np.uint8), err_msg=name)


def test_unpack4_every_byte():
    p = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    jlo, jhi = jq._unpack4(jnp.asarray(p), jnp.float32)
    tlo, thi = tq._unpack4(torch.from_numpy(p), torch.float32)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert tlo.min() == -8 and tlo.max() == 7 and thi.min() == -8


def test_embed_rows_match(quantized):
    _, jtree, ttree = quantized
    ids = np.array([[1, 2, 32], [7, 1255, 0]], np.int32)
    want = np.asarray(jq.embed_rows(jtree["decoder"], jnp.asarray(ids)))
    got = tq.embed_rows(ttree["decoder"], torch.from_numpy(ids).long())
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("rows", [5, 300])
def test_mm_matches_per_layer(quantized, rows):
    """quant.mm on every quantized matrix of both decoder layers; 300 rows
    cover the JAX int4 kernel's row-tile padding."""
    bits, jtree, ttree = quantized
    cfg = tiny_config()
    rng = np.random.default_rng(rows)
    jl, tl = jtree["decoder"]["layers"], ttree["decoder"]["layers"]
    for li in range(cfg.decoder.n_layers):
        for name in tq.QUANT_KEYS:
            in_dim = jl[name].shape[-1] * (2 if bits == 4 else 1)
            x = rng.standard_normal((rows, in_dim)).astype(np.float32)
            if bits == 4:   # the stacked weight + layer index: Pallas
                want = jq.mm(jnp.asarray(x), jl, name, jnp.float32,
                             li=jnp.int32(li))
            else:
                want = jq.mm(jnp.asarray(x), {k: v[li] for k, v in jl.items()},
                             name, jnp.float32)
            got = tq.mm(torch.from_numpy(x), {k: v[li] for k, v in tl.items()},
                        name)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{name}[{li}]")


def test_int4_mm_plain_matches_mm4_and_pallas():
    rng = np.random.default_rng(13)
    w = rng.standard_normal((3, 64, 512)).astype(np.float32)
    lp = jq.quantize_layer_stack({"wqkv": jnp.asarray(w)}, bits=4)
    p, s = np.asarray(lp["wqkv"]), np.asarray(lp["wqkv_scale"])
    tp, ts = torch.from_numpy(p.copy()), torch.from_numpy(s.copy())
    for rows in (1, 5, 300):
        x = rng.standard_normal((rows, 512)).astype(np.float32)
        for li in (0, 2):
            got = int4_mm_plain(torch.from_numpy(x), tp, ts, li).numpy()
            np.testing.assert_allclose(
                got, np.asarray(jq._mm4(jnp.asarray(x), jnp.asarray(p[li]),
                                        jnp.asarray(s[li]), jnp.float32)),
                rtol=TOL, atol=TOL)
            np.testing.assert_allclose(
                got, np.asarray(jax_int4_mm(jnp.asarray(x), jnp.asarray(p),
                                            jnp.asarray(s), li)),
                rtol=TOL, atol=TOL)
            # CPU tensors take the plain version and launch nothing
            n0 = int4_mm.launches
            np.testing.assert_array_equal(
                int4_mm(torch.from_numpy(x), tp, ts, li).numpy(), got)
            assert int4_mm.launches == n0


def test_final_logits_match(quantized, cfg):
    """Quantized tables: int8 widened to bf16, int4 through the int4 kernel
    (Pallas in interpret mode on the JAX side) with bf16 activations."""
    _, jtree, ttree = quantized
    x = np.random.default_rng(2).standard_normal(
        (3, cfg.decoder.dim)).astype(np.float32)
    want = np.asarray(jdec.final_logits(jtree["decoder"], cfg,
                                        jnp.asarray(x)))
    tcfg = tiny_config()
    got = tdec.final_logits(ttree["decoder"], tcfg, torch.from_numpy(x))
    assert got.shape == (3, cfg.decoder.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    got3 = tdec.final_logits(ttree["decoder"], tcfg,
                             torch.from_numpy(x)[None])
    np.testing.assert_array_equal(got3[0].numpy(), got.numpy())


@pytest.mark.parametrize("quantize,bits", [(True, 8), ("int8", 8),
                                           ("int4", 4)])
def test_engine_quantize_kwarg(tparams, quantize, bits):
    """quantize= quantizes the decoder only: the encoder stays exact and the
    caller's tree is left as it was."""
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine

    eng = VoxtralEngine(tiny_config(), tparams, buckets=(16, 4, 1),
                        dec_kv_ring=64, quantize=quantize)
    assert eng.quantized == quantize
    dl = eng.params["decoder"]["layers"]
    assert dl["wqkv"].dtype == torch.int8
    assert tq.stack_is_packed4(dl) == (bits == 4)
    assert eng.params["decoder"]["tok_embeddings"].dtype == torch.int8
    for name in tq.QUANT_KEYS:
        assert eng.params["encoder"]["layers"][name] is \
            tparams["encoder"]["layers"][name]
        assert name + "_scale" not in eng.params["encoder"]["layers"]
    assert tparams["decoder"]["layers"]["wqkv"].dtype == torch.float32
    # BOS/PAD rows come from the quantized table
    want = tq.embed_rows(eng.params["decoder"], torch.tensor(1))
    np.testing.assert_array_equal(eng.embed_bos.numpy(), want.numpy())
