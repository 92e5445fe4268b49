"""Flash-decode (kernel B): the port's plain version against the three JAX
Pallas kernels it replaces (ops/flash_decode.py, interpret mode on the CPU):
  #4 _kernel_flat_fused (row write + attention), and
  #2 _kernel / #3 _kernel_flat (attention after ring_rows_write),
on f32, bf16 and fp8 rings.  Outputs at atol 1e-5 (float32), rings
bit-equal.  Then the decoder's dispatch of fp8 rings, and the kernel's
split plan.  tests/test_torch_cuda.py holds the CUDA kernel against the
plain version on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops.flash_decode import (
    flash_decode_attention_batched,
    flash_decode_write_attention_batched,
)
from voxtral_tpu.ops.ring import ring_rows_write as jax_rows_write
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_chunk,
    flash_decode_plain,
    flash_decode_plan,
    flash_decode_split_plain,
    flash_decode_splits,
)

torch.set_num_threads(1)


def _case(bsz, n_layers, kh, g, d, cap, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    k_all = f(bsz, n_layers, kh, cap, d).astype(dtype)
    v_all = f(bsz, n_layers, kh, cap, d).astype(dtype)
    return k_all, v_all, f(bsz, kh * g, d), f(bsz, kh, d), f(bsz, kh, d)


def _torch(x):
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    if x.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(x.copy())


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# the tests/test_flash_decode.py fused-kernel shapes, plus a cap that is not
# a power of two (48 = 3 blocks of 16) with wraparound
@pytest.mark.parametrize("cap,window,pos", [
    (64, 48, [0, 5, 47, 63, 200]),
    (48, 48, [1, 30, 47, 48, 131]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_fused_write_kernel(cap, window, pos, dtype):
    bsz, n_layers, kh, g, d = 5, 2, 2, 4, 8
    rdt = jnp.dtype(dtype)
    k_all, v_all, q, kr, vr = _case(bsz, n_layers, kh, g, d, cap, seed=41,
                                    dtype=rdt)
    li = 1
    want, wk, wv = flash_decode_write_attention_batched(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.asarray(kr), jnp.asarray(vr), jnp.int32(li),
        jnp.asarray(pos, jnp.int32), window=window, block=16, interpret=True,
        out_dtype=jnp.float32)
    tk, tv = _torch(k_all), _torch(v_all)
    got = flash_decode(_torch(q), tk, tv, li, torch.tensor(pos), _torch(kr),
                       _torch(vr), window=window, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tk.float().numpy(), _f32(wk))
    np.testing.assert_array_equal(tv.float().numpy(), _f32(wv))


@pytest.mark.parametrize("flat", [False, True])
def test_plain_matches_attention_kernels_after_row_write(flat):
    bsz, n_layers, kh, g, d = 3, 2, 2, 4, 8
    cap, window, block = 48, 40, 16
    k_all, v_all, q, kr, vr = _case(bsz, n_layers, kh, g, d, cap, seed=7)
    pos = [3, 44, 101]
    li = 0
    wk, wv = jax.vmap(jax_rows_write, in_axes=(0, 0, 0, 0, None, 0))(
        jnp.asarray(k_all), jnp.asarray(v_all), jnp.asarray(kr),
        jnp.asarray(vr), jnp.int32(li), jnp.asarray(pos, jnp.int32))
    want = flash_decode_attention_batched(
        jnp.asarray(q), wk, wv, jnp.int32(li), jnp.asarray(pos, jnp.int32),
        window=window, block=block, interpret=True, flat=flat,
        out_dtype=jnp.float32)
    # attention alone over the written rings (the kernel's write=False mode)
    got = flash_decode(_torch(q), _torch(np.asarray(wk)),
                       _torch(np.asarray(wv)), li, torch.tensor(pos),
                       window=window, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # write + attention from the unwritten rings gives the same
    tk, tv = _torch(k_all), _torch(v_all)
    got_w = flash_decode(_torch(q), tk, tv, li, torch.tensor(pos),
                         _torch(kr), _torch(vr), window=window,
                         out_dtype=torch.float32)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))


def test_cpu_tensors_take_the_plain_version():
    k_all, v_all, q, kr, vr = _case(2, 2, 2, 2, 4, 32, seed=3)
    args = (_torch(q), _torch(k_all), _torch(v_all), 1, torch.tensor([4, 40]),
            _torch(kr), _torch(vr))
    flash_decode.launches = 0
    got = flash_decode(*args, window=24)
    args2 = (args[0], _torch(k_all), _torch(v_all)) + args[3:]
    want = flash_decode_plain(*args2, window=24)
    assert torch.equal(got, want)
    assert flash_decode.launches == 0


# --- fp8 rings: the inputs of tests/test_flash_decode.py's two fp8 tests ---

@pytest.mark.parametrize("flat", [False, True])
def test_plain_matches_fp8_attention_kernels(flat):
    """Attention alone over fp8 rings against JAX #2 (flat=False) and #3
    (flat=True), which widen the fp8 blocks in VMEM: the inputs of
    test_flash_fp8_ring_matches_widened (seed 31, pos [4, 47, 130])."""
    rng = np.random.default_rng(31)
    bsz, n_layers, kh, g, d = 3, 2, 2, 4, 8
    cap, window, block = 64, 48, 16
    f8 = jnp.float8_e4m3fn
    ks8 = jnp.asarray(rng.standard_normal((bsz, n_layers, kh, cap, d)),
                      jnp.float32).astype(f8)
    vs8 = jnp.asarray(rng.standard_normal((bsz, n_layers, kh, cap, d)),
                      jnp.float32).astype(f8)
    qs = rng.standard_normal((bsz, kh * g, d)).astype(np.float32)
    pos = [4, 47, 130]
    want = flash_decode_attention_batched(
        jnp.asarray(qs), ks8, vs8, jnp.int32(1), jnp.asarray(pos, jnp.int32),
        window=window, block=block, interpret=True, flat=flat,
        out_dtype=jnp.float32)
    tk, tv = _torch(np.asarray(ks8)), _torch(np.asarray(vs8))
    assert tk.dtype == torch.float8_e4m3fn
    got = flash_decode_plain(_torch(qs), tk, tv, 1, torch.tensor(pos),
                             window=window, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_plain_matches_fp8_fused_write_kernel():
    """Row write + attention on fp8 rings against JAX #4, which casts the
    rows to fp8 first: the inputs of the fp8 case of
    test_fused_write_attention_matches_two_step (seed 41, block 32).  The
    rows lie inside +-448, where the port's saturating cast and the JAX
    cast agree, so the rings are bit-equal."""
    bsz, n_layers, kh, g, d = 5, 2, 2, 4, 8
    cap, window, block = 64, 48, 32
    rdt = jnp.dtype("float8_e4m3fn")
    k_all, v_all, q, kr, vr = _case(bsz, n_layers, kh, g, d, cap, seed=41,
                                    dtype=rdt)
    assert max(np.abs(kr).max(), np.abs(vr).max()) < 448
    pos = [0, 5, 47, 63, 200]
    want, wk, wv = flash_decode_write_attention_batched(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.asarray(kr), jnp.asarray(vr), jnp.int32(1),
        jnp.asarray(pos, jnp.int32), window=window, block=block,
        interpret=True, out_dtype=jnp.float32)
    tk, tv = _torch(k_all), _torch(v_all)
    got = flash_decode_plain(_torch(q), tk, tv, 1, torch.tensor(pos),
                             _torch(kr), _torch(vr), window=window,
                             out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for t, j in ((tk, wk), (tv, wv)):
        np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                      np.asarray(j).view(np.uint8))


def test_decoder_routes_fp8_rings_to_flash(params_np, monkeypatch):
    """attn_impl="auto" takes flash-decode on fp8 rings (the port's rule;
    the JAX package keeps them on the plain path), "xla" keeps the plain
    path, and one tiny-f32 decoder step from the same fp8 cache gives the
    same hidden state (1e-5), rings and argmax ids either way."""
    base = tiny_config().replace(kv_dtype="float8_e4m3fn")
    cfgs = {impl: base.replace(decoder=dataclasses.replace(
        base.decoder, attn_impl=impl)) for impl in ("auto", "xla")}
    calls = {"flash": 0, "ring": 0}

    def counted(name, fn):
        def f(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return f

    monkeypatch.setattr(tdec, "flash_decode",
                        counted("flash", tdec.flash_decode))
    monkeypatch.setattr(tdec, "ring_attention",
                        counted("ring", tdec.ring_attention))

    dp = from_jax_numpy(params_np)["decoder"]
    ada = tdec.ada_scales(dp, base)
    rng = np.random.default_rng(3)
    bsz, cap, t0 = 3, 64, 40
    cache = tdec.KVCache.create(base.decoder, torch.float8_e4m3fn, cap=cap,
                                batch=bsz)
    prompt = torch.from_numpy(rng.standard_normal(
        (bsz, t0, base.decoder.dim)).astype(np.float32))
    tdec.decoder_forward(dp, base, prompt, cache, torch.zeros(
        bsz, dtype=torch.int32), ada)
    emb = torch.from_numpy(rng.standard_normal(
        (bsz, 1, base.decoder.dim)).astype(np.float32))
    pos = torch.tensor([t0, t0, t0], dtype=torch.int32)
    out = {}
    for impl, route in (("auto", "flash"), ("xla", "ring")):
        c2 = tdec.KVCache(cache.k.clone(), cache.v.clone())
        calls.update(flash=0, ring=0)
        x, _ = tdec.decoder_forward(dp, cfgs[impl], emb, c2, pos, ada)
        assert calls[route] == base.decoder.n_layers and sum(
            calls.values()) == base.decoder.n_layers, (impl, calls)
        out[impl] = (x, tdec.final_logits(dp, cfgs[impl], x).argmax(-1), c2)
    np.testing.assert_allclose(out["auto"][0].numpy(), out["xla"][0].numpy(),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(out["auto"][1], out["xla"][1])
    for a, b in ((out["auto"][2].k, out["xla"][2].k),
                 (out["auto"][2].v, out["xla"][2].v)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("span,kh,want", [
    (512, 8, 2), (8192, 8, 8), (896, 8, 2), (2048, 8, 4),
    (384, 8, 2), (64, 8, 1), (48, 2, 1), (896, 4, 2)])
def test_split_plan(span, kh, want):
    """The kernel's split: ranges of about 448 window slots, at least 2
    and at most 8, at least 64 slots each, a multiple of 64 slots covering
    the window; shapes only, and no batch size among them."""
    assert flash_decode_splits(span, kh) == want
    chunk = flash_decode_chunk(span, kh)
    assert chunk % 64 == 0 and (want - 1) * chunk < span <= want * chunk


@pytest.mark.parametrize("bsz,kh,want", [
    (1, 8, 8), (2, 8, 8), (3, 8, 5), (8, 8, 2), (16, 8, 1), (64, 8, 1),
    (16, 4, 2), (16, 2, 4)])
def test_split_mapping(bsz, kh, want):
    """How the 8 ranges of an 8192-slot window run: a cluster of up to 8
    blocks per (stream, KV head) while the grid fits one wave of 132
    blocks, down to one block walking every range (B >= 9 at 8 KV heads);
    the split itself is the same at every B."""
    plan = flash_decode_plan(8192, bsz, kh)
    assert plan.cluster == want
    assert (plan.splits, plan.chunk) == (flash_decode_splits(8192, kh),
                                         flash_decode_chunk(8192, kh))
    assert want == 1 or bsz * kh * want <= 132


def _split_case(bsz, cap, seed, ring=np.float32):
    k_all, v_all, q, k_rows, v_rows = _case(bsz, 2, 2, 4, 128, cap, seed,
                                            dtype=ring)
    rng = np.random.default_rng(seed + 1)
    pos = rng.integers(0, 3 * cap, size=bsz).astype(np.int32)
    pos[0] = cap + 5                 # stream 0 across every range
    return k_all, v_all, q, k_rows, v_rows, pos


@pytest.mark.parametrize("ring", [np.float32, jnp.bfloat16,
                                  jnp.float8_e4m3fn])
@pytest.mark.parametrize("cap,window", [(512, 8192), (384, 300)])
def test_split_model_mappings_and_plain(ring, cap, window):
    """flash_decode_split_plain (the kernel's ranges, partitions and fold
    order) gives the same bits under every mapping, from one block walking
    every range to one block a range, and stays within 1e-5 of
    flash_decode_plain, rings bit-equal."""
    k_all, v_all, q, k_rows, v_rows, pos = _split_case(3, cap, 21, ring)
    args = lambda: (_torch(q).to(torch.bfloat16), _torch(k_all),
                    _torch(v_all), 1, torch.from_numpy(pos), _torch(k_rows),
                    _torch(v_rows))
    kw = dict(window=window, out_dtype=torch.float32)
    splits = flash_decode_splits(min(cap, window), 2)
    assert splits > 1
    outs = []
    for c in range(1, splits + 1):
        a = args()
        outs.append((flash_decode_split_plain(*a, cluster=c, **kw), a[1]))
    ref_args = args()
    ref = flash_decode_plain(*ref_args, **kw)
    for out, ring_k in outs:
        assert torch.equal(out, outs[0][0])
        assert torch.equal(ring_k.view(torch.uint8),
                           ref_args[1].view(torch.uint8))
    np.testing.assert_allclose(outs[0][0].numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("ring", [np.float32, jnp.bfloat16])
def test_split_model_against_jax_kernel(ring):
    """The split model at B=3 on a 512-slot ring (2 ranges of 256) against
    the JAX package's fused Pallas kernel (#4) in interpret mode: outputs
    within 1e-5, rings bit-equal; stream 0's output the same bits alone
    and inside the batch."""
    cap, window = 512, 8192
    k_all, v_all, q, k_rows, v_rows, pos = _split_case(3, cap, 33, ring)
    jo, jk, jv = flash_decode_write_attention_batched(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.asarray(k_rows), jnp.asarray(v_rows), jnp.int32(1),
        jnp.asarray(pos), window=window, block=64, interpret=True,
        out_dtype=jnp.float32)
    tk, tv = _torch(k_all), _torch(v_all)
    got = flash_decode_split_plain(
        _torch(q), tk, tv, 1, torch.from_numpy(pos), _torch(k_rows),
        _torch(v_rows), window=window, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _f32(jo), atol=1e-5)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                      np.asarray(j).view(np.uint8))
    alone = flash_decode_split_plain(
        _torch(q[:1]), _torch(k_all[:1]), _torch(v_all[:1]), 1,
        torch.from_numpy(pos[:1]), _torch(k_rows[:1]), _torch(v_rows[:1]),
        window=window, out_dtype=torch.float32)
    assert torch.equal(alone[0], got[0])
