"""Flash encode (TPU kernel #7) on fp8 e4m3 encoder rings, on the CPU.

The kernel reads an e4m3 ring by widening each row to the query's dtype as
it loads it, which is exact, so it computes the function the JAX package's
ring_attention computes on a byte-wide ring (voxtral_tpu/ops/ring.py: the
ring read in the query's dtype).  Here: the plain version and the split
walk's plain model on e4m3 rings against the JAX ring_attention on the same
float8_e4m3fn ring (GQA and MHA, first lap and wrapped; f32 queries within
2e-5, bf16 within the kernels' 2e-2, where the probabilities round against
another max), the split model bitwise the same across three chunkings at
B=1 and B=3, the tiny-config streaming encoder and VoxStream on an e4m3
encoder ring equal to the JAX package's at two chunkings (f32 within 1e-5,
ids exactly), and the wrapper's operand check refusing what the kernel
does not take.  The kernel itself is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py's flash_enc, stream and pool_ring
phases)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.models import encoder as jenc
from voxtral_tpu.ops.ring import ring_attention as j_ring_attention
from voxtral_tpu.runtime import engine as jeng
from voxtral_tpu.runtime import stream as jstream
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models import encoder as tenc
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops.flash_encode import (
    check_operands,
    flash_encode_plain,
    flash_encode_split_plain,
)
from voxtral_tpu_torch.ops.ring import ring_chunk_write
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime import stream as tstream
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)

FP8 = "float8_e4m3fn"
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=0, atol=2e-2)


def _e4m3_ring(rng, kh, cap, d):
    """A ring [KH, cap, D] of e4m3fn values from seeded normals, as the
    JAX array and as the port's tensor (the same bytes)."""
    j = jnp.asarray(rng.standard_normal((kh, cap, d)).astype(np.float32)
                    ).astype(jnp.float8_e4m3fn)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.float8_e4m3fn)      # exact: every value is an e4m3 value
    assert np.array_equal(t.view(torch.uint8).numpy(),
                          np.asarray(j).view(np.uint8))
    return j, t


@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos0,t", [(10, 12), (150, 12), (300, 40)])
@pytest.mark.parametrize("kh,g", [(2, 4), (4, 1)], ids=["gqa", "mha"])
def test_plain_on_e4m3_rings_matches_jax_ring_attention(kh, g, pos0, t, qdt):
    """flash_encode_plain and flash_encode_split_plain (the plan's
    segments and 2) on a full e4m3 ring of 128 slots, window 48: in the
    first lap (slots past the chunk hold no position yet) and wrapped."""
    rng = np.random.default_rng(kh * 1000 + pos0 + t)
    cap, window, d = 128, 48, 8
    jk, tk = _e4m3_ring(rng, kh, cap, d)
    jv, tv = _e4m3_ring(rng, kh, cap, d)
    q = rng.standard_normal((t, kh * g, d)).astype(np.float32)
    # the JAX package's ring_attention runs on the CPU in f32 only (XLA's
    # CPU dot takes no bf16 x bf16 -> f32): for bf16 queries it gets the
    # query rounded to bf16, so the two differ only where the port rounds
    # the probabilities to bf16 (within BF16_TOL)
    qr = np.asarray(jnp.asarray(q).astype(qdt).astype(jnp.float32))
    want = np.asarray(j_ring_attention(
        jnp.asarray(qr), jk, jv, jnp.int32(pos0), window=window,
        out_dtype=jnp.float32))
    tq = torch.from_numpy(q).to(getattr(torch, qdt))[None]
    p = torch.tensor([pos0])
    tol = F32_TOL if qdt == "float32" else BF16_TOL
    got = flash_encode_plain(tq, tk[None], tv[None], p, window=window,
                             out_dtype=torch.float32)
    np.testing.assert_allclose(got[0].numpy(), want, **tol)
    for segments in (None, 2):
        split = flash_encode_split_plain(tq, tk[None], tv[None], p,
                                         window=window, segments=segments,
                                         out_dtype=torch.float32)
        np.testing.assert_allclose(split[0].numpy(), want, **tol)


@pytest.mark.parametrize("bsz", [1, 3])
def test_split_plain_on_e4m3_rings_chunking_invariant_bitwise(bsz):
    """200 rows written to e4m3 rings of 256 slots, then 96 more written
    and attended (bf16 queries, the kernel's split walk in 3 segments) as
    one chunk, as [32, 32, 32] and as [8, 40, 24, 24]: bit-identical
    outputs, each stream its own rows."""
    rng = np.random.default_rng(40 + bsz)
    cap, window, kh, g, d, n0, n = 256, 100, 2, 2, 8, 200, 96
    kv, vv = (torch.from_numpy(rng.standard_normal(
        (bsz, n0 + n, kh, d)).astype(np.float32)) for _ in range(2))
    qq = torch.from_numpy(rng.standard_normal(
        (bsz, n, kh * g, d)).astype(np.float32)).to(torch.bfloat16)

    def run(sizes):
        k_all, v_all = (torch.zeros((bsz, 1, kh, cap, d),
                                    dtype=torch.float8_e4m3fn)
                        for _ in range(2))
        ring_chunk_write(k_all, v_all, kv[:, :n0], vv[:, :n0], 0,
                         torch.zeros(bsz, dtype=torch.int32))
        outs, at = [], 0
        for s in sizes:
            p = torch.full((bsz,), n0 + at, dtype=torch.int32)
            _, _, kr, vr = ring_chunk_write(
                k_all, v_all, kv[:, n0 + at: n0 + at + s],
                vv[:, n0 + at: n0 + at + s], 0, p)
            outs.append(flash_encode_split_plain(
                qq[:, at: at + s], kr, vr, p, window=window, segments=3,
                out_dtype=torch.float32))
            at += s
        return torch.cat(outs, dim=1)

    ref = run([96])
    assert torch.isfinite(ref).all() and ref.abs().amax() > 0
    assert torch.equal(ref, run([32, 32, 32]))
    assert torch.equal(ref, run([8, 40, 24, 24]))


@pytest.fixture(scope="module")
def tparams(params_np):
    return from_jax_numpy(params_np)


@pytest.mark.parametrize("sizes", [(8, 12), (4, 4, 12)])
def test_encode_chunk_on_e4m3_ring_matches_jax(cfg, params, tparams, sizes):
    """The ring-cache encoder with enc_kv_dtype float8_e4m3fn, chunk by
    chunk: the port's "auto" (flash-encode, its plain version here)
    against the JAX package's (ring_attention on the fp8 ring): outputs
    within 1e-5 and both rings' bytes equal."""
    jcfg = cfg.replace(enc_kv_dtype=FP8)
    tcfg = tiny_config().replace(enc_kv_dtype=FP8)
    assert tdec._use_flash(tcfg.encoder,
                           torch.zeros(1, dtype=tcfg.enc_kvdtype))
    rng = np.random.default_rng(sum(sizes))
    jcache = jenc.EncKVCache.create(jcfg.encoder, jcfg.enc_kvdtype, 64)
    tcache = tenc.EncKVCache.create(tcfg.encoder, tcfg.enc_kvdtype, 64)
    assert tcache.k.dtype == torch.float8_e4m3fn
    pos = 0
    for t in sizes:
        x = rng.standard_normal((t, cfg.encoder.dim)).astype(np.float32)
        jy, jcache = jenc.encode_chunk(params["encoder"], jcfg,
                                       jnp.asarray(x), jcache,
                                       jnp.int32(pos))
        ty, tcache = tenc.encode_chunk(tparams["encoder"], tcfg,
                                       torch.from_numpy(x)[None], tcache, pos)
        np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy),
                                   rtol=1e-5, atol=1e-5)
        pos += t
    for tr, jr in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_array_equal(tr[0].view(torch.uint8).numpy(),
                                      np.asarray(jr).view(np.uint8))


@pytest.mark.parametrize("feed", [3200, None], ids=["0.2s", "whole"])
def test_voxstream_on_e4m3_encoder_ring_equals_jax(params, tiny_tokenizer,
                                                   tparams, feed):
    """VoxStream end to end with an e4m3 encoder ring, fed 0.2 s at a time
    and all at once: the port's ids equal the JAX package's."""
    from voxtral_tpu.config import tiny_config as jax_tiny_config

    audio = make_audio(2.0, seed=81)
    kw = dict(buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)
    jeng_ = jeng.VoxtralEngine(jax_tiny_config().replace(enc_kv_dtype=FP8),
                               params, tokenizer=tiny_tokenizer, **kw)
    teng_ = teng.VoxtralEngine(
        tiny_config().replace(enc_kv_dtype=FP8), tparams,
        tokenizer=TekkenTokenizer([bytes([i]) for i in range(256)], 1000),
        **kw)
    ids = []
    for cls, eng in ((jstream.VoxStream, jeng_), (tstream.VoxStream, teng_)):
        s = cls(eng)
        s.record_ids = True
        step = feed or len(audio)
        for i in range(0, len(audio), step):
            s.feed(audio[i: i + step])
        s.finish()
        ids.append(s.generated_ids)
    assert len(ids[0]) > 10
    assert ids[1] == ids[0]
    assert teng_.new_enc_cache().k.dtype == torch.float8_e4m3fn


def test_check_operands_refuses_bad_fp8_rings():
    """The kernel's operand check (the wrapper runs it on CUDA tensors)
    takes e4m3 rings whose rows start on 16 bytes, and refuses a ring pair
    of two dtypes, an e5m2 ring, a misaligned base and a row stride that
    is not a multiple of 16 bytes."""
    q = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    fp8 = torch.float8_e4m3fn
    k = torch.zeros((1, 2, 128, 64), dtype=fp8)
    check_operands(q, k, k.clone(), torch.bfloat16)
    check_operands(q.float(), k, k.clone(), torch.float32)
    wide = torch.zeros((1, 2, 128, 80), dtype=fp8)[..., :64]   # 80-byte rows
    check_operands(q, wide, wide, torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        check_operands(q, k, k.to(torch.bfloat16), torch.bfloat16)
    with pytest.raises(ValueError, match="rings"):
        e5 = torch.zeros((1, 2, 128, 64), dtype=torch.float8_e5m2)
        check_operands(q, e5, e5, torch.bfloat16)
    odd = torch.zeros((1, 2, 128, 72), dtype=fp8)[..., :64]   # 72-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        check_operands(q, odd, odd, torch.bfloat16)
    buf = torch.zeros(2 * 128 * 64 + 8, dtype=fp8)
    off = buf[8:].view(1, 2, 128, 64)                         # base + 8
    assert off.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        check_operands(q, off, off, torch.bfloat16)
    with pytest.raises(ValueError, match="shapes"):
        check_operands(q, k, k[:, :, :64].contiguous(), torch.bfloat16)


def test_encoder_dispatch_takes_the_kernel_on_e4m3_rings():
    """decoder._use_flash: "auto" and "flash" take the kernels on e4m3
    rings (both attention kernels read them), "xla" never; e5m2 and
    integer rings stay on the plain path."""
    cfg = tiny_config().encoder
    ring = torch.zeros(1, dtype=torch.float8_e4m3fn)
    for impl, want in (("auto", True), ("flash", True), ("xla", False)):
        c = dataclasses.replace(cfg, attn_impl=impl)
        assert tdec._use_flash(c, ring) is want
    for dt in (torch.float8_e5m2, torch.int8):
        assert not tdec._use_flash(cfg, torch.zeros(1, dtype=dt))
