"""Flash encode (TPU kernel #7) and the encoder's ring chunk write of the
port against the JAX package: the plain version `flash_encode_plain`
against the Pallas kernel in interpret mode (the cases of
tests/test_flash_encode.py, f32, 2e-5), its chunking invariance, the
encoder's attention dispatch rule, and `ring_chunk_write` bit for bit
against JAX's batched blend and single-stream rotate (the cases of
tests/test_batched.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops.flash_encode import (
    flash_bulk_attention as j_flash,
    flash_bulk_attention_batched as j_flash_batched,
)
from voxtral_tpu.ops.ring import _win
from voxtral_tpu.ops.ring import ring_chunk_write as j_chunk_write
from voxtral_tpu.ops.ring import ring_write as j_ring_write
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import encoder as enc_mod
from voxtral_tpu_torch.models.params import from_jax_numpy, init_params
from voxtral_tpu_torch.ops.flash_encode import (
    MAX_SEGMENTS,
    flash_bulk_attention_batched,
    flash_encode_plain,
    flash_encode_segments,
    flash_encode_split_plain,
)
from voxtral_tpu_torch.ops.ring import ring_chunk_write, ring_write

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _rings(rng, n, kh, cap, d):
    """n rows of K/V written from position 0: (numpy K, V rows, port rings
    [1, KH, cap, D], JAX rings [KH, cap, D])."""
    kv = rng.standard_normal((n, kh, d)).astype(np.float32)
    vv = rng.standard_normal((n, kh, d)).astype(np.float32)
    jk = j_ring_write(jnp.zeros((kh, cap, d), jnp.float32), jnp.asarray(kv),
                      jnp.int32(0))
    jv = j_ring_write(jnp.zeros((kh, cap, d), jnp.float32), jnp.asarray(vv),
                      jnp.int32(0))
    tk, tv = (torch.zeros((1, kh, cap, d)) for _ in range(2))
    ring_write(tk, torch.from_numpy(kv)[None], torch.tensor([0]))
    ring_write(tv, torch.from_numpy(vv)[None], torch.tensor([0]))
    return kv, vv, (tk, tv), (jk, jv)


@pytest.mark.parametrize(
    "pos0,t", [(0, 8), (0, 33), (40, 24), (100, 16), (120, 8), (250, 40)])
def test_plain_matches_pallas(pos0, t):
    """MHA, cap 128 < pos0 + t in the last cases (the ring has wrapped)."""
    rng = np.random.default_rng(pos0 + t)
    cap, window, kh, d = 128, 48, 2, 8
    _, _, (tk, tv), (jk, jv) = _rings(rng, pos0 + t, kh, cap, d)
    np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk))
    q = rng.standard_normal((t, kh, d)).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jk, jv, jnp.int32(pos0),
                              window=window, block=32, bq=16))
    got = flash_encode_plain(torch.from_numpy(q)[None], tk, tv,
                             torch.tensor([pos0]), window=window)
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)


def test_plain_matches_pallas_gqa():
    rng = np.random.default_rng(7)
    cap, window, kh, g, d = 64, 24, 2, 4, 8
    pos0, t = 30, 12
    _, _, (tk, tv), (jk, jv) = _rings(rng, pos0 + t, kh, cap, d)
    q = rng.standard_normal((t, kh * g, d)).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jk, jv, jnp.int32(pos0),
                              window=window, block=16, bq=8))
    got = flash_encode_plain(torch.from_numpy(q)[None], tk, tv,
                             torch.tensor([pos0]), window=window)
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)


def test_batched_plain_matches_pallas_per_stream_positions():
    """B=3 streams, each at its own position, through the batched Pallas
    entry point and through the dispatching wrapper (CPU: plain)."""
    rng = np.random.default_rng(11)
    cap, window, kh, d, t, b = 64, 24, 2, 8, 8, 3
    pos = [5 + 13 * s for s in range(b)]
    tks, tvs, jks, jvs, qs = [], [], [], [], []
    for p in pos:
        _, _, (tk, tv), (jk, jv) = _rings(rng, p + t, kh, cap, d)
        tks.append(tk)
        tvs.append(tv)
        jks.append(jk)
        jvs.append(jv)
        qs.append(rng.standard_normal((t, kh, d)).astype(np.float32))
    q = np.stack(qs)
    want = np.asarray(j_flash_batched(
        jnp.asarray(q), jnp.stack(jks), jnp.stack(jvs),
        jnp.asarray(pos, jnp.int32), jnp.full((b,), t, jnp.int32),
        window=window, block=16, bq=8))
    n0 = flash_bulk_attention_batched.launches
    got = flash_bulk_attention_batched(
        torch.from_numpy(q), torch.cat(tks), torch.cat(tvs),
        torch.tensor(pos), window=window)
    assert flash_bulk_attention_batched.launches == n0   # CPU: no launch
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_chunking_invariant_bitwise():
    """The same 96 positions written and attended as one chunk or as
    [32, 32, 32] or [8, 40, 24, 24] give bit-identical outputs: every
    masked slot contributes exactly 0 and the products run over the whole
    ring in slot order, whatever T is."""
    rng = np.random.default_rng(3)
    cap, window, kh, d, n = 128, 48, 2, 8, 96
    kv = torch.from_numpy(rng.standard_normal((n, kh, d)).astype(np.float32))
    vv = torch.from_numpy(rng.standard_normal((n, kh, d)).astype(np.float32))
    qa = torch.from_numpy(rng.standard_normal((n, kh, d)).astype(np.float32))

    def run(sizes):
        tk, tv = (torch.zeros((1, kh, cap, d)) for _ in range(2))
        outs, pos = [], 0
        for s in sizes:
            p = torch.tensor([pos])
            ring_write(tk, kv[None, pos: pos + s], p)
            ring_write(tv, vv[None, pos: pos + s], p)
            outs.append(flash_encode_plain(qa[None, pos: pos + s], tk, tv, p,
                                           window=window))
            pos += s
        return torch.cat(outs, dim=1)

    a = run([96])
    assert torch.equal(a, run([32, 32, 32]))
    assert torch.equal(a, run([8, 40, 24, 24]))


def _counting(monkeypatch):
    """Replace the encoder's two attention entry points with counted
    passthroughs: {"flash": calls, "ring": calls}."""
    calls = {"flash": 0, "ring": 0}
    real_flash = enc_mod.flash_bulk_attention_batched
    real_ring = enc_mod.ring_attention

    def flash(*a, **k):
        calls["flash"] += 1
        return real_flash(*a, **k)

    def ring(*a, **k):
        calls["ring"] += 1
        return real_ring(*a, **k)

    monkeypatch.setattr(enc_mod, "flash_bulk_attention_batched", flash)
    monkeypatch.setattr(enc_mod, "ring_attention", ring)
    return calls


@pytest.mark.parametrize("impl,cdt,enc_kv,t,route", [
    ("auto", "bfloat16", "bfloat16", 8, "flash"),
    ("auto", "bfloat16", "float32", 8, "flash"),
    # float32 queries take the kernel's f32 instantiation
    ("auto", "float32", "float32", 8, "flash"),
    ("auto", "float32", "bfloat16", 8, "flash"),
    ("flash", "float32", "float32", 8, "flash"),
    # a byte-wide e4m3 ring: the kernel widens it as it loads it
    ("auto", "bfloat16", "float8_e4m3fn", 8, "flash"),
    ("xla", "bfloat16", "bfloat16", 8, "ring"),
    ("auto", "float32", "float32", 1, "ring"),  # T == 1: direct slot write
    # bf16 takes the row-invariant route (decoder._use_rowinv): a T == 1
    # chunk attends through the chunk path like any other chunk
    ("auto", "bfloat16", "bfloat16", 1, "flash"),
])
def test_encoder_attention_dispatch(monkeypatch, impl, cdt, enc_kv, t, route):
    """attn_impl "auto" takes the flash-encode wrapper for every chunk of
    T > 1 rows on a float ring of >= 2 bytes or an e4m3 ring, at any B and
    for bf16 and float32 queries alike, and for T == 1 chunks on the
    row-invariant route (bf16); "xla" and float32 T == 1 chunks take the
    plain ring_attention."""
    cfg = tiny_config(enc_kv_ring=64, compute_dtype=cdt).replace(
        enc_kv_dtype=enc_kv)
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  attn_impl=impl))
    encp = init_params(cfg, seed=0, device="cpu")["encoder"]
    calls = _counting(monkeypatch)
    for bsz in (1, 2):
        cache = enc_mod.EncKVCache.create(cfg.encoder, cfg.enc_kvdtype, 64,
                                          batch=bsz)
        x = torch.from_numpy(np.random.default_rng(bsz).standard_normal(
            (bsz, t, cfg.encoder.dim)).astype(np.float32))
        y, _ = enc_mod.encode_chunk(encp, cfg, x, cache, 3)
        assert y.shape == (bsz, t, cfg.encoder.dim)
        assert bool(torch.isfinite(y.float()).all())
    other = "ring" if route == "flash" else "flash"
    assert calls[route] == 2 * cfg.encoder.n_layers
    assert calls[other] == 0


@pytest.mark.parametrize("impl,cdt,route", [
    ("auto", "bfloat16", "kernel"),
    ("auto", "float32", "kernel"),
    ("flash", "float32", "kernel"),
    ("xla", "bfloat16", "plain"),
    ("xla", "float32", "plain"),
])
def test_bulk_encoder_attention_dispatch(monkeypatch, impl, cdt, route):
    """The bulk encoder's attn_impl follows the streaming encoder's rule
    (decoder._use_flash with no ring): "auto" and "flash" take the banded
    wrapper (the kernel for CUDA tensors) at both compute dtypes, "xla"
    banded_attention_plain; one call per layer (on the CPU the wrapper
    runs the plain version)."""
    from voxtral_tpu_torch.models import bulk_encode as bulk_mod

    cfg = tiny_config(compute_dtype=cdt)
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  attn_impl=impl))
    params = init_params(cfg, seed=0, device="cpu")
    calls = {"kernel": 0, "plain": 0}
    real_kernel = bulk_mod.banded_attention_batched
    real_plain = bulk_mod.banded_attention_plain

    def counted(tag, fn):
        def call(*a, **k):
            calls[tag] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(bulk_mod, "banded_attention_batched",
                        counted("kernel", real_kernel))
    monkeypatch.setattr(bulk_mod, "banded_attention_plain",
                        counted("plain", real_plain))
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 48, cfg.encoder.n_mel)).astype(np.float32))
    rows = bulk_mod.bulk_encode_clip(params["encoder"], params["adapter"],
                                     cfg, mel)
    assert rows.shape == (2, 6, cfg.decoder.dim)
    assert bool(torch.isfinite(rows).all())
    assert calls[route] == cfg.encoder.n_layers
    assert calls["plain" if route == "kernel" else "kernel"] == 0


def test_bulk_encoder_rejects_unknown_attn_impl():
    from voxtral_tpu_torch.models import bulk_encode as bulk_mod

    cfg = tiny_config()
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  attn_impl="sdpa"))
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        bulk_mod.bulk_encode_clip(params["encoder"], params["adapter"], cfg,
                                  torch.zeros((1, 16, cfg.encoder.n_mel)))


# --- the kernel's split walk (segments of ring blocks, combined in order) --

def test_segment_plan_depends_on_cap_only():
    """The plan takes cap and nothing else (B, T and the positions cannot
    change a row's rounding), splits the 1024-slot streaming ring into 4
    segments of 4 blocks, and never asks for more segments than blocks or
    than one cluster holds."""
    import inspect

    assert list(inspect.signature(flash_encode_segments).parameters) == ["cap"]
    assert flash_encode_segments(1024) == 4
    for cap in range(1, 3000):
        n_blocks = -(-cap // 64)
        s = flash_encode_segments(cap)
        assert 1 <= s <= min(MAX_SEGMENTS, n_blocks)
        assert s == flash_encode_segments(cap)


@pytest.mark.parametrize("case", [
    # (cap, window, pos0, t, segments): positions 0-40 in the first lap,
    # where the segments past pos_hi hold no written slot
    (512, 48, 0, 8, None),
    (512, 48, 17, 24, None),
    (512, 48, 40, 16, 3),
    # wraparound, a ragged segment split, GQA in every case
    (512, 300, 700, 40, None),
    (512, 300, 1000, 33, 5),
    # T > cap: the first rows' slots are overwritten, they see no key
    (64, 48, 0, 100, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_plain_and_pallas(case, dtype):
    """Segment partials in plain PyTorch, combined in segment order, give
    flash_encode_plain and the Pallas kernel (interpret mode): f32 within
    2e-5; bf16, where the probabilities round against the segment's max
    rather than the row's, within the kernels' 2e-2.  Rows that see no key
    are exactly 0 in all three."""
    cap, window, pos0, t, segments = case
    rng = np.random.default_rng(cap + pos0 + t)
    kh, g, d = 2, 2, 8
    _, _, (tk, tv), (jk, jv) = _rings(rng, pos0 + t, kh, cap, d)
    q = rng.standard_normal((t, kh * g, d)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tq, tk, tv = (x.to(tdt) for x in (torch.from_numpy(q)[None], tk, tv))
    p = torch.tensor([pos0])
    got = flash_encode_split_plain(tq, tk, tv, p, window=window,
                                   segments=segments, out_dtype=torch.float32)
    plain = flash_encode_plain(tq, tk, tv, p, window=window,
                               out_dtype=torch.float32)
    want = np.asarray(j_flash(jnp.asarray(q).astype(jdt), jk.astype(jdt),
                              jv.astype(jdt), jnp.int32(pos0), window=window,
                              block=64, bq=16).astype(jnp.float32))
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(), **tol)
    np.testing.assert_allclose(got[0].numpy(), want, **tol)
    dead = max(0, t - cap)      # rows whose own slot was overwritten
    if dead:
        assert not got[0, :dead].any() and not plain[0, :dead].any()
        assert not np.any(want[:dead])
    assert got[0, dead:].abs().amax(dim=(1, 2)).min() > 0


def test_split_plain_empty_segments_add_exactly_zero():
    """In the first lap the segments past pos_hi hold no written slot: the
    split over 8 segments equals the split over the segments that hold
    one, bit for bit, at every position 0-40."""
    rng = np.random.default_rng(5)
    cap, kh, d = 1024, 2, 8
    for pos0 in range(0, 41, 8):
        _, _, (tk, tv), _ = _rings(rng, pos0 + 24, kh, cap, d)
        q = torch.from_numpy(
            rng.standard_normal((1, 24, kh, d)).astype(np.float32))
        p = torch.tensor([pos0])
        a = flash_encode_split_plain(q, tk, tv, p, window=750, segments=8)
        # slots 0..127 form segment 0 of 8; the rest is never written
        b = flash_encode_split_plain(q, tk[:, :, :128], tv[:, :, :128], p,
                                     window=750, segments=1)
        assert torch.equal(a, b)


# --- ring_chunk_write against JAX (tests/test_batched.py's cases) ----------

def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _chunk_write_case(jdt, b, n_layers, kh, cap, d, t, pos, li, seed):
    """JAX batched (vmap: the blend, or the rotate for T > cap) and
    single-stream results, and the port's, for the same rings and chunk."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(
            jdt)

    k_all, v_all = arr(b, n_layers, kh, cap, d), arr(b, n_layers, kh, cap, d)
    k_c, v_c = arr(b, t, kh, d), arr(b, t, kh, d)
    jpos = jnp.asarray(pos, jnp.int32)
    batched = jax.vmap(j_chunk_write, in_axes=(0, 0, 0, 0, None, 0))(
        k_all, v_all, k_c, v_c, jnp.int32(li), jpos)
    single = [j_chunk_write(k_all[s], v_all[s], k_c[s], v_c[s],
                            jnp.int32(li), jpos[s]) for s in range(b)]
    tk, tv, tkc, tvc = (from_jax_numpy(np.asarray(x))
                        for x in (k_all, v_all, k_c, v_c))
    got = ring_chunk_write(tk, tv, tkc, tvc, li, torch.tensor(pos))
    assert got[0] is tk and got[1] is tv                  # in place
    assert got[2].data_ptr() == tk[:, li].data_ptr()      # views of layer li
    return batched, single, got


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16",
                                        "float8_e4m3fn"])
def test_ring_chunk_write_bit_equal_to_jax(dtype_name):
    jdt = jnp.dtype(dtype_name)
    win = _win(jdt)
    cap, t = 8 * win, 2 * win - 3
    pos = [0, 5, win - 1, cap - t + 1, cap - 1, 3 * cap + 7]
    batched, single, got = _chunk_write_case(jdt, 6, 3, 4, cap, 64, t, pos,
                                             2, 11)
    for j in range(4):
        # bit for bit against the single-stream rotate; against the blend
        # as values, as tests/test_batched.py compares them: its one-hot
        # sum turns a -0.0 row value (fp8 rounds tiny values to +-0) into
        # +0.0
        np.testing.assert_array_equal(
            _bits(got[j]), np.stack([_bits(s[j]) for s in single]))
        np.testing.assert_array_equal(
            got[j].float().numpy(),
            np.asarray(batched[j].astype(jnp.float32)))


@pytest.mark.parametrize("t", [5, 29])
def test_ring_chunk_write_tiny_cap_and_overflow(t):
    """cap 12: T=5 (the blend in JAX) and T=29 > cap (only the last cap
    rows survive), bit-equal to both JAX forms."""
    batched, single, got = _chunk_write_case(jnp.float32, 3, 2, 2, 12, 8, t,
                                             [0, 9, 23], 0, 13)
    for j in range(4):
        np.testing.assert_array_equal(_bits(got[j]), _bits(batched[j]))
        np.testing.assert_array_equal(
            _bits(got[j]), np.stack([_bits(s[j]) for s in single]))
