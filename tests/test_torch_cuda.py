"""Tests of the port that need an NVIDIA GPU: each hand-written CUDA kernel
against its plain PyTorch version at the full-width shapes, the wrappers'
refusals, and the offline, batched serving and streaming paths at reduced
depth.  They
skip without a card.  This file imports no JAX, so on the GPU machine (which has none) it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxtral_tpu_torch.config import full_config
from voxtral_tpu_torch.ops.banded_encode import (
    banded_attention_batched,
    banded_attention_plain,
)
from voxtral_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
from voxtral_tpu_torch.ops.flash_encode import (
    flash_bulk_attention_batched,
    flash_encode_plain,
    flash_encode_segments,
    flash_encode_split_plain,
)
from voxtral_tpu_torch.ops.quant_mm import int4_mm, int4_mm_plain
from voxtral_tpu_torch.ops.ring import ring_rows_write, ring_rows_write_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("t,kv_lo", [(1500, (0,)), (1013, (0,)),
                                     (777, (0, 300))])
def test_banded_kernel_matches_plain(dev, t, kv_lo):
    """Full-width encoder shape (H=KH=32, D=64, window 750), bf16 in, f32
    out: both versions round the probabilities to bf16 before the PV
    product, so they agree to bf16 resolution (2e-2 abs)."""
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (_randn(gen, (len(kv_lo), t, 32, 64), torch.bfloat16, dev)
               for _ in range(3))
    lo = torch.tensor(kv_lo, dtype=torch.int32, device=dev)
    n0 = banded_attention_batched.launches
    got = banded_attention_batched(q, k, v, lo, window=750,
                                   out_dtype=torch.float32)
    want = banded_attention_plain(q, k, v, lo, window=750,
                                  out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert banded_attention_batched.launches == n0 + 1
    assert (got - want).abs().max().item() <= 2e-2
    if kv_lo[-1]:   # rows that see no key are 0
        assert torch.equal(got[-1, : kv_lo[-1]],
                           torch.zeros_like(got[-1, : kv_lo[-1]]))


def _flash_case(dev, seed, bsz, cap, dtype, q_dtype=torch.float32,
                rows_scale=1.0):
    """Full-width decoder rings [B, 26, 8, cap, 128] of random rows, q
    [B, 32, 128] and f32 rows [B, 8, 128] (scaled by rows_scale)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kk = _randn(gen, (bsz, 26, 8, cap, 128), dtype, dev)
    vk = _randn(gen, (bsz, 26, 8, cap, 128), dtype, dev)
    q = _randn(gen, (bsz, 32, 128), q_dtype, dev)
    rows = tuple(_randn(gen, (bsz, 8, 128), torch.float32, dev) * rows_scale
                 for _ in range(2))
    return kk, vk, q, rows


def _bits(x):
    return x.view(torch.uint8)


def _check_flash(dev, kk, vk, q, rows, pos, window=8192,
                 out_dtype=torch.float32, tol=1e-4):
    """flash_decode against flash_decode_plain on copies of the rings:
    outputs within `tol`, rings bit for bit, one launch."""
    kp, vp = kk.clone(), vk.clone()
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    n0 = flash_decode.launches
    got = flash_decode(q, kk, vk, 25, p, *rows, window=window,
                       out_dtype=out_dtype)
    want = flash_decode_plain(q, kp, vp, 25, p, *rows, window=window,
                              out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    assert got.dtype == out_dtype and bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(_bits(kk), _bits(kp)) and torch.equal(_bits(vk),
                                                             _bits(vp))
    return got


@pytest.mark.parametrize("bsz,cap,pos", [(1, 896, [0]), (1, 896, [1019]),
                                         (3, 8192, [0, 4103, 16389])])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("write", [False, True])
def test_flash_decode_kernel_matches_plain(dev, bsz, cap, pos, dtype, write):
    """Full-width decoder shape (H=32, KH=8, D=128, L=26): the same output
    to f32 rounding (1e-4 abs), the same rings bit for bit."""
    kk, vk, q, rows = _flash_case(dev, cap + bsz, bsz, cap, dtype)
    _check_flash(dev, kk, vk, q, rows if write else (), pos)


@pytest.mark.parametrize("bsz,cap,pos,window", [
    (1, 512, [63], 8192),      # 8 splits of 64: the window is split 0 alone
    (1, 512, [64], 8192),      # one slot into split 1
    (1, 512, [511], 8192),     # every split full
    (1, 896, [2000], 64),      # window 64: one split, wrapped
    (1, 8192, [8191], 8192),   # the full 8192 window, 8 splits of 1024
    (1, 8192, [20000], 8192),  # the full window after wraparound
    (16, 896, [0, 63, 64, 447, 448, 895, 896, 1019]
     + [(97 * i) % (3 * 896) for i in range(8, 16)], 8192),  # B=16 mixed
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_flash_decode_kernel_split_edges(dev, bsz, cap, pos, window, dtype):
    """The split plan's edges (flash_decode_splits): windows ending at and
    one past a split's end, one split, the full window, B=16 with mixed
    positions; bf16 q and output as on the decode path, with the row
    write (2e-2: one bf16 step of outputs below 4, where the two versions'
    f32 results fall on either side of a rounding boundary)."""
    kk, vk, q, rows = _flash_case(dev, cap + pos[0], bsz, cap, dtype,
                                  q_dtype=torch.bfloat16)
    _check_flash(dev, kk, vk, q, rows, pos, window=window,
                 out_dtype=torch.bfloat16, tol=2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_flash_decode_kernel_saturates_fp8_rows(dev, dtype):
    """Rows up to |x| ~ 4000: the kernel casts them as to_ring_dtype does
    (fp8 saturates at +-448), stores them bit for bit as the plain version
    does and attends over the stored values."""
    kk, vk, q, rows = _flash_case(dev, 9, 3, 896, dtype, rows_scale=1000.0)
    pos = [0, 448, 896 + 123]
    _check_flash(dev, kk, vk, q, rows, pos, tol=1e-4 * 1000)
    if dtype == torch.float8_e4m3fn:
        assert kk[:, 25, :, [0, 448, 123]].float().abs().max().item() == 448.0


def test_flash_decode_kernel_reads_strided_rows(dev):
    """The new rows as the decoder passes them: v a slice of a wider
    product (3 x 8 x 128 elements between streams), read in place; the same
    output and rings as the plain version's."""
    kk, vk, q, (k_rows, v_rows) = _flash_case(dev, 5, 3, 896,
                                              torch.float8_e4m3fn,
                                              q_dtype=torch.bfloat16)
    wide = torch.zeros((3, 3, 8, 128), device=dev)
    wide[:, 2] = v_rows
    assert not wide[:, 2].is_contiguous()
    _check_flash(dev, kk, vk, q, (k_rows, wide[:, 2]), [0, 448, 1019])


@pytest.mark.parametrize("bsz,cap,dtype", [(1, 8192, torch.bfloat16),
                                           (16, 896, torch.float8_e4m3fn)])
def test_flash_decode_kernel_deterministic(dev, bsz, cap, dtype):
    """Two calls give the same output bit for bit: the splits' partials are
    folded in split order (attend only, and write + attend on two copies
    of the rings)."""
    kk, vk, q, rows = _flash_case(dev, 11, bsz, cap, dtype,
                                  q_dtype=torch.bfloat16)
    pos = [10000] if bsz == 1 else [(4099 * i + 700) % (2 * cap)
                                    for i in range(bsz)]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(window=8192, out_dtype=torch.float32)
    a = flash_decode(q, kk, vk, 25, p, **kw)
    b = flash_decode(q, kk, vk, 25, p, **kw)
    k2, v2 = kk.clone(), vk.clone()
    c = flash_decode(q, kk, vk, 25, p, *rows, **kw)
    d = flash_decode(q, k2, v2, 25, p, *rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)
    assert torch.equal(_bits(kk), _bits(k2))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 16, 4, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        banded_attention_batched(q, q, q, window=8)
    with pytest.raises(ValueError, match="bf16 or f32"):
        banded_attention_batched(q.half(), q.half(), q.half(), window=8)
    # fp8 rings are taken; other ring types, D != 128 and non-contiguous
    # caches are not
    q = torch.zeros((1, 32, 128), device=dev)
    p = torch.tensor([3], device=dev)
    ring = torch.zeros((1, 2, 8, 64, 128), device=dev)
    f8 = ring.to(torch.float8_e4m3fn)
    out = flash_decode(q, f8, f8, 0, p, window=64)
    torch.cuda.synchronize()
    assert out.shape == q.shape and not out.any()
    with pytest.raises(ValueError, match="rings"):
        flash_decode(q, ring.half(), ring.half(), 0, p, window=64)
    with pytest.raises(ValueError, match="rings"):
        flash_decode(q, ring.to(torch.float8_e5m2),
                     ring.to(torch.float8_e5m2), 0, p, window=64)
    with pytest.raises(ValueError, match="D=64"):
        flash_decode(q[..., :64].contiguous(), ring[..., :64].contiguous(),
                     ring[..., :64].contiguous(), 0, p, window=64)
    with pytest.raises(ValueError, match="contiguous"):
        r2 = ring.transpose(3, 4)
        flash_decode(q, r2, r2, 0, p, window=64)
    with pytest.raises(ValueError, match="bf16 or f32"):
        flash_decode(q.half(), ring, ring, 0, p, window=64)
    with pytest.raises(ValueError, match="k_rows"):
        rows = torch.zeros((1, 8, 128), dtype=torch.float16, device=dev)
        flash_decode(q, f8, f8, 0, p, rows, rows, window=64)


def test_offline_path_at_reduced_depth(dev):
    """Full widths, 2 encoder and 2 decoder layers, bf16: the offline path
    launches each kernel where it should, and the encoder's adapter rows
    agree with the same weights run through the plain versions on the
    CPU."""
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import (
        padded_clip_mel,
        transcribe_offline_ids,
    )

    cfg = full_config()
    cfg = cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, n_layers=2),
        decoder=dataclasses.replace(cfg.decoder, n_layers=2))
    params = init_params(cfg, seed=0, device=dev)
    engine = VoxtralEngine(cfg, params, dec_kv_ring=256)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(16000)).astype(np.float32)

    banded_attention_batched.launches = 0
    flash_decode.launches = 0
    stats = {}
    ids = transcribe_offline_ids(engine, audio, timings=stats)
    assert stats["adapter_finite"]
    assert all(0 <= t < cfg.decoder.vocab_size for t in ids)
    assert banded_attention_batched.launches == 2
    assert flash_decode.launches == 2 * stats["decode_steps"]

    mel = padded_clip_mel(engine, audio)[None]
    rows = engine.encode_clip_bulk(mel).cpu()
    cpu_params = {g: {k: (v.cpu() if isinstance(v, torch.Tensor)
                          else {kk: vv.cpu() for kk, vv in v.items()})
                      for k, v in grp.items()}
                  for g, grp in params.items()}
    cpu_engine = VoxtralEngine(cfg, cpu_params, dec_kv_ring=256)
    want = cpu_engine.encode_clip_bulk(mel)
    rel = ((rows - want).abs().max() / want.abs().max()).item()
    assert rel <= 5e-2, rel


# full-width int4 matrices: (out, in) of the decoder's four layer weights
# and the tied logits table
INT4_SHAPES = {"wqkv": (6144, 3072), "wo": (3072, 4096),
               "w13": (18432, 3072), "w2": (3072, 9216),
               "logits": (131072, 3072)}


@pytest.mark.parametrize("rows", [1, 16, 608])
@pytest.mark.parametrize("name", list(INT4_SHAPES))
def test_int4_kernel_matches_plain(dev, name, rows):
    """bf16 x against nibble-packed weights (layer 1 of a 2-layer stack,
    one layer for the table): the products are exact, only the f32
    summation order differs, so max abs error <= 1e-5 x max |plain|
    (chip_smoke.py's INT4_REL_TOL)."""
    from voxtral_tpu_torch.models.quant import quantize_layer_stack

    out_dim, in_dim = INT4_SHAPES[name]
    n_layers = 1 if name == "logits" else 2
    gen = torch.Generator(device=dev).manual_seed(out_dim + rows)
    w = _randn(gen, (n_layers, out_dim, in_dim), torch.bfloat16, dev)
    q = quantize_layer_stack({"wqkv": w}, bits=4)
    p, s = q["wqkv"], q["wqkv_scale"]
    del w, q
    x = _randn(gen, (rows, in_dim), torch.bfloat16, dev)
    li = n_layers - 1
    n0 = int4_mm.launches
    got = int4_mm(x, p, s, li)
    want = int4_mm_plain(x, p, s, li)
    torch.cuda.synchronize()
    assert int4_mm.launches == n0 + 1
    assert got.shape == (rows, out_dim) and got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("rows", [5, 40])
def test_int4_kernel_ragged_edges(dev, rows):
    """Rows, columns and the packed K range all off the kernel's tiles
    (out 200, packed 1552 = 24 x 64 + 16), with and without K splits."""
    from voxtral_tpu_torch.models.quant import quantize_layer_stack

    gen = torch.Generator(device=dev).manual_seed(rows)
    w = _randn(gen, (1, 200, 3104), torch.bfloat16, dev)
    q = quantize_layer_stack({"wqkv": w}, bits=4)
    x = _randn(gen, (rows, 3104), torch.bfloat16, dev)
    got = int4_mm(x, q["wqkv"], q["wqkv_scale"], 0)
    want = int4_mm_plain(x, q["wqkv"], q["wqkv_scale"], 0)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.bfloat16,
                                   torch.float32])
def test_ring_rows_write_kernel_bit_equal(dev, dtype):
    """Full-width rings [3, 26, 8, 896, 128]: positions 0, mid-ring and
    wrapped; rows up to |x| ~ 4000, so fp8 saturates.  The rings are bit
    for bit those of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (3, 26, 8, 896, 128)
    kk = _randn(gen, shape, torch.float32, dev).to(dtype)
    vk = _randn(gen, shape, torch.float32, dev).to(dtype)
    kp, vp = kk.clone(), vk.clone()
    k_rows = _randn(gen, (3, 8, 128), torch.float32, dev) * 1000.0
    v_rows = _randn(gen, (3, 8, 128), torch.float32, dev)
    pos = torch.tensor([0, 448, 896 + 123], device=dev)
    n0 = ring_rows_write.launches
    ring_rows_write(kk, vk, k_rows, v_rows, 25, pos)
    ring_rows_write_plain(kp, vp, k_rows, v_rows, 25, pos)
    torch.cuda.synchronize()
    assert ring_rows_write.launches == n0 + 1
    assert torch.equal(kk.view(torch.uint8), kp.view(torch.uint8))
    assert torch.equal(vk.view(torch.uint8), vp.view(torch.uint8))
    if dtype == torch.float8_e4m3fn:
        assert kk[:, 25, :, [0, 448, 123]].float().abs().max().item() == 448.0


def test_int4_and_rows_wrappers_refuse(dev):
    p = torch.zeros((2, 64, 64), dtype=torch.int8, device=dev)
    s = torch.ones((2, 64, 2), device=dev)
    x = torch.zeros((4, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        int4_mm(x.float(), p, s, 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        int4_mm(x[:, :100], p[..., :50].contiguous(), s, 0)
    with pytest.raises(ValueError, match="contiguous"):
        int4_mm(torch.zeros((128, 4), dtype=torch.bfloat16, device=dev).t(),
                p, s, 0)
    with pytest.raises(ValueError, match="layer"):
        int4_mm(x, p, s, 2)
    ring = torch.zeros((2, 3, 8, 64, 128), device=dev)
    rows = torch.zeros((2, 8, 128), device=dev)
    pos = torch.tensor([1, 70], device=dev)
    with pytest.raises(ValueError, match="rings"):
        ring_rows_write(ring.half(), ring.half(), rows, rows, 0, pos)
    with pytest.raises(ValueError, match="f32"):
        ring_rows_write(ring, ring, rows.bfloat16(), rows.bfloat16(), 0, pos)
    with pytest.raises(ValueError, match="contiguous"):
        r2 = ring.transpose(3, 4)
        ring_rows_write(r2, r2, rows, rows, 0, pos)
    with pytest.raises(ValueError, match="head_dim"):
        r3 = torch.zeros((2, 3, 8, 64, 12), device=dev)
        ring_rows_write(r3, r3, rows[..., :12].contiguous(),
                        rows[..., :12].contiguous(), 0, pos)


# rows that cross every tile boundary of the int4 kernel's plans (16-, 32-
# and 64-row tiles) up to 64 and past it, and the prefill shapes of B=16
# and B=32 (38 rows a stream)
INT4_ROWS = (1, 2, 7, 8, 9, 15, 16, 17, 24, 31, 32, 33, 40, 47, 48, 49, 63,
             64, 65, 96, 127, 128, 129, 608, 1216)


@pytest.fixture(scope="module")
def int4_stacks():
    """Layer 25 of a 26-layer wo stack (3072 x 4096: split K at decode) and
    the ragged one-layer [200, 3104] (packed 1552 = 24 x 64 + 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from voxtral_tpu_torch.models.quant import quantize_layer_stack

    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for name, (n_layers, out_dim, in_dim) in (("wo26", (26, 3072, 4096)),
                                              ("ragged", (1, 200, 3104))):
        w = _randn(gen, (n_layers, out_dim, in_dim), torch.bfloat16, "cuda")
        q = quantize_layer_stack({"wqkv": w}, bits=4)
        out[name] = (q["wqkv"], q["wqkv_scale"], n_layers - 1)
        del w, q
    return out


@pytest.mark.parametrize("rows", INT4_ROWS)
@pytest.mark.parametrize("name", ["wo26", "ragged"])
def test_int4_kernel_rows_sweep(dev, int4_stacks, name, rows):
    """Every row count's plan (tile width, K split over a cluster, tiles
    walked by fewer clusters) against the plain version, 1e-5 x max
    |plain|, one launch; a second call is bitwise equal."""
    p, s, li = int4_stacks[name]
    gen = torch.Generator(device=dev).manual_seed(rows)
    x = _randn(gen, (rows, 2 * p.shape[-1]), torch.bfloat16, dev)
    n0 = int4_mm.launches
    got = int4_mm(x, p, s, li)
    again = int4_mm(x, p, s, li)
    want = int4_mm_plain(x, p, s, li)
    torch.cuda.synchronize()
    assert int4_mm.launches == n0 + 2
    assert torch.equal(got, again)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("rows", [16, 608])
@pytest.mark.parametrize("name", list(INT4_SHAPES))
def test_int4_kernel_bitwise_repeatable(dev, name, rows):
    """The full-width products at the decode and prefill row counts: two
    calls give the same bits (the K split folds in rank order)."""
    from voxtral_tpu_torch.models.quant import quantize_layer_stack

    out_dim, in_dim = INT4_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(in_dim + rows)
    w = _randn(gen, (1, out_dim, in_dim), torch.bfloat16, dev)
    q = quantize_layer_stack({"wqkv": w}, bits=4)
    del w
    x = _randn(gen, (rows, in_dim), torch.bfloat16, dev)
    a = int4_mm(x, q["wqkv"], q["wqkv_scale"], 0)
    b = int4_mm(x, q["wqkv"], q["wqkv_scale"], 0)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [5, 40, 100, 129])
@pytest.mark.parametrize("nj,cs,clusters", [(2, 1, 1), (2, 5, 2), (4, 1, 3),
                                            (4, 8, 1), (16, 1, 1),
                                            (16, 1, 2)])
def test_int4_kernel_every_tile_on_ragged_edges(dev, int4_stacks, nj, cs,
                                                clusters, rows):
    """Each tile of the kernel forced onto the ragged [200, 3104] product
    (the plan would give it another): the decode tiles with and without a
    K split, the wgmma prefill tile, with clusters that walk several tiles
    each; against the plain version, 1e-5 x max |plain|."""
    from voxtral_tpu_torch.ops import cuda_lib

    p, s, li = int4_stacks["ragged"]
    gen = torch.Generator(device=dev).manual_seed(rows)
    x = _randn(gen, (rows, 2 * p.shape[-1]), torch.bfloat16, dev)
    got = torch.full((rows, p.shape[1]), float("nan"), device=dev)
    cuda_lib.check(cuda_lib.kernels().vt_int4_mm(
        x.data_ptr(), p.data_ptr(), s.data_ptr(), got.data_ptr(), rows,
        p.shape[1], p.shape[-1], li, nj, cs, clusters,
        cuda_lib.stream_handle(dev)), "int4_mm")
    want = int4_mm_plain(x, p, s, li)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("nj,cs", [(2, 1), (2, 8), (4, 1), (4, 8), (16, 1)])
def test_int4_plan_residency_fits_the_card(dev, nj, cs):
    """The plan's blocks per SM (it launches at most that many a SM) are no
    more than the card's occupancy query gives for the kernel."""
    from voxtral_tpu_torch.ops import cuda_lib
    from voxtral_tpu_torch.ops.quant_mm import int4_mm_blocks_per_sm

    got = cuda_lib.kernels().vt_int4_mm_occupancy(nj, cs)
    assert got >= int4_mm_blocks_per_sm(nj, cs) >= 1, got


@pytest.mark.parametrize("bsz", [1, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.bfloat16,
                                   torch.float32])
def test_ring_rows_write_kernel_bit_equal_batches(dev, dtype, bsz):
    """Rings [B, 26, 8, 160, 128] at B = 1, 16, 64: positions 0, mid-ring,
    wrapped and spread; rows up to |x| ~ 4000 on every other stream, so fp8
    saturates; layers 0 and 25.  Rings bit for bit those of plain."""
    gen = torch.Generator(device=dev).manual_seed(bsz)
    cap = 160
    shape = (bsz, 26, 8, cap, 128)
    kk = _randn(gen, shape, torch.float32, dev).to(dtype)
    vk = _randn(gen, shape, torch.float32, dev).to(dtype)
    kp, vp = kk.clone(), vk.clone()
    k_rows = _randn(gen, (bsz, 8, 128), torch.float32, dev)
    v_rows = _randn(gen, (bsz, 8, 128), torch.float32, dev)
    k_rows[::2] *= 1000.0
    v_rows[1::2] *= 1000.0
    pos = torch.tensor([(0, cap // 2, cap + 7)[i] if i < 3 else 37 * i
                        for i in range(bsz)], device=dev)
    n0 = ring_rows_write.launches
    for li in (0, 25):
        ring_rows_write(kk, vk, k_rows, v_rows, li, pos)
        ring_rows_write_plain(kp, vp, k_rows, v_rows, li, pos)
    torch.cuda.synchronize()
    assert ring_rows_write.launches == n0 + 2
    assert torch.equal(kk.view(torch.uint8), kp.view(torch.uint8))
    assert torch.equal(vk.view(torch.uint8), vp.view(torch.uint8))


def test_ring_rows_write_reads_offset_rows(dev):
    """Rows that are a contiguous view starting 4 bytes off a 16-byte
    boundary (the kernel's loads are 16 bytes) are written as plain does."""
    gen = torch.Generator(device=dev).manual_seed(5)
    kk = _randn(gen, (1, 2, 8, 64, 128), torch.float32, dev).bfloat16()
    vk, kp, vp = kk.clone(), kk.clone(), kk.clone()
    buf = _randn(gen, (1 + 2 * 8 * 128,), torch.float32, dev)
    k_rows = buf[1: 1 + 1024].view(1, 8, 128)
    v_rows = buf[1 + 1024:].view(1, 8, 128)
    pos = torch.tensor([70], device=dev)
    ring_rows_write(kk, vk, k_rows, v_rows, 1, pos)
    ring_rows_write_plain(kp, vp, k_rows, v_rows, 1, pos)
    torch.cuda.synchronize()
    assert torch.equal(kk, kp) and torch.equal(vk, vp)


def test_int4_fp8_serving_at_reduced_depth(dev):
    """Full widths, 2 encoder and 2 decoder layers, int4 decoder and fp8
    rings, B=2: bulk encode, batched prefill and decode bursts launch every
    kernel exactly where they should (flash-decode on every decode step,
    the fp8 rings included)."""
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.parallel import serving as sv
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine, decompose
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    cfg = full_config(kv_dtype="float8_e4m3fn", enc_kv_dtype="bfloat16")
    cfg = cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, n_layers=2),
        decoder=dataclasses.replace(cfg.decoder, n_layers=2))
    engine = VoxtralEngine(cfg, init_params(cfg, seed=0, device=dev),
                           dec_kv_ring=256, quantize="int4")
    rng = np.random.default_rng(0)
    mel = np.stack([padded_clip_mel(engine, (0.1 * rng.standard_normal(
        16000)).astype(np.float32)) for _ in range(2)])
    for fn in (banded_attention_batched, flash_decode, int4_mm,
               ring_rows_write):
        fn.launches = 0
    rows = engine.encode_clips_bulk(mel)
    assert bool(torch.isfinite(rows).all())
    plen = engine.prompt_len
    cache = sv.batched_dec_cache(cfg, 2, engine.dec_kv_ring, device=dev)
    sv.bprefill(engine.params["decoder"], cfg,
                engine.prompt_embeds(rows[:, : plen - 1]), cache,
                torch.zeros(2, dtype=torch.int32, device=dev), engine.ada())
    prev = torch.full((2,), 32, dtype=torch.int32, device=dev)
    pos, steps = plen - 1, 0
    for b in decompose(rows.shape[1] - pos, (64, 16, 4, 1)):
        toks, _, _, _, cache = sv.bdecode_burst(
            engine.params["decoder"], cfg, rows[:, pos: pos + b], prev,
            cache, torch.full((2,), pos, dtype=torch.int32, device=dev),
            engine.ada())
        prev, pos, steps = toks[:, -1], pos + b, steps + b
    torch.cuda.synchronize()
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.decoder.vocab_size
    assert banded_attention_batched.launches == 2
    assert flash_decode.launches == 2 * steps     # fp8 rings take the kernel
    assert ring_rows_write.launches == 0
    assert int4_mm.launches == 2 * 4 + (2 * 4 + 1) * steps


def _enc_rings(gen, bsz, cap, dtype, dev, n_layers=3):
    """Stacked encoder caches [B, L, 32, cap, 64] of random rows."""
    shape = (bsz, n_layers, 32, cap, 64)
    return (_randn(gen, shape, dtype, dev), _randn(gen, shape, dtype, dev))


@pytest.mark.parametrize("bsz,t,pos", [
    (1, 4, [0]), (1, 100, [300]), (1, 274, [5000]), (1, 64, [1020]),
    (3, 64, [0, 300, 5000]), (3, 256, [17, 750, 4099])])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_encode_kernel_matches_plain(dev, bsz, t, pos, dtype):
    """Full-width encoder shape (H=KH=32, D=64, cap 1024, window 750),
    layer 2 of a stacked cache read in place through its view: both
    versions round the probabilities to bf16 before the PV product, the
    kernel against its running max and the plain one against the row max,
    so they agree to bf16 resolution (2e-2 abs, chip_smoke.py's
    FLASH_ENC_TOL)."""
    gen = torch.Generator(device=dev).manual_seed(t + bsz)
    k_all, v_all = _enc_rings(gen, bsz, 1024, dtype, dev)
    q = _randn(gen, (bsz, t, 32, 64), torch.bfloat16, dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    n0 = flash_bulk_attention_batched.launches
    got = flash_bulk_attention_batched(q, k_all[:, 2], v_all[:, 2], p,
                                       window=750, out_dtype=torch.float32)
    want = flash_encode_plain(q, k_all[:, 2], v_all[:, 2], p, window=750,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert flash_bulk_attention_batched.launches == n0 + 1
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-2


def test_flash_encode_kernel_chunking_invariant_bitwise(dev):
    """After 800 positions, 256 more written and attended as [256],
    [64] * 4 and [100, 100, 56]: the kernel's outputs are bit-identical
    (it walks the ring in absolute slot order)."""
    from voxtral_tpu_torch.ops.ring import ring_write

    gen = torch.Generator(device=dev).manual_seed(5)
    n0, n = 800, 256
    kv = _randn(gen, (1, n0 + n, 32, 64), torch.bfloat16, dev)
    vv = _randn(gen, (1, n0 + n, 32, 64), torch.bfloat16, dev)
    qq = _randn(gen, (1, n, 32, 64), torch.bfloat16, dev)

    def run(sizes):
        k, v = (torch.zeros((1, 32, 1024, 64), dtype=torch.bfloat16,
                            device=dev) for _ in range(2))
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        ring_write(k, kv[:, :n0], zero)
        ring_write(v, vv[:, :n0], zero)
        outs, at = [], 0
        for s in sizes:
            p = torch.full((1,), n0 + at, dtype=torch.int32, device=dev)
            ring_write(k, kv[:, n0 + at: n0 + at + s], p)
            ring_write(v, vv[:, n0 + at: n0 + at + s], p)
            outs.append(flash_bulk_attention_batched(
                qq[:, at: at + s], k, v, p, window=750))
            at += s
        return torch.cat(outs, dim=1)

    a = run([256])
    assert torch.equal(a, run([64] * 4))
    assert torch.equal(a, run([100, 100, 56]))


def test_flash_encode_wrapper_refuses(dev):
    q = torch.zeros((1, 8, 32, 64), dtype=torch.bfloat16, device=dev)
    ring = torch.zeros((1, 32, 128, 64), dtype=torch.bfloat16, device=dev)
    p = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bf16 or f32"):
        flash_bulk_attention_batched(q.half(), ring, ring, p, window=750)
    f8 = ring.to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="rings"):
        flash_bulk_attention_batched(q, f8, f8, p, window=750)
    with pytest.raises(ValueError, match="head_dim"):
        flash_bulk_attention_batched(q[..., :32], ring[..., :32],
                                     ring[..., :32], p, window=750)


def test_streaming_paths_at_reduced_depth(dev):
    """Full widths, 2 encoder and 2 decoder layers, bf16, encoder ring
    1024: VoxStream (fused and bucketed) and BatchedTranscriber at B=2
    launch flash-encode once per layer for every encoder chunk of T > 1
    and flash-decode once per layer per decode step; the streams give ids
    in range."""
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.parallel.serving import BatchedTranscriber
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel
    from voxtral_tpu_torch.runtime.stream import VoxStream
    from voxtral_tpu_torch.tokenizer import TekkenTokenizer

    cfg = full_config()
    cfg = cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, n_layers=2),
        decoder=dataclasses.replace(cfg.decoder, n_layers=2))
    params = init_params(cfg, seed=0, device=dev)
    tok = TekkenTokenizer([bytes([i % 256]) for i in range(131072 - 1000)],
                          1000)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(3 * 16000)).astype(np.float32)
    for fused in (True, False):
        engine = VoxtralEngine(cfg, params, tokenizer=tok, dec_kv_ring=256,
                               buckets=(64, 16, 4, 1), fused_streaming=fused)
        assert engine.enc_kv_ring == 1024
        flash_bulk_attention_batched.launches = 0
        flash_decode.launches = 0
        s = VoxStream(engine)
        s.record_ids = True
        for i in range(0, len(audio), 16000):
            s.feed(audio[i: i + 16000])
        s.finish()
        torch.cuda.synchronize()
        assert s.n_enc_chunk_calls > 0 and s.n_decode_steps > 0
        assert flash_bulk_attention_batched.launches == 2 * s.n_enc_chunk_calls
        assert flash_decode.launches == 2 * s.n_decode_steps
        assert all(0 <= t < cfg.decoder.vocab_size for t in s.generated_ids)
    flash_bulk_attention_batched.launches = 0
    flash_decode.launches = 0
    tr = BatchedTranscriber(engine, batch=2, dec_kv_ring=256)
    mel = np.stack([padded_clip_mel(engine, audio)] * 2)
    toks = tr.transcribe(mel, interval_frames=200)
    torch.cuda.synchronize()
    assert flash_bulk_attention_batched.launches == 2 * tr.n_enc_chunk_calls
    assert flash_decode.launches == 2 * tr.decode_steps
    assert toks[0] == toks[1]           # two copies of one clip


# --- the two kernels on the shared Hopper attention tile -------------------

@pytest.mark.parametrize("bsz,t,kh,window,kv_lo", [
    (2, 333, 8, 100, (0, 150)),    # GQA 4, ragged T, kv_lo > 0, a narrow
                                   # band: tiles inside it and at its edges
    (1, 1500, 32, 750, (0,)),      # the 30 s clip
    (2, 200, 32, 750, (0, 250)),   # kv_lo past T: a stream that sees nothing
])
def test_banded_kernel_edges_and_gqa(dev, bsz, t, kh, window, kv_lo):
    gen = torch.Generator(device=dev).manual_seed(t + kh)
    q = _randn(gen, (bsz, t, 32, 64), torch.bfloat16, dev)
    k, v = (_randn(gen, (bsz, t, kh, 64), torch.bfloat16, dev)
            for _ in range(2))
    lo = torch.tensor(kv_lo, dtype=torch.int32, device=dev)
    got = banded_attention_batched(q, k, v, lo, window=window,
                                   out_dtype=torch.float32)
    want = banded_attention_plain(q, k, v, lo, window=window,
                                  out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-2
    for i, first in enumerate(kv_lo):   # rows before kv_lo see no key: 0
        assert not got[i, :first].any()


@pytest.mark.parametrize("bsz,t,cap,kh,pos,dtype", [
    # positions 0-40 in the first lap: most segments hold no written slot
    (1, 41, 1024, 32, [0], torch.bfloat16),
    (2, 24, 1024, 32, [17, 40], torch.float32),
    # cap not a multiple of 64, GQA 4, wrapped
    (1, 100, 1000, 8, [2000], torch.bfloat16),
    (3, 64, 1000, 32, [0, 500, 3000], torch.float32),
    # T > cap: the first rows' slots were overwritten, they see no key
    (2, 300, 200, 32, [0, 50], torch.bfloat16),
    # three ring blocks, the last one ragged
    (1, 64, 130, 32, [17], torch.float32),
])
def test_flash_encode_kernel_edges_and_split(dev, bsz, t, cap, kh, pos,
                                             dtype):
    """Against the plain version and the plain model of the kernel's split
    (flash_encode_split_plain, the same segment plan), 2e-2; rows that see
    no key are exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(t + cap)
    shape = (bsz, 2, kh, cap, 64)
    k_all, v_all = (_randn(gen, shape, dtype, dev) for _ in range(2))
    q = _randn(gen, (bsz, t, 32, 64), torch.bfloat16, dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(window=750, out_dtype=torch.float32)
    got = flash_bulk_attention_batched(q, k_all[:, 1], v_all[:, 1], p, **kw)
    want = flash_encode_plain(q, k_all[:, 1], v_all[:, 1], p, **kw)
    split = flash_encode_split_plain(q, k_all[:, 1], v_all[:, 1], p, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-2
    assert (got - split).abs().max().item() <= 2e-2
    dead = max(0, t - cap)      # rows at or before pos_hi - cap
    assert not got[:, :dead].any() and not want[:, :dead].any()


def test_flash_encode_kernel_chunking_invariant_bitwise_b16(dev):
    """B=16, the walk split into flash_encode_segments(1024) = 4 segments:
    after 800 positions, 256 more written and attended as [256], [64] * 4
    and [100, 100, 56] give bit-identical outputs, whichever way the
    segments are mapped to blocks."""
    from voxtral_tpu_torch.ops.ring import ring_chunk_write

    assert flash_encode_segments(1024) == 4
    gen = torch.Generator(device=dev).manual_seed(64)
    bsz, n0, n = 16, 800, 256
    kv = _randn(gen, (bsz, n0 + n, 32, 64), torch.bfloat16, dev)
    vv = _randn(gen, (bsz, n0 + n, 32, 64), torch.bfloat16, dev)
    qq = _randn(gen, (bsz, n, 32, 64), torch.bfloat16, dev)

    def run(sizes, split=None):
        k_all, v_all = (torch.zeros((bsz, 2, 32, 1024, 64),
                                    dtype=torch.bfloat16, device=dev)
                        for _ in range(2))
        zero = torch.zeros(bsz, dtype=torch.int32, device=dev)
        ring_chunk_write(k_all, v_all, kv[:, :n0], vv[:, :n0], 1, zero)
        outs, at = [], 0
        for s in sizes:
            p = torch.full((bsz,), n0 + at, dtype=torch.int32, device=dev)
            _, _, kr, vr = ring_chunk_write(
                k_all, v_all, kv[:, n0 + at: n0 + at + s],
                vv[:, n0 + at: n0 + at + s], 1, p)
            outs.append(flash_bulk_attention_batched(
                qq[:, at: at + s], kr, vr, p, window=750, split=split))
            at += s
        return torch.cat(outs, dim=1)

    a = run([256])
    assert torch.equal(a, run([64] * 4))
    assert torch.equal(a, run([100, 100, 56]))
    assert torch.equal(a, run([64] * 4, split=True))
    assert torch.equal(a, run([256], split=False))


def test_tile_wrappers_refuse(dev):
    q = torch.zeros((1, 8, 32, 64), dtype=torch.bfloat16, device=dev)
    ring = torch.zeros((1, 32, 128, 64), dtype=torch.bfloat16, device=dev)
    p = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shapes"):        # H % KH != 0
        banded_attention_batched(q, q[:, :, :5], q[:, :, :5], window=8)
    with pytest.raises(ValueError, match="out_dtype"):
        banded_attention_batched(q, q, q, window=8, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="out_dtype"):
        flash_bulk_attention_batched(q, ring, ring, p, window=750,
                                     out_dtype=torch.float16)
    flat = torch.zeros(ring.numel() + 1, dtype=torch.bfloat16, device=dev)
    odd = flat[1:].view(ring.shape)                         # 2-byte offset
    with pytest.raises(ValueError, match="aligned"):
        flash_bulk_attention_batched(q, odd, odd, p, window=750)


@pytest.mark.parametrize("bsz,t,cap,pos,dtype", [
    (1, 100, 1024, [2000], torch.bfloat16),
    (16, 64, 1024, None, torch.bfloat16),
    (1, 41, 1024, [0], torch.float32),         # first lap: empty segments
    (3, 100, 1000, [0, 500, 3000], torch.bfloat16),
    (2, 300, 200, [0, 50], torch.float32),     # rows that see no key
])
def test_flash_encode_split_mappings_bitwise_equal(dev, bsz, t, cap, pos,
                                                   dtype):
    """One block per segment (a cluster folding through distributed shared
    memory) and one block walking every segment (folding in shared memory)
    give the same output bit for bit, and the default is one of them."""
    gen = torch.Generator(device=dev).manual_seed(t + cap)
    shape = (bsz, 2, 32, cap, 64)
    k_all, v_all = (_randn(gen, shape, dtype, dev) for _ in range(2))
    q = _randn(gen, (bsz, t, 32, 64), torch.bfloat16, dev)
    pos = pos or [(97 * i) % 3000 for i in range(bsz)]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    outs = [flash_bulk_attention_batched(q, k_all[:, 1], v_all[:, 1], p,
                                         window=750, split=split)
            for split in (None, True, False)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])


# --- Jacobi decoding and the StreamPool on the card -------------------------

def test_banded_kernel_at_the_window_pool_shape(dev):
    """#1 at the window-mode pool's tick: B=32 slots of 752 context rows +
    100 new ones, each slot hiding its own stale context (kv_lo 0 to
    752), against the plain version one slot at a time."""
    gen = torch.Generator(device=dev).manual_seed(32)
    kv_lo = [(0, 300, 752, 0, 100)[i % 5] for i in range(32)]
    q, k, v = (_randn(gen, (32, 852, 32, 64), torch.bfloat16, dev)
               for _ in range(3))
    lo = torch.tensor(kv_lo, dtype=torch.int32, device=dev)
    got = banded_attention_batched(q, k, v, lo, window=750,
                                   out_dtype=torch.float32)
    want = torch.cat([banded_attention_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], lo[i:i + 1], window=750,
        out_dtype=torch.float32) for i in range(32)])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-2
    for i, first in enumerate(kv_lo):
        assert not got[i, :first].any()


@pytest.mark.parametrize("t,window", [(64, 64), (96, 32)])
def test_jacobi_equals_sequential_f32(dev, t, window):
    """Jacobi against the sequential burst in f32 on the card (the
    sequential steps through flash-decode, the Jacobi windows through the
    plain ring path): equal ids, or a first difference at a near-tie
    (chip_smoke.jacobi_vs_sequential, JACOBI_TIE_REL)."""
    import chip_smoke as cs
    from voxtral_tpu_torch.models.decoder import ada_scales
    from voxtral_tpu_torch.models.params import init_params

    cfg = cs.small_config("float32")
    params = init_params(cfg, seed=0, device=dev)
    rows = (torch.randn((1, t, cfg.decoder.dim),
                        generator=torch.Generator().manual_seed(t)) * 0.5)
    flash_decode.launches = 0
    res = cs.jacobi_vs_sequential(params, cfg, rows.to(dev),
                                  ada_scales(params["decoder"], cfg), window)
    assert flash_decode.launches >= cfg.decoder.n_layers * t
    assert res["iters"] >= t // window
    assert res["first_diff"] is None or res["near_tie"], res


def _pool_ticks(engine, mode, audios, ticks):
    """A 4-slot pool fed 0.5 s per slot per tick: each tick's new ids per
    slot, and the pool."""
    from voxtral_tpu_torch.parallel.scheduler import StreamPool

    pool = StreamPool(engine, 4, dec_kv_ring=256, enc_mode=mode)
    pool.record_ids = True
    for _ in audios:
        i = pool.add_stream()
        pool.set_processing_interval(i, 0.4)
        pool.set_continuous(i, True)
    out = []
    for ti in range(ticks):
        for i, a in enumerate(audios):
            pool.feed(i, a[ti * 8000: (ti + 1) * 8000])
        seen = [len(s.generated_ids) for s in pool.slots]
        pool.tick()
        out.append([s.generated_ids[n:] for s, n in zip(pool.slots, seen)])
    return out, pool


@pytest.mark.parametrize("mode", ["ring", "window"])
def test_pool_on_the_card_against_the_cpu(dev, mode):
    """4-slot pools at a small bf16 config (the kernels' head dims): ring
    mode launches flash-encode and flash-decode, window mode banded and
    flash-decode; the adapter rows the encoder wrote agree with the same
    pool's on the CPU (the plain versions) within 5e-2 of their largest
    magnitude, every id is in range, and each tick's ids equal the CPU
    run's in ring mode.  In window mode they agree on at least half per
    slot: the banded kernel and its plain version round the probabilities
    to bf16 against different maxima (BANDED_TOL), and on these random
    weights that flips a near-tie of slot 3's first ids on the card."""
    import chip_smoke as cs
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine

    cfg = cs.small_config("bfloat16")
    tok = cs.byte_tokenizer(cfg.decoder.vocab_size)
    audios = [cs.make_audio(4.0, seed=300 + i) for i in range(4)]
    params = init_params(cfg, seed=0, device=dev)
    cpu = {g: {k: (v.cpu() if isinstance(v, torch.Tensor)
                   else {kk: vv.cpu() for kk, vv in v.items()})
               for k, v in grp.items()} for g, grp in params.items()}
    kw = dict(tokenizer=tok, buckets=(16, 4, 1), enc_kv_ring=128,
              dec_kv_ring=256)
    for fn in (flash_bulk_attention_batched, banded_attention_batched,
               flash_decode):
        fn.launches = 0
    got, gpool = _pool_ticks(VoxtralEngine(cfg, params, **kw), mode, audios,
                             8)
    torch.cuda.synchronize()
    enc = (flash_bulk_attention_batched if mode == "ring"
           else banded_attention_batched)
    assert enc.launches > 0 and flash_decode.launches > 0
    want, cpool = _pool_ticks(VoxtralEngine(cfg, cpu, **kw), mode, audios, 8)
    rows, ref = gpool.row_ring.cpu(), cpool.row_ring
    assert ((rows - ref).abs().max() / ref.abs().max()).item() <= 5e-2
    assert sum(len(ids) for tick in got for ids in tick) > 20
    assert all(0 <= t < cfg.decoder.vocab_size
               for tick in got for ids in tick for t in ids)
    if mode == "ring":
        assert got == want
    for i in range(4):
        a, b = gpool.slots[i].generated_ids, cpool.slots[i].generated_ids
        assert a and b
        assert sum(x == y for x, y in zip(a, b)) / max(len(a), len(b)) \
            >= 0.5, (i, a, b)


@pytest.mark.parametrize("rdt", [torch.bfloat16, torch.float8_e4m3fn])
def test_kernels_at_tp2_rank_shapes(dev, rdt):
    """One tp-2 rank's head counts (parallel/mesh.py rank_config): banded
    at H=KH=16 (B=2 T=1696), flash-decode with the row write at 16q/4kv
    (B=16 cap 896, mixed positions; 2 splits where 8 KV heads take 1) and
    flash-encode at 16 heads (B=16 T=64) against their plain versions,
    with the rings bit-equal and flash-encode's two split mappings
    bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = (_randn(gen, (2, 1696, 16, 64), torch.bfloat16, dev)
               for _ in range(3))
    lo = torch.zeros(2, dtype=torch.int32, device=dev)
    got = banded_attention_batched(q, k, v, lo, window=750,
                                   out_dtype=torch.float32)
    want = banded_attention_plain(q, k, v, lo, window=750,
                                  out_dtype=torch.float32)
    assert (got - want).abs().max().item() <= 2e-2
    pos = torch.tensor([0, 448, 1019] + [(97 * i) % 2688 for i in range(3, 16)],
                       dtype=torch.int32, device=dev)
    kk, vk = (_randn(gen, (16, 26, 4, 896, 128), rdt, dev) for _ in range(2))
    qq = _randn(gen, (16, 16, 128), torch.bfloat16, dev)
    rows = [_randn(gen, (16, 4, 128), torch.float32, dev) for _ in range(2)]
    kp, vp = kk.clone(), vk.clone()
    got = flash_decode(qq, kk, vk, 25, pos, *rows, window=8192,
                       out_dtype=torch.float32)
    want = flash_decode_plain(qq, kp, vp, 25, pos, *rows, window=8192,
                              out_dtype=torch.float32)
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(kk.view(torch.uint8), kp.view(torch.uint8))
    assert torch.equal(vk.view(torch.uint8), vp.view(torch.uint8))
    kr, vr = (_randn(gen, (16, 16, 1024, 64), torch.bfloat16, dev)
              for _ in range(2))
    q = _randn(gen, (16, 64, 16, 64), torch.bfloat16, dev)
    p0 = torch.tensor([2000 + 37 * i for i in range(16)], dtype=torch.int32,
                      device=dev)
    a, b = (flash_bulk_attention_batched(q, kr, vr, p0, window=750,
                                         out_dtype=torch.float32, split=sp)
            for sp in (True, False))
    assert torch.equal(a, b)
    want = flash_encode_plain(q, kr, vr, p0, window=750,
                              out_dtype=torch.float32)
    assert (a - want).abs().max().item() <= 2e-2


def test_tp2_mesh_on_one_card_over_gloo(dev, tmp_path):
    """Two ranks share the card over gloo (NCCL would refuse: one card per
    rank): small_config float32 serving at dp 1 x tp 2 gives the
    unsharded run's ids, and flash-decode launches on every rank, once per
    layer per step."""
    import chip_smoke as cs
    from voxtral_tpu_torch import dryrun
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.parallel.mesh import run_ranks
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    cfg = cs.small_config("float32")
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  attn_impl="xla"))
    kw = dict(buckets=(16, 4, 1), enc_kv_ring=128, dec_kv_ring=256)
    eng = VoxtralEngine(cfg, init_params(cfg, seed=0, device=dev), **kw)
    mel = np.stack([padded_clip_mel(eng, cs.make_audio(3.0, seed=i))
                    for i in range(2)])
    want = dryrun.run_serving(eng, mel)
    outs = run_ranks(dryrun.mesh_serve, 2,
                     (1, 2, cfg, 0, mel, kw, "cuda", "gloo"),
                     device="cuda", backend="gloo", workdir=str(tmp_path))
    for o in outs:
        assert o["tokens"] == want["tokens"]
        assert o["launches"]["flash_decode"] == \
            cfg.decoder.n_layers * o["decode_steps"] > 0


def test_f32_encoder_under_auto_on_the_card(dev):
    """small_config in float32 under "auto" runs the streaming and bulk
    encoders on both encoder kernels' f32 instantiation, launching them as
    often as in bf16, within F32_ENCODER_REL_TOL of the plain path; each
    f32 kernel is within F32_ATTN_TOL of its plain version at the path's
    and at full-width shapes (chip_smoke.f32_encoder_auto)."""
    import chip_smoke as cs

    rec = cs.f32_encoder_auto("cuda")
    n = cs.small_config().encoder.n_layers
    assert rec["f32_launches"] == rec["bf16_launches"] == [2 * n, n]
    assert rec["f32_rel_err_stream"] <= cs.F32_ENCODER_REL_TOL
    assert rec["f32_rel_err_bulk"] <= cs.F32_ENCODER_REL_TOL
    for name in ("banded", "flash_encode"):
        assert rec["kernels"][name]["max_abs_err"] <= cs.F32_ATTN_TOL


def test_f32_flash_encode_is_chunking_invariant_on_the_card(dev):
    """The f32 walk visits the ring's tiles in slot order and skips, per
    row, the tiles with no key for it: the rows of 48 positions written
    and attended as one chunk or as chunks of 24 and 24 (or 8, 16, 24) are
    equal bit for bit, past the ring's wrap too."""
    from voxtral_tpu_torch.ops.ring import ring_chunk_write

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    h, d, cap, window, total = 4, 64, 128, 64, 240
    q, k, v = (_randn(gen, (1, total, h, d), torch.float32, dev)
               for _ in range(3))
    outs = []
    for sizes in ((48,) * 5, (24, 24) * 5, (8, 16, 24) * 5):
        kc = torch.zeros((1, 1, h, cap, d), device=dev)
        vc = torch.zeros_like(kc)
        rows, p = [], 0
        for n in sizes:
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            _, _, kr, vr = ring_chunk_write(kc, vc, k[:, p:p + n],
                                            v[:, p:p + n], 0, pos)
            rows.append(flash_bulk_attention_batched(
                q[:, p:p + n], kr, vr, pos, window=window,
                out_dtype=torch.float32))
            p += n
        outs.append(torch.cat(rows, dim=1))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_checkpoint_tools_on_the_card(dev):
    """chip_smoke's ckpt phase at small_config in bf16 (the kernels' head
    dims, 2 + 2 layers): make_fake_ckpt's checkpoint through the CLI
    offline, fidelity_check PASS on the card against the f32 oracle,
    make_golden record + check with equal ids (both streaming, on
    flash-encode); banded, flash-encode and flash-decode launch, with the
    phase's exact checks.  (The streaming CLI is left to the phase's
    full-width run: on this small random model it decodes no text token,
    so it prints no Decoder: line, as the reference's CLI does not.)"""
    import chip_smoke as cs

    cfg = cs.small_config("bfloat16")
    # make_golden's engine takes the default buckets (up to 256)
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, kv_ring=512))
    rec = cs.phase_ckpt(cfg, "cuda", clip_seconds=5.0,
                        steps=("offline", "fidelity", "golden"))
    assert rec["fidelity"]["ok"]
    assert rec["golden"]["check"][0].startswith("OK")
    assert rec["launches"]["banded_attention_batched"] == cfg.encoder.n_layers
    assert rec["launches"]["flash_bulk_attention_batched"] > 0
