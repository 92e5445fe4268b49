"""Tests of the port that need an NVIDIA GPU: each hand-written CUDA kernel
against its plain PyTorch version at the full-width shapes, the wrappers'
refusals, and the offline path at reduced depth.  They skip without a
card.  This file imports no JAX, so on the GPU machine (which has none) it
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


@pytest.mark.parametrize("bsz,cap,pos", [(1, 896, [0]), (1, 896, [1019]),
                                         (3, 8192, [0, 4103, 16389])])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("write", [False, True])
def test_flash_decode_kernel_matches_plain(dev, bsz, cap, pos, dtype, write):
    """Full-width decoder shape (H=32, KH=8, D=128, L=26): the same output
    to f32 rounding (1e-4 abs), the same rings bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(cap + bsz)
    kk = _randn(gen, (bsz, 26, 8, cap, 128), dtype, dev)
    vk = _randn(gen, (bsz, 26, 8, cap, 128), dtype, dev)
    kp, vp = kk.clone(), vk.clone()
    q = _randn(gen, (bsz, 32, 128), torch.float32, dev)
    rows = ((_randn(gen, (bsz, 8, 128), torch.float32, dev),
             _randn(gen, (bsz, 8, 128), torch.float32, dev)) if write else ())
    p = torch.tensor(pos, device=dev)
    n0 = flash_decode.launches
    got = flash_decode(q, kk, vk, 25, p, *rows, window=8192,
                       out_dtype=torch.float32)
    want = flash_decode_plain(q, kp, vp, 25, p, *rows, window=8192,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(kk, kp) and torch.equal(vk, vp)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 16, 4, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        banded_attention_batched(q, q, q, window=8)
    with pytest.raises(ValueError, match="bf16"):
        banded_attention_batched(q.float(), q.float(), q.float(), window=8)
    ring = torch.zeros((1, 2, 8, 64, 128), device=dev).to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="rings"):
        flash_decode(torch.zeros((1, 32, 128), device=dev), ring, ring, 0,
                     torch.tensor([3], device=dev), window=64)


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
