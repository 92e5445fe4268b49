"""Banded encoder attention (kernel A): the port's plain version against the
JAX Pallas kernel (ops/banded_encode.py:_kernel, interpret mode on the CPU)
at atol/rtol 2e-5 in float32.  tests/test_torch_cuda.py holds the CUDA
kernel against the plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops.banded_encode import banded_attention_batched as jax_banded
from voxtral_tpu_torch.ops.banded_encode import (
    banded_attention_batched,
    banded_attention_plain,
)

torch.set_num_threads(1)


def _inputs(bsz, t, kh, g, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bsz, t, kh * g, d)).astype(np.float32)
    k = rng.standard_normal((bsz, t, kh, d)).astype(np.float32)
    v = rng.standard_normal((bsz, t, kh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "t,window,bq,bk,kv_lo",
    [
        (64, 24, 8, 128, (0, 0)),       # window << T, tiny blocks
        (40, 100, 8, 128, (0, 0)),      # window > T (full causal)
        (300, 96, 128, 128, (0, 0)),    # multiple q tiles, band spans tiles
        (260, 250, 64, 128, (0, 0)),    # band wider than a tile, T % bk != 0
        (150, 64, 64, 128, (0, 37)),    # leading keys hidden for stream 1
    ],
)
def test_plain_matches_pallas(t, window, bq, bk, kv_lo):
    q, k, v = _inputs(2, t, 4, 2, 8, seed=t + window)
    want = np.asarray(jax_banded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_lo, jnp.int32), window=window, block_q=bq,
        block_k=bk))
    got = banded_attention_batched(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(kv_lo, dtype=torch.int32), window=window)
    for b, lo in enumerate(kv_lo):
        # rows before kv_lo see no key: undefined in Pallas, 0 in the port
        np.testing.assert_allclose(got[b, lo:].numpy(), want[b, lo:],
                                   rtol=2e-5, atol=2e-5)


def test_row_with_no_visible_key_is_zero():
    """Rows q < kv_lo see no key: the port defines them as 0 (the Pallas
    kernel leaves them undefined)."""
    q, k, v = _inputs(1, 20, 2, 1, 4, seed=1)
    out = banded_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([8], dtype=torch.int32), window=6)
    assert torch.equal(out[0, :8], torch.zeros_like(out[0, :8]))
    assert bool(torch.isfinite(out).all())
    assert out[0, 8:].abs().sum() > 0


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _inputs(1, 33, 2, 2, 4, seed=2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    banded_attention_batched.launches = 0
    got = banded_attention_batched(tq, tk, tv, window=9)
    want = banded_attention_plain(tq, tk, tv, window=9)
    assert torch.equal(got, want)
    assert banded_attention_batched.launches == 0
