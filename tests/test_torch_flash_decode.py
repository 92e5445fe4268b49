"""Flash-decode (kernel B): the port's plain version against the three JAX
Pallas kernels it replaces (ops/flash_decode.py, interpret mode on the CPU):
  #4 _kernel_flat_fused (row write + attention), and
  #2 _kernel / #3 _kernel_flat (attention after ring_rows_write).
Outputs at atol 1e-5 (float32), rings bit-equal.  tests/test_torch_cuda.py
holds the CUDA kernel against the plain version on the card."""

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
from voxtral_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain

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
