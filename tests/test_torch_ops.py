"""Norms, RoPE and the plain ring ops of the port against the JAX ops, in
float32 (atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops import norms as jn
from voxtral_tpu.ops import ring as jr
from voxtral_tpu.ops import rope as jrope
from voxtral_tpu_torch.ops import norms as tn
from voxtral_tpu_torch.ops import ring as tr
from voxtral_tpu_torch.ops import rope as trope

torch.set_num_threads(1)
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_norms_and_activations():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    w = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(tn.rms_norm(_t(x), _t(w), 1e-5).numpy(),
                               np.asarray(jn.rms_norm(jnp.asarray(x), w, 1e-5)),
                               atol=ATOL)
    for f in ("gelu", "silu"):
        np.testing.assert_allclose(getattr(tn, f)(_t(x)).numpy(),
                                   np.asarray(getattr(jn, f)(jnp.asarray(x))),
                                   atol=ATOL)
    # bf16 input: the norm computes in f32 and rounds back to bf16
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tn.rms_norm(xb, _t(w))
    assert got.dtype == torch.bfloat16
    want = jn.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), w)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("head_dim,theta", [(6, 1e6), (64, 1e6), (128, 1e4)])
def test_rope(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    pos = np.array([[0, 1, 7, 4095], [17, 300, 8191, 2]], np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    tc, ts = trope.rope_cos_sin(_t(pos), head_dim, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    x = rng.standard_normal((2, 4, 3, head_dim)).astype(np.float32)
    got = trope.apply_rope_interleaved(_t(x), tc, ts)
    want = jrope.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(tc.numpy()),
                                        jnp.asarray(ts.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cap,t,pos0", [
    (16, 5, 3),       # plain write
    (16, 7, 13),      # wraps around the ring end
    (48, 9, 45),      # non-power-of-two cap, wraps
    (16, 16, 5),      # T == cap
    (16, 37, 22),     # T > cap: only the last cap rows survive
    (16, 1, 40),      # single row
])
def test_ring_write(cap, t, pos0):
    rng = np.random.default_rng(cap + t)
    kh, d = 2, 3
    ring = rng.standard_normal((kh, cap, d)).astype(np.float32)
    vals = rng.standard_normal((t, kh, d)).astype(np.float32)
    want = np.asarray(jr.ring_write(jnp.asarray(ring), jnp.asarray(vals),
                                    jnp.int32(pos0)))
    got = _t(ring).clone()[None]
    out = tr.ring_write(got, _t(vals)[None], torch.tensor([pos0]))
    assert out is got                                  # in place
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_ring_rows_write_batched():
    rng = np.random.default_rng(7)
    bsz, n_layers, kh, cap, d = 3, 2, 2, 48, 4
    k_all = rng.standard_normal((bsz, n_layers, kh, cap, d)).astype(np.float32)
    v_all = rng.standard_normal((bsz, n_layers, kh, cap, d)).astype(np.float32)
    kr = rng.standard_normal((bsz, kh, d)).astype(np.float32)
    vr = rng.standard_normal((bsz, kh, d)).astype(np.float32)
    pos = np.array([0, 47, 130], np.int32)
    tk, tv = _t(k_all).clone(), _t(v_all).clone()
    tr.ring_rows_write(tk, tv, _t(kr), _t(vr), 1, _t(pos))
    for b in range(bsz):
        wk, wv = jr.ring_rows_write(
            jnp.asarray(k_all[b]), jnp.asarray(v_all[b]), jnp.asarray(kr[b]),
            jnp.asarray(vr[b]), jnp.int32(1), jnp.int32(pos[b]))
        np.testing.assert_array_equal(tk[b].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(tv[b].numpy(), np.asarray(wv))


def test_slot_logical_positions():
    for p_end, cap in ((0, 16), (5, 16), (37, 16), (100, 48)):
        want = np.asarray(jr.slot_logical_positions(jnp.int32(p_end), cap))
        got = tr.slot_logical_positions(torch.tensor([p_end]), cap)
        np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("t,q_pos0,cap,window", [
    (1, 0, 16, 12),      # first token
    (1, 29, 16, 12),     # wrapped ring, window < cap
    (5, 40, 48, 48),     # non-power-of-two cap, window == cap
    (38, 0, 64, 48),     # the prompt prefill shape (T = prompt_len - 1)
    (7, 60, 64, 48),
])
def test_ring_attention(t, q_pos0, cap, window):
    rng = np.random.default_rng(t * 100 + q_pos0)
    kh, g, d = 2, 2, 6
    q = rng.standard_normal((t, kh * g, d)).astype(np.float32)
    k_ring = rng.standard_normal((kh, cap, d)).astype(np.float32)
    v_ring = rng.standard_normal((kh, cap, d)).astype(np.float32)
    want = np.asarray(jr.ring_attention(
        jnp.asarray(q), jnp.asarray(k_ring), jnp.asarray(v_ring),
        jnp.int32(q_pos0), window=window))
    got = tr.ring_attention(_t(q)[None], _t(k_ring)[None], _t(v_ring)[None],
                            torch.tensor([q_pos0]), window=window)
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL)
