"""Parameter trees of the port against the JAX package's: the conversion
from the JAX tree, the safetensors loader on the reference-layout tiny
checkpoint, and the layout of the seeded random init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_io import _torch_layout_checkpoint
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.io.safetensors import write_safetensors
from voxtral_tpu.models.params import init_params as jax_init
from voxtral_tpu.models.params import load_params as jax_load
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.params import (
    from_jax_numpy,
    init_params,
    load_params,
)

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _bits(x):
    """Tensor or array -> f32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_numpy_is_exact(dtype):
    params = jax_init(jax_tiny(compute_dtype=dtype), seed=3)
    tp = _flat(from_jax_numpy(jax.tree.map(np.asarray, params)))
    jp = _flat(params)
    assert tp.keys() == jp.keys()
    for name, leaf in jp.items():
        assert str(tp[name].dtype) == "torch." + leaf.dtype.name, name
        assert tuple(tp[name].shape) == leaf.shape, name
        np.testing.assert_array_equal(_bits(tp[name]), _bits(leaf),
                                      err_msg=name)


def test_load_params_matches_jax(tmp_path):
    jcfg = jax_tiny(compute_dtype="float32").replace(param_dtype="bfloat16")
    tensors = _torch_layout_checkpoint(jcfg, np.random.default_rng(4))
    write_safetensors(str(tmp_path / "consolidated.safetensors"), tensors)
    jp = _flat(jax_load(str(tmp_path), jcfg))
    tcfg = tiny_config(compute_dtype="float32").replace(param_dtype="bfloat16")
    tp = _flat(load_params(str(tmp_path), tcfg))
    assert tp.keys() == jp.keys()
    for name, leaf in jp.items():
        assert str(tp[name].dtype) == "torch." + leaf.dtype.name, name
        np.testing.assert_array_equal(_bits(tp[name]), _bits(leaf),
                                      err_msg=name)


def test_init_params_layout_matches_jax():
    """Seeded torch init: the JAX tree's names, shapes and dtypes (values
    come from another generator), and the same values for the same seed."""
    for dtype in ("float32", "bfloat16"):
        jp = _flat(jax_init(jax_tiny(compute_dtype=dtype), seed=0))
        tp = _flat(init_params(tiny_config(compute_dtype=dtype), seed=0))
        assert tp.keys() == jp.keys()
        for name, leaf in jp.items():
            assert tuple(tp[name].shape) == leaf.shape, name
            assert str(tp[name].dtype) == "torch." + leaf.dtype.name, name
    a = _flat(init_params(tiny_config(), seed=5))
    b = _flat(init_params(tiny_config(), seed=5))
    c = _flat(init_params(tiny_config(), seed=6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder/layers/wqkv"], c["decoder/layers/wqkv"])
    # constant leaves match exactly (norms, biases)
    j5 = _flat(jax_init(jax_tiny(), seed=5))
    for name in ("encoder/layers/bqkv", "decoder/final_norm",
                 "encoder/layers/attn_norm"):
        np.testing.assert_array_equal(_bits(a[name]), _bits(j5[name]))
