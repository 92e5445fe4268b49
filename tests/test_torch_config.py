"""The port's config equals the JAX package's: every constant, every
dataclass field, the derived properties and the helper functions."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import voxtral_tpu.config as jcfg
import voxtral_tpu_torch.config as tcfg

torch.set_num_threads(1)


def _constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, float, str))}


def test_constants_equal():
    j, t = _constants(jcfg), _constants(tcfg)
    assert len(j) > 20
    assert j == t


@pytest.mark.parametrize("name", ["tiny_config", "mid_config", "full_config"])
def test_config_fields_equal(name):
    j = getattr(jcfg, name)()
    t = getattr(tcfg, name)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    for sub in ("encoder", "decoder"):
        assert [f.name for f in dataclasses.fields(getattr(j, sub))] == \
            [f.name for f in dataclasses.fields(getattr(t, sub))]
    assert j.prompt_len == t.prompt_len
    assert j.encoder.qkv_dim == t.encoder.qkv_dim
    assert (j.decoder.q_dim, j.decoder.kv_dim) == \
        (t.decoder.q_dim, t.decoder.kv_dim)
    for prop in ("cdtype", "pdtype", "kvdtype", "enc_kvdtype"):
        tdt = getattr(t, prop)
        assert isinstance(tdt, torch.dtype)
        assert str(tdt) == "torch." + jnp.dtype(getattr(j, prop)).name


def test_replace_and_helpers_equal():
    j = jcfg.full_config().replace(kv_dtype="float32", delay_tokens=3)
    t = tcfg.full_config().replace(kv_dtype="float32", delay_tokens=3)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.kvdtype == torch.float32
    for n in (0, 1, 159, 160, 161, 1280, 16000, 16001, 480000):
        assert jcfg.num_audio_tokens(n) == tcfg.num_audio_tokens(n)
    for ms in (0, 79, 80, 480, 1000, 2400, 9999):
        assert jcfg.delay_tokens_from_ms(ms) == tcfg.delay_tokens_from_ms(ms)
    for d in range(0, 31):
        assert jcfg.n_right_pad_tokens(d) == tcfg.n_right_pad_tokens(d)
