"""The port's four measurement tools (voxtral_tpu_torch/tools/microbench,
decode_profile, int4_kernel_bench, bulk_encode_bench) against the JAX
package's tools/ of the same names, both run on the CPU at tiny size with
the same weights: the same lines in the same order, and every number that
is not a time equal (bytes, GiB, shapes, steps, iterations).  A time, or
a rate or realtime factor made from one, is masked before the comparison
(on the CPU it is no device figure anyway).  The few words that name an
implementation differ by design (the JAX tool's "Pallas" kernel is a CUDA
one here; a JAX "compile" is a warm-up here) and are mapped.  The JAX-only
knobs exit 2, and every tool refuses without a CUDA device unless given
--device cpu."""

import os
import re
import sys

import jax
import pytest
import torch

import voxtral_tpu.config as jax_config
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import params as tparams_mod
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.tools import (
    bulk_encode_bench,
    decode_profile,
    int4_kernel_bench,
    microbench,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import bulk_encode_bench as jax_bulk  # noqa: E402  (the JAX package's tools)
import decode_profile as jax_profile  # noqa: E402
import int4_kernel_bench as jax_int4  # noqa: E402
import microbench as jax_micro  # noqa: E402

torch.set_num_threads(1)

# a number followed by a time unit, a rate or a realtime factor; an int4
# bench floor (microseconds)
_TIMED = re.compile(r"[-+]?\d+(?:\.\d+)?(?=\s*(?:ms|us\b|s\b|GiB/s|x realtime))"
                    r"|(?<=floor )\d+")
# the JAX tools' words for their own implementation -> the port's
_WORDS = {"Pallas": "CUDA", "int4-pallas": "int4-cuda", "compiling": "warming",
          "scan/fusion overhead": "graph replay and host overhead"}


def _lines(out: str, words=True) -> list[str]:
    got = []
    for line in out.splitlines():
        if words:
            for a, b in _WORDS.items():
                line = line.replace(a, b)
        got.append(" ".join(_TIMED.sub("T", line).split()))
    return got


@pytest.fixture
def same_weights(monkeypatch, params_np):
    """The port's init_params hands out the JAX tiny config's weights (the
    two packages draw different numbers from one seed; iteration counts
    depend on the weights)."""
    monkeypatch.setattr(tparams_mod, "init_params",
                        lambda cfg, seed=0, device="cpu": from_jax_numpy(
                            params_np))


def _run_jax(module, argv, monkeypatch, capsys, cfg=None):
    monkeypatch.setattr(jax_config, "full_config",
                        lambda: cfg or jax_tiny())
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    capsys.readouterr()
    assert module.main() in (None, 0)
    return capsys.readouterr().out


def _run_port(module, argv, capsys, cfg=None):
    capsys.readouterr()
    assert module.main(argv + ["--device", "cpu"],
                       cfg=cfg or tiny_config()) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("which", ["single", "jacobi", "logits"])
def test_microbench_prints_the_jax_tools_lines(monkeypatch, capsys,
                                               same_weights, which):
    """The B=1 sequential burst, a Jacobi burst (its iteration count) and
    the logits: the JAX tool's lines."""
    for k, v in (("MB_BATCH", "2"), ("MB_RING", "64"), ("MB_BURST", "8")):
        monkeypatch.setenv(k, v)
    port = _run_port(microbench, [which], capsys)
    ref = _run_jax(jax_micro, [which], monkeypatch, capsys)
    assert len(_lines(port)) == 1 and _lines(port) == _lines(ref)


def test_microbench_all(monkeypatch, capsys, same_weights):
    """Every call in the JAX tool's order.  The JAX tool's prefill and
    encode calls name serving functions its package no longer has
    (`bprefill_lockstep`, `bencode_lockstep`) and raise, so those two
    lines are held to the JAX tool's format strings."""
    for k, v in (("MB_BATCH", "2"), ("MB_RING", "64"), ("MB_BURST", "8")):
        monkeypatch.setenv(k, v)
    got = _lines(_run_port(microbench, ["all"], capsys))
    assert [ln.split(":")[0].split(" [")[0] for ln in got] == [
        "decode burst", "decode burst", "decode burst", "prefill(38)",
        "encode chunk 256", "single-stream sequential", "jacobi",
        "logits+argmax"]
    assert got[3] == "prefill(38): T ms (2 streams)"
    assert got[4] == "encode chunk 256: T ms (2 streams) -> Tx realtime " \
        "aggregate"
    with pytest.raises(AttributeError, match="lockstep"):
        _run_jax(jax_micro, ["prefill"], monkeypatch, capsys)


@pytest.mark.parametrize("env", [{}, {"MB_INT8": "1"}])
def test_microbench_decode_variants(monkeypatch, capsys, same_weights, env):
    """The decode variants of each attention path, on the int8 decoder
    too."""
    for k, v in (("MB_BATCH", "2"), ("MB_RING", "64"), ("MB_BURST", "4"),
                 *env.items()):
        monkeypatch.setenv(k, v)
    port = _run_port(microbench, ["decode"], capsys)
    ref = _run_jax(jax_micro, ["decode"], monkeypatch, capsys)
    assert [ln.split("]")[0] for ln in _lines(port)] == [
        "decode burst [auto", "decode burst [xla", "decode burst [flash"]
    assert _lines(port) == _lines(ref)


def test_decode_profile_prints_the_jax_tools_ledger(monkeypatch, capsys,
                                                    same_weights):
    """Every term: the GiB it moves, the burst and batch equal."""
    for k, v in (("DP_BATCH", "2"), ("DP_RING", "64"), ("DP_POS", "40"),
                 ("DP_BURST", "4"), ("DP_REP", "1")):
        monkeypatch.setenv(k, v)
    port = _run_port(decode_profile, [], capsys)
    ref = _run_jax(jax_profile, [], monkeypatch, capsys)
    labels = [ln.split(":")[0].strip() for ln in _lines(port)]
    assert labels == ["weights", "logits", "attn/grid", "attn/flat",
                      "attn/xla", "rowwrite", "matmuls", "step"]
    assert _lines(port) == _lines(ref)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_decode_profile_on_the_quantized_rungs(monkeypatch, capsys,
                                               same_weights, quant):
    for k, v in (("DP_BATCH", "2"), ("DP_RING", "64"), ("DP_POS", "40"),
                 ("DP_BURST", "4"), ("DP_REP", "1"), ("DP_QUANT", quant),
                 ("DP_TERMS", "weights,matmuls")):
        monkeypatch.setenv(k, v)
    port = _run_port(decode_profile, [], capsys)
    ref = _run_jax(jax_profile, [], monkeypatch, capsys)
    assert len(_lines(port)) == 3 and _lines(port) == _lines(ref)


# the JAX tool's matrices are the full model's; both sides run them cut by
# SHRINK in both dims (the JAX tool through its random draws, the port
# through a config of those widths), 26 layers
SHRINK = 16


def test_int4_kernel_bench_prints_the_jax_tools_lines(monkeypatch, capsys):
    draw = jax.random.normal

    def small(key, shape, dtype):
        return draw(key, (*shape[:-2], shape[-2] // SHRINK,
                          shape[-1] // SHRINK) if len(shape) == 3
                    else (shape[0], shape[1] // SHRINK), dtype)

    cfg = tiny_config()
    cfg = cfg.replace(decoder=type(cfg.decoder)(
        dim=3072 // SHRINK, n_layers=26, n_heads=32, head_dim=128 // SHRINK,
        n_kv_heads=8, hidden=9216 // SHRINK, vocab_size=1256))
    argv = ["16", "all"]
    port = _run_port(int4_kernel_bench, argv, capsys, cfg=cfg)
    monkeypatch.setattr(jax.random, "normal", small)
    ref = _run_jax(jax_int4, argv, monkeypatch, capsys)

    def shrunk(line):
        return re.sub(r"\[(\d+)x(\d+)\]", lambda m: "[%dx%d]" % (
            int(m[1]) // SHRINK, int(m[2]) // SHRINK), line)

    assert [ln.split(" [")[0] for ln in _lines(port)] == [
        "wqkv", "wo", "w13", "w2"]
    assert _lines(port) == [shrunk(ln) for ln in _lines(ref)]


@pytest.fixture
def jax_cache_dir(monkeypatch, tmp_path):
    """The JAX tool turns on JAX's persistent compile cache in a directory
    under HOME: point it at tmp_path, and put JAX's settings back after."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.setattr(jax_bulk, "cache", str(tmp_path / "jax"))
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_bulk_encode_bench_prints_the_jax_tools_lines(monkeypatch, capsys,
                                                      same_weights,
                                                      jax_cache_dir):
    for k, v in (("BULK_SECONDS", "3"), ("BULK_GROUPS", "2,3")):
        monkeypatch.setenv(k, v)
    port = _run_port(bulk_encode_bench, [], capsys)
    ref = _run_jax(jax_bulk, [], monkeypatch, capsys)
    got, want = _lines(port), _lines(ref)
    assert got[0].startswith("device: ") and want[0].startswith("device: ")
    assert got[1].startswith("mel: (") and len(got) == 10
    assert got[1:] == want[1:]


@pytest.mark.parametrize("tool,env", [
    (microbench, "MB_UNROLL"), (decode_profile, "DP_BLOCK")])
def test_jax_only_knobs_exit_2(monkeypatch, capsys, tool, env):
    monkeypatch.setenv(env, "2")
    assert tool.main(["--device", "cpu"], cfg=tiny_config()) == 2
    assert env in capsys.readouterr().err


@pytest.mark.parametrize("tool", [microbench, decode_profile,
                                  int4_kernel_bench, bulk_encode_bench])
def test_tools_refuse_without_cuda(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([], cfg=tiny_config()) == 1
    assert "no CUDA device" in capsys.readouterr().err
