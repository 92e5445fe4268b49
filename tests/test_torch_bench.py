"""The port's bench (voxtral_tpu_torch/bench.py) against the JAX package's
root bench.py, on the CPU at tiny size with the same weights: the two
encoders' adapter rows within 1e-5 (the streaming tolerance of
tests/test_torch_stream.py), run_once's ids in its three encode modes
exactly equal to bench.py's pipeline (bench.py:537-610) written out here in
JAX, the default stream table, and `main` end to end: its last line, its
metric name, the keys of `extra`, no -1, the TPU anchors file untouched,
and no run without CUDA unless asked for the CPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from voxtral_tpu.config import TOKEN_EOS
from voxtral_tpu.parallel import serving as jsv
from voxtral_tpu.runtime.engine import VoxtralEngine as JEngine
from voxtral_tpu.runtime.engine import decompose
from voxtral_tpu_torch import bench as tbench
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.parallel import serving as tsv
from voxtral_tpu_torch.runtime.offline import padded_clip_mel
from voxtral_tpu_torch.tools import synthetic_audio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 2.0
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def engines(cfg, params, params_np, tiny_tokenizer):
    """(JAX engine, port engine) of bench.py's geometry on the tiny f32
    config with the same weights, and the bench clip's padded mel."""
    s = tbench.Settings(streams=3)
    jeng = JEngine(cfg, params, tokenizer=tiny_tokenizer,
                   dec_kv_ring=s.dec_ring, **tbench.ENGINE_KW)
    teng, weights = tbench.build_engine(s, "cpu", tiny_config(),
                                        from_jax_numpy(params_np))
    assert weights == "random"
    mel = padded_clip_mel(teng, synthetic_audio(SECONDS))
    return jeng, teng, mel


def test_encode_clip_rows_equal_jax(engines):
    """Two streams through one shared encoder ring (the second starts a
    new epoch at position 0): the adapter rows of each equal bench.py's."""
    jeng, teng, mel = engines
    jcache, tcache = jeng.new_enc_cache(), teng.new_enc_cache()
    for _ in range(2):
        want, jcache = jbench._encode_clip(jeng, mel, jcache)
        got, tcache = tbench._encode_clip(teng, mel, tcache)
        assert got.dtype == torch.float32
        assert got.shape == (mel.shape[0] // 8, teng.cfg.decoder.dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_clips_batched_rows_equal_jax(engines):
    """enc_batch 2 on the batched encoder cache, twice on the one cache:
    [2, n, dim] rows equal to bench.py's vmapped fused encoder."""
    jeng, teng, mel = engines
    cfg = teng.cfg
    jcache = jsv.batched_enc_cache(jeng.cfg, 2, jeng.enc_kv_ring)
    tcache = tsv.batched_enc_cache(cfg, 2, teng.enc_kv_ring)
    for _ in range(2):
        want, jcache = jbench._encode_clips_batched(jeng, mel, 2, jcache)
        got, tcache = tbench._encode_clips_batched(teng, mel, 2, tcache)
        assert got.shape == (2, mel.shape[0] // 8, cfg.decoder.dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_run_once(engine, mel, n, enc, group, batch, burst=64):
    """bench.py's run_once (:506-610) in the JAX package, on the CPU:
    bulk in groups, batched or incremental encode, the vmapped prompt
    embeds, bprefill of L-1 rows, bdecode_burst over decompose(n - (L-1),
    (burst, 16, 4, 1)) with the fed-back token on the device, one fetch,
    EOS cut on the host.  Returns (ids, steps)."""
    cfg, L = engine.cfg, engine.prompt_len
    dparams = engine.params["decoder"]
    if enc == "bulk":
        m = jnp.asarray(mel)
        adapter = jnp.concatenate([
            engine.encode_clips_bulk(jnp.broadcast_to(
                m, (min(group, n - g0),) + m.shape))
            for g0 in range(0, n, group)])
    elif batch > 1:
        cache, rows = jsv.batched_enc_cache(cfg, batch, engine.enc_kv_ring), []
        for _ in range(0, n, batch):
            r, cache = jbench._encode_clips_batched(engine, mel, batch, cache)
            rows.append(r)
        adapter = jnp.concatenate(rows, axis=0)[:n]
    else:
        cache, rows = engine.new_enc_cache(), []
        for _ in range(n):
            r, cache = jbench._encode_clip(engine, mel, cache)
            rows.append(r)
        adapter = jnp.stack(rows)
    dec = jsv.batched_dec_cache(cfg, n, engine.dec_kv_ring)
    prompt = jax.vmap(engine.prompt_embeds)(adapter[:, :L])
    dec = jsv.bprefill(dparams, cfg, prompt[:, : L - 1], dec,
                       jnp.zeros((n,), jnp.int32), engine.ada())
    parts, prev, pos = [], jnp.full((n,), 32, jnp.int32), L - 1
    for b in decompose(adapter.shape[1] - pos, (burst, 16, 4, 1)):
        toks, _, _, _, dec = jsv.bdecode_burst(
            dparams, cfg, jax.lax.slice_in_dim(adapter, pos, pos + b, axis=1),
            prev, dec, jnp.full((n,), pos, jnp.int32), engine.ada())
        parts.append(toks)
        prev = toks[:, -1].astype(jnp.int32)
        pos += b
    host = np.asarray(jnp.concatenate(parts, axis=1)).tolist()
    ids = [t[: t.index(TOKEN_EOS)] if TOKEN_EOS in t else t for t in host]
    return ids, pos - (L - 1)


@pytest.mark.parametrize("enc,group,batch", [
    ("inc", 4, 1), ("bulk", 2, 1), ("inc", 4, 2)])
def test_run_once_ids_equal_jax(engines, enc, group, batch):
    """run_once's ids over 3 streams (groups and batches of 2, the last one
    partial) equal bench.py's pipeline exactly, every position decoded."""
    jeng, teng, mel = engines
    s = tbench.Settings(streams=3, enc=enc, enc_group=group,
                        enc_batch=batch)
    want, want_steps = _jax_run_once(jeng, mel, 3, enc, group, batch)
    got = tbench.run_once(teng, s, mel, log=lambda m: None)
    assert got["steps"] == want_steps == mel.shape[0] // 8 - (
        teng.prompt_len - 1)
    assert got["tokens"] == want
    assert sum(len(t) for t in want) >= 3 * 10
    assert got["wall_s"] >= got["encode_s"] >= 0 and got["captures"] == 0


@pytest.mark.parametrize("mode", ["bf16", "fp8kv", "int8", "int4"])
def test_default_streams_equal_bench_py(mode):
    assert tbench._default_streams(mode) == jbench._default_streams(mode)
    assert tbench.settings({"BENCH_MODE": mode}).streams == \
        jbench._default_streams(mode)


# bench.py's keys of `extra` (:899-927, the anchors left out), its ledger
# keys at a run on a host without memory stats (:458), the load rows'
# (:822-828) and the port's additions
_BASE_KEYS = {
    "wall_s", "encode_phase_s", "decode_phase_s", "streams",
    "audio_s_per_stream", "decode_steps_per_stream",
    "decoder_step_ms_batched", "tokens_per_s_aggregate",
    "p50_token_latency_ms_I0.5", "p90_token_latency_ms_I0.5",
    "int8_decoder_step_ms_batched", "int8_streams",
    "int4_fp8kv_decoder_step_ms_batched",
    "bf16w_fp8kv_decoder_step_ms_batched", "bf16w_fp8kv_streams",
    "pipelined_phases", "device", "weights", "mode",
    "ledger_gib_post-decode"}
_ADDED_KEYS = {"power_limit", "graph_captures_timed",
               "graph_capture_ms_timed", "kernel_launches"}


def _load_keys(rows) -> set:
    return {k for n, interval, tag in rows for k in (
        f"p50_token_latency_ms_under_{n}stream_load_I{interval}",
        f"p90_token_latency_ms_under_{n}stream_load_I{interval}",
        f"load_{tag}_sustainable")}


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_main_last_line(mode, capsys):
    """main on the tiny config at 2 streams x 2 s, 1 try, 2 load slots x 2
    ticks (bf16: every side phase; int4: BENCH_LAT=0 BENCH_LOAD=0, as the
    smoke runs it): the last line parses, the metric names the clip's
    seconds, `extra` holds bench.py's keys and the named additions only,
    no value reads -1, and docs/bench_anchors.json is unchanged."""
    anchors = os.path.join(ROOT, "docs", "bench_anchors.json")
    with open(anchors, "rb") as f:
        before = f.read()
    env = {"BENCH_MODE": mode, "BENCH_STREAMS": "2", "BENCH_SECONDS": "2",
           "BENCH_TRIES": "1", "BENCH_LOAD_STREAMS": "2",
           "BENCH_LOAD_TICKS": "2", "BENCH_FP8_STREAMS": "2"}
    if mode != "bf16":
        env.update(BENCH_LAT="0", BENCH_LOAD="0")
    capsys.readouterr()
    assert tbench.main(["--device", "cpu"], env=env, cfg=tiny_config()) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    suffix = "" if mode == "bf16" else f"_{mode}"
    assert out["metric"] == f"aggregate_x_realtime_per_chip_2s_2streams{suffix}"
    assert out["unit"] == "x_realtime" and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] * 0.3998, 2)
    extra = out["extra"]
    want = _BASE_KEYS | _ADDED_KEYS
    if mode == "bf16":       # the phase barrier: the encode split is known
        want |= {"ledger_gib_post-encode"} | _load_keys(
            [(2, 2, "load-window"), (2, 8, "load-window-exact"),
             (2, 0.5, "load-ring"), (16, 0.5, "load-ring16")])
    assert set(extra) == want
    assert -1 not in list(_numbers(extra))
    assert extra["decode_steps_per_stream"] == 74 - 38
    assert extra["mode"] == mode and extra["device"] == "cpu"
    assert extra["pipelined_phases"] == (mode != "bf16")
    assert set(extra["kernel_launches"]) == {
        "banded_attention_batched", "flash_decode",
        "flash_bulk_attention_batched", "int4_mm", "ring_rows_write"}
    assert not any(extra["kernel_launches"].values())     # CPU: no kernel
    probes = ("int8_decoder_step_ms_batched",
              "int4_fp8kv_decoder_step_ms_batched",
              "bf16w_fp8kv_decoder_step_ms_batched")
    if mode == "bf16":
        assert all(extra[k] > 0 for k in probes)
        assert extra["p90_token_latency_ms_I0.5"] >= \
            extra["p50_token_latency_ms_I0.5"] > 0
    else:                    # not run: null, not -1
        assert all(extra[k] is None for k in probes)
        assert extra["p50_token_latency_ms_I0.5"] is None
    with open(anchors, "rb") as f:
        assert f.read() == before


def test_refuses_without_cuda(capsys):
    """--device cuda (the default) without a CUDA device exits non-zero,
    in-process and as `python -m voxtral_tpu_torch.bench`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tbench.main(["--device", "cuda"], env={}) == 1
    assert "no CUDA device" in capsys.readouterr().err
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-m", "voxtral_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and "metric" not in run.stdout


def test_settings_follow_bench_py():
    """The knobs' defaults and clamps of bench.py:321-497: the pipelined
    phases off for bf16 only, the encode group and batch clamped to the
    streams, the load streams min(N, 32); an unknown mode raises."""
    s = tbench.settings({})
    assert (s.mode, s.streams, s.seconds, s.burst, s.dec_ring, s.enc,
            s.tries, s.pipelined, s.load_streams, s.load_ticks) == (
        "bf16", 64, 60.0, 64, 896, "inc", 2, False, 32, 16)
    s = tbench.settings({"BENCH_MODE": "fp8kv", "BENCH_STREAMS": "3",
                         "BENCH_ENC_GROUP": "8", "BENCH_ENC_BATCH": "9"})
    assert (s.pipelined, s.enc_group, s.enc_batch, s.load_streams) == (
        True, 3, 3, 3)
    assert tbench.settings({"BENCH_PIPE": "1"}).pipelined
    with pytest.raises(ValueError, match="BENCH_MODE"):
        tbench.settings({"BENCH_MODE": "fp4"})
