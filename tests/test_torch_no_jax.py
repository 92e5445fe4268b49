"""The port stands alone: importing every module of voxtral_tpu_torch loads
neither JAX nor the JAX package (nor ml_dtypes, nor any module of tests/,
whose oracle the port's fidelity check has its own copy of), and running
the offline path on CPU tensors launches no kernel."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import torch

import voxtral_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, os, pkgutil, sys
import voxtral_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
tests = os.path.join(os.getcwd(), "tests") + os.sep
bad = sorted(m for m, mod in list(sys.modules.items())
             if m.split(".")[0] in ("jax", "jaxlib", "voxtral_tpu", "ml_dtypes")
             or (getattr(mod, "__file__", None) or "").startswith(tests))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    expected = [m.name for m in pkgutil.walk_packages(
        voxtral_tpu_torch.__path__, "voxtral_tpu_torch.")]
    assert int(n) == len(expected) >= 20
    # the checkpoint tools, the oracle among them, the measurement tools,
    # the CUDA-graph layer and the bench are walked too
    assert {f"voxtral_tpu_torch.tools.{t}" for t in (
        "make_fake_ckpt", "inspect_weights", "oracle", "fidelity_check",
        "make_golden", "benchmark", "int8_ab", "window_ab", "microbench",
        "decode_profile", "int4_kernel_bench", "bulk_encode_bench")} | {
        "voxtral_tpu_torch.ops.graphs",
        "voxtral_tpu_torch.bench"} <= set(expected)
    assert bad == "[]", bad


def test_no_source_line_imports_jax():
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "voxtral_tpu_torch")):
        if "build" in dirs:
            dirs.remove("build")     # kernel build outputs, not sources
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax",
                                                 "import voxtral_tpu ",
                                                 "from voxtral_tpu.",
                                                 "from voxtral_tpu ")), (f, s)


def test_cpu_run_launches_no_kernel():
    from conftest import make_audio
    from voxtral_tpu_torch.config import tiny_config
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.ops.banded_encode import banded_attention_batched
    from voxtral_tpu_torch.ops.flash_decode import flash_decode
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import transcribe_offline_ids

    cfg = tiny_config()
    engine = VoxtralEngine(cfg, init_params(cfg, seed=1, device="cpu"), dec_kv_ring=64,
                           buckets=(16, 4, 1))
    banded_attention_batched.launches = 0
    flash_decode.launches = 0
    stats = {}
    ids = transcribe_offline_ids(engine, make_audio(1.0, seed=4),
                                 timings=stats)
    assert stats["decode_steps"] > 0 and len(ids) <= stats["decode_steps"]
    assert all(0 <= t < cfg.decoder.vocab_size for t in ids)
    assert banded_attention_batched.launches == 0
    assert flash_decode.launches == 0
    assert np.isfinite(stats["encode_s"])


def test_streaming_modules_import_alone_and_launch_no_kernel_on_cpu():
    """The streaming slice's modules are among those the probe imports, and
    a CPU run of VoxStream and BatchedTranscriber (fused and bucketed
    encoder chunks of T > 1) launches no kernel."""
    from conftest import make_audio
    from voxtral_tpu_torch.config import tiny_config
    from voxtral_tpu_torch.models.params import init_params
    from voxtral_tpu_torch.ops.flash_decode import flash_decode
    from voxtral_tpu_torch.ops.flash_encode import flash_bulk_attention_batched
    from voxtral_tpu_torch.parallel.serving import BatchedTranscriber
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel
    from voxtral_tpu_torch.runtime.stream import VoxStream
    from voxtral_tpu_torch.tokenizer import TekkenTokenizer

    names = {m.name for m in pkgutil.walk_packages(
        voxtral_tpu_torch.__path__, "voxtral_tpu_torch.")}
    assert {"voxtral_tpu_torch.runtime.stream", "voxtral_tpu_torch.mic",
            "voxtral_tpu_torch.models.fused_stream",
            "voxtral_tpu_torch.ops.flash_encode"} <= names
    cfg = tiny_config()
    tok = TekkenTokenizer([bytes([i]) for i in range(256)], 1000)
    flash_bulk_attention_batched.launches = 0
    flash_decode.launches = 0
    audio = make_audio(1.0, seed=4)
    for fused in (True, False):
        engine = VoxtralEngine(cfg, init_params(cfg, seed=1, device="cpu"), tokenizer=tok,
                               enc_kv_ring=64, dec_kv_ring=64,
                               buckets=(16, 4, 1), fused_streaming=fused)
        s = VoxStream(engine)
        s.feed(audio)
        s.finish()
        assert s.n_enc_chunk_calls > 0 and s.n_generated > 0
    tr = BatchedTranscriber(engine, batch=2)
    mel = np.stack([padded_clip_mel(engine, audio)] * 2)
    tr.transcribe(mel, interval_frames=48)
    assert tr.n_enc_chunk_calls > 0 and tr.decode_steps > 0
    assert flash_bulk_attention_batched.launches == 0
    assert flash_decode.launches == 0


def test_mesh_modules_and_spawned_ranks_import_no_jax(tmp_path):
    """The mesh slice's modules are among those the probe imports, and a
    world of spawned ranks (parallel/mesh.py run_ranks, as the mesh tests
    and the dry run start them from this JAX-loaded process) loads no JAX
    and no module of the JAX package."""
    import torch_rank_tasks
    from voxtral_tpu_torch.parallel.mesh import run_ranks

    names = {m.name for m in pkgutil.walk_packages(
        voxtral_tpu_torch.__path__, "voxtral_tpu_torch.")}
    assert {"voxtral_tpu_torch.parallel.mesh", "voxtral_tpu_torch.dryrun",
            "voxtral_tpu_torch.audio.mel_device"} <= names
    mods = run_ranks(torch_rank_tasks.rank_modules, 2, device="cpu",
                     backend="gloo", workdir=tmp_path, timeout=240)
    for m in mods:
        assert "torch.distributed" in m
        bad = [x for x in m if x.split(".")[0]
               in ("jax", "jaxlib", "voxtral_tpu", "ml_dtypes")]
        assert bad == [], bad
