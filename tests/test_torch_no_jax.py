"""The port stands alone: importing every module of voxtral_tpu_torch loads
neither JAX nor the JAX package (nor ml_dtypes), and running the offline
path on CPU tensors launches no kernel."""

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
import importlib, pkgutil, sys
import voxtral_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "voxtral_tpu", "ml_dtypes"))
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
    engine = VoxtralEngine(cfg, init_params(cfg, seed=1), dec_kv_ring=64,
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
