"""Batch invariance of the port's decoder side, on the CPU.

On the card a stream's decoder rows must not depend on how many streams
share its call (the JAX package's promise, voxtral_tpu/parallel/
scheduler.py: "Burst partition cannot change transcripts").  In a bf16
config the decoder's products take the row-invariant kernels
(ops/bf16_mm.py, the int kernels' row-invariant plans), the ring path's
attention products run one stream at a time, and flash-decode's split
takes no batch size (tests/test_torch_flash_decode.py).  Here: the
routing rule (models/decoder.py:_use_rowinv) sends every decoder call of
a bf16 config through them and leaves float32 alone, counted with
stand-ins; ring_attention's per-stream products are a B=1 call's; and on
tiny_config() in bf16 with the JAX package's weights a BatchedTranscriber
stream and a ring-pool slot give the ids of the port's VoxStream on the
same audio.  The kernels themselves are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py's batchinv phase)."""

import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder, jacobi
from voxtral_tpu_torch.models.params import from_jax_numpy, init_params
from voxtral_tpu_torch.ops import bf16_mm, quant_mm
from voxtral_tpu_torch.ops.ring import ring_attention
from voxtral_tpu_torch.parallel import serving
from voxtral_tpu_torch.parallel.scheduler import StreamPool
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime.stream import VoxStream
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)

KW = dict(buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)


@pytest.fixture
def seen(monkeypatch):
    """Counts the products that reach bf16_mm and the int kernels, by
    their rowinv argument, and the decoder's norms (ops/norms.py:
    add_rms_norm, whose kernel is row-invariant)."""
    got = {"bf16": 0, "int8_rowinv": 0, "int8_rows": 0, "int4_rowinv": 0,
           "int4_rows": 0, "norm": 0}
    real = (bf16_mm.bf16_mm, quant_mm.int8_mm, quant_mm.int4_mm,
            decoder.add_rms_norm)

    def bf16(x, w):
        got["bf16"] += 1
        return real[0](x, w)

    def norm(x, w, eps, *a, **k):
        got["norm"] += 1
        return real[3](x, w, eps, *a, **k)

    def counted(kind, fn):
        def f(x, w, s, li, rowinv=False):
            got[f"{kind}_{'rowinv' if rowinv else 'rows'}"] += 1
            return fn(x, w, s, li, rowinv=rowinv)
        return f

    monkeypatch.setattr(bf16_mm, "bf16_mm", bf16)
    monkeypatch.setattr(quant_mm, "int8_mm", counted("int8", real[1]))
    monkeypatch.setattr(quant_mm, "int4_mm", counted("int4", real[2]))
    monkeypatch.setattr(decoder, "add_rms_norm", norm)
    return got


@pytest.mark.parametrize("rung", ["bf16", "int8", "int4", "float32"])
def test_decoder_calls_take_the_rowinv_route(seen, rung):
    """A B=3 prefill of 5 rows, a B=3 burst of 4 steps and one Jacobi
    window of 4 rows at B=1: in bf16 every layer product (4 a layer and
    pass) and every logits call goes through bf16_mm, or, on the int8 and
    int4 rungs, through the int kernel's row-invariant plan, none through
    a row-count plan; float32 takes none of them.  Every norm (2 a layer
    and pass, the final one a logits call) goes through the one norm,
    whose kernel is row-invariant, on every rung."""
    cdtype = "float32" if rung == "float32" else "bfloat16"
    cfg = tiny_config(compute_dtype=cdtype)
    eng = teng.VoxtralEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                             quantize=rung if rung in ("int8", "int4")
                             else False, **KW)
    dp, ada, dim = eng.params["decoder"], eng.ada(), cfg.decoder.dim
    gen = torch.Generator().manual_seed(3)
    cache = eng.new_dec_cache(3)
    serving.bprefill(dp, cfg, torch.randn((3, 5, dim), generator=gen), cache,
                     torch.zeros(3, dtype=torch.int32), ada)
    serving.bdecode_burst(dp, cfg, torch.randn((3, 4, dim), generator=gen),
                          torch.full((3,), 32, dtype=torch.int32), cache,
                          torch.full((3,), 5, dtype=torch.int32), ada)
    one = eng.new_dec_cache(1)
    *_, iters = jacobi.decode_burst_jacobi(
        dp, cfg, torch.randn((1, 4, dim), generator=gen), 32, one, 0, ada,
        window=4)
    nl = cfg.decoder.n_layers
    passes = 1 + 4 + iters                  # forward passes
    logits = 4 + iters                      # logits calls
    want = dict.fromkeys(seen, 0)
    if rung == "bf16":
        want["bf16"] = 4 * nl * passes + logits
    elif rung in ("int8", "int4"):
        want[f"{rung}_rowinv"] = 4 * nl * passes + logits
    want["norm"] = 2 * nl * passes + logits
    assert seen == want


@pytest.mark.parametrize("cdtype,call,want", [
    (torch.bfloat16, "decoder", True), (torch.bfloat16, "stream", True),
    (torch.float32, "decoder", False), (torch.float32, "stream", False)])
def test_rowinv_rule_covers_every_decoder_call(cdtype, call, want):
    """One predicate, by caller and dtype alone: the decoder (every call
    of it) and the streaming encoder side of a bf16 config take the route,
    the same callers in float32 and the bulk encoder do not."""
    assert decoder._use_rowinv(cdtype, call) is want
    assert decoder._use_rowinv(cdtype, "bulk") is False


@pytest.mark.parametrize("ring", [torch.bfloat16, torch.float8_e4m3fn])
def test_ring_attention_per_stream_products_are_b1_calls(ring):
    """ring_attention(per_stream=True) at B=3, T=5 gives each stream the
    bits of a B=1 call on that stream alone, and the batched products'
    values within float rounding."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((3, 5, 8, 16), generator=gen).to(torch.bfloat16)
    k = torch.randn((3, 2, 64, 16), generator=gen).to(ring)
    v = torch.randn((3, 2, 64, 16), generator=gen).to(ring)
    pos = torch.tensor([0, 30, 100], dtype=torch.int32)
    kw = dict(window=48, out_dtype=torch.float32)
    got = ring_attention(q, k, v, pos, per_stream=True, **kw)
    for b in range(3):
        alone = ring_attention(q[b: b + 1], k[b: b + 1], v[b: b + 1],
                               pos[b: b + 1], per_stream=True, **kw)
        assert torch.equal(got[b: b + 1], alone)
    np.testing.assert_allclose(got.numpy(), ring_attention(
        q, k, v, pos, **kw).numpy(), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def bf16_engine(params_np):
    tok = TekkenTokenizer([bytes([i]) for i in range(256)], 1000)
    return teng.VoxtralEngine(tiny_config(compute_dtype="bfloat16"),
                              from_jax_numpy(params_np), tokenizer=tok, **KW)


def _voxstream_ids(eng, audio, feed_n=8000, interval=0.25):
    s = VoxStream(eng)
    s.record_ids = True
    s.set_processing_interval(interval)
    for i in range(0, len(audio), feed_n):
        s.feed(audio[i: i + feed_n])
    s.finish()
    return s.generated_ids


def test_bf16_transcriber_stream_equals_voxstream(bf16_engine):
    """bf16: each stream of a B=3 BatchedTranscriber gives the port's
    VoxStream's ids on its clip (over the ids both have)."""
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    audios = [make_audio(2.0, seed=40 + i) for i in range(3)]
    mel = torch.from_numpy(np.stack([padded_clip_mel(bf16_engine, a)
                                     for a in audios]))
    tr = serving.BatchedTranscriber(bf16_engine, batch=3, dec_kv_ring=64)
    got = tr.transcribe(mel, interval_frames=48)
    for i, audio in enumerate(audios):
        want = _voxstream_ids(bf16_engine, audio, feed_n=16000, interval=0.5)
        m = min(len(got[i]), len(want))
        assert m > 10 and got[i][:m] == want[:m], i


def test_bf16_pool_slot_equals_voxstream(bf16_engine):
    """bf16: the ring-mode pool's slots give VoxStream's full transcripts
    (the shorter clip drains early and rides along)."""
    audios = [make_audio(2.4, seed=1), make_audio(1.7, seed=2)]
    pool = StreamPool(bf16_engine, 3, dec_kv_ring=64, enc_mode="ring")
    pool.record_ids = True
    slots = []
    for _ in audios:
        i = pool.add_stream()
        pool.set_processing_interval(i, 0.25)
        slots.append(i)
    for off in range(0, max(len(a) for a in audios), 8000):
        for i, a in zip(slots, audios):
            if off < len(a):
                pool.feed(i, a[off: off + 8000])
        pool.tick()
    for i in slots:
        pool.finish(i)
    for i, audio in zip(slots, audios):
        want = _voxstream_ids(bf16_engine, audio)
        assert len(want) > 10
        assert pool.slots[i].generated_ids == want, i
