"""Row invariance of the port's streaming encoder side, on the CPU.

On the card the streaming encoder side's products take kernels whose rows'
bits do not depend on how many rows share a call (ops/bf16_mm.py, the int4
and int8 kernels' row-invariant plans), so that a stream's transcript does
not depend on how its audio was chunked.  Here: the plans of those
kernels take no row count while the decode plans stay as they were, the
routing rule (models/decoder.py:_use_rowinv) sends the streaming calls and
only those through them, and on tiny_config() the streaming ids of three
chunkings equal each other (float32, equal to the JAX package's VoxStream
too, and on the int8 rung).  The kernels themselves are checked on the
card (tests/test_torch_cuda.py, chip_smoke.py's rowinv phase)."""

import hashlib
import inspect

import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.config import tiny_config as jax_tiny_config
from voxtral_tpu.runtime import engine as jeng
from voxtral_tpu.runtime import stream as jstream
from voxtral_tpu_torch.config import full_config, tiny_config
from voxtral_tpu_torch.models import bulk_encode, decoder
from voxtral_tpu_torch.models import encoder as enc_mod
from voxtral_tpu_torch.models.fused_stream import ConvTails
from voxtral_tpu_torch.models.params import from_jax_numpy, init_params
from voxtral_tpu_torch.models.quant import quantize_params
from voxtral_tpu_torch.ops import bf16_mm, quant_mm
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime import stream as tstream
from voxtral_tpu_torch.tokenizer import TekkenTokenizer

torch.set_num_threads(1)

# the products of the streaming encoder side at full width: (out, in)
_E = full_config().encoder
STREAM_SHAPES = {
    "wqkv": (3 * _E.qkv_dim, _E.dim), "wo": (_E.dim, _E.qkv_dim),
    "w13": (2 * _E.hidden, _E.dim), "w2": (_E.dim, _E.hidden),
    "adapter_w0": (full_config().adapter_hidden, 4 * _E.dim),
    "adapter_w1": (full_config().decoder.dim, full_config().adapter_hidden),
    "conv0": (_E.dim, _E.conv_kernel * _E.n_mel),
    "conv1": (_E.dim, _E.conv_kernel * _E.dim),
}
LAYER = ("wqkv", "wo", "w13", "w2")
SMS = 132


def _rowinv_plans():
    """(name, plan function, its K argument from in, the plans' tile nj,
    blocks_per_sm(nj, cs), smem(nj, cs), the K chunk) of each
    row-invariant plan."""
    return [
        ("bf16", bf16_mm.bf16_mm_plan, lambda i: i, 8,
         lambda nj, cs: bf16_mm.bf16_mm_blocks_per_sm(),
         lambda nj, cs: max(bf16_mm.bf16_mm_smem(64, seq)
                            for seq in (False, True)), bf16_mm.K_CHUNK),
        ("int8", quant_mm.int8_mm_rowinv_plan, lambda i: i, 8,
         lambda nj, cs: quant_mm.int8_mm_blocks_per_sm(),
         lambda nj, cs: quant_mm.int8_mm_smem(64), quant_mm.INT8_K_CHUNK),
        ("int4", quant_mm.int4_mm_rowinv_plan, lambda i: i // 2, 4,
         quant_mm.int4_mm_blocks_per_sm, quant_mm.int4_mm_smem,
         quant_mm.K_CHUNK),
    ]


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_rowinv_plans_take_no_row_count(kind):
    """Each row-invariant plan is a function of (out, K) and the card: no
    row argument; one mma family for every product (bf16 and int8: the
    ring's 64-row wgmma m64n64k16 tile, int4: its widest mma.sync decode
    tile, never the wgmma prefill tile); a K split of 1..8 blocks of at
    least one chunk each; a wave of clusters the card holds at once, in the
    shared memory an SM has."""
    _, plan_of, k_of, nj, per_sm, smem, chunk = next(
        p for p in _rowinv_plans() if p[0] == kind)
    params = list(inspect.signature(plan_of).parameters)
    assert params[0] == "out" and "rows" not in params and len(params) == 3
    names = STREAM_SHAPES if kind == "bf16" else LAYER
    for name in names:
        out, in_dim = STREAM_SHAPES[name]
        plan = plan_of(out, k_of(in_dim), SMS)
        chunks = -(-k_of(in_dim) // chunk)
        assert plan.nj == nj and plan.nj != 16
        assert 1 <= plan.cs <= min(8, chunks)
        assert plan.per_sm == per_sm(nj, plan.cs) >= 1
        assert plan.clusters * plan.cs <= SMS * plan.per_sm
        assert plan.clusters >= 1 and plan.tiles >= 1
        assert smem(nj, plan.cs) <= 233472 // plan.per_sm


BF16_ROWS = list(range(1, 300)) + [383, 384, 385, 511, 512, 513, 1696,
                                   2128, 2432, 3040]


@pytest.mark.parametrize("name", list(STREAM_SHAPES) + [
    "dec_wqkv", "dec_wo", "dec_w13", "dec_w2", "dec_logits"])
def test_bf16_mm_every_tile_height_one_instruction_sequence(name):
    """bf16_mm's launch at rows 1..299 and up to 3040 (both sides of
    every change of the tile height and of how the split runs): the tile
    holds 64 rows up to 64, and above 128 where its 128-row tiles number
    at least half an SM each; whatever the tile, the grid and the way the
    split runs, a row's sums are the same program: the plan's K ranges (contiguous, non-empty, 1..8 of them,
    covering K, fixed by (out, K)) folded in order, every 64-column chunk
    as four k16 steps of the one wgmma m64n64k16."""
    out, in_dim = (STREAM_SHAPES[name] if name in STREAM_SHAPES
                   else DECODE_SHAPES[name[4:]])
    chunks = in_dim // bf16_mm.K_CHUNK
    want = bf16_mm.bf16_mm_launch(1, out, in_dim, SMS)
    assert want.ranges[0][0] == 0 and want.ranges[-1][1] == chunks
    assert 1 <= len(want.ranges) <= 8
    assert all(lo < hi for lo, hi in want.ranges)
    assert all(a[1] == b[0] for a, b in zip(want.ranges, want.ranges[1:]))
    assert len(want.ranges) == bf16_mm.bf16_mm_plan(out, in_dim, SMS).cs
    seen = set()
    for rows in BF16_ROWS:
        lp = bf16_mm.bf16_mm_launch(rows, out, in_dim, SMS)
        assert (lp.ranges, lp.instruction) == (want.ranges, want.instruction)
        assert lp.instruction == "wgmma.m64n64k16.f32.bf16.bf16"
        tall = -(-out // bf16_mm.BLOCK_N) * -(-rows // 128) >= SMS / 2
        assert lp.tile_rows == (128 if rows > 64 and tall else 64)
        assert lp.seq == bf16_mm.bf16_mm_seq(rows, out, in_dim, SMS)
        assert lp.seq or lp.tile_rows == 64   # clusters: the 64-row tile
        n_tiles = -(-out // bf16_mm.BLOCK_N) * -(-rows // lp.tile_rows)
        per_sm = bf16_mm.bf16_mm_blocks_per_sm(lp.tile_rows, True)
        assert lp.blocks == (min(n_tiles, SMS * per_sm) if lp.seq
                             else n_tiles)
        seen.add((lp.tile_rows, lp.seq))
    assert {t for t, _ in seen} == set(bf16_mm.TILE_ROWS)


def test_bf16_mm_tiles_fit_the_card():
    """Every (tile height, way of running the split) of csrc/bf16_mm.cu
    (the clusters on the 64-row tile only) fits its blocks an SM, two of
    the 64-row tile and one of the 128-row tile: their shared
    memory (ring, barriers, the cluster's fold buffer) within the H100's
    227 KB a block and 228 KB an SM, their 384 threads within the
    register file at the registers a thread the launch gives (80 or 168),
    setmaxnreg's split of those (32 a producer thread and 104 a consumer,
    or 40 and 232) within that allocation, and a consumer's accumulators
    (a range's sums and the ranges folded so far, 32 a 64-row fragment)
    within its share."""
    assert bf16_mm.THREADS == bf16_mm.CONSUMER_THREADS + 128
    for tile, blocks, launch_regs in ((64, 2, 80), (128, 1, 168)):
        assert 65536 // (blocks * bf16_mm.THREADS) // 8 * 8 == launch_regs
        assert (bf16_mm.CONSUMER_THREADS * bf16_mm.CONSUMER_REGS[tile]
                + (bf16_mm.THREADS - bf16_mm.CONSUMER_THREADS)
                * bf16_mm.PRODUCER_REGS[tile]) <= \
            launch_regs * bf16_mm.THREADS
        assert 2 * 32 * (tile // 64) + 32 <= bf16_mm.CONSUMER_REGS[tile]
        for seq in (False, True) if tile == 64 else (True,):
            stages = bf16_mm.bf16_mm_stages(tile, seq)
            smem = bf16_mm.bf16_mm_smem(tile, seq)
            assert smem <= 232448 and blocks * (smem + 1024) <= 233472
            assert bf16_mm.bf16_mm_blocks_per_sm(tile, seq) == blocks
            assert stages >= 3 and 16 * stages + 8 <= 256


# the decode and prefill plans (int8_mm_plan, int4_mm_plan) at the
# decoder's products (out, in) for rows 1..128 and the prefills (38 rows a
# stream), pinned: the sha256 of repr([(name, rows, int4 plan), ...]) as it
# was before the row-invariant plans came beside it, and of repr([(name,
# rows, int8 plan, int8 row-invariant launch's (tile rows, seq, blocks)),
# ...]) since the int8 kernel runs the ring's wgmma tile on both plans; a
# few of them written out below
DECODE_SHAPES = {"wqkv": (6144, 3072), "wo": (3072, 4096),
                 "w13": (18432, 3072), "w2": (3072, 9216),
                 "logits": (131072, 3072)}
DECODE_ROWS = list(range(1, 129)) + [152, 304, 608, 1216, 2128, 3040]
DECODE_PLANS_SHA256 = {
    "int4": "9e5b309b9c35f1c494b2507053b3e4e2c9f6d863b9815d10c40c3360ce01fd48",
    "int8": "3290cadd8a5498e50ff36edf7173ff98a8d5a20b27d27c8e20cbc2dda9965e99",
}
DECODE_PLANS = {  # (name, rows): (int8 plan, int4 plan)
    ("wqkv", 16): ((8, 4, 48, 48, 2), (2, 6, 96, 96, 5)),
    ("wo", 56): ((8, 8, 24, 24, 2), (4, 4, 96, 96, 3)),
    ("w13", 1): ((8, 1, 144, 144, 2), (2, 2, 288, 288, 5)),
    ("logits", 56): ((8, 1, 264, 1024, 2), (4, 1, 396, 4096, 3)),
    ("w2", 2128): ((16, 1, 132, 408, 1), (16, 1, 132, 408, 1)),
}


def test_decode_plans_unchanged():
    """The decode and prefill plans of the int8 and int4 kernels are the
    pinned ones for every decoder product at every row count (the decode
    path keeps its bits; the int4 plans as before the row-invariant plans,
    the int8 ones as the ring tile's), and so are the int8 kernel's
    row-invariant launches."""
    plans = {
        "int4": [(name, r, tuple(quant_mm.int4_mm_plan(r, o, i // 2)))
                 for name, (o, i) in DECODE_SHAPES.items()
                 for r in DECODE_ROWS],
        "int8": [(name, r, tuple(quant_mm.int8_mm_plan(r, o, i)),
                  tuple(quant_mm.int8_mm_launch(r, o, i, SMS, True)[:3]))
                 for name, (o, i) in DECODE_SHAPES.items()
                 for r in DECODE_ROWS]}
    for kind, got in plans.items():
        assert hashlib.sha256(repr(got).encode()).hexdigest() == \
            DECODE_PLANS_SHA256[kind], kind
    for (name, r), (p8, p4) in DECODE_PLANS.items():
        o, i = DECODE_SHAPES[name]
        assert tuple(quant_mm.int8_mm_plan(r, o, i)) == p8
        assert tuple(quant_mm.int4_mm_plan(r, o, i // 2)) == p4


@pytest.mark.parametrize("cdtype,call,want", [
    (torch.bfloat16, "stream", True),
    (torch.float32, "stream", False),     # float32 witnesses keep torch.mm
    (torch.bfloat16, "bulk", False),      # bulk encoder and window mode
    (torch.float32, "bulk", False),
])
def test_rowinv_predicate(cdtype, call, want):
    assert decoder._use_rowinv(cdtype, call) is want
    if call == "stream":   # T == 1 takes the chunk attention on the route
        assert enc_mod.chunk_attention(1, cdtype) is want
    assert enc_mod.chunk_attention(2, cdtype) is True


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls that reach bf16_mm (and those whose weight is the
    transpose view of a stored [in, out], `bf16_kn`), and the int8
    products by their rowinv argument."""
    seen = {"bf16": 0, "bf16_kn": 0, "int8_rowinv": 0, "int8_plain": 0}
    real_bf16, real_int8 = bf16_mm.bf16_mm, quant_mm.int8_mm

    def bf16(x, w):
        seen["bf16"] += 1
        assert x.is_contiguous()
        # raises on a layout the kernel does not take
        seen["bf16_kn"] += bf16_mm.weight_layout(w)
        return real_bf16(x, w)

    def int8(x, w, s, li, rowinv=False):
        seen["int8_rowinv" if rowinv else "int8_plain"] += 1
        return real_int8(x, w, s, li, rowinv=rowinv)

    monkeypatch.setattr(bf16_mm, "bf16_mm", bf16)
    monkeypatch.setattr(quant_mm, "int8_mm", int8)
    return seen


def _engine(cfg, params, **kw):
    return teng.VoxtralEngine(cfg, params, buckets=(16, 4, 1),
                              enc_kv_ring=64, dec_kv_ring=64, **kw)


@pytest.mark.parametrize("encoder_int8", [False, True])
def test_stream_calls_take_the_rowinv_route(calls, encoder_int8):
    """bf16 tiny config: a fused chunk, and the unfused conv0/conv1/encode/
    adapter calls, send every float product through bf16_mm (the conv
    stem's two, four a layer, the adapter's two) or, with an int8 encoder,
    its layer products to int8_mm on the row-invariant plan; the bulk
    encoder and window mode send none.  The conv stem's weights are read
    where the model holds them ([in, out], no copy).  Their rows equal the
    plain functions' (the CPU wrappers take them)."""
    cfg = tiny_config(compute_dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu")
    if encoder_int8:
        params = quantize_params(params, decoder=False, bits=8)
    eng = _engine(cfg, params)
    e = cfg.encoder
    layer = 0 if encoder_int8 else 4 * e.n_layers
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, e.n_mel)).astype(np.float32))

    rows, _, _ = eng.fused_encode(mel, ConvTails.create(cfg),
                                  eng.new_enc_cache(), 0)
    assert calls["bf16"] == 2 + layer + 2 and calls["bf16_kn"] == 2
    assert calls["int8_rowinv"] == (4 * e.n_layers if encoder_int8 else 0)
    c0, _ = eng.conv0(mel, torch.zeros((1, 2, e.n_mel)))
    c1, _ = eng.conv1(c0, torch.zeros((1, 2, e.dim), dtype=cfg.cdtype))
    y, _ = eng.encode(c1, eng.new_enc_cache(), 0)
    rows2 = eng.adapter(y)
    assert calls["bf16"] == 2 * (2 + layer + 2)
    assert torch.equal(rows, rows2)          # the same function, unfused
    assert calls["int8_plain"] == 0
    before = dict(calls)
    bulk_encode.bulk_encode_clip(params["encoder"], params["adapter"], cfg,
                                 mel)
    xwin = torch.zeros((1, 8, e.dim), dtype=cfg.cdtype)
    bulk_encode.window_encode_chunk(
        params["encoder"], params["adapter"], cfg, mel,
        torch.zeros((1, 2, e.n_mel)), torch.zeros((1, 2, e.dim),
                                                  dtype=cfg.cdtype),
        xwin, torch.zeros(1, dtype=torch.int32))
    assert calls["bf16"] == before["bf16"]
    assert calls["int8_rowinv"] == before["int8_rowinv"]


def test_float32_streams_keep_torch_mm(calls):
    """A float32 config (the witnesses) never takes the row-invariant
    route."""
    cfg = tiny_config()
    eng = _engine(cfg, init_params(cfg, seed=0, device="cpu"))
    mel = torch.zeros((1, 16, cfg.encoder.n_mel))
    eng.fused_encode(mel, ConvTails.create(cfg), eng.new_enc_cache(), 0)
    assert calls == {"bf16": 0, "bf16_kn": 0, "int8_rowinv": 0,
                     "int8_plain": 0}


# three chunkings of one clip, as chip_smoke.py's stream phase feeds it:
# (feed samples, interval seconds or None for the default, fused)
CHUNKINGS = {"1s_at_2s": (16000, None, True),
             "0.5s_at_0.5s": (8000, 0.5, True),
             "1s_at_2s_unfused": (16000, None, False)}
AUDIO = make_audio(2.6, seed=29)


def _ids(stream_cls, engine, feed_n, interval):
    s = stream_cls(engine)
    s.record_ids = True
    if interval is not None:
        s.set_processing_interval(interval)
    for i in range(0, len(AUDIO), feed_n):
        s.feed(AUDIO[i: i + feed_n])
    s.finish()
    return s.generated_ids


@pytest.mark.parametrize("rung", ["float32", "int8"])
def test_stream_ids_equal_across_chunkings(params, params_np, tiny_tokenizer,
                                           rung):
    """tiny_config() with the JAX package's weights: the streaming ids of
    the three chunkings equal each other; in float32 they also equal the
    JAX package's VoxStream fed the first way.  The int8 rung quantizes
    the encoder's layers too (their products through int8_mm's
    row-invariant route) and the decoder as the engine does."""
    cfg = tiny_config()
    tparams = from_jax_numpy(params_np)
    tok = TekkenTokenizer([bytes([i]) for i in range(256)], 1000)
    quantize = False
    if rung == "int8":
        tparams = quantize_params(tparams, decoder=False, bits=8)
        quantize = "int8"
    got = {name: _ids(tstream.VoxStream,
                      _engine(cfg, tparams, tokenizer=tok,
                              fused_streaming=fused, quantize=quantize),
                      feed_n, interval)
           for name, (feed_n, interval, fused) in CHUNKINGS.items()}
    first = got["1s_at_2s"]
    assert len(first) > 20
    assert all(ids == first for ids in got.values())
    if rung == "float32":
        je = jeng.VoxtralEngine(jax_tiny_config(), params,
                                tokenizer=tiny_tokenizer, buckets=(16, 4, 1),
                                enc_kv_ring=64, dec_kv_ring=64)
        assert _ids(jstream.VoxStream, je, 16000, None) == first
