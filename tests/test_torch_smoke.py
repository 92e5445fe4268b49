"""chip_smoke.py's slice, serve, qkv_rope, flash_enc, int8, stream, bstream,
jacobi, pool, mesh, mel_device and bench phases rehearsed on the CPU at tiny
size.
CPU tensors launch no kernel, so the plain functions stand in for the
kernels and count as their launches; the phases' own checks (exact launch
counts per rung, ids in range, identical second runs, kernel path against
plain path) then run as they do on the card."""

import functools

import pytest
import torch

import chip_smoke as cs
from voxtral_tpu_torch.config import tiny_config
from test_torch_graphs import stand_in  # noqa: F401  (a fixture)
from voxtral_tpu_torch.models import bulk_encode, decoder, encoder, jacobi
from voxtral_tpu_torch.ops import (
    banded_encode,
    flash_decode,
    flash_encode,
    norms,
    quant_mm,
    ring,
    rope,
)

torch.set_num_threads(1)


def _counted(kernel_fn, plain_fn, own=False):
    """plain_fn, adding one per call to the kernel wrapper's counter, which
    the phases reset and read (`own`: the stand-in's copy of it, for a
    wrapper the phases import by name)."""
    @functools.wraps(kernel_fn)
    def f(*args, rowinv=False, **kwargs):   # the int kernels' plan choice
        (f if own else kernel_fn).launches += 1
        return plain_fn(*args, **kwargs)
    return f


@pytest.fixture
def counted_kernels(monkeypatch):
    monkeypatch.setattr(bulk_encode, "banded_attention_batched", _counted(
        banded_encode.banded_attention_batched,
        banded_encode.banded_attention_plain))
    monkeypatch.setattr(decoder, "flash_decode", _counted(
        flash_decode.flash_decode, flash_decode.flash_decode_plain))
    monkeypatch.setattr(encoder, "flash_bulk_attention_batched", _counted(
        flash_encode.flash_bulk_attention_batched,
        flash_encode.flash_encode_plain))
    monkeypatch.setattr(decoder, "ring_rows_write", _counted(
        ring.ring_rows_write, ring.ring_rows_write_plain))
    # phase_serve imports int4_mm and int8_mm from their module, so it reads
    # the stand-ins' counters
    monkeypatch.setattr(quant_mm, "int4_mm", _counted(
        quant_mm.int4_mm, quant_mm.int4_mm_plain, own=True))
    monkeypatch.setattr(quant_mm, "int8_mm", _counted(
        quant_mm.int8_mm, quant_mm.int8_mm_plain, own=True))
    # every norm of the model (each an add_rms_norm call), counted as the
    # norm kernel's launches; the phases model them from the model's
    # passes (chip_smoke.decoder_calls)
    for mod in (decoder, encoder, bulk_encode):
        monkeypatch.setattr(mod, "add_rms_norm", _counted(
            norms.rms_norm, norms.add_rms_norm_plain))
        # each layer's qkv epilogue, counted as the qkv_rope kernel's
        monkeypatch.setattr(mod, "qkv_rope", _counted(
            rope.qkv_rope, rope.qkv_rope_plain))
    with cs.decoder_calls():
        yield
    for fn in (banded_encode.banded_attention_batched,
               flash_decode.flash_decode, ring.ring_rows_write,
               flash_encode.flash_bulk_attention_batched, norms.rms_norm,
               rope.qkv_rope):
        fn.launches = 0


def test_slice_and_serve_phases_on_cpu(counted_kernels):
    # the engine's encoder ring must hold its window (24) and the largest
    # bucket (64)
    cfg = tiny_config(enc_kv_ring=128)
    params = cs.make_params(cfg, "cpu")
    sl = cs.phase_slice(cfg, params, "cpu", (1.2, 2.0))
    assert sl["launches"][0] == 2 * cfg.encoder.n_layers
    assert sl["launches"][1] == cfg.decoder.n_layers * sum(
        c["decode_steps"] for c in sl["clips"])
    assert sl["launches"][4] == sum(
        cfg.decoder.n_layers * (1 + c["decode_steps"]) + cfg.encoder.n_layers
        for c in sl["clips"])

    sv = cs.phase_serve(cfg, params, "cpu", n_streams=3, seconds=2.0,
                        dec_ring=64, extra_steps=4)
    rungs = {r["rung"]: r for r in sv["rungs"]}
    assert list(rungs) == ["bf16", "fp8kv", "int8", "int4", "int4deq"]
    assert [r["runs"] for r in rungs.values()] == [2, 1, 1, 1, 1]
    steps = rungs["bf16"]["decode_steps"]
    # every rung decodes through flash-decode, fp8 rings included; the
    # row-write kernel runs in the fp8kv rung's "xla" mid-fill burst; the
    # int4 and int8 rungs each their product, one launch a layer product of
    # the prefill and 4 a layer + the table a step; every rung its norms:
    # 2 a layer of the prefill and of each step, the final norm a step, 2 a
    # layer and the final one of the bulk encoder pass; and its qkv
    # epilogues, one a layer of each of those passes
    nl, ne = cfg.decoder.n_layers, cfg.encoder.n_layers
    quant = 4 * nl + (4 * nl + 1) * steps
    assert sv["launches"] == {
        "banded_attention_batched": 5 * ne,
        "flash_decode": 5 * nl * steps,
        "ring_rows_write": nl * 4,
        "int4_mm": quant, "int8_mm": quant, "bf16_mm": 0,
        "rms_norm": 5 * (2 * nl + (2 * nl + 1) * steps + 2 * ne + 1),
        "qkv_rope": 5 * (nl * (1 + steps) + ne),
    }
    assert rungs["int8"]["launches"]["int8_mm"] == quant
    assert rungs["fp8kv"]["launches_xla_mid_fill"] == {
        "banded_attention_batched": 0, "flash_decode": 0,
        "ring_rows_write": nl * 4, "int4_mm": 0,
        "int8_mm": 0, "bf16_mm": 0, "rms_norm": (2 * nl + 1) * 4,
        "qkv_rope": nl * 4}
    assert rungs["bf16"]["stream0_agree_b1"] == 1.0   # f32 on the CPU
    for name in ("fp8kv", "int8", "int4", "int4deq"):
        assert 0.0 <= rungs[name]["agree_bf16"] <= 1.0
    # f32 weights and activations: the dequantized rung differs from the
    # int4 one only in the f32 rounding of its sums, and gives its ids
    assert rungs["int4deq"]["agree_int4"] == 1.0
    assert rungs["int4deq"]["int4_max_quant_steps"] <= 0.5 + 1e-5


def test_dequantize4_rejects_a_wrong_scale():
    """dequantize4's bound catches an int4 table whose scales are off."""
    from voxtral_tpu_torch.models.quant import quantize_params

    cfg = tiny_config()
    params = cs.make_params(cfg, "cpu")
    q = quantize_params(params, encoder=False, bits=4)
    _, worst = cs.dequantize4(q, params)
    assert 0.4 < worst <= 0.5 + cs.QUANT4_STEP_SLACK
    bad = dict(q["decoder"])
    bad["tok_embeddings_scale"] = bad["tok_embeddings_scale"] * 1.1
    with pytest.raises(AssertionError, match="tok_embeddings"):
        cs.dequantize4({**q, "decoder": bad}, params)


# FLASH_ENC_FULL's cases at tiny width: a 64-slot ring holds the window
# (24) beside the largest chunk (24 rows); 60 slots for the ragged edge;
# the bench ring's cases on 96 slots (window + 72 rows)
TINY_FLASH_ENC = dict(n_layers=2, heads=4, head_dim=16, cap=64,
                      ragged_cap=60, window=24, ts=(4, 16, 20),
                      positions=(0, 7, 30, 300), prefill=40,
                      splits=((24,), (8, 8, 8), (10, 10, 4)),
                      bench=dict(cap=96, cases=((1, 32, (0, 32, 96)),
                                                (1, 12, (96,)),
                                                (1, 72, (0, 200)),
                                                (2, 32, (0, 160)))))


def test_flash_enc_phase_on_cpu():
    """The wrapper runs the plain version on CPU tensors, so the
    comparison reads 0 and the chunking check holds the plain version
    bitwise."""
    out = cs.phase_flash_enc("cpu", TINY_FLASH_ENC, batches=(1, 3))
    assert out == {"max_abs_err": 0.0, "bitwise_invariant": True}
    assert flash_encode.flash_bulk_attention_batched.launches == 0


# INT8_FULL's cases at tiny width: five products (in a multiple of 128, as
# the kernel takes), 3 layers, the step at 2 and 5 rows, a 20-row prefill
TINY_INT8 = dict(products={"wqkv": (48, 256), "wo": (32, 128),
                           "w13": (96, 256), "w2": (32, 384),
                           "logits": (160, 256)},
                 layers=3, step_rows=(2, 5), rows=(1, 2, 5, 8, 20),
                 prefill_rows=(20,))


def test_int8_phase_on_cpu(counted_kernels):
    """The int8 phase at tiny width: every product of the decode step at
    both row counts and the last layer's at every row count checked (the
    plain version against itself: error 0, two calls equal), two counted
    launches a check; no timing off the card."""
    out = cs.phase_int8("cpu", TINY_INT8)
    n_layers = TINY_INT8["layers"]
    assert out["step_products"] == 4 * n_layers + 1
    # on both plans (INT8_PLANS)
    assert out["checked_products"] == 2 * (2 * (4 * n_layers + 1)
                                           + 5 * 4 + 4)
    assert out["max_abs_err"] == 0.0 and out["max_rel_err"] == 0.0
    assert out["library_ms"] is None and "ms" not in out
    assert out["bound_by"] == "bytes" and out["bound_ms"] > 0
    assert quant_mm.int8_mm.launches == 0      # the phase resets its count


def test_rowinv_phase_on_cpu(counted_kernels, monkeypatch):
    """The rowinv phase at tiny width: the bf16 product on every product
    of the streaming encoder side and the int8 and int4 kernels'
    row-invariant plans on a layer's four, each checked at every row count
    (the plain version against itself: error 0), no timing off the card,
    and the counters it used reset."""
    from voxtral_tpu_torch.ops import bf16_mm

    monkeypatch.setattr(bf16_mm, "bf16_mm", _counted(
        bf16_mm.bf16_mm, bf16_mm.bf16_mm_plain, own=True))
    cfg = tiny_config(compute_dtype="bfloat16")
    rows = (1, 2, 5, 24)
    out = cs.phase_rowinv("cpu", cfg, rows_list=rows)
    shapes = cs.rowinv_shapes(cfg)
    assert out["checked"] == (len(shapes) + 2 * len(cs.ROWINV_LAYER)) \
        * len(rows)
    assert (out["max_abs_err_bf16"], out["max_abs_err_int8"],
            out["max_abs_err_int4"]) == (0.0, 0.0, 0.0)
    assert out["torch_mm_varies_at"] == {}
    assert not any(k.endswith(f"_rows{n}") for k in out for n in rows)
    assert (bf16_mm.bf16_mm.launches, quant_mm.int8_mm.launches,
            quant_mm.int4_mm.launches) == (0, 0, 0)


def test_qkv_rope_phase_on_cpu(counted_kernels):
    """The qkv_rope phase at tiny width on the CPU, where the kernel's
    wrapper runs the plain version: at a step, a ring chunk with bias, a
    bulk layer on the shared table and an f32 step, q, k and v equal the
    torch sequence's and a second call's, v is a view of qkv exactly where
    no bias and an f32 v leave nothing to write, nothing launches and
    nothing is timed off the card."""
    cfg = tiny_config(compute_dtype="bfloat16")
    shapes = {
        "step": (3, 1, "decoder", False, False, "bfloat16", "float32"),
        "ring": (2, 5, "encoder", True, False, "bfloat16", "float32"),
        "bulk": (2, 7, "encoder", True, True, "bfloat16", "bfloat16"),
        "f32": (2, 3, "decoder", False, False, "float32", "float32"),
    }
    out = cs.phase_qkv_rope("cpu", cfg, shapes)
    for name in shapes:
        for check in ("plain", "twice", "v_view"):
            assert out[f"qkv_rope_{check}_equal_{name}"] is True
        assert out[f"qkv_rope_launches_per_call_{name}"] == 0
        assert f"qkv_rope_ms_{name}" not in out
    assert rope.qkv_rope.launches == 0


@pytest.mark.parametrize("route, routed", [
    ("plain_kernels", ("decoder", "encoder", "bulk_encode")),
    ("cublas_stream", ("decoder", "encoder", "bulk_encode")),
    ("parent_decoder_route", ("decoder",)),
])
def test_reference_routes_take_the_plain_qkv_epilogue(counted_kernels, route,
                                                      routed):
    """The smoke's reference routes send the qkv epilogue of the modules
    they cover to the torch sequence (qkv_rope_plain) through an
    uncounted stand-in, so a kernel-path check never compares the kernel
    with itself; every module gets its own function back afterwards."""
    mods = {"decoder": decoder, "encoder": encoder,
            "bulk_encode": bulk_encode}
    before = {n: m.qkv_rope for n, m in mods.items()}
    with getattr(cs, route)():
        for n, m in mods.items():
            plain = m.qkv_rope.__wrapped__ is rope.qkv_rope_plain
            assert plain == (n in routed)
            if plain:
                assert m.qkv_rope.launches == 0
    assert {n: m.qkv_rope for n, m in mods.items()} == before


def test_stream_and_bstream_phases_on_cpu(counted_kernels):
    cfg = tiny_config(enc_kv_ring=128)
    params = cs.make_params(cfg, "cpu")
    st = cs.phase_stream(cfg, params, "cpu", seconds=2.5)
    assert [r["run"] for r in st["runs"]] == [
        "1s_at_2s", "0.5s_at_0.5s", "1s_at_2s_unfused"]
    for r in st["runs"]:
        assert r["encoder_chunks"] > 0 and r["decode_steps"] > 0
        assert r["launches"] == {
            "flash_bulk_attention_batched":
                cfg.encoder.n_layers * r["encoder_chunks"],
            "flash_decode": cfg.decoder.n_layers * r["decode_steps"],
            "banded_attention_batched": 0}
    # f32 on the CPU: every chunking gives the offline path's ids, and the
    # offline path teacher-forced on each run's ids predicts every one
    assert set(st["agreement"].values()) == {1.0}
    assert set(st["teacher_forced_offline"].values()) == {1.0}
    assert st["launches"]["flash_bulk_attention_batched"] == sum(
        r["launches"]["flash_bulk_attention_batched"] for r in st["runs"])
    # the e4m3 encoder ring: "auto" sends every chunk to flash-encode (its
    # stand-in), the parent's route none; f32 on the CPU: equal ids (CPU
    # products are not row-invariant: rows are compared, not gated)
    fp8 = st["fp8_enc_ring"]
    assert set(fp8) == {"auto", "parent"}
    assert fp8["parent"]["attn_impl"] == "xla"
    for route, rec in fp8.items():
        assert set(rec["agreement"].values()) == {1.0}
        assert set(rec["rows_diff"]) == set(st["rows_diff"])
        for r in rec["runs"].values():
            assert r["encoder_chunks"] > 0
            assert r["launches"]["flash_bulk_attention_batched"] == (
                cfg.encoder.n_layers * r["encoder_chunks"]
                if route == "auto" else 0)

    bst = cs.phase_bstream(cfg, params, "cpu", n_streams=3, seconds=2.0,
                           dec_ring=64, interval_frames=48)
    assert bst["encoder_chunks"] > 0 and bst["decode_steps"] > 0
    assert bst["launches"] == {
        "flash_bulk_attention_batched":
            cfg.encoder.n_layers * bst["encoder_chunks"],
        "flash_decode": cfg.decoder.n_layers * bst["decode_steps"],
        "banded_attention_batched": 0}
    assert bst["compared"] > 0 and 0.0 <= bst["stream0_agree_b1"] <= 1.0


def test_jacobi_phase_on_cpu(counted_kernels):
    """The jacobi phase at tiny size: "auto" takes Jacobi for the 64-row
    bursts (which launch no flash-decode), the counts are exact, f32 ids
    equal the sequential ones, and the small config's check passes.  The
    decoder window (256) lets the clip's adaptive ring hold every position,
    as the full config's does: a 64-row window written into a ring that
    wraps within the attention window would overwrite keys its own first
    rows attend."""
    cfg = tiny_config(enc_kv_ring=128, dec_window=256, dec_kv_ring=256)
    params = cs.make_params(cfg, "cpu")
    jac = cs.phase_jacobi(cfg, params, "cpu", seconds=8.0)
    auto, seq = jac["runs"]["auto"], jac["runs"]["sequential"]
    assert auto["jacobi_steps"] >= 64 and seq["jacobi_steps"] == 0
    assert auto["jacobi_iters"] >= auto["jacobi_steps"] // 64
    assert auto["launches"]["flash_decode"] == cfg.decoder.n_layers * (
        auto["decode_steps"] - auto["jacobi_steps"])
    assert jac["agree"] == 1.0 and auto["ids"] == seq["ids"]
    assert [c["first_diff"] for c in jac["f32_checks"]] == [None, None]
    assert jac["launches_banded"] == 2 * cfg.encoder.n_layers


def test_graphs_phase_on_cpu(counted_kernels, stand_in, monkeypatch):
    """The graphs phase at tiny size with test_torch_graphs' stand-in for
    the CUDA graph and the rule's device test dropped, so the graphed
    paths run: serve (eagerly too on GRAPHS_EAGER_SERVE's rungs), mid-fill
    bursts (fp8kv also under "xla"), the B=1 stream and the Jacobi clip
    give the eager ids, each way with its exact launch counts; one step's
    logits are bit-equal; every graphed path captured."""
    for mod in (decoder, encoder, jacobi):
        monkeypatch.setattr(mod, "_use_graph", lambda cfg, cache, x, call:
                            call in decoder.GRAPHED_CALLS
                            and cache.graphs is not None)
    cfg = tiny_config(enc_kv_ring=128, dec_window=256, dec_kv_ring=256)
    params = cs.make_params(cfg, "cpu")
    gr = cs.phase_graphs(cfg, params, "cpu", n_streams=3, seconds=2.0,
                         dec_ring=64, extra_steps=4, stream_seconds=2.5,
                         jacobi_seconds=8.0)
    rungs = {r["rung"]: r for r in gr["rungs"]}
    assert list(rungs) == ["bf16", "fp8kv", "int8", "int4"]
    nl = cfg.decoder.n_layers
    for name, r in rungs.items():
        assert r["logits_bit_equal"] and r["decode_steps"] > 0
        assert r["serve_captures_graph"] > 0
        # the whole serve also runs eagerly on these rungs only
        assert (r.get("serve_captures_eager") == 0) == (
            name in cs.GRAPHS_EAGER_SERVE)
    assert rungs["fp8kv"]["launches_xla_mid_fill_graph"]["ring_rows_write"] \
        == nl * 8
    # the int8 rung's graphed step on the plain path and on the kernel
    assert 0.0 <= rungs["int8"]["ab_agree_ids"] <= 1.0
    assert gr["launches"]["ring_rows_write"] == 2 * nl * 8
    assert gr["stream"]["captures_eager"] == 0 < gr["stream"]["captures_graph"]
    assert gr["jacobi"]["jacobi_steps"] >= 64
    assert gr["captures"]["graphs"] > 0


def test_jacobi_near_tie_rule():
    """jacobi_vs_sequential reads the sequential top-2 gap where the ids
    part: equal ids pass, and a real difference is no near-tie."""
    cfg = cs.small_config("float32")
    params = cs.make_params(cfg, "cpu")
    from voxtral_tpu_torch.models import jacobi
    from voxtral_tpu_torch.models.decoder import ada_scales

    ada = ada_scales(params["decoder"], cfg)
    rows = torch.randn((1, 16, cfg.decoder.dim),
                       generator=torch.Generator().manual_seed(1))
    assert cs.jacobi_vs_sequential(params, cfg, rows, ada, 8)[
        "first_diff"] is None
    # the Jacobi side decodes with the final norm negated: its argmaxes
    # differ from the first position on, far from a tie
    bumped = dict(params["decoder"])
    bumped["final_norm"] = -bumped["final_norm"]
    real = jacobi.decode_burst_jacobi
    jacobi.decode_burst_jacobi = lambda p, *a, **kw: real(bumped, *a, **kw)
    try:
        res = cs.jacobi_vs_sequential(params, cfg, rows, ada, 8)
    finally:
        jacobi.decode_burst_jacobi = real
    assert res["first_diff"] == 0 and res["near_tie"] is False
    assert res["gap"] > 0


def test_busy_counts_overlapping_kernels_once():
    """busy_us is the union of the events' intervals: a kernel that starts
    before the one ahead of it ends (a programmatic dependent launch)
    adds only the time past that one's end; gaps add nothing."""
    from types import SimpleNamespace

    def ev(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start,
                                                          end=end))

    assert cs.busy_us([]) == 0.0
    assert cs.busy_us([ev(0, 10)]) == 10
    # 0-10 and 6-14 overlap, 12-13 lies inside, 20-25 after a gap
    assert cs.busy_us([ev(20, 25), ev(6, 14), ev(0, 10), ev(12, 13)]) == 19
    assert cs.busy_us([ev(0, 5), ev(5, 8)]) == 8


def test_pool_phases_on_cpu(counted_kernels):
    """pool_ring and pool_window at tiny size: exact launch counts (the
    flash-encode stand-in per encoder layer per ring-mode encode call, the
    banded one per window-mode call, flash-decode per decoded row), the
    tick table, and slot 0 against the B=1 VoxStream (f32: equal)."""
    cfg = tiny_config(enc_kv_ring=128)
    params = cs.make_params(cfg, "cpu")
    pr = cs.phase_pool(cfg, params, "cpu", "pool_ring", 3, "ring", 0.5, 6,
                       dec_ring=64)
    assert pr["enc_mode"] == "ring" and pr["ticks"] == 12
    assert pr["launches"]["flash_bulk_attention_batched"] == \
        cfg.encoder.n_layers * pr["encode_calls"] > 0
    assert pr["launches"]["flash_decode"] == \
        cfg.decoder.n_layers * pr["decoded_rows"] > 0
    assert pr["launches"]["banded_attention_batched"] == 0
    assert pr["slot0_agree_b1_voxstream"] == 1.0 and pr["compared"] > 0
    # slot 0's encoder rows by position equal the B=1 stream's through the
    # end: the encode calls it sat out (the churned slot catching up) are
    # not recorded as its rows
    assert pr["slot0_rows_diff_b1"] is None
    assert "slot0_dec_rows_diff_b1" in pr
    assert pr["tokens_per_tick"] > 0 and pr["bursts_per_tick"] > 0
    pw = cs.phase_pool(cfg, params, "cpu", "pool_window", 4, "window", 1.0,
                       3, dec_ring=64, dec_kv_dtype="float8_e4m3fn",
                       ref_ids=pr.pop("slot0_ids"))
    assert pw["enc_mode"] == "window" and pw["dec_kv_dtype"] == "float8_e4m3fn"
    assert pw["launches"]["banded_attention_batched"] == \
        cfg.encoder.n_layers * pw["encode_calls"] > 0
    assert pw["launches"]["flash_bulk_attention_batched"] == 0
    assert 0.0 <= pw["slot0_agree_pool_ring"] <= 1.0


def test_pool_ring_fp8_on_cpu(counted_kernels):
    """The ring pool at the load-ring settings (e4m3 encoder and decoder
    rings) at tiny size, 3 slots: "auto" launches the flash-encode
    stand-in per encoder layer per encode call and slot 0 equals the B=1
    VoxStream on the same rings (f32); the parent's route (the encoder's
    plain attention) launches none and is only compared."""
    cfg = tiny_config(enc_kv_ring=128)
    params = cs.make_params(cfg, "cpu")
    kw = {**cs.POOL_RING_FP8, "n_slots": 3, "n_ticks": 4, "dec_ring": 64,
          "enc_kv_ring": 128}
    for enc_attn in (None, "xla"):
        pr = cs.phase_pool(cfg, params, "cpu", enc_attn=enc_attn, **kw)
        assert pr["enc_kv_dtype"] == "float8_e4m3fn"
        assert pr["dec_kv_dtype"] == "float8_e4m3fn"
        assert pr["enc_ring"] == 128
        flash = pr["launches"]["flash_bulk_attention_batched"]
        if enc_attn is None:
            assert flash == cfg.encoder.n_layers * pr["encode_calls"] > 0
        else:
            assert flash == 0 and pr["enc_attn_impl"] == "xla"
        assert pr["slot0_agree_b1_voxstream"] == 1.0 and pr["compared"] > 0
        assert pr["slot0_rows_diff_b1"] is None


def test_bench_phase_on_cpu(counted_kernels):
    """The bench phase at 2 streams x 2 s, 2 load slots x 2 ticks: both
    runs pass its checks (no -1, no `_oom`, value > 0, their kernels
    counted), bulk-mode ids equal serve_clips', "inc" agrees with bulk."""
    cfg = tiny_config()
    env = {"BENCH_STREAMS": "2", "BENCH_SECONDS": "2", "BENCH_TRIES": "1",
           "BENCH_LOAD_STREAMS": "2", "BENCH_LOAD_TICKS": "2",
           "BENCH_FP8_STREAMS": "2"}
    out = cs.phase_bench(cfg, cs.make_params(cfg, "cpu"), "cpu", env=env,
                         int4_env={**env, "BENCH_MODE": "int4",
                                   "BENCH_LAT": "0", "BENCH_LOAD": "0"},
                         bulk_streams=2)
    assert out["bf16"]["metric"] == "aggregate_x_realtime_per_chip_2s_2streams"
    assert out["int4"]["metric"].endswith("_int4")
    assert out["bulk_equal_serve_clips"] and out["bulk_steps"] == 74 - 38
    assert min(out["inc_agree_bulk"]) >= cs.STREAM_AGREE_MIN
    got = out["launches"]
    assert got["flash_decode"] > 0 and got["flash_bulk_attention_batched"] > 0
    assert got["int4_mm"] > 0 and got["banded_attention_batched"] > 0
    # the bf16 run's int8 step probe: 5 bursts of 64 steps, 4 layer
    # products a step (the probe keeps the bf16 table)
    assert got["int8_mm"] == 4 * cfg.decoder.n_layers * cs.BENCH_PROBE_STEPS


def test_mesh_and_mel_device_phases_on_cpu():
    """The mesh phase at tiny width: its spawned gloo ranks (tp 2 in
    bf16 as on the card, then dp 2 x tp 2) against the unsharded runs and
    the f32 witness, with its checks (no kernel launches on the CPU); and
    the device mel against the host mel."""
    from voxtral_tpu_torch.models.params import init_params

    cfg = tiny_config(compute_dtype="bfloat16", enc_kv_ring=128)
    out = cs.phase_mesh(cfg, init_params(cfg, seed=0, device="cpu"), "cpu",
                        seconds=3.0, n_streams=2)
    fw, small = out["full_width"], out["small"]
    assert fw["hidden_rel_err"] <= cs.MESH_HIDDEN_REL_TOL
    assert 0 < fw["hidden_rel_err"] <= cs.MESH_WITNESS_FACTOR * \
        fw["tp1_hidden_rel_err"]
    assert fw["tokens"] > 0 and len(fw["ids_agree"]) == 2
    assert small["serve_f32_agree"] == small["pool_f32_agree"] == [1.0] * 4
    assert "rank_shapes" not in out
    mel = cs.phase_mel_device("cpu", n_clips=2, seconds=3.0)
    assert mel["max_abs_err"] <= 3e-4 and mel["frames"] == 300


def test_ckpt_phase_on_cpu(counted_kernels):
    """The ckpt phase at tiny size: make_fake_ckpt's checkpoint through the
    CLI (offline, streaming, --int4), fidelity_check (PASS in float32),
    make_golden record + check (equal ids) and int8_ab with AB_BITS=4,
    with its exact launch checks; the directory is gone afterwards."""
    import glob
    import os
    import tempfile

    before = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                        "voxtral_ckpt_*")))
    # make_golden's engine takes the default buckets (up to 256): the
    # encoder ring holds the window (24) plus 256
    rec = cs.phase_ckpt(tiny_config(enc_kv_ring=512), "cpu",
                        clip_seconds=5.0)
    assert set(glob.glob(os.path.join(tempfile.gettempdir(),
                                      "voxtral_ckpt_*"))) == before
    n_enc, n_dec = 2, 2
    assert rec["cli_offline"]["launches"]["banded_attention_batched"] == n_enc
    assert rec["cli_offline"]["mode"] == "offline"
    assert rec["cli_stream"]["mode"] == "stream"
    assert rec["cli_stream"]["launches"]["banded_attention_batched"] == 0
    assert rec["cli_stream"]["launches"]["flash_bulk_attention_batched"] > 0
    assert rec["cli_int4"]["launches"]["int4_mm"] > 0
    for name in ("cli_offline", "cli_stream", "cli_int4"):
        assert rec[name]["load_s"] >= 0 and rec[name]["weights_gib"] >= 0
        assert rec[name]["x_realtime"] > 0
    fid = rec["fidelity"]
    assert fid["ok"] and fid["agree"] == fid["steps"] >= 50
    assert fid["launches"]["flash_decode"] == n_dec * fid["steps"]
    assert rec["golden"]["rc"] == [0, 0]
    assert rec["golden"]["check"][0].startswith("OK   clip.torch_engine.json")
    assert rec["int4_ab"]["lines"][0].startswith("QUANT-AB: bf16 ")
    assert rec["int4_ab"]["launches"]["int4_mm"] > 0
    assert all(v > 0 for v in rec["launches"].values())


def test_ckpt_phase_refuses_a_full_disk(monkeypatch):
    """Too little room for the checkpoint fails the phase with a message
    (it never skips) and leaves nothing behind."""
    import shutil

    monkeypatch.setattr(shutil, "disk_usage",
                        lambda p: shutil._ntuple_diskusage(10**12, 10**12, 1000))
    with pytest.raises(AssertionError, match="GB free under"):
        cs.phase_ckpt(tiny_config(enc_kv_ring=128), "cpu")


def test_f32_encoder_auto_on_cpu():
    """The f32 encoder check at its shapes on the CPU, where the kernels'
    wrappers run their plain versions: "auto" and "xla" agree and no kernel
    launches."""
    rec = cs.f32_encoder_auto("cpu")
    assert rec["f32_launches"] == rec["bf16_launches"] == [0, 0]
    assert rec["f32_rel_err_stream"] <= cs.F32_ENCODER_REL_TOL
    assert rec["f32_rel_err_bulk"] <= cs.F32_ENCODER_REL_TOL
    assert "kernels" not in rec


def test_batchinv_phase_on_cpu(counted_kernels, stand_in):
    """The batchinv phase at tiny size in bf16 (the row-invariant route's
    rule, plain functions on the CPU) with test_torch_graphs' stand-in
    graph: stream 0's graphed step at B=1, 3 and 5 on all four rungs and
    both routes, its prefill alone and inside B=4, each compared and
    recorded; no timing off the card; the counters reset."""
    cfg = tiny_config(compute_dtype="bfloat16", enc_kv_ring=128,
                      dec_window=256, dec_kv_ring=256)
    params = cs.make_params(cfg, "cpu")
    bi = cs.phase_batchinv(cfg, params, "cpu", sizes=(1, 3, 5),
                           time_sizes=(3,), dec_ring=256, pos=200,
                           prefill_b=(4,))
    assert [r["rung"] for r in bi["rungs"]] == ["bf16", "fp8kv", "int8",
                                               "int4"]
    for r in bi["rungs"]:
        for route in cs.BATCHINV_ROUTES:
            for bsz in (3, 5):
                assert isinstance(r[f"step_{route}_b{bsz}_equal"], bool)
            assert f"prefill_{route}_b4_rings_diff" in r
        assert not any(k.startswith("step_ms") for k in r)
        # the port's route on the CPU: every product the plain one, the
        # T > 1 attention's products one stream at a time
        assert r["prefill_rowinv_b4_rings_diff"] is None
        assert r["prefill_rowinv_b4_first_diff"] is None
    assert flash_decode.flash_decode.launches == 0
