"""chip_smoke.py's slice, serve, flash_enc, stream, bstream, jacobi, pool,
mesh and mel_device phases rehearsed on the CPU at tiny size.
CPU tensors launch no kernel, so the plain functions stand in for the
kernels and count as their launches; the phases' own checks (exact launch
counts per rung, ids in range, identical second runs, kernel path against
plain path) then run as they do on the card."""

import functools

import pytest
import torch

import chip_smoke as cs
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import bulk_encode, decoder, encoder
from voxtral_tpu_torch.ops import (
    banded_encode,
    flash_decode,
    flash_encode,
    quant_mm,
    ring,
)

torch.set_num_threads(1)


def _counted(kernel_fn, plain_fn, own=False):
    """plain_fn, adding one per call to the kernel wrapper's counter, which
    the phases reset and read (`own`: the stand-in's copy of it, for a
    wrapper the phases import by name)."""
    @functools.wraps(kernel_fn)
    def f(*args, **kwargs):
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
    # phase_serve imports int4_mm from its module, so it reads the
    # stand-in's counter
    monkeypatch.setattr(quant_mm, "int4_mm", _counted(
        quant_mm.int4_mm, quant_mm.int4_mm_plain, own=True))
    yield
    for fn in (banded_encode.banded_attention_batched,
               flash_decode.flash_decode, ring.ring_rows_write,
               flash_encode.flash_bulk_attention_batched):
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

    sv = cs.phase_serve(cfg, params, "cpu", n_streams=3, seconds=2.0,
                        dec_ring=64, extra_steps=4)
    rungs = {r["rung"]: r for r in sv["rungs"]}
    assert list(rungs) == ["bf16", "fp8kv", "int8", "int4", "int4deq"]
    assert [r["runs"] for r in rungs.values()] == [2, 1, 1, 1, 1]
    steps = rungs["bf16"]["decode_steps"]
    # every rung decodes through flash-decode, fp8 rings included; the
    # row-write kernel runs in the fp8kv rung's "xla" mid-fill burst
    assert sv["launches"] == {
        "banded_attention_batched": 5 * cfg.encoder.n_layers,
        "flash_decode": 5 * cfg.decoder.n_layers * steps,
        "ring_rows_write": cfg.decoder.n_layers * 4,
        "int4_mm": 4 * cfg.decoder.n_layers
        + (4 * cfg.decoder.n_layers + 1) * steps,
    }
    assert rungs["fp8kv"]["launches_xla_mid_fill"] == {
        "banded_attention_batched": 0, "flash_decode": 0,
        "ring_rows_write": cfg.decoder.n_layers * 4, "int4_mm": 0}
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
# (24) beside the largest chunk (24 rows); 60 slots for the ragged edge
TINY_FLASH_ENC = dict(n_layers=2, heads=4, head_dim=16, cap=64,
                      ragged_cap=60, window=24, ts=(4, 16, 20),
                      positions=(0, 7, 30, 300), prefill=40,
                      splits=((24,), (8, 8, 8), (10, 10, 4)))


def test_flash_enc_phase_on_cpu():
    """The wrapper runs the plain version on CPU tensors, so the
    comparison reads 0 and the chunking check holds the plain version
    bitwise."""
    out = cs.phase_flash_enc("cpu", TINY_FLASH_ENC, batches=(1, 3))
    assert out == {"max_abs_err": 0.0, "bitwise_invariant": True}
    assert flash_encode.flash_bulk_attention_batched.launches == 0


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
    # f32 on the CPU: every chunking gives the offline path's ids
    assert set(st["agreement"].values()) == {1.0}
    assert st["launches"]["flash_bulk_attention_batched"] == sum(
        r["launches"]["flash_bulk_attention_batched"] for r in st["runs"])

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
    assert pr["tokens_per_tick"] > 0 and pr["bursts_per_tick"] > 0
    pw = cs.phase_pool(cfg, params, "cpu", "pool_window", 4, "window", 1.0,
                       3, dec_ring=64, dec_kv_dtype="float8_e4m3fn",
                       ref_ids=pr.pop("slot0_ids"))
    assert pw["enc_mode"] == "window" and pw["dec_kv_dtype"] == "float8_e4m3fn"
    assert pw["launches"]["banded_attention_batched"] == \
        cfg.encoder.n_layers * pw["encode_calls"] > 0
    assert pw["launches"]["flash_bulk_attention_batched"] == 0
    assert 0.0 <= pw["slot0_agree_pool_ring"] <= 1.0


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
