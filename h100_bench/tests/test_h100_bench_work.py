"""Work counts against hand counts from the published widths."""

import json
import os

import pytest

from h100_bench import reference, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model(name="voxtral-mini-4b-rt-bf16"):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_decoder_weights_6_86_gb_and_2_05_ms():
    m = model()
    n = sum(o * i * c for o, i, c in
            work.decoder_products(m) + [work.logits_product(m)])
    # 26 x (6144 + 4096 + 18432 + 9216) x 3072 + 131072 x 3072
    assert n == 26 * (6144 * 3072 + 3072 * 4096 + 18432 * 3072
                      + 3072 * 9216) + 131072 * 3072
    assert 2 * n / 1e9 == pytest.approx(6.8577, abs=1e-4)
    assert 2 * n / work.HBM_BYTES_PER_S * 1e3 == pytest.approx(2.047,
                                                                abs=1e-3)


def test_decoder_mm_work_by_hand():
    m = model()
    weights = 2 * (26 * 116391936 + 131072 * 3072)   # bf16 bytes a pass
    b, f = work.decoder_mm_work(m, 128, 1, 39, "bf16")
    # one step of 128 rows, the prefill of 128 x 38 rows (no logits)
    layers = 26 * (6144 * 3072 + 3072 * 4096 + 18432 * 3072 + 3072 * 9216)
    io_step = 26 * (128 * (3072 + 4096 + 3072 + 9216) * 2
                    + 128 * (6144 + 3072 + 18432 + 3072) * 4) \
        + 128 * 3072 * 2 + 128 * 131072 * 4
    io_pre = 26 * (4864 * (3072 + 4096 + 3072 + 9216) * 2
                   + 4864 * (6144 + 3072 + 18432 + 3072) * 4)
    assert b == weights + io_step + 2 * layers + io_pre
    assert f == 2 * 128 * (layers + 131072 * 3072) + 2 * 4864 * layers
    bi, fi = work.decoder_mm_work(m, 128, 1, 39, "int8")
    scales = 4 * 2 * (26 * (6144 + 3072 + 18432 + 3072)) + 4 * 131072
    assert bi == weights // 2 + io_step + layers + io_pre + scales
    assert fi == f


def test_flash_decode_work_by_hand():
    m = model()
    b, f = work.flash_decode_work(m, 2, [0, 9], "bf16")
    row = 8 * 128          # K or V of one position, elements
    per_layer = (2 * row * 2 * 0 + 2 * row * (4 + 2) + 2 * 32 * 128 * 2) \
        + (2 * row * 2 * 9 + 2 * row * (4 + 2) + 2 * 32 * 128 * 2)
    assert b == 26 * 2 * per_layer
    assert f == 26 * 2 * (4 * 32 * 128 * 1 + 4 * 32 * 128 * 10)
    b8, _ = work.flash_decode_work(m, 2, [9], "e4m3")
    assert b8 == 26 * 2 * (2 * row * 9 + 2 * row * 5 + 2 * 32 * 128 * 2)


def test_offline_clip_flops_of_a_60_s_clip():
    m = model()
    tm = reference.padded_mel_frames(60 * 16000, 6)
    assert (tm, tm // 8) == (6392, 799)
    f = work.offline_clip_flops(m, tm, 39)
    # products alone: encoder 32 x 3196 x 2 x 1280 x (3840 + 1280 + 10240
    # + 5120), decoder 799 positions x 2 x 26 x 116391936, logits 761
    enc = 32 * 3196 * 2 * 1280 * (3840 + 1280 + 10240 + 5120)
    dec = 799 * 2 * 26 * 116391936 + 761 * 2 * 131072 * 3072
    assert enc + dec < f < 1.2 * (enc + dec)


def test_roofline_takes_the_larger_bound():
    assert work.roofline_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.roofline_s(0, 989e12) == pytest.approx(1.0)
    assert work.roofline_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
