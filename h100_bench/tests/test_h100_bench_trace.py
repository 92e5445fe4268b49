"""The traced span's reduction: busy time as the union of overlapping
device intervals, per-kernel sums, idle gaps named by the host."""

import pytest

from h100_bench import trace


def test_union_counts_overlap_once():
    total, merged = trace.union_ns([(0, 10), (5, 15), (20, 30), (29, 31),
                                    (40, 40)])
    assert total == 15 + 11
    assert merged[:2] == [[0, 15], [20, 31]]


def test_summarize():
    us = 1000
    ev = [
        (trace.SPAN, False, 0, 1000 * us),
        (trace.SPAN, True, 0, 900 * us),      # the device-side annotation
        ("void flash_decode_kernel<4>(...)", True, 100 * us, 300 * us),
        ("void flash_decode_kernel<4>(...)", True, 250 * us, 400 * us),  # PDL
        ("bf16_mm_kernel", True, 600 * us, 700 * us),
        ("Command Buffer Full", True, 0, 1000 * us),
        ("aten::item", False, 410 * us, 590 * us),
        ("cudaStreamSynchronize", False, 420 * us, 580 * us),
        ("aten::copy_", False, 700 * us, 1000 * us),
    ]
    s = trace.summarize(ev)
    assert s["span_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(400e-6)      # 100-400, 600-700
    assert trace.kernel_seconds(s, "flash_decode_kernel") == (
        2, pytest.approx(350e-6))
    gaps = dict((n.split(" (x")[0], t) for n, t in
                s["breakdown"]["idle_gaps"])
    assert gaps["no host event"] == pytest.approx(100e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(200e-6)
    assert gaps["aten::copy_"] == pytest.approx(300e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["void flash_decode_kernel<4>(...)"] == pytest.approx(350e-6)
    assert "Command Buffer Full" not in ops


def test_summarize_refuses_an_empty_trace():
    with pytest.raises(RuntimeError):
        trace.summarize([(trace.SPAN, False, 0, 10)])
