"""The port's mic.py (capture ring + live feeding loop, host only) on the
cases of tests/test_mic.py: with the same scripted capture, the port's loop
feeds, flushes and warns exactly as the JAX package's does."""

import io
import time

import numpy as np
import pytest

from test_mic import FakeCapture, FakeStream, _silence, _voice
from voxtral_tpu import mic as jmic
from voxtral_tpu_torch import mic as tmic
from voxtral_tpu_torch.config import SAMPLE_RATE

CASES = {
    # name: (capture chunks, run_mic_loop keyword arguments)
    "silence_skip_feed_after_flush": (
        lambda: [_voice(1.0), _silence(3.0), _voice(0.5)], {}),
    "flush_rearms_after_voice": (
        lambda: [_voice(0.8), _silence(2.0), _voice(0.8), _silence(2.0)],
        {"overbuffer_skip_s": 1e9}),
    "overbuffer_catchup_drains_to_keep": (lambda: [_voice(8.0)], {}),
    "no_catchup_below_threshold": (lambda: [_voice(4.0)], {}),
}


def _loop(mod, chunks, kw):
    s, warns, drains = FakeStream(), [], []
    mod.run_mic_loop(s, FakeCapture(chunks), lambda: drains.append(1),
                     sleep_fn=lambda _: None, warn=warns.append, **kw)
    return s, warns, len(drains)


@pytest.mark.parametrize("case", list(CASES))
def test_mic_loop_equals_jax(case):
    make, kw = CASES[case]
    s, warns, drains = _loop(tmic, make(), kw)
    js, jwarns, jdrains = _loop(jmic, make(), kw)
    assert (s.feeds, s.flushes, warns, drains) == \
        (js.feeds, js.flushes, jwarns, jdrains)
    # the properties tests/test_mic.py states for each case
    if case == "silence_skip_feed_after_flush":
        assert abs(s.fed - int(2.1 * SAMPLE_RATE)) <= SAMPLE_RATE // 10
        assert s.flushes == 1
    elif case == "flush_rearms_after_voice":
        assert s.flushes == 2
    elif case == "overbuffer_catchup_drains_to_keep":
        assert len(warns) == 1 and "skipping" in warns[0]
        assert abs(s.fed - SAMPLE_RATE) <= SAMPLE_RATE // 10
    else:
        assert not warns and s.fed == 4 * SAMPLE_RATE


def _drain_capture(cap, timeout=5.0):
    got, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        chunk = cap.read(4096)
        if len(chunk):
            got.append(chunk)
        elif cap.eof():
            break
        else:
            time.sleep(0.005)
    return np.concatenate(got)


def test_mic_capture_ring_bounds_and_order():
    pcm = (np.sin(np.arange(SAMPLE_RATE) * 0.01) * 20000).astype("<i2")
    out = _drain_capture(tmic.MicCapture(io.BytesIO(pcm.tobytes()),
                                         ring_seconds=10.0))
    assert len(out) == SAMPLE_RATE
    np.testing.assert_allclose(out, pcm.astype(np.float32) / 32768.0)


def test_mic_capture_ring_drops_oldest_when_full():
    n = SAMPLE_RATE * 2
    pcm = np.arange(n, dtype="<i2")
    cap = tmic.MicCapture(io.BytesIO(pcm.tobytes()), ring_seconds=0.5)
    deadline = time.monotonic() + 5.0
    while not cap._eof and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cap.available() <= int(0.5 * SAMPLE_RATE) + 1600
    tail = cap.read(1 << 30)
    assert int(tail[-1] * 32768.0) == n - 1      # the newest samples survive


def test_mic_constants_equal_jax():
    for name in ("OVERBUFFER_SKIP_S", "OVERBUFFER_KEEP_S", "SILENCE_FEED_MS",
                 "DEFAULT_RMS_THRESHOLD"):
        assert getattr(tmic, name) == getattr(jmic, name)
