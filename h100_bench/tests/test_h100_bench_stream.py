"""The stream kind on the CPU at test widths: a token's row and due time,
the tail over every token due in the window, the reference against the
pool, and the check failing the control and each fault a served model can
have.  The tests run paced ticks on the wall clock (a few seconds each)."""

import time

import numpy as np
import pytest
import torch

from h100_bench import reference, run
from h100_bench.kinds import stream
from h100_bench.tests.test_h100_bench_offline import _fault
from h100_bench.tests.tiny import tiny_model, tiny_stream

SEED = 2**31 + 99
LIMITS = {"logit_gap": 1e-4}


def run_stream(seconds=3.0, traffic=None, model=None):
    ctx = run.Context(model=model or tiny_model(vocab=32768),
                      traffic=traffic or tiny_stream(), seed=SEED,
                      seconds=seconds, trace=False,
                      device=torch.device("cpu"), t_start=time.monotonic())
    return stream.run(ctx)


def test_row_due_times():
    # row r needs the mel frames up to 8r + 7; the first 31 rows see only
    # the left padding, row 31 its last frame's first 40 real samples
    assert stream.row_last_sample(30) < 0 <= stream.row_last_sample(31) == 39
    assert stream.row_last_sample(33) - stream.row_last_sample(32) == 1280
    s = stream.Session(0, 10.0, 60.0, 0)
    assert s.row_due(0) == pytest.approx(10.0 + 1 / 16000)
    r = 40
    last = stream.row_last_sample(r)
    assert s.row_due(r) == pytest.approx(10.0 + (last + 1) / 16000)
    s.origin = 16000                   # a full reset after 1 s of audio
    assert s.row_due(r) == pytest.approx(11.0 + (last + 1) / 16000)


def test_live_mel_matches_the_port_stream(monkeypatch):
    from voxtral_tpu_torch.native import make_mel_context

    monkeypatch.setenv("VOXTRAL_NO_NATIVE", "1")
    x = torch.randn(16000 * 3 + 555, generator=torch.Generator().manual_seed(
        3)) * 0.1
    ctx = make_mel_context(32 * 1280)
    for i in range(0, x.shape[0], 8000):
        ctx.feed(x[i: i + 8000].numpy())
    port = ctx.data()
    ref = reference.live_mel(x).numpy()
    assert ref.shape[0] == port.shape[0] - port.shape[0] % 8
    np.testing.assert_allclose(port[: ref.shape[0]], ref, atol=2e-5)


@pytest.mark.parametrize("ring", [256, 64])
def test_window_tail_and_correct(ring):
    """Every text token due in the window counts; a ring of 64 overflows
    and resets slots fully inside the window, and stays exact."""
    out = run_stream(traffic=tiny_stream(dec_kv_ring=ring))
    assert out["failed"] == 0
    assert out["attempted"] > 50
    lat = out["e2e"]["token_latency_p95_ms"]
    assert 0 < lat < float("inf")
    assert run.check_numbers(out["numbers"], LIMITS)[0], out["numbers"]
    rec = out["record"]
    # the window's 6 ticks (CPU times: no bound on them here)
    assert len(rec["tick_ms"]) == len(rec["late_ms"]) == 6


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "token_altered"])
def test_faults_come_out_incorrect(kind, monkeypatch):
    serving, burst = _fault(kind)
    monkeypatch.setattr(serving, "bdecode_burst", burst)
    out = run_stream(traffic=tiny_stream(slots=2))
    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    res = run.compose(bench, bench["workloads"][0]["name"], out, False,
                      {"platform": "gpu", "kind": "test", "count": 1},
                      LIMITS)
    assert res["correct"] is False, res["check"]


def test_control_comes_out_incorrect():
    model = tiny_model(vocab=32768)
    d = stream.LivePool(model, tiny_stream(), SEED, torch.device("cpu"))
    for k in range(12):
        d.tick(k)
    for i in range(len(d.sessions)):        # end every session now
        s = d.sessions[i][-1]
        s.closed_at = d.now()
        d.pool.close(i)
        d._join(i, s.closed_at, 10.0)
    cases = stream._judged(d, tiny_stream(check_sessions=3), 0.0, d.now())
    assert len(cases) == 3 and sum(1 for _, ids in cases if ids) >= 2
    prec = reference.Precision(**model["precision"])
    prog = stream.judge_sessions(model, SEED, torch.device("cpu"), cases,
                                 prec)
    ctrl = stream.judge_sessions(model, SEED, torch.device("cpu"), cases,
                                 prec, control=reference.Precision(
                                     **model["precision"],
                                     control=model["control"]))
    limits = {"logit_gap": 2 * max(prog["logit_gap"], 1e-7)}
    assert run.check_numbers(prog, limits)[0]
    assert not run.check_numbers(ctrl, limits)[0]
