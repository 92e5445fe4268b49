"""The offline kind end to end on the CPU at test widths: the rate over
the whole window, the reference against the program, the reference's mel
against the port's, and the check failing the control and each fault a
served model can have (a step that keeps its state, half of the batch
left out, a token altered where it is produced).  No exchange between
chips exists in these cells."""

import time

import numpy as np
import pytest
import torch

from h100_bench import audio, reference, run
from h100_bench.kinds import offline
from h100_bench.tests.tiny import tiny_model, tiny_traffic

SEED = 2**31 + 4242
# the sound test-width runs read ~1e-7 (float32 on both sides)
TINY_LIMITS = {"rows_rel_err": 1e-4, "hidden_rel_err": 1e-4,
               "logit_gap": 1e-4}
CONFIGS = ["voxtral-mini-4b-rt-bf16", "voxtral-mini-4b-rt-int8"]


def run_tiny(name, seconds=0.3, traffic=None, seed=SEED):
    ctx = run.Context(model=tiny_model(name),
                      traffic=traffic or tiny_traffic(),
                      seed=seed, seconds=seconds, trace=False,
                      device=torch.device("cpu"),
                      t_start=time.monotonic())
    return offline.run(ctx)


@pytest.mark.parametrize("name", CONFIGS)
def test_rate_over_the_whole_window_and_correct(name):
    out = run_tiny(name, seconds=0.5)
    b = out["record"]["batches"]
    window = b[-1]["end_s"]
    # every batch that started inside the window finished and counts
    assert b[-1]["end_s"] - b[-1]["wall_s"] < 0.5 <= window
    assert out["attempted"] == 3 * len(b) and out["failed"] == 0
    assert out["e2e"]["x_realtime"] == pytest.approx(
        3 * 2.0 * len(b) / window)
    ok, check = run.check_numbers(out["numbers"], TINY_LIMITS)
    assert ok, check


@pytest.mark.parametrize("n", [32000, 32000 + 777, 16000 * 5 + 3])
def test_reference_mel_matches_the_port(n, monkeypatch):
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    monkeypatch.setenv("VOXTRAL_NO_NATIVE", "1")
    x = audio.clips(SEED, 1, n / 16000, "cpu")[0]

    class Eng:
        delay_tokens = 6

    port = padded_clip_mel(Eng, x.numpy())
    ref = reference.padded_mel(x, 6).numpy()
    assert port.shape == ref.shape == (
        reference.padded_mel_frames(x.shape[0], 6), 128)
    np.testing.assert_allclose(port, ref, atol=2e-5)


def _fault(kind):
    from voxtral_tpu_torch.models.decoder import KVCache
    from voxtral_tpu_torch.parallel import serving

    real = serving.bdecode_burst

    def burst(dparams, cfg, chunks, prev, cache, pos0, ada, n_alt=0):
        if kind == "state_unchanged":
            scratch = KVCache(cache.k.clone(), cache.v.clone())
            out = real(dparams, cfg, chunks, prev, scratch, pos0, ada, n_alt)
            return out[:4] + (cache,)
        if kind == "half_batch":
            # the second half's streams never run: their tokens stay as the
            # buffer was
            h = chunks.shape[0] // 2
            half = KVCache(cache.k[:h], cache.v[:h])
            out = real(dparams, cfg, chunks[:h], prev[:h], half, pos0[:h],
                       ada, n_alt)
            toks = torch.zeros((chunks.shape[0], chunks.shape[1]),
                               dtype=out[0].dtype)
            toks[:h] = out[0]
            return (toks,) + out[1:4] + (cache,)
        out = real(dparams, cfg, chunks, prev, cache, pos0, ada, n_alt)
        toks = out[0].clone()
        toks[:, 0] = (toks[:, 0] + 1) % cfg.decoder.vocab_size   # altered
        return (toks,) + out[1:]

    return serving, burst


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "token_altered"])
@pytest.mark.parametrize("name", CONFIGS)
def test_faults_come_out_incorrect(name, kind, monkeypatch):
    serving, burst = _fault(kind)
    monkeypatch.setattr(serving, "bdecode_burst", burst)
    out = run_tiny(name, seconds=0.0,
                   traffic=tiny_traffic(streams=2, check_clips=2))
    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    res = run.compose(bench, bench["workloads"][0]["name"], out, False,
                      {"platform": "gpu", "kind": "test", "count": 1},
                      TINY_LIMITS)
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("name", CONFIGS)
def test_control_comes_out_incorrect(name):
    """The reference one precision lower in the program's place reads 3x
    or more above the program, and fails a limit set between them."""
    model = tiny_model(name)
    traffic = tiny_traffic(streams=2, check_clips=2)
    from voxtral_tpu_torch.parallel.serving import serve_clips

    check = [0, 1]
    dev = torch.device("cpu")
    engine, mel, kept = offline.setup(model, traffic, SEED, dev, check)
    ids, st = serve_clips(engine, mel)
    steps = st["decode_steps"]
    prec = reference.Precision(**model["precision"])
    args = (model, SEED, dev, kept, st["adapter_rows"],
            st["prefill_last_hidden"], ids, steps, prec)
    prog = offline.judge(*args)
    ctrl = offline.judge(*args, control=reference.Precision(
        **model["precision"], control=model["control"]))
    limits = {k: 2 * max(prog[k], 1e-7) for k in prog}
    assert run.check_numbers(prog, limits)[0]
    assert not run.check_numbers(ctrl, limits)[0]
    assert max(ctrl[k] / max(prog[k], 1e-7) for k in prog) >= 3
