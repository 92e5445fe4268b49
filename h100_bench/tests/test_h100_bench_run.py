"""The runner: the result line's keys and order, the check, the import
guard, cells and metrics found by name, the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench import run

REPO = run.ROOT


def fake_out(numbers, trace=None, failed=0):
    rec = {"kind": "offline", "batches": [
        {"encode_s": 1.0, "prefill_s": 0.2, "decode_s": 3.0,
         "decode_steps": 100, "wall_s": 4.2, "capture_s": 0.05}],
        "trace": trace, "streams": 128, "window_s": 4.2, "prompt_len": 39,
        "clip_flops": 1e13,
        "model": run.load_json(os.path.join(
            REPO, "h100_bench/configs/voxtral-mini-4b-rt-bf16.json"))}
    return {"record": rec, "e2e": {"x_realtime": 812.5}, "attempted": 128,
            "failed": failed, "setup_s": 31.0, "peak_bytes": 40 * 2**30,
            "numbers": numbers}


def test_last_line_keys_and_order():
    bench = run.load_json(os.path.join(REPO, "BENCHMARK.json"))
    cell = bench["workloads"][0]["name"]
    limits = {"rows_rel_err": 0.01, "logit_gap": 0.5}
    res = run.compose(bench, cell, fake_out({"rows_rel_err": 0.004,
                                             "logit_gap": 0.2}),
                      False, {"platform": "gpu", "kind": "H100",
                              "count": 1}, limits)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"x_realtime", "peak_hbm_gib", "setup_s"}
    assert res["metrics"]["peak_hbm_gib"] == {"value": 40.0, "unit": "GiB"}
    assert res["device"]["memory_peak_bytes"] == 40 * 2**30
    assert res["check"]["logit_gap"] == {"value": 0.2, "limit": 0.5}
    json.dumps(res)


def test_traced_line_reads_per_layer_metrics():
    bench = run.load_json(os.path.join(REPO, "BENCHMARK.json"))
    cell = bench["workloads"][0]["name"]
    tr = {"busy_s": 3.9, "span_s": 4.2, "ops": {},
          "breakdown": {"device_ops": [["k", 1.0]], "idle_gaps": []}}
    res = run.compose(bench, cell, fake_out({"rows_rel_err": 0.0,
                                             "logit_gap": 0.0}, tr),
                      True, {"platform": "gpu", "kind": "H100",
                             "count": 1}, {"logit_gap": 1.0})
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"]
    m = res["metrics"]
    assert m["encode_share.offline"]["value"] == pytest.approx(100 / 4.2)
    assert m["decode_ms_per_step.offline"]["value"] == pytest.approx(30.0)
    assert m["idle_share.offline"]["value"] == pytest.approx(
        100 * (1 - 3.9 / 4.2))
    # no kernels in this trace: the rooflines find nothing and are left out
    assert "flash_decode_roofline.offline" not in m
    assert m["mfu.offline"]["value"] == pytest.approx(
        100 * 128e13 / (4.2 * 989e12))
    assert res["device"]["busy_s"] == 3.9 and res["device"]["window_s"] == 4.2


@pytest.mark.parametrize("numbers, ok", [
    ({"a": 0.1, "b": 0.2}, True),
    ({"a": 0.1, "b": 0.3}, False),
    ({"a": float("nan"), "b": 0.0}, False),
    ({"a": float("inf"), "b": 0.0}, False),
    ({"b": 0.0}, False),
])
def test_check_numbers(numbers, ok):
    good, check = run.check_numbers(numbers, {"a": 0.2, "b": 0.2})
    assert good is ok
    assert list(check) == ["a", "b"]
    json.dumps(check)


def test_failed_answers_make_a_run_incorrect():
    bench = run.load_json(os.path.join(REPO, "BENCHMARK.json"))
    res = run.compose(bench, bench["workloads"][0]["name"],
                      fake_out({"x": 0.0}, failed=1), False, {}, {"x": 1.0})
    assert res["correct"] is False


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"voxtral_tpu_torch": 1, "voxtral_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == []
    mods.update({"voxtral_tpu.models": 1, "jax": 1, "jaxlib.xla": 1,
                 "flax": 1})
    assert run.forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla",
                                           "voxtral_tpu.models"]


def _loaded_after(stmt):
    code = f"import sys; {stmt}; print(' '.join(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True,
                         env=dict(os.environ, PYTHONPATH=REPO))
    return out.stdout.split()


def test_reference_loads_neither_the_program_nor_jax():
    mods = _loaded_after("import h100_bench.reference, h100_bench.weights, "
                         "h100_bench.audio, h100_bench.work")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"voxtral_tpu_torch", "voxtral_tpu", "jax", "jaxlib",
                       "flax"}


def test_harness_loads_no_jax():
    mods = _loaded_after(
        "import h100_bench.run, h100_bench.kinds.offline, h100_bench.trace, "
        "h100_bench.control; from h100_bench.kinds import offline; "
        "offline.port_config(offline.run.__globals__['weights'] and "
        "__import__('json').load(open('h100_bench/configs/"
        "voxtral-mini-4b-rt-bf16.json'))); "
        "import voxtral_tpu_torch.parallel.serving, "
        "voxtral_tpu_torch.runtime.offline")
    assert run.forbidden_modules(dict.fromkeys(mods)) == []
    assert "voxtral_tpu_torch" in mods


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    shutil.copytree(os.path.join(REPO, "h100_bench"), tmp_path / "h100_bench")
    bench = run.load_json(os.path.join(REPO, "BENCHMARK.json"))
    bench["workloads"].append({"name": "dummy", "config": bench["configs"][0]
                               ["name"], "traffic": "dummy-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "dummy_ms.offline", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "x_realtime",
                               "workloads": ["dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "h100_bench/traffic/dummy-mix.json").write_text(json.dumps(
        {"kind": "offline", "streams": 4, "clip_seconds": 5}))
    (tmp_path / "h100_bench/limits/dummy.json").write_text('{"g": 1}')
    (tmp_path / "h100_bench/metrics/dummy_ms.offline.py").write_text(
        "def read(rec):\n    return 1e3 * rec['batches'][0]['wall_s']\n")
    cell, model, traffic, limits = run.cell_files(bench, "dummy",
                                                  root=str(tmp_path))
    assert traffic["streams"] == 4 and limits == {"g": 1}
    assert model["decoder"]["dim"] == 3072
    names = [m["name"] for m in run.cell_metrics(bench, "dummy", True)]
    assert "dummy_ms.offline" in names
    assert run.read_metric("dummy_ms.offline", {"batches": [
        {"wall_s": 0.5}]}, root=str(tmp_path)) == 500.0


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench", "--workload",
         "offline-bf16-64x60s", "--seed", str(2**31 + 5), "--seconds", "1"],
        cwd=REPO, text=True, capture_output=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_no_program_no_result(tmp_path, monkeypatch):
    """In a directory that holds only BENCHMARK.json and the files under
    paths the run refuses (the port found is not this checkout's)."""
    import torch

    shutil.copytree(os.path.join(REPO, "h100_bench"), tmp_path / "h100_bench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", "offline-bf16-64x60s", "--seed", "1",
                     "--seconds", "1"]) == 3


def test_benchmark_json_is_well_formed():
    b = run.load_json(os.path.join(REPO, "BENCHMARK.json"))
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in b["workloads"]}
    for c in b["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert c["file"].startswith(b["paths"][0] + "/")
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(
            REPO, "h100_bench/traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            REPO, "h100_bench/limits", w["name"] + ".json"))
        e2e = run.cell_metrics(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert run.cell_metrics(b, w["name"], True)
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(
            REPO, "h100_bench/metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= cells
        moved = [e for e in b["end_to_end"] if e["name"] == m["moves"]][0]
        for c in m.get("workloads", cells):
            assert c in moved.get("workloads", cells)
