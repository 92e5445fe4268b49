"""One run of one cell of the benchmark of `voxtral_tpu_torch` on H100s.

    python3 -m h100_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name: the cell in
`BENCHMARK.json` at the root of the checkout, the configuration in the
file it names, the traffic in `h100_bench/traffic/<traffic>.json`, whose
`kind` names its module in `h100_bench/kinds/`, the limits of the check
in `h100_bench/limits/<cell>.json`, and each per-layer metric's reader in
`h100_bench/metrics/<metric>.py`.  Adding a cell or a metric adds files
and entries; no file here changes.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, and last the check's
numbers beside their limits, which also end standard error.  Without
enough CUDA devices, without the port in this checkout, or with JAX
loaded, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "voxtral_tpu")


@dataclasses.dataclass
class Context:
    model: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str,
               root: str = ROOT) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic, limits) of the cell `name`, the files
    under the checkout `root`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, "h100_bench")
    model = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(here, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(here, "limits", name + ".json"))
    return cell, model, traffic, limits


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries this cell reports: its per-layer ones with
    --trace 1, else its end-to-end ones (an entry without `workloads`
    holds for every cell)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def read_metric(name: str, record: dict, root: str = ROOT):
    """The per-layer metric `name` read by its reader file, or None when
    it finds nothing to read."""
    path = os.path.join(root, "h100_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def check_numbers(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit, none missing or not finite."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("inf"))
        v = float(v) if math.isfinite(v) else float("inf")
        ok &= v <= limit
        out[name] = {"value": v if math.isfinite(v) else str(v),
                     "limit": limit}
    return ok, out


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def compose(bench: dict, cell: str, out: dict, trace: bool, device: dict,
            limits: dict) -> dict:
    """The result line of a run: the kind's output `out` read into the
    cell's metrics (end-to-end, or per-layer with `trace`), `device` given
    its peak (and busy and window seconds with `trace`), and the check's
    numbers beside their limits, last."""
    rec = out["record"]
    values = dict(out["e2e"], setup_s=out["setup_s"],
                  peak_hbm_gib=out["peak_bytes"] / 2**30)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = read_metric(m["name"], rec) if trace else values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=out["peak_bytes"])
    result = {"correct": None, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        tr = rec["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["span_s"]
        result["breakdown"] = tr["breakdown"]
    correct, check = check_numbers(out["numbers"], limits)
    result["correct"] = bool(correct and out["failed"] == 0)
    result["check"] = check
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m h100_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, model, traffic, limits = cell_files(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"h100_bench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import voxtral_tpu_torch
    except ImportError as exc:
        print(f"h100_bench: the program is not in this checkout ({exc})",
              file=sys.stderr)
        return 3
    pkg = os.path.dirname(os.path.abspath(voxtral_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        print(f"h100_bench: voxtral_tpu_torch loads from {pkg}, not from "
              f"this checkout {ROOT}", file=sys.stderr)
        return 3

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kind = importlib.import_module(f"h100_bench.kinds.{traffic['kind']}")
    ctx = Context(model=model, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), device=dev,
                  t_start=t_start)
    out = kind.run(ctx)

    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"]}
    result = compose(bench, cell["name"], out, bool(args.trace), device,
                     limits)
    print(f"h100_bench: {cell['name']} seed {args.seed} on "
          f"{power_limit()}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
