"""The readings that the limits of a cell's check are set from.

    python3 -m h100_bench.control --workload <cell> --seeds 11,12,... \\
        [--out control.jsonl]

For each seed, in one process: an offline cell's set-up and one batch
served by the program as the window serves it (a stream cell: a whole
run of `--seconds`), then the check's numbers twice: for the program (the
lower readings) and for the control, the reference computed one precision
below the configuration's (its `control`: fp8 below bf16, int4 below
int8) in the program's place (the upper readings).  One JSON line a seed.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from . import reference, run
from .kinds import offline, stream


def offline_readings(model, traffic, seed, dev) -> dict:
    from voxtral_tpu_torch.parallel.serving import serve_clips

    n = traffic["streams"]
    rng = np.random.default_rng(seed)
    check = sorted(rng.choice(n, size=traffic["check_clips"], replace=False))
    t0 = time.monotonic()
    engine, mel, kept = offline.setup(model, traffic, seed, dev, check)
    ids, st = serve_clips(engine, mel)
    rows = st["adapter_rows"][check].clone()
    hidden = st["prefill_last_hidden"][check].clone()
    steps = st["decode_steps"]
    served = [ids[i] for i in check]
    del engine, mel, st, ids
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.monotonic()
    prec = reference.Precision(**model["precision"])
    prog = offline.judge(model, seed, dev, kept, rows, hidden, served, steps,
                         prec)
    t2 = time.monotonic()
    ctrl = offline.judge(model, seed, dev, kept, rows, hidden, served, steps,
                         prec,
                         control=reference.Precision(
                             **model["precision"], control=model["control"]))
    return {"seed": seed, "program": prog, "control": ctrl,
            "tokens": sum(len(s) for s in served),
            "spread": offline.token_spread(served),
            "cut_at_eos": sum(len(s) < steps for s in served),
            "serve_s": t1 - t0, "judge_s": t2 - t1,
            "control_s": time.monotonic() - t2}


def stream_readings(model, traffic, seed, seconds, dev) -> dict:
    """A whole run of a stream cell (its window: the sessions it judges
    are those a run judges), then the control on the same sessions."""
    t0 = time.monotonic()
    out = stream.run(run.Context(model=model, traffic=traffic, seed=seed,
                                 seconds=seconds, trace=False, device=dev,
                                 t_start=t0))
    t1 = time.monotonic()
    ctrl = stream.judge_sessions(
        model, seed, dev, out["cases"],
        reference.Precision(**model["precision"]),
        control=reference.Precision(**model["precision"],
                                    control=model["control"]))
    return {"seed": seed, "program": out["numbers"], "control": ctrl,
            "tokens": sum(len(ids) for _, ids in out["cases"]),
            "sessions": len(out["cases"]), "failed": out["failed"],
            "latency_p95_ms": out["e2e"]["token_latency_p95_ms"],
            "run_s": t1 - t0, "control_s": time.monotonic() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="a stream cell's window")
    args = ap.parse_args(argv)
    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    _, model, traffic, _ = run.cell_files(bench, args.workload)
    if not torch.cuda.is_available():
        print("h100_bench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        if traffic["kind"] == "stream":
            got = stream_readings(model, traffic, seed, args.seconds, dev)
        else:
            got = offline_readings(model, traffic, seed, dev)
        line = json.dumps(dict(got, workload=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
