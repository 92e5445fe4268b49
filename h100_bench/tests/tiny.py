"""A tiny configuration and traffic for the CPU tests of the harness."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_model(name="voxtral-mini-4b-rt-bf16", dtype="float32",
               vocab=1256):
    """The configuration file `name` at test widths, in `dtype`."""
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        m = json.load(f)
    m = copy.deepcopy(m)
    m["encoder"].update(dim=16, n_layers=2, n_heads=4, head_dim=4,
                        hidden=32, n_kv_heads=4, window=24)
    m["decoder"].update(dim=24, n_layers=2, n_heads=4, head_dim=6,
                        hidden=48, n_kv_heads=2, window=48, vocab_size=vocab,
                        ada_dim=8)
    m["adapter_hidden"] = 24
    m["param_dtype"] = m["compute_dtype"] = dtype
    if m["kv_dtype"] == "bfloat16":
        m["kv_dtype"] = m["enc_kv_dtype"] = dtype
    return m


def tiny_traffic(streams=3, clip_seconds=2.0, check_clips=2):
    return {"kind": "offline", "streams": streams,
            "clip_seconds": clip_seconds, "buckets": [16, 4, 1],
            "dec_kv_ring": 128, "check_clips": check_clips}


def tiny_stream(slots=3, dec_kv_ring=256, session_s=(4.0, 8.0),
                check_sessions=3):
    return {"kind": "stream", "slots": slots, "interval_s": 0.5,
            "gate_s": 0.4, "session_s": list(session_s), "enc_kv_ring": 128,
            "dec_kv_ring": dec_kv_ring, "buckets": [64, 16, 4, 1],
            "stagger_s": 0.5, "warm_s": 1.0, "tail_s": 1.0, "grace_s": 3.0, "bank_clips": 4,
            "check_sessions": check_sessions, "trace_ticks": 2}
