"""The seeded inputs: clips and weights repeat from the seed and differ
across seeds; seeds past 32 signed bits work."""

import torch

from h100_bench import audio, weights
from h100_bench.tests.tiny import tiny_model

BIG = 2**31 + 977


def test_clips_repeat_and_differ():
    a = audio.clips(BIG, 3, 0.5, "cpu")
    b = audio.clips(BIG, 3, 0.5, "cpu")
    c = audio.clips(BIG + 1, 3, 0.5, "cpu")
    assert a.shape == (3, 8000) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # each clip of a batch is its own
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    assert float(a.abs().max()) < 1.0


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_weights_repeat_and_differ():
    m = tiny_model()
    a = list(_leaves(weights.make_params(m, BIG, "cpu")))
    b = list(_leaves(weights.make_params(m, BIG, "cpu")))
    c = list(_leaves(weights.make_params(m, 7, "cpu")))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(not torch.equal(x, y) for x, y in zip(a, c))


def test_weights_layout_and_scale():
    m = tiny_model(dtype="bfloat16")
    p = weights.make_params(m, 3, "cpu")
    d, e = m["decoder"], m["encoder"]
    q, kv = d["n_heads"] * d["head_dim"], d["n_kv_heads"] * d["head_dim"]
    assert p["decoder"]["layers"]["wqkv"].shape == (
        d["n_layers"], q + 2 * kv, d["dim"])
    assert p["decoder"]["layers"]["wqkv"].dtype == torch.bfloat16
    assert p["decoder"]["final_norm"].dtype == torch.float32
    assert p["encoder"]["conv0_w"].shape == (3 * e["n_mel"], e["dim"])
    # encoder's merged bias: q 0.01, k zero, v -0.01
    b = p["encoder"]["layers"]["bqkv"][0]
    qe = e["n_heads"] * e["head_dim"]
    assert torch.all(b[:qe] == 0.01) and torch.all(b[qe:2 * qe] == 0)
    assert torch.all(b[2 * qe:] == -0.01)
