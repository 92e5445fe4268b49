"""The int4 kernel's launch plan and its K-split fold, on the CPU.

`int4_mm_plan` (ops/quant_mm.py) decides, from the shapes alone, the tile
width, the K split over a thread-block cluster and the clusters that
csrc/int4_mm.cu launches; `int4_mm_split_plain` is a plain model of the
kernel's fold of the split's partial sums.  The kernel itself is tested on
the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.models import quant as jq
from voxtral_tpu.ops.quant_mm import int4_mm as jax_int4_mm
from voxtral_tpu_torch.ops.quant_mm import (
    K_CHUNK,
    MAX_CLUSTER,
    int4_mm_blocks_per_sm,
    int4_mm_plain,
    int4_mm_plan,
    int4_mm_split_plain,
    int4_mm_splits,
)

# (out, packed half) of the full-width products (wqkv, wo, w13, w2, the
# logits table) and of the ragged shape of the GPU tests
PRODUCTS = {"wqkv": (6144, 1536), "wo": (3072, 2048), "w13": (18432, 1536),
            "w2": (3072, 4608), "logits": (131072, 1536),
            "ragged": (200, 1552)}
# decode (1, 16, 64 streams), prefill (38 rows a stream at B=1, 16, 32) and
# the row counts around the plan's tile edges
ROWS = (1, 16, 17, 38, 64, 65, 608, 1216)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", list(PRODUCTS))
def test_plan_fits_one_wave_and_covers_k(name, rows):
    out, half = PRODUCTS[name]
    plan = int4_mm_plan(rows, out, half)
    assert plan.nj in (2, 4, 16)
    assert 1 <= plan.cs <= MAX_CLUSTER
    assert plan.nj != 16 or plan.cs == 1
    # at most one wave: no more blocks than 132 SMs hold at once
    assert plan.per_sm == int4_mm_blocks_per_sm(plan.nj, plan.cs) >= 1
    assert plan.cs * plan.clusters <= 132 * plan.per_sm
    assert 1 <= plan.clusters <= plan.tiles
    # non-empty ranges of whole K chunks, in order, covering half
    splits = int4_mm_splits(half, plan.cs)
    assert len(splits) == plan.cs
    assert splits[0][0] == 0 and splits[-1][1] == half
    for (a, b), (c, _) in zip(splits, splits[1:] + [(half, None)]):
        assert a < b == c and a % K_CHUNK == 0
    # the same plan on every call, and from a fresh cache
    assert int4_mm_plan(rows, out, half) is plan
    int4_mm_plan.cache_clear()
    assert int4_mm_plan(rows, out, half) == plan


def test_plan_splits_the_narrow_decode_products():
    """At 16 rows the narrow layer products split K over a cluster (their
    tiles alone leave the card mostly idle) and every product launches at
    least two blocks per SM; the logits table does not need to split; at
    608 rows nothing splits and the wgmma prefill tile is taken."""
    for name in ("wqkv", "wo", "w2"):
        assert int4_mm_plan(16, *PRODUCTS[name]).cs > 1, name
    for name in ("wqkv", "wo", "w13", "w2", "logits"):
        plan = int4_mm_plan(16, *PRODUCTS[name])
        assert plan.cs * plan.clusters >= 2 * 132, name
    assert int4_mm_plan(16, *PRODUCTS["logits"]).cs == 1
    for name in ("wqkv", "wo", "w13", "w2"):
        plan = int4_mm_plan(608, *PRODUCTS[name])
        assert (plan.nj, plan.cs) == (16, 1), name


# tiny and odd shapes: (rows, out, in)
SPLIT_SHAPES = ((1, 16, 32), (5, 48, 160), (17, 40, 288), (33, 64, 1024),
                (3, 200, 3104))


@pytest.mark.parametrize("rows,out,in_dim", SPLIT_SHAPES)
def test_split_fold_matches_plain_and_pallas(rows, out, in_dim):
    """The kernel's fold (each range's f32 partials added in rank order,
    then scaled per half) against the plain product and the JAX Pallas
    kernel in interpret mode, for every split the kernel could take, within
    1e-5 x max |ref| (f32 sums in another order).  x holds bf16 values in
    f32, as the kernel reads them."""
    rng = np.random.default_rng(rows * 1000 + in_dim)
    w = rng.standard_normal((2, out, in_dim)).astype(np.float32)
    lp = jq.quantize_layer_stack({"wqkv": jnp.asarray(w)}, bits=4)
    p, s = np.asarray(lp["wqkv"]), np.asarray(lp["wqkv_scale"])
    x = rng.standard_normal((rows, in_dim)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    tp, ts, tx = (torch.from_numpy(a.copy()) for a in (p, s, x))
    ref = np.asarray(jax_int4_mm(jnp.asarray(x), jnp.asarray(p),
                                 jnp.asarray(s), 1))
    tol = 1e-5 * np.abs(ref).max()
    plain = int4_mm_plain(tx, tp, ts, 1).numpy()
    np.testing.assert_allclose(plain, ref, rtol=0, atol=tol)
    chunks = -(-(in_dim // 2) // K_CHUNK)
    for cs in range(1, min(MAX_CLUSTER, chunks) + 1):
        got = int4_mm_split_plain(tx, tp, ts, 1, cs).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol,
                                   err_msg=f"cs={cs}")
        np.testing.assert_allclose(got, plain, rtol=0, atol=tol,
                                   err_msg=f"cs={cs}")
        # the bf16 x the kernel takes gives the same sums
        np.testing.assert_array_equal(
            int4_mm_split_plain(tx.bfloat16(), tp, ts, 1, cs).numpy(), got)
