"""The int8 kernel's launch plans, its K-split fold and the int8 route of
the port's products, on the CPU.

`int8_mm_plan` and `int8_mm_rowinv_plan` (ops/quant_mm.py) decide the K
split that csrc/int8_mm.cu runs (from the shapes, or from (out, K) alone),
and `int8_mm_launch` the tile height, the way the split runs and the grid;
`int8_mm_split_plain` is a plain model of the kernel's fold of the split's
partial sums.  Both are held against the JAX package's int8 product
(voxtral_tpu/models/quant.py `mm`, whose int8 -> bf16 convert XLA fuses
into the product).  Every comparison is within 1e-5 x max |ref|: an int8
weight times a bf16 value is exact in f32, so only the order of the f32
sums differs.  The kernel itself is tested on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models import quant as jq
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models import quant as tq
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops import quant_mm
from voxtral_tpu_torch.ops.quant_mm import (
    INT8_K_CHUNK,
    MAX_CLUSTER,
    RING_TILE_ROWS,
    int8_mm,
    int8_mm_blocks_per_sm,
    int8_mm_launch,
    int8_mm_plain,
    int8_mm_plan,
    int8_mm_rowinv_plan,
    int8_mm_smem,
    int8_mm_split_plain,
    int8_mm_splits,
    int8_mm_stages,
)

torch.set_num_threads(1)

# max abs error allowed, as a share of max |ref|
REL = 1e-5

# (out, in) of the int8 rung's full-width products (wqkv, wo, w13, w2, the
# logits table)
PRODUCTS = {"wqkv": (6144, 3072), "wo": (3072, 4096), "w13": (18432, 3072),
            "w2": (3072, 9216), "logits": (131072, 3072)}
# a B=1 stream, the B=16 serve, a B=32, the B=56 bench decodes, a Jacobi
# window, the B=16, B=56 and B=64 prefills (38 rows a stream)
ROWS = (1, 16, 32, 56, 64, 608, 2128, 2432)


def _close(got, ref, what=""):
    tol = REL * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", list(PRODUCTS))
def test_plan_fits_one_wave_and_covers_k(name, rows):
    out, in_dim = PRODUCTS[name]
    plan = int8_mm_plan(rows, out, in_dim)
    assert 1 <= plan.cs <= MAX_CLUSTER
    assert 1 <= plan.clusters <= plan.tiles
    chunk = INT8_K_CHUNK
    # the ring's tile: 64 rows of x (nj 8) up to 64 rows, where the split
    # is the row-invariant plan's, 64 or 128 above; single blocks one wave
    # holds, or clusters, a tile each
    if rows <= 64:
        assert plan.nj == 8
        assert plan.cs == int8_mm_rowinv_plan(out, in_dim).cs
    else:
        assert 8 * plan.nj in RING_TILE_ROWS
    assert plan.per_sm == int8_mm_blocks_per_sm(8 * plan.nj) >= 1
    assert plan.clusters <= 132 * plan.per_sm
    lp = int8_mm_launch(rows, out, in_dim)
    assert lp.tile_rows == 8 * plan.nj and len(lp.ranges) == plan.cs
    if lp.seq:   # single blocks: one wave, persistent over the tiles
        assert lp.blocks == plan.clusters
        assert lp.tile_rows == 128 or plan.cs == 1
    else:        # a split of the 64-row tile: clusters, a tile each
        assert (lp.tile_rows, lp.blocks) == (64, plan.tiles)
        assert plan.cs > 1
    assert [(a * chunk, b * chunk) for a, b in lp.ranges] == \
        int8_mm_splits(in_dim, plan.cs)
    # non-empty ranges of whole K chunks, in order, covering the input dim
    splits = int8_mm_splits(in_dim, plan.cs)
    assert len(splits) == plan.cs
    assert splits[0][0] == 0 and splits[-1][1] == in_dim
    for (a, b), (c, _) in zip(splits, splits[1:] + [(in_dim, None)]):
        assert a < b == c and a % chunk == 0
    # the same plan on every call, and from a fresh cache
    assert int8_mm_plan(rows, out, in_dim) is plan
    int8_mm_plan.cache_clear()
    assert int8_mm_plan(rows, out, in_dim) == plan


def test_plan_splits_the_narrow_decode_products():
    """At 1-64 rows (one 64-row tile of each product) the narrow layer
    products split K so that their tiles fill about two blocks an SM (wo
    and w2 over a full cluster of 8, wqkv over 4), w13 and the logits
    table do not split, and the row-count plan equals the row-invariant
    one; at 608 rows the 128-row tile splits wo and w2 in two; at 2128 and
    2432 rows nothing splits."""
    for rows in (1, 16, 32, 56, 64):
        for name, cs in (("wqkv", 4), ("wo", 8), ("w13", 1), ("w2", 8),
                         ("logits", 1)):
            plan = int8_mm_plan(rows, *PRODUCTS[name])
            assert (plan.nj, plan.cs) == (8, cs), (name, rows)
            assert plan.cs == int8_mm_rowinv_plan(*PRODUCTS[name]).cs
            assert plan.cs * plan.tiles >= 132 or name == "w13", (name, rows)
            assert int8_mm_launch(rows, *PRODUCTS[name]).seq == (cs == 1)
    for rows, split in ((608, {"wo": 2, "w2": 2}), (2128, {}), (2432, {})):
        for name in ("wqkv", "wo", "w13", "w2"):
            plan = int8_mm_plan(rows, *PRODUCTS[name])
            assert (plan.nj, plan.cs) == (16, split.get(name, 1)), (name,
                                                                     rows)


def test_tiles_fit_a_block_and_the_sm():
    """The shared memory of csrc/int8_mm.cu's tiles stays within a block's
    227 KB and the SM's 228 KB at the residency the plans assume: the
    ring's (wgmma_ring.cuh's Tile with one byte a weight: stages of 32 KB
    at 64 rows, 48 KB at 128, 1 KB for alignment, 256 bytes of barriers; a
    cluster's fold staged and received in the idle ring) two blocks of the
    64-row tile on 3 stages, one of the 128-row tile on 4, clusters and
    single blocks alike."""
    want = {64: (3, 99584, 2), 128: (4, 197888, 1)}
    for tile, (stages, smem, blocks) in want.items():
        assert int8_mm_stages(tile) == stages >= 3
        assert int8_mm_smem(tile) == smem <= 232448
        assert int8_mm_blocks_per_sm(tile) == blocks
        assert blocks * (smem + 1024) <= 233472


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_rowinv_launch_one_instruction_sequence(name):
    """The row-invariant launch at rows 1..300 and the prefills up to 3040:
    whatever the tile height, the grid and the way the split runs, a row's
    sums are the same program (the plan's K ranges, contiguous, non-empty,
    1..8 of them, covering K, fixed by (out, K), folded in order, every
    128-column chunk as eight k16 steps of the one wgmma m64n64k16 with the
    widened weights as register A); clusters only on the 64-row tile."""
    out, in_dim = PRODUCTS[name]
    want = int8_mm_launch(1, out, in_dim, 132, True)
    chunks = in_dim // INT8_K_CHUNK
    assert want.ranges[0][0] == 0 and want.ranges[-1][1] == chunks
    assert all(a[1] == b[0] and a[0] < a[1]
               for a, b in zip(want.ranges, want.ranges[1:]))
    assert len(want.ranges) == int8_mm_rowinv_plan(out, in_dim).cs
    heights = set()
    for rows in list(range(1, 301)) + [608, 1216, 2128, 2432, 3040]:
        lp = int8_mm_launch(rows, out, in_dim, 132, True)
        assert (lp.ranges, lp.instruction) == (want.ranges, want.instruction)
        assert "m64n64k16" in lp.instruction
        assert lp.seq or lp.tile_rows == 64
        heights.add(lp.tile_rows)
    assert heights == set(RING_TILE_ROWS)


def _stack(rng, n_layers, out, in_dim):
    """int8 weights [L, out, in] and f32 scales [L, out] from the JAX
    package's quantize_layer_stack, as numpy."""
    w = rng.standard_normal((n_layers, out, in_dim)).astype(np.float32)
    lp = jq.quantize_layer_stack({"wqkv": jnp.asarray(w)}, bits=8)
    return np.asarray(lp["wqkv"]), np.asarray(lp["wqkv_scale"])


# tiny and odd shapes: (rows, out, in); the last at the B=64 prefill's
# rows
SPLIT_SHAPES = ((1, 16, 128), (5, 48, 384), (17, 40, 1024), (33, 64, 1152),
                (3, 200, 3072), (2432, 24, 640))


@pytest.mark.parametrize("rows,out,in_dim", SPLIT_SHAPES)
def test_split_fold_matches_plain_and_jax(rows, out, in_dim):
    """The kernel's fold (each range's f32 partials added in rank order,
    then the row scale) against the plain product and the JAX package's
    int8 `mm`, for every split the kernel could take, within 1e-5 x max
    |ref|.  x holds bf16 values in f32, as the kernel reads them; bf16 x
    gives the same sums; CPU tensors launch nothing."""
    rng = np.random.default_rng(rows * 1000 + in_dim)
    q, s = _stack(rng, 2, out, in_dim)
    x = rng.standard_normal((rows, in_dim)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    tw, ts, tx = (torch.from_numpy(a.copy()) for a in (q, s, x))
    ref = np.asarray(jq.mm(jnp.asarray(x), {"wqkv": jnp.asarray(q[1]),
                                            "wqkv_scale": jnp.asarray(s[1])},
                           "wqkv", jnp.float32))
    plain = int8_mm_plain(tx, tw, ts, 1).numpy()
    _close(plain, ref, "plain")
    n0 = int8_mm.launches
    np.testing.assert_array_equal(int8_mm(tx, tw, ts, 1).numpy(), plain)
    assert int8_mm.launches == n0
    chunks = -(-in_dim // INT8_K_CHUNK)
    for cs in range(1, min(MAX_CLUSTER, chunks) + 1):
        got = int8_mm_split_plain(tx, tw, ts, 1, cs).numpy()
        _close(got, ref, f"cs={cs} against JAX")
        _close(got, plain, f"cs={cs} against plain")
        np.testing.assert_array_equal(
            int8_mm_split_plain(tx.bfloat16(), tw, ts, 1, cs).numpy(), got)
        # the kernel's chain: each range's k16 steps summed in order
        chain = int8_mm_split_plain(tx, tw, ts, 1, cs, k_step=16).numpy()
        _close(chain, ref, f"cs={cs} k16 chain against JAX")
        _close(chain, plain, f"cs={cs} k16 chain against plain")


def test_wrapper_refuses_other_devices():
    """Neither CPU nor CUDA: the wrapper raises, it computes nothing."""
    w = torch.zeros((1, 16, 128), dtype=torch.int8, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        int8_mm(torch.zeros((2, 128), dtype=torch.bfloat16, device="meta"),
                w, torch.ones((1, 16), device="meta"), 0)


@pytest.fixture(scope="module")
def int8_trees(params, params_np):
    """The JAX package's int8 tree (numpy) and the port's, from the same
    tiny_config weights."""
    jtree = jax.tree.map(np.asarray, jq.quantize_params(params, bits=8))
    return jtree, tq.quantize_params(from_jax_numpy(params_np), bits=8)


@pytest.fixture
def int8_calls(monkeypatch):
    """Counts the calls that reach ops/quant_mm.py int8_mm."""
    calls = []
    real = quant_mm.int8_mm

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(quant_mm, "int8_mm", counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_routes_every_int8_product_to_int8_mm(int8_trees, int8_calls,
                                                 dtype):
    """quant.mm on every int8 matrix of the tiny decoder's layers, with x
    in f32 and in bf16, equals the JAX package's int8 `mm` within 1e-5 x
    max |ref|, one int8_mm call a product."""
    jtree, ttree = int8_trees
    cfg = tiny_config()
    rng = np.random.default_rng(8)
    jl, tl = jtree["decoder"]["layers"], ttree["decoder"]["layers"]
    for li in range(cfg.decoder.n_layers):
        for name in tq.QUANT_KEYS:
            x = rng.standard_normal((7, jl[name].shape[-1])).astype(np.float32)
            want = jq.mm(jnp.asarray(x).astype(dtype),
                         {k: v[li] for k, v in jl.items()}, name,
                         jnp.dtype(dtype))
            got = tq.mm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        {k: v[li] for k, v in tl.items()}, name)
            _close(got.numpy(), np.asarray(want, dtype=np.float32),
                   f"{name}[{li}]")
    assert len(int8_calls) == len(tq.QUANT_KEYS) * cfg.decoder.n_layers
    assert all(shape[0] == 1 for shape in int8_calls)   # one-layer stacks


def test_final_logits_int8_table_matches_jax(int8_trees, int8_calls, cfg):
    """The int8 table's logits (bf16 activations, one scale per vocab row)
    equal the JAX package's within 1e-5 x max |ref|, through one int8_mm
    call on the table as a one-layer stack, for [T, dim] and [B, T, dim]."""
    jtree, ttree = int8_trees
    x = np.random.default_rng(2).standard_normal(
        (3, cfg.decoder.dim)).astype(np.float32)
    want = np.asarray(jdec.final_logits(jtree["decoder"], cfg,
                                        jnp.asarray(x)))
    tcfg = tiny_config()
    got = tdec.final_logits(ttree["decoder"], tcfg, torch.from_numpy(x))
    assert got.shape == (3, cfg.decoder.vocab_size)
    _close(got.numpy(), want)
    assert int8_calls == [(1, cfg.decoder.vocab_size, cfg.decoder.dim)]
    got3 = tdec.final_logits(ttree["decoder"], tcfg,
                             torch.from_numpy(x)[None])
    np.testing.assert_array_equal(got3[0].numpy(), got.numpy())
