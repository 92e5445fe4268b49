"""Device mesh and tensor-parallel layout for multi-device serving.

PyTorch counterpart of voxtral_tpu/parallel/mesh.py.  The two scale-out
axes are the JAX package's:
  dp - data parallel over streams: each dp group serves its contiguous
       block of B/dp streams (the JAX P("dp") split of the leading axis),
       with no collective between groups;
  tp - tensor parallel over attention heads and FFN hidden (Megatron
       column/row parallel linears, as JAX's `param_shardings`).

In JAX, NamedSharding annotations let GSPMD insert the collectives.  Here
each rank holds only its local slices (`shard_params`), runs the model at
its per-rank head counts (`rank_config`: heads, KV heads, FFN hidden and
the adapter's hidden divided by tp; dim, head_dim, windows and vocab size
kept) and the model code calls the collectives itself, over the tp group
its config carries:
  - column-parallel: `wqkv` (per q/k/v segment, so rank r's q heads use
    its own KV heads), `w13` (per gate/up segment), the encoder's `bqkv`
    with its columns, and the adapter's `w0`;
  - row-parallel: `wo`, `w2` and the adapter's `w1`, each product followed
    by one all-reduce (sum) of its float32 result over tp, before any bias
    (`bo`, `b2`, added once after the reduce) and before the cast to the
    activation dtype, so the cast rounds once as on one device;
  - `tok_embeddings` split over the vocab: the embedding lookup is a
    masked local lookup plus an all-reduce (the sum of one row and zeros
    is exact); the logits are the local vocab slice, the greedy argmax a
    vocab-parallel one (ties to the lowest global index, as torch.argmax),
    and the alt tokens gather the full logits;
  - everything else is replicated: norms, the decoder's ada weights, and
    the conv stem.  The stem (about 5 M parameters, 0.1 % of the model) is
    the one divergence from the JAX layout, which splits its output
    channels over tp (voxtral_tpu/parallel/mesh.py:47-50): GSPMD then
    gathers them for the next product, which an explicit port would have
    to write out for no gain.

The quantized weight rungs (int8, int4) keep one layout per output row
that does not split by heads: on a mesh they run with tp = 1, the weights
replicated and the streams split over dp (the JAX int4 dry run's layout).

The backend is explicit.  `backend=None` means NCCL on CUDA (one card per
rank: it raises when two ranks would share a card) and gloo on the CPU.
Several ranks on one card (the dry run and the smoke run on one H100) must
ask for gloo, whose collectives stage CUDA tensors through the host.

`run_ranks` spawns a world of processes joined by a FileStore rendezvous in
a directory of the caller's choice, every collective with a timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..config import DecoderConfig, EncoderConfig, VoxtralConfig

PyTree = Any

# seconds any collective may wait before the ranks fail (a dead or hung
# rank fails the whole world instead of hanging it)
DEFAULT_TIMEOUT_S = 300
# the time a spawned world (run_ranks) may take as a whole, from the first
# spawn to the last rank's exit, unless its caller gives its own
WORLD_TIMEOUT_S = 900


# --------------------------------------------------------------------------
# the tp group and its collectives
# --------------------------------------------------------------------------

class TensorParallel:
    """This rank's tp group: its size, this rank's index in it, and the
    collectives the model code calls over it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of x over the group, in place; returns x."""
        dist.all_reduce(x, group=self.group)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x concatenated along the last axis, in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=-1)

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy ids over vocab-split logits [B, V/tp] (rank r holds ids
        [r V/tp, (r+1) V/tp)) -> int32 [B] global ids, ties to the lowest
        global index as torch.argmax over the full logits."""
        n = logits.shape[-1]
        idx = torch.argmax(logits, dim=-1, keepdim=True)
        val = logits.gather(-1, idx)[..., 0]
        glob = (idx[..., 0] + self.rank * n).to(val.dtype)   # exact < 2^24
        both = torch.stack([val, glob]).contiguous()         # [2, B]
        parts = [torch.empty_like(both) for _ in range(self.size)]
        dist.all_gather(parts, both, group=self.group)
        allv = torch.stack([p[0] for p in parts])             # [tp, B]
        alli = torch.stack([p[1] for p in parts])
        best = allv.max(dim=0, keepdim=True).values
        first = torch.argmax((allv == best).to(torch.int32), dim=0,
                             keepdim=True)                    # lowest rank
        return alli.gather(0, first)[0].to(torch.int32)


def tp_of(cfg) -> Optional[TensorParallel]:
    """The tp group a (per-rank) config carries, or None off a mesh."""
    return getattr(cfg, "tp", None)


def tp_sum(x: torch.Tensor, cfg) -> torch.Tensor:
    """x summed over cfg's tp group (in place); x itself off a mesh."""
    tp = tp_of(cfg)
    return x if tp is None else tp.sum(x)


# --------------------------------------------------------------------------
# per-rank config
# --------------------------------------------------------------------------

_TP_FIELD = dict(default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class RankEncoderConfig(EncoderConfig):
    """An EncoderConfig at one tp rank's head counts, with its tp group."""
    tp: Optional[TensorParallel] = dataclasses.field(**_TP_FIELD)


@dataclasses.dataclass(frozen=True)
class RankDecoderConfig(DecoderConfig):
    """A DecoderConfig at one tp rank's head counts, with its tp group."""
    tp: Optional[TensorParallel] = dataclasses.field(**_TP_FIELD)


@dataclasses.dataclass(frozen=True)
class RankConfig(VoxtralConfig):
    """A VoxtralConfig at one tp rank's widths, with its tp group."""
    tp: Optional[TensorParallel] = dataclasses.field(**_TP_FIELD)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name != "tp"}


def _split(what: str, n: int, tp: int) -> int:
    if n % tp:
        raise ValueError(f"{what} ({n}) does not split over tp={tp}")
    return n // tp


def rank_config(cfg: VoxtralConfig, tp: TensorParallel) -> RankConfig:
    """cfg at one tp rank: heads, KV heads and FFN hidden of both stacks
    and the adapter's hidden divided by tp.size; dim, head_dim, windows,
    ring sizes and vocab_size (ids stay global) kept."""
    n = tp.size
    e, d = cfg.encoder, cfg.decoder
    enc = RankEncoderConfig(**{
        **_fields(e), "n_heads": _split("encoder heads", e.n_heads, n),
        "n_kv_heads": _split("encoder KV heads", e.n_kv_heads, n),
        "hidden": _split("encoder hidden", e.hidden, n)}, tp=tp)
    dec = RankDecoderConfig(**{
        **_fields(d), "n_heads": _split("decoder heads", d.n_heads, n),
        "n_kv_heads": _split("decoder KV heads", d.n_kv_heads, n),
        "hidden": _split("decoder hidden", d.hidden, n)}, tp=tp)
    _split("vocab", d.vocab_size, n)
    return RankConfig(**{
        **_fields(cfg), "encoder": enc, "decoder": dec,
        "adapter_hidden": _split("adapter hidden", cfg.adapter_hidden, n)},
        tp=tp)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

def resolve_backend(device: str, backend: Optional[str]) -> str:
    """The process-group backend: `backend`, or NCCL on CUDA and gloo on
    the CPU when it is None."""
    device = torch.device(device).type
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device != "cuda":
        raise ValueError("nccl runs on CUDA devices only")
    return backend


def check_cards(device: str, backend: str, world: int) -> None:
    """NCCL takes one card per rank: raise when `world` ranks would share
    fewer cards (pass backend="gloo" to place several ranks on one)."""
    if backend == "nccl" and torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"nccl needs one card per rank: {world} ranks on {cards} "
                f"card(s); pass backend='gloo' to place several ranks on "
                f"one card")


def make_mesh(dp: int, tp: int = 1, device: str = "cuda",
              backend: Optional[str] = None):
    """A DeviceMesh with dims ("dp", "tp") over dp * tp ranks, rank
    d * tp + t at (d, t).  Joins the default process group first if this
    process has none (env:// rendezvous: MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE); its backend must be the one asked for.  On CUDA, selects
    the card of this rank (rank modulo the cards)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dp * tp
    backend = resolve_backend(device, backend)
    check_cards(device, backend, world)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    if not dist.is_initialized():
        dist.init_process_group(backend, timeout=timeout)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    if dist.get_world_size() != world:
        raise ValueError(f"a {dp} x {tp} mesh needs {world} ranks, the "
                         f"world has {dist.get_world_size()}")
    rank = dist.get_rank()
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    grid = torch.arange(world).reshape(dp, tp)
    dp_group = tp_group = None
    # every rank creates every group, in one order
    for j in range(tp):
        ranks = grid[:, j].tolist()
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            dp_group = g
    for i in range(dp):
        ranks = grid[i].tolist()
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            tp_group = g
    return DeviceMesh.from_group([dp_group, tp_group], dev_type, mesh=grid,
                                 mesh_dim_names=("dp", "tp"))


def mesh_dims(mesh) -> tuple[int, int, int, int]:
    """(dp, tp, this rank's dp index, its tp index); (1, 1, 0, 0) off a
    mesh."""
    if mesh is None:
        return 1, 1, 0, 0
    return (mesh["dp"].size(), mesh["tp"].size(),
            mesh.get_local_rank("dp"), mesh.get_local_rank("tp"))


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """The mesh's tp group for this rank, or None when tp is 1."""
    _, tp, _, r = mesh_dims(mesh)
    return TensorParallel(mesh.get_group("tp"), tp, r) if tp > 1 else None


# --------------------------------------------------------------------------
# layouts
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split over tp along `axis`.  `segments` (lengths along the
    axis that add up to its size; None: one segment) are split each on its
    own, rank r taking the r-th piece of every segment, concatenated."""
    axis: int
    segments: Optional[tuple[int, ...]] = None


def param_shardings(cfg: VoxtralConfig, mesh=None) -> PyTree:
    """The tp layout of the parameter tree (module docstring), a tree
    mirroring the params with a Split or None (replicated) per leaf.
    Every leaf is replicated over dp."""
    e, d = cfg.encoder, cfg.decoder
    col, row = Split(1), Split(2)            # [L, out, in]: out / in
    enc_qkv = Split(1, (e.qkv_dim,) * 3)     # [L, q+k+v, ...]
    enc = {
        "conv0_w": None, "conv0_b": None, "conv1_w": None, "conv1_b": None,
        "layers": {
            "attn_norm": None, "ffn_norm": None, "bo": None, "b2": None,
            "wqkv": enc_qkv, "bqkv": enc_qkv, "wo": row,
            "w13": Split(1, (e.hidden, e.hidden)), "w2": row,
        },
        "final_norm": None,
    }
    dec = {
        "tok_embeddings": Split(0),
        "layers": {
            "attn_norm": None, "ffn_norm": None,
            "wqkv": Split(1, (d.q_dim, d.kv_dim, d.kv_dim)), "wo": row,
            "w13": Split(1, (d.hidden, d.hidden)), "w2": row,
            "ada_down": None, "ada_up": None,
        },
        "final_norm": None,
    }
    adapter = {"w0": Split(0), "w1": Split(1)}
    return {"encoder": enc, "adapter": adapter, "decoder": dec}


def shard_leaf(x: torch.Tensor, spec: Optional[Split], tp: int,
               r: int) -> torch.Tensor:
    """Rank r's slice of x under `spec` (a new contiguous tensor), or x
    itself when replicated."""
    if spec is None or tp == 1:
        return x
    segs = spec.segments or (x.shape[spec.axis],)
    if sum(segs) != x.shape[spec.axis]:
        raise ValueError(f"segments {segs} of axis {spec.axis} of "
                         f"{tuple(x.shape)}")
    parts, off = [], 0
    for n in segs:
        k = _split(f"axis {spec.axis} of {tuple(x.shape)}", n, tp)
        parts.append(x.narrow(spec.axis, off + r * k, k))
        off += n
    return torch.cat(parts, dim=spec.axis).contiguous()


def shard_params(params: PyTree, cfg: VoxtralConfig, mesh) -> PyTree:
    """This rank's local parameter tree: tp slices of the split leaves
    (new tensors, so the caller may free the full tree), the replicated
    leaves shared.  At tp = 1 the tree itself (quantized trees included);
    at tp > 1 a quantized tree raises."""
    _, tp, _, r = mesh_dims(mesh)
    if tp == 1:
        return params

    def walk(tree, specs, path):
        out = {}
        for k, v in tree.items():
            if k not in specs:
                raise ValueError(
                    f"{path}{k}: no tp layout (quantized weights run at "
                    f"tp = 1 on a mesh)")
            out[k] = (walk(v, specs[k], f"{path}{k}.") if isinstance(v, dict)
                      else shard_leaf(v, specs[k], tp, r))
        return out

    return walk(params, param_shardings(cfg, mesh), "")


def batch_shardings(mesh, batch: int) -> slice:
    """This rank's contiguous block of the `batch` streams (the JAX
    P("dp") split of the leading axis)."""
    dp, _, d, _ = mesh_dims(mesh)
    n = _split("streams", batch, dp)
    return slice(d * n, (d + 1) * n)


def gather_streams(mesh, local: list) -> list:
    """Per-stream results of this rank's block, concatenated over the dp
    groups in dp order (every rank gets the whole list); `local` itself
    off a mesh or at dp = 1."""
    dp = mesh_dims(mesh)[0]
    if dp == 1:
        return list(local)
    parts: list = [None] * dp
    dist.all_gather_object(parts, list(local), group=mesh.get_group("dp"))
    return [x for p in parts for x in p]


# --------------------------------------------------------------------------
# spawning a world of ranks
# --------------------------------------------------------------------------

def _rank_main(rank: int, fn, world: int, workdir: str, device: str,
               backend: str, args: tuple) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    try:
        out = fn(rank, *args)
        # no rank leaves the world before every rank has joined it: a rank
        # that closed its sockets while a slower one was still in gloo's
        # connectFullMesh failed that one ("Connection closed by peer")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def run_ranks(fn, world: int, args: tuple = (), *, device: str = "cuda",
              backend: Optional[str] = None,
              workdir: Optional[str] = None,
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """fn(rank, *args) in `world` spawned processes joined in one default
    process group (rendezvous through a FileStore in `workdir`, a fresh
    temporary directory when None); returns their results in rank order.
    `fn` must be importable by the children (a module-level function).  A
    rank that raises fails the call (the others are stopped); a hung
    collective times out after DEFAULT_TIMEOUT_S, and a world still running
    `timeout` seconds after its start is killed (TimeoutError)."""
    import torch.multiprocessing as mp

    backend = resolve_backend(device, backend)
    check_cards(device, backend, world)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="voxtral_ranks_") if own else workdir
    try:
        os.makedirs(workdir, exist_ok=True)
        if os.path.exists(os.path.join(workdir, "store")):
            raise ValueError(f"{workdir} holds an old rendezvous store")
        deadline = time.monotonic() + timeout
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, workdir, device, backend, args),
            nprocs=world, join=False, start_method="spawn")
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                    proc.join()
                raise TimeoutError(f"{world} spawned ranks still running "
                                   f"{timeout} s after their start")
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
