"""Data parallelism (counterpart of ``gligen_tpu/parallel/mesh.py``).

The reference scales with one NCCL process per GPU (main.py:56-62,
distributed.py); the JAX package with one process per host driving a
``jax.sharding.Mesh``.  The port keeps the reference's shape:

* training runs one process per card in a ``torch.distributed`` process
  group formed from the launcher's environment (``torchrun``: ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``).  Every process holds the same parameters (seeded alike,
  or loaded from the same checkpoint) and decodes its contiguous slice of
  each global batch (``process_batch_slice``, the DistributedSampler
  contract); the train step averages the trainable gradients over the
  group (``all_reduce_mean_``);
* generation runs one process over a ``Mesh``, an ordered list of devices
  (duplicates allowed), each running its rows of a padded batch
  (``inference/pipeline.py``).

The backend is a rule, not a knob: NCCL when every rank of a host has a
card of its own, gloo on the CPU or when ranks share a card (NCCL refuses
two ranks on one GPU).  A group that fails to form raises.

Tensor parallelism and FSDP (ROADMAP M12 part 2) split the group into a
grid (``init_grid``): TP groups of ``tp`` consecutive ranks and DP groups of
the ranks ``tp`` apart, JAX's ``(('data', n / tp), ('model', tp))`` order.
TP ranks share their batch rows (``data_index``, ``data_size``).  The
Megatron pair's two collectives are autograd Functions over the TP group:
``copy_in`` (identity forward, all-reduce backward) where a region reads
its replicated input, ``reduce_out`` (all-reduce forward, identity
backward) where it writes its output; ``all_gather`` and
``reduce_scatter_mean`` serve FSDP (``parallel/fsdp.py``).  Every
collective has one route per backend: NCCL on the card; gloo through the
host, its sums in fp32 (two ranks' bf16 partials sum exactly in fp32 and
round once, as a bf16 sum would).  gloo takes each of them in torch 2.11
and 2.13 (``chip_smoke.py`` phase 22 runs them on the card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the launcher's variables a process group is formed from
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# gradients are averaged in buckets of at most this many elements
BUCKET_ELEMENTS = 1 << 25
# how long a collective waits for every rank before it raises
GROUP_TIMEOUT = datetime.timedelta(minutes=30)

# a gloo group over the same ranks for host-side values (flags, objects):
# the process group itself where it is gloo
_HOST_GROUP = None
# the TP x DP grid of ``init_grid``, None for 1-D data parallelism
_GRID = None


# ---------------------------------------------------------------- the mesh

@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices over which a batch's rows are split
    (``shard_batch``); a device may appear more than once, and its
    replicas then share one copy of the weights (``replicate``)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A mesh over ``devices`` (names, indices of cards or
    ``torch.device``s; a duplicate is a second replica on that device), by
    default over every visible card.  Raises when there is no card to
    build the default mesh on, or for a card index the machine lacks."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu', ...] for a "
                               "mesh on the CPU")
        devices = range(torch.cuda.device_count())
    out = []
    for d in devices:
        dev = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
            if not torch.cuda.is_available() or dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"make_mesh: {dev} is not a card of this machine")
        out.append(dev)
    if not out:
        raise ValueError("make_mesh: no device")
    return Mesh(tuple(out))


def padded_rows(rows: int, mesh: Optional[Mesh]) -> int:
    """``rows`` rounded up to a multiple of the mesh size."""
    n = 1 if mesh is None else mesh.size
    return -(-int(rows) // n) * n


def pad_rows(x: torch.Tensor, target: int) -> torch.Tensor:
    """``x`` padded to ``target`` rows by repeating its last row (the
    padded rows' outputs are discarded by the caller; pipeline.py:111-118)."""
    pad = target - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def shard_batch(mesh: Mesh, tree: Any) -> List[Any]:
    """A tree of batch-leading tensors (dicts nest) split into
    ``mesh.size`` equal row blocks, block ``i`` on ``mesh.devices[i]``.
    The batch must divide by the mesh size (``pad_rows`` first)."""
    rows = []

    def count(x):
        rows.append(int(torch.as_tensor(x).shape[0]))

    tree_map(count, tree)
    if any(r % mesh.size for r in rows):
        raise ValueError(f"batch dims {sorted(set(rows))} not divisible by the mesh size "
                         f"{mesh.size}")
    return [tree_map(lambda x, i=i, dev=dev: torch.as_tensor(x).tensor_split(mesh.size)[i]
                     .to(dev), tree) for i, dev in enumerate(mesh.devices)]


def replicate(mesh: Mesh, module: torch.nn.Module) -> Tuple[torch.nn.Module, ...]:
    """``module`` on every mesh device, aligned with ``mesh.devices``: the
    module itself on its own device, one copy on each other device, and
    the same object wherever a device repeats."""
    import copy

    own = next(module.parameters()).device
    by_device = {dev: module if dev == own else copy.deepcopy(module).to(dev)
                 for dev in mesh.distinct()}
    return tuple(by_device[d] for d in mesh.devices)


# ---------------------------------------------------------------- processes

def world_size() -> int:
    """The processes of the active group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the active group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_process_zero() -> bool:
    """Rank-0 gating (distributed.py:9-16)."""
    return process_index() == 0


def data_size() -> int:
    """The data-parallel replicas: the DP group's size under a grid, else
    the world's."""
    return _GRID.dp_size if _GRID is not None else world_size()


def data_index() -> int:
    """This process's replica index: its rank in its DP group under a grid
    (the TP ranks of one group share it), else its rank."""
    return _GRID.dp_rank if _GRID is not None else process_index()


def process_batch_slice(global_batch: int) -> slice:
    """This process's contiguous rows of a global batch (the
    DistributedSampler contract, reference trainer.py:275); replica-major,
    the ranks of a TP group sharing theirs."""
    n = data_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} replicas")
    local = global_batch // n
    r = data_index()
    return slice(r * local, (r + 1) * local)


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None) -> int:
    """The rows each mesh device (or, without a mesh, each process) runs."""
    n = mesh.size if mesh is not None else world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    return global_batch // n


def backend_for(device_type: str, local_world: int, cards: int) -> str:
    """NCCL when every rank of a host has a card of its own, else gloo
    (the CPU, or ranks sharing a card)."""
    return "nccl" if device_type == "cuda" and local_world <= cards else "gloo"


def init_process_group(device_type: str = "cuda") -> torch.device:
    """Join the process group the launcher's environment describes
    (``LAUNCH_ENV``; ``LOCAL_WORLD_SIZE`` defaults to ``WORLD_SIZE``) and
    return this process's device: ``cuda:LOCAL_RANK`` (modulo the cards,
    where ranks share them) or the CPU.  Raises where a variable is
    missing, where ``device_type`` is "cuda" and the machine has no card,
    and where the group does not form."""
    global _HOST_GROUP
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_process_group: {', '.join(missing)} not set; launch with "
                           "torchrun (or set the variables of each process yourself)")
    if dist.is_initialized():
        raise RuntimeError("init_process_group: this process is already in a group")
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: no CUDA device for a rank on the card")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        cards, device = 0, torch.device("cpu")
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    backend = backend_for(device_type, local_world, cards)
    dist.init_process_group(backend=backend, init_method="env://", timeout=GROUP_TIMEOUT,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    _HOST_GROUP = dist.new_group(backend="gloo") if backend == "nccl" else dist.group.WORLD
    return device


def destroy_process_group() -> None:
    """Leave the active group, if any."""
    global _HOST_GROUP, _GRID
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    _GRID = None


# ---------------------------------------------------------------- the grid

@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One TP group as a module sees it: the process group, this rank's
    index in it and its size."""

    group: Any
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place in the TP x DP grid: its TP group (None at
    tp = 1) and its DP group, index and size."""

    tp: Optional[TensorParallel]
    dp_group: Any
    dp_rank: int
    dp_size: int


def init_grid(tp: int) -> Grid:
    """Split the active group into TP groups of ``tp`` consecutive ranks
    and DP groups of the ranks ``tp`` apart (every rank forms every group,
    in one order).  Raises without a group or where ``tp`` does not divide
    the world."""
    global _GRID
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("init_grid: no process group; call init_process_group first")
    if _GRID is not None:
        raise RuntimeError("init_grid: this process already has a grid")
    world, rank = world_size(), process_index()
    if tp < 1 or world % tp:
        raise ValueError(f"init_grid: tp {tp} does not divide {world} processes")
    mine_tp = mine_dp = None
    for d in range(world // tp):
        ranks = list(range(d * tp, (d + 1) * tp))
        group = dist.new_group(ranks=ranks) if tp > 1 else None
        if rank in ranks:
            mine_tp = None if tp == 1 else TensorParallel(group, ranks.index(rank), tp)
    for k in range(tp):
        ranks = list(range(k, world, tp))
        group = dist.new_group(ranks=ranks) if tp > 1 else dist.group.WORLD
        if rank in ranks:
            mine_dp = (group, ranks.index(rank), len(ranks))
    _GRID = Grid(mine_tp, *mine_dp)
    return _GRID


def tensor_parallel() -> Optional[TensorParallel]:
    """This process's TP group, None without a grid or at tp = 1."""
    return _GRID.tp if _GRID is not None else None


def dp_group() -> Any:
    """The DP group's process group (the whole group without a grid)."""
    return _GRID.dp_group if _GRID is not None else dist.group.WORLD


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor (``all_reduce_sum_``
    on a copy)."""
    out = t.detach().clone()
    all_reduce_sum_([out], group)
    return out


class _CopyIn(torch.autograd.Function):
    """A TP region's replicated input: identity forward; the backward sums
    the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """A TP region's output: the ranks' partials summed forward; the
    gradient, the same on every rank, passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_in(x: Optional[torch.Tensor], tp: Optional[TensorParallel]) -> Optional[torch.Tensor]:
    """``x`` entering a TP region (``_CopyIn``); x itself without one."""
    return x if tp is None or x is None else _CopyIn.apply(x, tp.group)


def reduce_out(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """A TP region's partial output summed over its ranks (``_ReduceOut``);
    x itself without one."""
    return x if tp is None else _ReduceOut.apply(x, tp.group)


def all_gather(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' shards of ``group`` concatenated along ``dim`` in rank
    order, contiguous, on the shard's device: ``all_gather_into_tensor``
    of the shards with ``dim`` moved first (on the host under gloo)."""
    n = dist.get_world_size(group)
    moved = shard.detach().movedim(dim, 0)
    src = (moved.contiguous() if dist.get_backend(group) == "nccl"
           else moved.to("cpu", copy=True).contiguous())
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(shard.device).movedim(0, dim).contiguous()


def reduce_scatter_mean(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the mean of ``full`` over
    ``group``, contiguous: ``reduce_scatter_tensor`` with ``dim`` moved
    first (on the host in fp32 under gloo)."""
    n = dist.get_world_size(group)
    moved = full.detach().movedim(dim, 0)
    src = (moved.contiguous() if dist.get_backend(group) == "nccl"
           else moved.to("cpu", torch.float32, copy=True).contiguous())
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.div_(n).to(full.device, full.dtype).movedim(0, dim).contiguous()


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` over ``group`` (the whole group by default) in place:
    flattened into buckets of at most ``BUCKET_ELEMENTS`` (one dtype and
    device each), one ``all_reduce`` per bucket, on the card under NCCL and
    on the host in fp32 under gloo.  Every rank gets the same bits.  No-op
    without a group."""
    n = world_size() if group is None else dist.get_world_size(group)
    tensors = list(tensors)
    if n == 1 or not tensors:
        return
    on_host = dist.get_backend(group) != "nccl"
    bucket: List[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        if on_host:
            flat = flat.to("cpu", torch.float32)
        dist.all_reduce(flat, group=group)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        bucket.clear()

    size = 0
    for t in tensors:
        if bucket and (size + t.numel() > BUCKET_ELEMENTS or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    flush()


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Average ``tensors`` over ``group`` (the whole group by default) in
    place: ``all_reduce_sum_``, then divided by the group's size.  No-op
    without a group."""
    n = world_size() if group is None else dist.get_world_size(group)
    tensors = list(tensors)
    if n == 1 or not tensors:
        return
    all_reduce_sum_(tensors, group)
    torch._foreach_div_(tensors, n)


def host_any(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (a gloo reduce of
    a host value: no device synchronisation).  ``flag`` without a group."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (picklable host values); ``obj``
    without a group."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_HOST_GROUP)
    return box[0]


def barrier() -> None:
    """Wait for every rank (over the host group); no-op without a group."""
    if world_size() > 1:
        dist.barrier(group=_HOST_GROUP)
