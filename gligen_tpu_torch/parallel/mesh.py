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


def process_batch_slice(global_batch: int) -> slice:
    """This process's contiguous rows of a global batch (the
    DistributedSampler contract, reference trainer.py:275); rank-major."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    local = global_batch // n
    r = process_index()
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
    global _HOST_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def _reduce_device(t: torch.Tensor) -> torch.device:
    """Where a tensor is reduced: on its card under NCCL, else on the CPU
    (gloo)."""
    return t.device if dist.get_backend() == "nccl" else torch.device("cpu")


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Average ``tensors`` over the group in place: flattened into buckets
    of at most ``BUCKET_ELEMENTS`` (one dtype and device each), one
    ``all_reduce`` per bucket, divided by the world size.  Every rank
    gets the same bits.  No-op without a group."""
    n = world_size()
    tensors = list(tensors)
    if n == 1 or not tensors:
        return
    bucket: List[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket]).to(_reduce_device(bucket[0]))
        dist.all_reduce(flat)
        flat.div_(n)
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
