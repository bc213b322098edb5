"""ZeRO-3 parameter sharding of the UNet over ``torch.distributed``
(counterpart of ``fsdp_shard_flat``, ``gligen_tpu/parallel/sharding.py:
119``, which GSPMD serves by all-gathering each weight around its use).

Each rank keeps 1/n of every parameter that ``sharding.fsdp_spec`` shards
(2^16 elements or more, along the JAX rule's dim); the rest stays
replicated.  A unit gathers its parameters before it runs and lets them go
after: the units are every ``BasicTransformerBlock``, every ``ResBlock`` and
each remaining top-level module (a ``SpatialTransformer``'s own norm and
projections, the position net, the convs, ...).  They are units, not single
layers, because the fused paths read submodule weights directly
(``attn.to_q.weight`` in ``_fused_self_attn``, ``c1.weight`` in
``ResBlock._fused``): a hook on ``to_q`` would never fire.

The gather is an autograd Function (``_Gather``): its backward
reduce-scatters the full gradient into the mean over the group of this
rank's slice, the shard's ``.grad``, so the train step reduces no FSDP
shard again (``sharding.gradient_rule`` "done").  AdamW's moments and the
EMA are built over the shard parameters and live only there.  Under remat
``full`` a ``SpatialTransformer`` recomputes each block through its module
call (``checkpoint(block, ...)``), so the recompute gathers again; a unit
that is not recomputed (a ``ResBlock``) keeps what autograd saved of its
gathered weights (their compute-dtype casts) until its backward.

``torch.distributed.fsdp.fully_shard`` is not used (nor tried on the
card): it turns the parameters into DTensors, which AdamW, the EMA's
foreach update and the ctypes kernels' raw pointers would then meet, and
the unit gather above, over ``mesh.all_gather`` and
``mesh.reduce_scatter_mean``, is all this UNet needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from gligen_tpu_torch.parallel import mesh
from gligen_tpu_torch.parallel.sharding import fsdp_spec


class _Gather(torch.autograd.Function):
    """A shard's full tensor, gathered over the group; the backward is
    the mean gradient's slice of this rank."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return mesh.all_gather(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return mesh.reduce_scatter_mean(grad, ctx.dim, ctx.group), None, None


@dataclasses.dataclass
class FsdpState:
    """What ``shard_unet_`` did: each parameter's sharded dim (None:
    replicated), the group, and the hooks it registered."""

    specs: Dict[str, Optional[int]]
    group: Any
    handles: List[Any]


def units(unet: nn.Module) -> List[nn.Module]:
    """The gather units of a UNet: every transformer block and ResBlock,
    each other top-level module, and the UNet itself (for its own
    parameters, if any)."""
    from gligen_tpu_torch.models.layers import BasicTransformerBlock
    from gligen_tpu_torch.models.unet import ResBlock

    out = [m for m in unet.modules() if isinstance(m, (BasicTransformerBlock, ResBlock))]
    out += [m for m in unet.children() if not isinstance(m, ResBlock)]
    return out + [unet]


def _own_sharded(unit: nn.Module, unit_ids, dims: Dict[int, int]) -> List[Tuple[nn.Module, str, nn.Parameter, int]]:
    """(module, attribute, shard, dim) of the sharded parameters the unit
    owns: its subtree's, less those of nested units."""
    out, stack = [], [unit]
    while stack:
        m = stack.pop()
        for name, p in m._parameters.items():
            if p is not None and id(p) in dims:
                out.append((m, name, p, dims[id(p)]))
        stack += [c for c in m.children() if id(c) not in unit_ids]
    return out


def shard_unet_(unet: nn.Module) -> Dict[str, Optional[int]]:
    """Shard ``unet`` in place over the whole process group by
    ``fsdp_spec`` and hook its units; returns the specs, also kept as
    ``unet.fsdp``.  Load weights before (every rank the same)."""
    if getattr(unet, "fsdp", None) is not None:
        raise RuntimeError("fsdp.shard_unet_: this UNet is already sharded")
    group = dist.group.WORLD
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    specs = {name: fsdp_spec(name, p.shape, n) for name, p in unet.named_parameters()}
    dims = {}
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if specs[name] is not None:
                p.data = p.data.chunk(n, specs[name])[rank].clone()
                dims[id(p)] = specs[name]
    all_units = units(unet)
    unit_ids = {id(u) for u in all_units}
    handles = []
    for unit in all_units:
        owned = _own_sharded(unit, unit_ids, dims)
        if not owned:
            continue

        def gather(module, args, owned=owned):
            for m, name, p, dim in owned:
                m._parameters[name] = _Gather.apply(p, dim, group)

        def release(module, args, output, owned=owned):
            for m, name, p, _ in owned:
                m._parameters[name] = p

        handles += [unit.register_forward_pre_hook(gather), unit.register_forward_hook(release)]
    unet.fsdp = FsdpState(specs, group, handles)
    return specs


def resident_bytes(module: nn.Module) -> int:
    """Bytes of the parameters a module holds at rest."""
    return sum(p.numel() * p.element_size() for p in module.parameters())
