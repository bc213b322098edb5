"""Tensor-parallel and FSDP placement of the UNet's parameters
(counterpart of ``gligen_tpu/parallel/sharding.py``).

The JAX package states its rules per tensor as PartitionSpecs and lets
GSPMD insert the collectives.  The port runs eagerly with hand-written
collectives (``parallel/mesh.py``), so it keeps the JAX rules as they are
(``tp_spec``, ``fsdp_spec``, on the port's names and torch layouts: a JAX
Dense kernel (I, O) is the port's (O, I) weight, an HWIO conv kernel the
port's OIHW, ``convert/from_jax.py``) and decides per Megatron pair
(``tp_plan``), never per tensor:

  * attention: q/k/v out-sharded (whole heads: the pair needs heads % tp
    == 0), to_out in-sharded; the partial outputs are summed once
    (``mesh.reduce_out``);
  * feed-forward: GEGLU out-sharded, net_2 in-sharded;
  * ResBlock: conv1, the time-embedding projection and GroupNorm 2 (its
    32 groups split evenly, so a group never crosses ranks) out-sharded,
    conv2 in-sharded.

A pair whose dims do not divide stays replicated whole, as the JAX rule
leaves an indivisible tensor replicated.  The biases after an in-sharded
weight (to_out, net_2, conv2) are replicated and added on TP rank 0 only;
so is the residual.

Two placements differ from GSPMD's and compute the same function:

  * ``net_0.proj`` is out-sharded per half.  Its (2F, C) weight is the
    value half over the gate half; rank r holds its slice of each
    (``halves``), so ``ln_geglu`` runs whole on every rank.  JAX's
    contiguous ``P(None, ax)`` at tp = 2 would give one rank every value
    and the other every gate, which GSPMD then moves.
  * ``skip_connection``: the JAX rule out-shards it (``:56-57``).  Here it
    stays replicated and TP rank 0 alone applies it, adding the projected
    input to its partial before the reduce (as it adds the identity
    residual of a ResBlock without one).

Gradients (``gradient_rule``): a sharded trainable tensor is averaged over
its DP group only; a replicated one used inside a TP region (the norm and
the fuser's gates and ``linear`` ahead of a sharded pair, as the models
list them next to their forwards in ``TP_REGIONS``/``TP_REGION``, and the
rank-0 biases) sees only its rank's share and is summed over the TP group
first; everything else is averaged over the DP group.

``fsdp_spec`` shards every parameter of 2^16 elements or more along the
dim the JAX rule picks (the largest divisible one of the JAX layout);
``parallel/fsdp.py`` gathers them per unit.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter lives: ``dim`` split over the group (None:
    replicated), split per half (``halves``: GEGLU's value and gate), or
    replicated and read inside a TP region or applied on TP rank 0 only
    (``tp_sum``: its gradient is a partial sum over the TP ranks)."""

    dim: Optional[int] = None
    halves: bool = False
    tp_sum: bool = False


REPLICATED = Placement()

# (port name regex, sharded dim of the port's tensor): the JAX rules
# (gligen_tpu/parallel/sharding.py:40-58) through the layout map; first
# match wins.
_TP_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    (r"\.to_[qkv]\.weight$", 0),
    (r"\.to_out\.weight$", 1),
    (r"\.to_out\.bias$", None),
    (r"\.net_0\.proj\.weight$", 0),
    (r"\.net_0\.proj\.bias$", 0),
    (r"\.net_2\.weight$", 1),
    (r"\.in_layers_2\.weight$", 0),
    (r"\.in_layers_2\.bias$", 0),
    (r"\.emb_layers_1\.weight$", 0),
    (r"\.emb_layers_1\.bias$", 0),
    (r"\.out_layers_0\.(weight|bias)$", 0),
    (r"\.out_layers_3\.weight$", 1),
    (r"\.skip_connection\.weight$", 0),
    (r"\.skip_connection\.bias$", 0),
)

# The parameters whose placement is not GSPMD's (the module docstring).
PLACEMENT_EXCEPTIONS = (r"\.net_0\.proj\.(weight|bias)$", r"\.skip_connection\.(weight|bias)$")


def tp_spec(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The JAX per-tensor TP rule for a port parameter: the dim of its
    torch tensor split over ``tp`` ranks, or None (replicated) where no
    rule matches or that dim does not divide."""
    for rx, dim in _TP_RULES:
        if re.search(rx, name):
            return dim if dim is not None and shape[dim] % tp == 0 else None
    return None


def _jax_dims(name: str, ndim: int) -> List[int]:
    """The port dim of each JAX dim of a parameter: Dense kernels (the
    UNet's 2-D ``weight``s) are transposed, conv kernels HWIO -> OIHW."""
    if name.endswith(".weight") and ndim == 2:
        return [1, 0]
    if ndim == 4:
        return [2, 3, 1, 0]
    return list(range(ndim))


def fsdp_spec(name: str, shape: Sequence[int], n: int) -> Optional[int]:
    """The JAX ZeRO-3 rule (sharding.py:105-116) for a port parameter: of
    2^16 elements or more, the largest dim of the JAX layout that divides
    by ``n`` (the first of equals), as the port's dim; else None."""
    shape = tuple(shape)
    numel = 1
    for s in shape:
        numel *= s
    if not shape or numel < 2**16:
        return None
    to_port = _jax_dims(name, len(shape))
    jax_shape = [shape[d] for d in to_port]
    for j in sorted(range(len(jax_shape)), key=lambda i: -jax_shape[i]):
        if jax_shape[j] % n == 0:
            return to_port[j]
    return None


# ---------------------------------------------------------------- the plan

def _pairs(unet: nn.Module, tp: int):
    """(module path, module, placements by local name, region parameters)
    of every Megatron pair of ``unet`` that divides by ``tp``."""
    from gligen_tpu_torch.models.layers import CrossAttention, FeedForward, SelfAttention
    from gligen_tpu_torch.models.unet import ResBlock

    col, row, summed = Placement(dim=0), Placement(dim=1), Placement(tp_sum=True)
    modules = dict(unet.named_modules())
    for path, m in modules.items():
        parent_path, _, attr = path.rpartition(".")
        parent = modules.get(parent_path)
        if isinstance(m, (SelfAttention, CrossAttention)):
            if m.heads % tp:  # whole heads a rank
                continue
            places = {"to_q.weight": col, "to_k.weight": col, "to_v.weight": col,
                      "to_out.weight": row, "to_out.bias": summed}
        elif isinstance(m, FeedForward):
            if m.net_2.weight.shape[1] % tp:
                continue
            half = Placement(dim=0, halves=True)
            places = {"net_0.proj.weight": half, "net_0.proj.bias": half,
                      "net_2.weight": row, "net_2.bias": summed}
        elif isinstance(m, ResBlock):
            if m.out_channels % tp or m.out_layers_0.num_groups % tp:
                continue
            places = {f"{layer}.{p}": col for layer in ("in_layers_2", "emb_layers_1",
                                                        "out_layers_0")
                      for p in ("weight", "bias")}
            places.update({"out_layers_3.weight": row, "out_layers_3.bias": summed})
            if m.skip_connection is not None:
                places.update({"skip_connection.weight": summed, "skip_connection.bias": summed})
            yield path, m, places, _expand_region(m, path, m.TP_REGION)
            continue
        else:
            continue
        region = getattr(parent, "TP_REGIONS", {}).get(attr, ())
        yield path, m, places, _expand_region(parent, parent_path, region)


def _expand_region(parent: Optional[nn.Module], parent_path: str,
                   attrs: Tuple[str, ...]) -> Tuple[str, ...]:
    """Full parameter names of the parent's attributes ``attrs`` (a
    parameter itself, or a module's parameters): the models'
    ``TP_REGIONS``/``TP_REGION``."""
    out = []
    for a in attrs:
        obj = getattr(parent, a)
        if isinstance(obj, nn.Parameter):
            out.append(f"{parent_path}.{a}")
        else:
            out += [f"{parent_path}.{a}.{n}" for n, _ in obj.named_parameters()]
    return tuple(out)


def tp_plan(unet: nn.Module, tp: int) -> Dict[str, Placement]:
    """{parameter name: placement} over every UNet parameter at ``tp``
    ranks, decided per Megatron pair (module docstring)."""
    plan = {name: REPLICATED for name, _ in unet.named_parameters()}
    if tp == 1:
        return plan
    for path, _, places, region in _pairs(unet, tp):
        for local, placement in places.items():
            plan[f"{path}.{local}"] = placement
        for name in region:
            plan[name] = Placement(tp_sum=True)
    return plan


def shard_tensor(t: torch.Tensor, placement: Placement, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the full tensor ``t`` (a copy)."""
    if placement.dim is None:
        return t.clone()
    if placement.halves:
        return torch.cat([h.chunk(n, placement.dim)[rank] for h in t.chunk(2, placement.dim)],
                         placement.dim).clone()
    return t.chunk(n, placement.dim)[rank].clone()


def gather_tensor(shards: Sequence[torch.Tensor], placement: Placement) -> torch.Tensor:
    """The full tensor from every rank's shard, in rank order (replicated:
    rank 0's)."""
    if placement.dim is None:
        return shards[0].clone()
    if placement.halves:
        halves = [s.chunk(2, placement.dim) for s in shards]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], placement.dim)
    return torch.cat(list(shards), placement.dim)


def shard_state_dict(full: Mapping[str, torch.Tensor], plan: Mapping[str, Placement],
                     rank: int, n: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s state dict of ``n`` TP ranks from the full one;
    names outside ``plan`` stay whole."""
    return {k: shard_tensor(v, plan.get(k, REPLICATED), rank, n) for k, v in full.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                      plan: Mapping[str, Placement]) -> Dict[str, torch.Tensor]:
    """The full state dict from every TP rank's, in rank order."""
    return {k: gather_tensor([s[k] for s in shards], plan.get(k, REPLICATED))
            for k in shards[0]}


def gradient_rule(placement: Placement, fsdp_dim: Optional[int] = None) -> str:
    """How a trainable parameter's gradient is reduced after the backward:
    "done" (an FSDP shard: reduce-scattered in the backward), "tp_sum" (a
    replicated tensor read inside a TP region, or applied on rank 0 only:
    summed over the TP group, then averaged over the DP group) or "dp"
    (averaged over the DP group)."""
    if fsdp_dim is not None:
        return "done"
    if placement.tp_sum:
        return "tp_sum"
    return "dp"


# ---------------------------------------------------------------- modules

def shard_unet_(unet: nn.Module, tp) -> Dict[str, Placement]:
    """Shard ``unet`` in place for the TP group ``tp``
    (``mesh.TensorParallel``): every divisible pair's parameters cut to
    this rank's shard, its attention and GroupNorm counts divided, its
    modules told their group.  Returns the plan, also kept as
    ``unet.tp_plan`` (the group as ``unet.tp``).  Load full weights before,
    or shards after (``shard_state_dict``, ``convert/from_jax.py``)."""
    if getattr(unet, "tp_plan", None) is not None:
        raise RuntimeError("shard_unet_: this UNet is already sharded")
    from gligen_tpu_torch.models.layers import FeedForward

    pairs = [m for _, m, _, _ in _pairs(unet, tp.size)]
    plan = tp_plan(unet, tp.size)
    params = dict(unet.named_parameters())
    with torch.no_grad():
        for name, placement in plan.items():
            if placement.dim is not None:
                params[name].data = shard_tensor(params[name].data, placement, tp.rank, tp.size)
    for m in pairs:
        m.tp = tp
        if isinstance(m, FeedForward):
            continue
        if hasattr(m, "heads"):
            m.heads //= tp.size
        else:  # ResBlock: GroupNorm 2 over this rank's channels
            m.out_layers_0.num_groups //= tp.size
    unet.tp_plan, unet.tp = plan, tp
    return plan
