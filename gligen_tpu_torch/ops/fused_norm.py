"""GroupNorm (+SiLU) and LayerNorm kernels: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``gligen_tpu/ops/pallas_norm.py``.  ``csrc/fused_norm.cu``
holds three entry points:

  * ``group_norm_fused``: GroupNorm(x) * scale + bias (then SiLU) over the
    channel-last axis of (B, ..., C), the kernel of every GroupNorm under
    ``GLIGEN_TPU_FUSED_NORM=gn`` (the default) or ``both``;
  * ``gn_affine``: its statistics alone, folded into the (B, C) fp32
    affine a, v with GroupNorm(x) * scale + bias == x * a + v, which the
    fused conv (ops/fused_conv.py) applies in its operand loader;
  * ``layer_norm_fused``: row LayerNorm, under ``ln`` or ``both``.

A GroupNorm of a UNet map runs as one launch, a thread-block cluster per
sample; the VAE's large maps as three launches (``gn_plan``: the route and
the row chunks, passed to the C entry).  ``group_norm_fused`` also takes
fp32 x (the inpaint image's fp32 VAE encode): its own entry,
``group_norm_f32``, fp32 in and out on the three-launch route.

Numerics are the TPU kernels': single-pass fp32 moments, the variance
clamped at 0, rsqrt(var + eps), one cast.  The GroupNorm plain version is
``basic.group_norm_rowsum``, the same function as the TPU kernel summed in
another order (gligen_tpu/ops/basic.py:116).

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other, and raises on what
the kernel does not take (a dtype other than bf16, or fp32 for the
GroupNorm; widths that are not multiples of 8, more than 4096 channels).  Each output is differentiable
(``launch.differentiable``): the backward differentiates the plain version,
fp32 statistics included, as pallas_norm.py:231-270 differentiates its
reference.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from gligen_tpu_torch.ops.basic import gn_affine_rowsum, group_norm_rowsum, layer_norm_xla
from gligen_tpu_torch.ops.launch import (
    F32, I32, PTR, Kernel, check, check_widths, differentiable, on_cuda,
)

MAX_CHANNELS = 4096  # the partial-sum block's (rows, 2, C) fp32 stays in 48 KB of shared memory
SMS = 132  # the H100 SXM's streaming multiprocessors
CHUNK_BLOCKS = 4 * SMS  # three-launch route: partial-sum blocks over all samples, 4 per SM
MAX_CLUSTER = 16  # one-launch route: blocks a sample, one cluster (csrc kMaxCluster)
# One launch for inputs up to this many bytes: they stay in the 50 MB L2
# between the statistics pass and the normalising one (every UNet map, at
# most 31.5 MB at 4 rows) ...
ONE_LAUNCH_BYTES = 32 * 2**20
# ... and where the samples' clusters put at least this many blocks (one an
# SM) to work: a cluster streams one sample, so 2 samples (the VAE's batch)
# would leave three quarters of the card idle, which the three-launch route
# spreads them over.
ONE_LAUNCH_BLOCKS = 64
# One-launch route: a block per this many bytes of a sample (one slot of its
# ring), up to a cluster.
BLOCK_BYTES = 32 * 2**10


def fused_smem(c: int, groups: int) -> int:
    """Dynamic shared memory of the one-launch kernel (csrc/fused_norm.cu:
    launch_fused): the 128 KB ring, the (RB, 2, C) fp32 partials of its
    1024 threads (RB = 1024 / (C / 8) rows side by side) or the (2, groups)
    statistics, and the block's (2, groups) group sums."""
    return 4 * 32768 + 4 * (max(1024 // (c // 8) * 2 * c, 2 * groups) + 2 * groups)


def gn_plan(b: int, n: int, c: int, groups: int = 32,
            normalise: bool = True) -> Tuple[str, int]:
    """(route, row chunks per sample) of a GroupNorm of x (B, N, C) bf16
    (``normalise``) or of its statistics alone (``gn_affine``): "one" (one
    launch, a cluster of up to MAX_CLUSTER blocks per sample) for inputs up
    to ONE_LAUNCH_BYTES of at least ONE_LAUNCH_BLOCKS / MAX_CLUSTER samples,
    whose block fits the H100's shared memory; else "three" (partials,
    combine, normalise).  The statistics alone, one read of x, go to the
    partials and the combine for the UNet's narrow maps of over 2 MB a
    sample (C < 1280): there the partials spread the read over every SM, and
    the cluster's 64 SMs were slower on the H100 (PERF.md)."""
    one = (2 * b * n * c <= ONE_LAUNCH_BYTES and b * MAX_CLUSTER >= ONE_LAUNCH_BLOCKS
           and fused_smem(c, groups) <= 232448)
    if one and (normalise or c >= 1280 or 2 * n * c <= 2 * 2**20):
        return "one", max(1, min(n, MAX_CLUSTER, -(-2 * n * c // BLOCK_BYTES)))
    return "three", max(1, min(n, -(-CHUNK_BLOCKS // b)))


def cuda_launches(route: str, normalise: bool) -> int:
    """CUDA launches of one call: 1 on the one-launch route; else the
    partials and the combine, and the normalising pass."""
    return 1 if route == "one" else 2 + normalise


def group_norm_plain(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                     silu: bool = False) -> torch.Tensor:
    """x: (B, ..., C); scale/bias: (C,).  Returns GroupNorm(x) * scale +
    bias, then SiLU when ``silu``, in x's dtype (pallas_norm.py:62-92)."""
    return group_norm_rowsum(x, scale, bias, num_groups, eps, "silu" if silu else None)


# (a, v), both (B, C) fp32 (pallas_conv.py:47-76)
gn_affine_plain = gn_affine_rowsum
# row LayerNorm over the last axis, in x's dtype (pallas_norm.py:155-162)
layer_norm_plain = layer_norm_xla


class _GroupStats(Kernel):
    """What the two GroupNorm entry points share: the checks, the scratch
    for the partial sums and the (B, C) affine."""

    library = "fused_norm"

    def _prepare(self, op, x, scale, bias, num_groups, normalise, dtype=torch.bfloat16):
        if x.dim() < 2:
            raise ValueError(f"{op}: x must be (B, ..., C), got {tuple(x.shape)}")
        b, c = x.shape[0], x.shape[-1]
        n = math.prod(x.shape[1:-1])
        if c % num_groups or c > MAX_CHANNELS or scale.shape != (c,) or bias.shape != (c,):
            raise ValueError(f"{op}: {c} channels in {num_groups} groups (at most {MAX_CHANNELS}) "
                             f"with ({c},) scale and bias")
        if n < 1 or n * c >= 2**31:
            raise ValueError(f"{op}: {n} rows of {c} channels per sample: 1 to 2^31 elements")
        check_widths(op, C=c)
        check(op, x.device, x=(x, dtype), scale=(scale, torch.float32),
              bias=(bias, torch.float32))
        route, chunks = gn_plan(b, n, c, num_groups, normalise)
        if dtype == torch.float32:  # group_norm_f32: the three launches only
            route, chunks = "three", max(1, min(n, -(-CHUNK_BLOCKS // b)))
        ws = (None if route == "one" else
              torch.empty((b, chunks, 2, c), dtype=torch.float32, device=x.device))
        a, v = (torch.empty((b, c), dtype=torch.float32, device=x.device) for _ in range(2))
        return (x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                None if ws is None else ws.data_ptr(), a.data_ptr(),
                v.data_ptr()), (b, n, c, num_groups, chunks), a, v, route


class GnAffine(_GroupStats):
    entry = "gn_affine_bf16"
    # x, scale, bias, ws, a, v, b, n, c, groups, chunks, eps, one_launch
    argtypes = (PTR,) * 6 + (I32,) * 5 + (F32, I32)

    def __call__(self, x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
        """Same contract as ``gn_affine_plain``.  Differentiable."""
        kw = dict(num_groups=num_groups, eps=eps)
        return differentiable(functools.partial(self._forward, **kw),
                              functools.partial(gn_affine_plain, **kw),
                              x, scale.float(), bias.float())

    def _forward(self, x, scale, bias, num_groups, eps):
        if not on_cuda(x, "gn_affine"):
            return gn_affine_plain(x, scale, bias, num_groups, eps)
        ptrs, dims, a, v, route = self._prepare("gn_affine", x, scale, bias, num_groups, False)
        self._launch(x.device, *ptrs, *dims, eps, int(route == "one"))
        return a, v


class GroupNorm(_GroupStats):
    """``routes`` counts the launches by route: "one" and "three" (bf16,
    ``gn_plan``'s) and "fp32" (``group_norm_f32``, three launches)."""

    entry = "group_norm_bf16"
    # x, scale, bias, ws, a, v, y, b, n, c, groups, chunks, eps, silu, one_launch
    argtypes = (PTR,) * 7 + (I32,) * 5 + (F32, I32, I32)
    # the same, without one_launch
    f32_argtypes = (PTR,) * 7 + (I32,) * 5 + (F32, I32)

    def __init__(self):
        super().__init__()
        self.routes = {"one": 0, "three": 0, "fp32": 0}

    def __call__(self, x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False) -> torch.Tensor:
        """Same contract as ``group_norm_plain``.  Differentiable."""
        kw = dict(num_groups=num_groups, eps=eps, silu=silu)
        return differentiable(functools.partial(self._forward, **kw),
                              functools.partial(group_norm_plain, **kw),
                              x, scale.float(), bias.float())

    def _forward(self, x, scale, bias, num_groups, eps, silu):
        if not on_cuda(x, "group_norm"):
            return group_norm_plain(x, scale, bias, num_groups, eps, silu)
        f32 = x.dtype == torch.float32
        ptrs, dims, _, _, route = self._prepare("group_norm", x, scale, bias, num_groups, True,
                                                x.dtype if f32 else torch.bfloat16)
        y = torch.empty_like(x)
        if f32:
            self._launch(x.device, *ptrs, y.data_ptr(), *dims, eps, int(silu),
                         entry=("group_norm_f32", self.f32_argtypes))
        else:
            self._launch(x.device, *ptrs, y.data_ptr(), *dims, eps, int(silu),
                         int(route == "one"))
        self.routes["fp32" if f32 else route] += 1
        return y


class LayerNorm(Kernel):
    library, entry = "fused_norm", "layer_norm_bf16"
    # x, scale, bias, y, rows, c, eps
    argtypes = (PTR,) * 4 + (I32, I32, F32)

    def __call__(self, x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
        """Same contract as ``layer_norm_plain``; any number of rows.
        Differentiable."""
        return differentiable(functools.partial(self._forward, eps=eps),
                              functools.partial(layer_norm_plain, eps=eps),
                              x, scale.float(), bias.float())

    def _forward(self, x, scale, bias, eps):
        if not on_cuda(x, "layer_norm"):
            return layer_norm_plain(x, scale, bias, eps=eps)
        c = x.shape[-1]
        if scale.shape != (c,) or bias.shape != (c,) or x.numel() == 0:
            raise ValueError(f"layer_norm: x {tuple(x.shape)} needs ({c},) scale and bias")
        check_widths("layer_norm", C=c)
        check("layer_norm", x.device, x=(x, torch.bfloat16), scale=(scale, torch.float32),
              bias=(bias, torch.float32))
        y = torch.empty_like(x)
        self._launch(x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                     x.numel() // c, c, eps)
        return y


group_norm_fused = GroupNorm()
gn_affine = GnAffine()
layer_norm_fused = LayerNorm()
KERNELS = {"group_norm": group_norm_fused, "gn_affine": gn_affine, "layer_norm": layer_norm_fused}
