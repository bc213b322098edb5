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

Numerics are the TPU kernels': single-pass fp32 moments, the variance
clamped at 0, rsqrt(var + eps), one cast.  The GroupNorm plain version is
``basic.group_norm_rowsum``, the same function as the TPU kernel summed in
another order (gligen_tpu/ops/basic.py:116).

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other, and raises on what
the kernel does not take (a dtype other than bf16, widths that are not
multiples of 8, more than 4096 channels).  Each output is differentiable
(``launch.differentiable``): the backward differentiates the plain version,
fp32 statistics included, as pallas_norm.py:231-270 differentiates its
reference.
"""

from __future__ import annotations

import functools
import math

import torch

from gligen_tpu_torch.ops.basic import gn_affine_rowsum, group_norm_rowsum, layer_norm_xla
from gligen_tpu_torch.ops.launch import (
    F32, I32, PTR, Kernel, check, check_widths, differentiable, on_cuda,
)

MAX_CHANNELS = 4096  # the partial-sum block's (rows, 2, C) fp32 stays in 48 KB of shared memory
CHUNK_BLOCKS = 4 * 132  # partial-sum blocks to aim for over all samples: 4 per SM of an H100


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

    def _prepare(self, op, x, scale, bias, num_groups):
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
        check(op, x.device, x=(x, torch.bfloat16), scale=(scale, torch.float32),
              bias=(bias, torch.float32))
        chunks = max(1, min(n, -(-CHUNK_BLOCKS // b)))  # row chunks per sample
        ws = torch.empty((b, chunks, 2, c), dtype=torch.float32, device=x.device)
        a, v = (torch.empty((b, c), dtype=torch.float32, device=x.device) for _ in range(2))
        return (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), ws.data_ptr(), a.data_ptr(),
                v.data_ptr()), (b, n, c, num_groups, chunks), a, v


class GnAffine(_GroupStats):
    entry = "gn_affine_bf16"
    # x, scale, bias, ws, a, v, b, n, c, groups, chunks, eps
    argtypes = (PTR,) * 6 + (I32,) * 5 + (F32,)

    def __call__(self, x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
        """Same contract as ``gn_affine_plain``.  Differentiable."""
        kw = dict(num_groups=num_groups, eps=eps)
        return differentiable(functools.partial(self._forward, **kw),
                              functools.partial(gn_affine_plain, **kw),
                              x, scale.float(), bias.float())

    def _forward(self, x, scale, bias, num_groups, eps):
        if not on_cuda(x, "gn_affine"):
            return gn_affine_plain(x, scale, bias, num_groups, eps)
        ptrs, dims, a, v = self._prepare("gn_affine", x, scale, bias, num_groups)
        self._launch(x.device, *ptrs, *dims, eps)
        return a, v


class GroupNorm(_GroupStats):
    entry = "group_norm_bf16"
    # x, scale, bias, ws, a, v, y, b, n, c, groups, chunks, eps, silu
    argtypes = (PTR,) * 7 + (I32,) * 5 + (F32, I32)

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
        ptrs, dims, _, _ = self._prepare("group_norm", x, scale, bias, num_groups)
        y = torch.empty_like(x)
        self._launch(x.device, *ptrs, y.data_ptr(), *dims, eps, int(silu))
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
