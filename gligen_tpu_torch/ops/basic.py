"""Core numeric primitives (counterpart of ``gligen_tpu/ops/basic.py``).

Pure functions over tensors.  Norm statistics run in fp32 whatever the
input dtype, and the result is cast back (the reference's GroupNorm32
semantics).  ``group_norm`` and ``layer_norm`` dispatch, by
GLIGEN_TPU_FUSED_NORM and the tensor's device, to the kernels of
``ops/fused_norm.py`` or to the plain ``*_xla`` forms.
"""

from __future__ import annotations

import math
import os
import threading
from contextlib import contextmanager
from typing import Iterator, Optional

import torch
import torch.nn.functional as F


def fourier_embed(x: torch.Tensor, num_freqs: int = 8, temperature: float = 100.0) -> torch.Tensor:
    """Per-frequency sin/cos embedding: for each frequency in order, the
    full sin block then the full cos block.  (..., D) -> (..., F*2*D)."""
    freqs = temperature ** (
        torch.arange(num_freqs, dtype=torch.float32, device=x.device) / num_freqs
    )
    ang = x[..., None, :].float() * freqs[:, None]
    emb = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)
    return emb.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1]).to(x.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, cos then sin, zero-padded for odd
    ``dim``.  (B,) -> (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _fused_norm_mode() -> str:
    """Which norms take the fused kernels (ops/fused_norm.py), read at call
    time from GLIGEN_TPU_FUSED_NORM as gligen_tpu/ops/basic.py:21-36 reads
    it: 'gn' (the default), 'ln', 'both' ('1' means 'both'); anything else,
    '0' included, is 'none'.  Where the JAX package asks whether the backend
    is a TPU, the dispatchers below ask whether the tensor is on CUDA."""
    mode = os.environ.get("GLIGEN_TPU_FUSED_NORM", "gn")
    if mode == "1":
        mode = "both"
    return mode if mode in ("both", "ln", "gn") else "none"


def _on_card(x: torch.Tensor) -> bool:
    """Whether x lies on a CUDA card: the dispatchers' counterpart of the
    JAX package's "is the backend a TPU"."""
    return x.is_cuda


def _groups(x: torch.Tensor, num_groups: int) -> int:
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    return c // num_groups


def group_norm_xla(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of an NHWC / (B, ..., C)
    tensor, with single-pass fp32 moments (mean and mean of squares) over
    each (sample, group), cast back to x's dtype (basic.py:75-99)."""
    cpg = _groups(x, num_groups)
    grouped = x.float().reshape(x.shape[0], -1, num_groups, cpg)
    mean = grouped.mean(dim=(1, 3), keepdim=True)
    mean_sq = (grouped * grouped).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def group_norm_rowsum(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """The same GroupNorm summed in another order (basic.py:102-155):
    per-channel sums of x and x^2 over the spatial axes, a per-group
    combine on (B, C), folded into y = x * a + v; ``act='silu'`` applies
    the SiLU in fp32 before the one cast.  The GroupNorm kernel's plain
    version."""
    a, v = gn_affine_rowsum(x, weight, bias, num_groups, eps)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    y = x.float() * a.reshape(shape) + v.reshape(shape)
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def gn_affine_rowsum(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int = 32,
    eps: float = 1e-5,
):
    """(a, v), both (B, C) fp32, with GroupNorm(x) * weight + bias == x * a
    + v: group_norm_rowsum's statistics (gligen_tpu/ops/pallas_conv.py:47)."""
    b, c = x.shape[0], x.shape[-1]
    cpg = _groups(x, num_groups)
    n = math.prod(x.shape[1:-1]) * cpg
    xf = x.float().reshape(b, -1, c)
    s, s2 = xf.sum(dim=1), (xf * xf).sum(dim=1)
    mean = s.reshape(b, num_groups, cpg).sum(-1) / n
    var = torch.clamp(s2.reshape(b, num_groups, cpg).sum(-1) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(cpg, dim=1) * weight.float()[None, :]
    v = bias.float()[None, :] - mean.repeat_interleave(cpg, dim=1) * a
    return a, v


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over the channel (last) axis, fp32 statistics, cast back;
    ``act='silu'`` folds the SiLU that follows every ResBlock norm
    (basic.py:158-183).  A CUDA tensor under GLIGEN_TPU_FUSED_NORM 'gn' or
    'both' takes the GroupNorm kernel, whose plain version is
    ``group_norm_rowsum``; otherwise ``group_norm_xla``, then the SiLU."""
    if _on_card(x) and _fused_norm_mode() in ("both", "gn"):
        from gligen_tpu_torch.ops.fused_norm import group_norm_fused

        return group_norm_fused(x, weight, bias, num_groups, eps, silu=act == "silu")
    y = group_norm_xla(x, weight, bias, num_groups=num_groups, eps=eps)
    return F.silu(y) if act == "silu" else y


def layer_norm_xla(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with single-pass fp32 moments
    (basic.py:186-195)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean_sq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (basic.py:198-206): a CUDA tensor under
    GLIGEN_TPU_FUSED_NORM 'ln' or 'both' takes the LayerNorm kernel,
    anything else ``layer_norm_xla``."""
    if _on_card(x) and _fused_norm_mode() in ("both", "ln"):
        from gligen_tpu_torch.ops.fused_norm import layer_norm_fused

        return layer_norm_fused(x, weight, bias, eps)
    return layer_norm_xla(x, weight, bias, eps=eps)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


# the blocks of tf32_off open in any thread, and the switches they saved
_TF32_LOCK = threading.Lock()
_TF32_OPEN = {"depth": 0, "saved": None}


@contextmanager
def tf32_off() -> Iterator[None]:
    """Both TF32 switches off inside the block, cuBLAS's matmuls and cuDNN's
    convs, each restored afterwards.  Saved and set by hand:
    ``torch.backends.cudnn.flags`` would also reset cuDNN's other switches
    to its own defaults, and the matmul switch has no context manager in
    every torch version.  The switches are process-wide, so blocks open in
    several threads at once (a mesh's cards) share one save: the first to
    open saves and clears them, the last to close restores them."""
    with _TF32_LOCK:
        if _TF32_OPEN["depth"] == 0:
            _TF32_OPEN["saved"] = (torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _TF32_OPEN["depth"] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_OPEN["depth"] -= 1
            if _TF32_OPEN["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _TF32_OPEN["saved"]
