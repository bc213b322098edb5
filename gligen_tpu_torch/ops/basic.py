"""Core numeric primitives (counterpart of ``gligen_tpu/ops/basic.py``).

Pure functions over tensors.  Norm statistics run in fp32 whatever the
input dtype, and the result is cast back (the reference's GroupNorm32
semantics).
"""

from __future__ import annotations

import math
from typing import Optional

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


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of an NHWC / (B, ..., C)
    tensor, with single-pass fp32 moments (mean and mean of squares).
    ``act='silu'`` applies the SiLU that follows every ResBlock norm, in
    fp32, before the cast back to the input dtype."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.float()
    grouped = xf.reshape(x.shape[0], -1, num_groups, c // num_groups)
    mean = grouped.mean(dim=(1, 3), keepdim=True)
    mean_sq = (grouped * grouped).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = normed * weight.float() + bias.float()
    if act == "silu":
        out = F.silu(out)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with single-pass fp32 moments."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean_sq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)
