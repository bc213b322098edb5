"""Spatially-aligned grounding tokenizers: hed, canny, depth, normal and
sem (counterpart of ``gligen_tpu/models/grounding/spatial.py``).

One NHWC body for the reference's five nets (hed_grounding_net.py:12-62;
canny, depth and normal the same but for the input's keyword;
sem_grounding_net.py:12-65 adds a 152 -> 3 channel ``in_conv``):

  map -> resize to ``resize_input`` (nearest) -> [in_conv] -> ConvNeXt-tiny
  -> (resize_input / 32)^2 tokens -> the learned null feature where the
  sample's ``mask`` is 0 -> + position embedding -> 3-layer SiLU MLP ->
  (B, T, out_dim).

The maps come in their compact host encodings (``prepare_spatial_map``):
uint8 pixels, uint8 class labels (sem), or floats.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.grounding.convnext import convnext_tiny
from gligen_tpu_torch.models.layers import Conv2d, Dense
from gligen_tpu_torch.ops.interpolate import resize_2d
from gligen_tpu_torch.utils.registry import GROUNDING_NETS

DOWN_FACTOR = 32  # ConvNeXt's stage-4 stride
FEATURE_DIM = 768  # ConvNeXt-tiny's stage-4 width


def _is_integer(x: torch.Tensor) -> bool:
    return not (x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool)


def prepare_spatial_map(x: torch.Tensor, size: int, mode: str, num_classes: int = 0
                        ) -> torch.Tensor:
    """A grounding map in its host encoding -> an fp32 NHWC map at
    ``size``^2 (spatial.py:29-61):

      * integer labels (B, H, W) or (B, H, W, 1) with ``num_classes``: the
        labels resized by torch's nearest taps (an index select, which
        commutes with the one-hot), then a one-hot over ``num_classes``; a
        label out of range gives a zero row, as ``jax.nn.one_hot`` does;
      * integer (uint8) pixels (B, H, W, C): x / 255 * 2 - 1 in fp32, then
        ``resize_2d`` in ``mode``;
      * floats: ``resize_2d`` in ``mode``, as they are."""
    if _is_integer(x) and num_classes:
        if x.dim() == 4:
            x = x[..., 0]
        _, h, w = x.shape
        # torch 'nearest' taps: src = floor(i * n_in / n_out)
        iy = torch.from_numpy(np.minimum(np.arange(size) * h // size, h - 1)).to(x.device)
        ix = torch.from_numpy(np.minimum(np.arange(size) * w // size, w - 1)).to(x.device)
        labels = x.index_select(1, iy).index_select(2, ix).long()
        classes = torch.arange(num_classes, device=x.device)
        return (labels[..., None] == classes).float()
    if _is_integer(x):
        x = x.float() / 255.0 * 2.0 - 1.0
    return resize_2d(x, (size, size), mode=mode)


class SpatialPositionNet(nn.Module):
    """The shared body; the modality aliases below fix the input's keyword.
    ``in_dim`` > 0 (sem: 152) reads a label map of that many classes
    through ``in_conv``."""

    def __init__(self, resize_input: int = 448, out_dim: int = 768, in_dim: int = 0,
                 dtype=torch.float32):
        super().__init__()
        if resize_input % DOWN_FACTOR:
            raise ValueError(f"resize_input {resize_input} is not a multiple of {DOWN_FACTOR}")
        self.resize_input = resize_input
        self.out_dim = out_dim
        self.in_dim = in_dim
        self.num_tokens = (resize_input // DOWN_FACTOR) ** 2
        if in_dim:
            self.in_conv = Conv2d(in_dim, 3, 3, dtype=dtype)
        self.convnext_tiny_backbone = convnext_tiny(dtype=dtype)
        self.null_feature = nn.Parameter(torch.zeros(FEATURE_DIM))
        self.pos_embedding = nn.Parameter(torch.zeros(1, self.num_tokens, FEATURE_DIM))
        self.linears_0 = Dense(FEATURE_DIM, 512, dtype=dtype)
        self.linears_2 = Dense(512, 512, dtype=dtype)
        self.linears_4 = Dense(512, out_dim, dtype=dtype)

    def _forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = prepare_spatial_map(x, self.resize_input, "nearest", num_classes=self.in_dim)
        if self.in_dim:
            x = self.in_conv(x)
        objs = self.convnext_tiny_backbone(x).reshape(b, self.num_tokens, FEATURE_DIM)
        m = mask.reshape(-1, 1, 1).float()
        objs = (objs * m + (1 - m) * self.null_feature + self.pos_embedding)
        objs = objs.to(self.linears_0.compute_dtype)
        h = F.silu(self.linears_0(objs))
        h = F.silu(self.linears_2(h))
        return self.linears_4(h)


class HedPositionNet(SpatialPositionNet):
    def forward(self, hed_edge: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._forward(hed_edge, mask)


class CannyPositionNet(SpatialPositionNet):
    def forward(self, canny_edge: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._forward(canny_edge, mask)


class DepthPositionNet(SpatialPositionNet):
    def forward(self, depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._forward(depth, mask)


class NormalPositionNet(SpatialPositionNet):
    def forward(self, normal: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._forward(normal, mask)


class SemPositionNet(SpatialPositionNet):
    def __init__(self, resize_input: int = 256, out_dim: int = 768, in_dim: int = 152,
                 dtype=torch.float32):
        super().__init__(resize_input=resize_input, out_dim=out_dim, in_dim=in_dim, dtype=dtype)

    def forward(self, sem: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._forward(sem, mask)


_PREFIX = "ldm.modules.diffusionmodules"
for _name, _net in (("hed", HedPositionNet), ("canny", CannyPositionNet),
                    ("depth", DepthPositionNet), ("normal", NormalPositionNet),
                    ("sem", SemPositionNet)):
    GROUNDING_NETS.register(_name, f"{_PREFIX}.{_name}_grounding_net.PositionNet")(_net)
