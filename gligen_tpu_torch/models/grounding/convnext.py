"""ConvNeXt-tiny backbone of the spatial grounding tokenizers (counterpart
of ``gligen_tpu/models/grounding/convnext.py``).

The reference's trimmed ConvNeXt (convnext.py:15-118), NHWC throughout: a
4x4/4 VALID stem conv and a LayerNorm, then three LayerNorm + 2x2/2 VALID
transitions, each stage a run of blocks (depthwise 7x7 conv -> LayerNorm
-> 4x MLP with the exact GELU -> ``gamma`` layer scale, + the block's
input).  No head and no final norm; ``forward`` returns the stage-4 map
(B, H/32, W/32, 768).  Every LayerNorm has eps 1e-6 and goes through
``ops/basic.py:layer_norm``, so under GLIGEN_TPU_FUSED_NORM 'ln' or 'both'
a CUDA tensor takes the LayerNorm kernel, as the JAX package sends it to
its Pallas kernel.

Module names are the JAX parameter paths (``downsample_layers_0_0``,
``stages_2_8.pwconv1``...), so ``convert/from_jax.py`` and
``convert/from_reference.py`` map the weights mechanically; the depthwise
conv's HWIO (7, 7, 1, C) kernel is the OIHW (C, 1, 7, 7) weight.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.layers import Conv2d, Dense, LayerNorm

LN_EPS = 1e-6
LAYER_SCALE_INIT = 1e-6


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = Dense(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Dense(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + self.gamma.to(h.dtype) * h


class ConvNeXt(nn.Module):
    """Over an RGB (3-channel) map."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), dtype=torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.add_module("downsample_layers_0_0",
                        Conv2d(3, dims[0], 4, stride=4, padding=0, dtype=dtype))
        self.add_module("downsample_layers_0_1", LayerNorm(dims[0], eps=LN_EPS))
        for i in range(1, 4):
            self.add_module(f"downsample_layers_{i}_0", LayerNorm(dims[i - 1], eps=LN_EPS))
            self.add_module(f"downsample_layers_{i}_1",
                            Conv2d(dims[i - 1], dims[i], 2, stride=2, padding=0, dtype=dtype))
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                self.add_module(f"stages_{i}_{j}", ConvNeXtBlock(dims[i], dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H/32, W/32, dims[-1])."""
        for i, depth in enumerate(self.depths):
            # level 0: the stem conv, then its norm; later: a norm, then the conv
            x = getattr(self, f"downsample_layers_{i}_0")(x)
            x = getattr(self, f"downsample_layers_{i}_1")(x)
            for j in range(depth):
                x = getattr(self, f"stages_{i}_{j}")(x)
        return x


def convnext_tiny(dtype=torch.float32) -> ConvNeXt:
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), dtype=dtype)
