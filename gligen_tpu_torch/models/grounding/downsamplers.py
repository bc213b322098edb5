"""Grounding downsamplers: the extra channels of the UNet's first conv, from
a spatial map (counterpart of ``gligen_tpu/models/grounding/downsamplers.py``).

NHWC rebuilds of the reference's five GroundingDownsamplers:
  hed    - no parameters: channel 0, bicubic to 64^2, 1 channel
           (hed_grounding_downsampler.py:9-21);
  canny  - channel 0, bicubic to 256^2, Conv(1 -> 4, 4x4/2, pad 1), SiLU,
           Conv(4 -> 8, 4x4/2, pad 1) (canny :9-29);
  depth  - the same (depth :9-30);
  normal - the same over all 3 channels (normal :9-27);
  sem    - the 152-class one-hot at 256^2 by nearest, Conv(152 -> 16), SiLU,
           Conv(16 -> 8) (sem :9-27).
hed, canny and depth take a grayscale map replicated to RGB and read its
channel 0 (the reference's ``grounding_extra_input[:, 0]``).  The convs are
cuDNN's: the JAX package computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.grounding.spatial import prepare_spatial_map
from gligen_tpu_torch.models.layers import Conv2d
from gligen_tpu_torch.utils.registry import DOWNSAMPLERS


class HedDownsampler(nn.Module):
    def __init__(self, out_dim: int = 1, dtype=torch.float32):
        super().__init__()
        self.out_dim = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prepare_spatial_map(x[..., :1], 64, "bicubic")


class _ConvStackDownsampler(nn.Module):
    """``in_channels``: 1 reads channel 0 of the map, 3 all of them.  A
    ``one_hot`` downsampler (sem) reads a label map as its one-hot over
    ``in_dim`` classes; the others take ``in_dim`` as the config's keyword
    and do not read it."""

    in_channels = 1
    one_hot = False
    resize_mode = "bicubic"
    hidden = 4

    def __init__(self, resize_input: int = 256, out_dim: int = 8, in_dim: int = 152,
                 dtype=torch.float32):
        super().__init__()
        self.resize_input = resize_input
        self.out_dim = out_dim
        self.in_dim = in_dim
        width = in_dim if self.one_hot else self.in_channels
        self.layers_0 = Conv2d(width, self.hidden, 4, stride=2, padding=1, dtype=dtype)
        self.layers_2 = Conv2d(self.hidden, out_dim, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.one_hot:
            x = prepare_spatial_map(x, self.resize_input, self.resize_mode,
                                    num_classes=self.in_dim)
        else:
            x = prepare_spatial_map(x[..., :self.in_channels], self.resize_input,
                                    self.resize_mode)
        return self.layers_2(F.silu(self.layers_0(x)))


class CannyDownsampler(_ConvStackDownsampler):
    pass


class DepthDownsampler(_ConvStackDownsampler):
    pass


class NormalDownsampler(_ConvStackDownsampler):
    in_channels = 3


class SemDownsampler(_ConvStackDownsampler):
    one_hot = True
    resize_mode = "nearest"
    hidden = 16


_PREFIX = "ldm.modules.diffusionmodules"
for _name, _net in (("hed", HedDownsampler), ("canny", CannyDownsampler),
                    ("depth", DepthDownsampler), ("normal", NormalDownsampler),
                    ("sem", SemDownsampler)):
    DOWNSAMPLERS.register(_name, f"{_PREFIX}.{_name}_grounding_downsampler.GroundingDownsampler")(
        _net)
