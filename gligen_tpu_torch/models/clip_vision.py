"""CLIP ViT-L/14 vision tower and its projection (counterpart of
``gligen_tpu/models/clip_vision.py``): the image features of box+text+image
grounding (the reference's CLIPModel ``image_embeds``,
gligen_inference.py:104-116).

A 14x14 stride-14 patch conv without bias over 224^2 pixels (256 patches),
the class embedding, the position embedding, ``pre_layrnorm``, 24 pre-LN
layers (width 1024, 16 heads, quick-GELU), ``post_layernorm`` on the CLS
token and the bias-free 1024 -> 768 ``visual_projection``.  Names follow
HF's ``CLIPVisionModelWithProjection`` as the JAX tree does, so
``convert/from_reference.py:convert_clip_vision`` is a key map.  Like the
text tower, its attention and LayerNorms are plain torch (the JAX tower
uses the plain einsum attention and flax's LayerNorm).  Pixels are NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.clip_text import CLIPEncoderLayer, LayerNorm
from gligen_tpu_torch.models.layers import Dense
from gligen_tpu_torch.ops.interpolate import resize_2d

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8, or float in [0, 1] or [0, 255] -> normalised
    (B, size, size, 3) fp32: uint8 / 255, a float whose largest value is
    above 2 / 255 (decided on the device, no host synchronisation), a
    bicubic resize to size^2, then CLIP's mean and std."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    else:
        x = torch.where(x.max() > 2.0, x / 255.0, x)
    x = resize_2d(x, (size, size), mode="bicubic")
    mean, std = (torch.from_numpy(a).to(x.device) for a in (CLIP_MEAN, CLIP_STD))
    return (x - mean) / std


class PatchEmbedding(nn.Module):
    """A ``patch``x``patch`` stride-``patch`` VALID conv without bias over
    NHWC pixels -> (B, patches, hidden) in ``dtype``; the weight is OIHW."""

    def __init__(self, hidden: int, patch: int, dtype=torch.float32):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(hidden, 3, patch, patch))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(pixels.to(self.dtype).permute(0, 3, 1, 2), self.weight.to(self.dtype),
                     stride=self.patch)
        return y.flatten(2).transpose(1, 2)


class CLIPVisionLayer(CLIPEncoderLayer):
    """The text tower's pre-LN layer with no attention mask."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x, 0.0)


class CLIPVisionModel(nn.Module):
    """forward(pixels, output_hidden_states=False) -> (image_embeds (B,
    projection_dim), pooled (B, hidden)); with ``output_hidden_states``
    also each layer's patch tokens as a (B, P, P, hidden) grid."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, hidden_size: int = 1024,
                 layers: int = 24, heads: int = 16, projection_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = layers
        self.grid = image_size // patch_size
        n_positions = self.grid**2 + 1
        self.patch_embedding = PatchEmbedding(hidden_size, patch_size, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(hidden_size))
        self.position_embedding = nn.Embedding(n_positions, hidden_size)
        self.pre_layrnorm = LayerNorm(hidden_size)
        for i in range(layers):
            self.add_module(f"layers_{i}", CLIPVisionLayer(hidden_size, heads, dtype=dtype))
        self.post_layernorm = LayerNorm(hidden_size)
        self.visual_projection = Dense(hidden_size, projection_dim, bias=False, dtype=dtype)

    def forward(self, pixels: torch.Tensor, output_hidden_states: bool = False):
        patches = self.patch_embedding(pixels)
        b, _, c = patches.shape
        cls = self.class_embedding.to(self.dtype).expand(b, 1, c)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding.weight.to(self.dtype)
        x = self.pre_layrnorm(x)
        hidden_states = []
        for i in range(self.layers):
            x = getattr(self, f"layers_{i}")(x)
            if output_hidden_states:
                hidden_states.append(x[:, 1:].reshape(b, self.grid, self.grid, c))
        pooled = self.post_layernorm(x[:, 0])
        image_embeds = self.visual_projection(pooled)
        if output_hidden_states:
            return image_embeds, pooled, hidden_states
        return image_embeds, pooled
