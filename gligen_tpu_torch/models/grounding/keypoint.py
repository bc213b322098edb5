"""Keypoint grounding tokenizer (counterpart of
``gligen_tpu/models/grounding/keypoint.py``).

Learned person (P) x keypoint (17) identity embeddings and Fourier xy
position features -> one 3-layer SiLU MLP -> B x (P*17) x out_dim
grounding tokens (136 at P = 8).  An invisible keypoint (mask 0, point
(0, 0)) takes the null person and null xy features.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.layers import Dense
from gligen_tpu_torch.ops.basic import fourier_embed
from gligen_tpu_torch.utils.registry import GROUNDING_NETS

KEYPOINTS = 17  # COCO's person keypoints


class KeypointPositionNet(nn.Module):
    def __init__(self, max_persons_per_image: int = 8, out_dim: int = 768,
                 fourier_freqs: int = 8, dtype=torch.float32):
        super().__init__()
        self.out_dim = out_dim
        self.persons = max_persons_per_image
        self.fourier_freqs = fourier_freqs
        position_dim = fourier_freqs * 2 * 2  # sin&cos x xy
        self.person_embeddings = nn.Parameter(torch.zeros(max_persons_per_image, out_dim))
        self.keypoint_embeddings = nn.Parameter(torch.zeros(KEYPOINTS, out_dim))
        self.null_person_feature = nn.Parameter(torch.zeros(out_dim))
        self.null_xy_feature = nn.Parameter(torch.zeros(position_dim))
        self.linears_0 = Dense(out_dim + position_dim, 512, dtype=dtype)
        self.linears_2 = Dense(512, 512, dtype=dtype)
        self.linears_4 = Dense(512, out_dim, dtype=dtype)

    def forward(self, points: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        # person i repeated over its 17 keypoints, plus each keypoint's identity
        ident = (self.person_embeddings.repeat_interleave(KEYPOINTS, dim=0)
                 + self.keypoint_embeddings.repeat(self.persons, 1))
        m = masks[..., None].float()
        xy = fourier_embed(points.float(), num_freqs=self.fourier_freqs)
        ident = ident * m + (1 - m) * self.null_person_feature
        xy = xy * m + (1 - m) * self.null_xy_feature
        h = F.silu(self.linears_0(torch.cat([ident, xy], dim=-1)))
        h = F.silu(self.linears_2(h))
        return self.linears_4(h)


GROUNDING_NETS.register(
    "keypoint", "ldm.modules.diffusionmodules.keypoint_grounding_net.PositionNet"
)(KeypointPositionNet)
