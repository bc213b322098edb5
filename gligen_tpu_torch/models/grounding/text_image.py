"""Box+text+image grounding tokenizer (counterpart of
``gligen_tpu/models/grounding/text_image.py``).

Two 3-layer SiLU MLPs over [feature | Fourier xyxy]: one over CLIP text
features, one over reprojected CLIP image features.  Their tokens are
concatenated on the token axis, B x 2N x out_dim (60 at N = 30).  Three
learned null features stand in for a dropped or padded text, image and
box slot, through the box, text and image masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.layers import Dense
from gligen_tpu_torch.ops.basic import fourier_embed
from gligen_tpu_torch.utils.registry import GROUNDING_NETS


class TextImagePositionNet(nn.Module):
    def __init__(self, in_dim: int = 768, out_dim: int = 768, fourier_freqs: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.out_dim = out_dim
        self.fourier_freqs = fourier_freqs
        position_dim = fourier_freqs * 2 * 4  # sin&cos x xyxy
        self.null_text_feature = nn.Parameter(torch.zeros(in_dim))
        self.null_image_feature = nn.Parameter(torch.zeros(in_dim))
        self.null_position_feature = nn.Parameter(torch.zeros(position_dim))
        for prefix in ("linears_text", "linears_image"):
            self.add_module(f"{prefix}_0", Dense(in_dim + position_dim, 512, dtype=dtype))
            self.add_module(f"{prefix}_2", Dense(512, 512, dtype=dtype))
            self.add_module(f"{prefix}_4", Dense(512, out_dim, dtype=dtype))

    def _mlp(self, prefix: str, h: torch.Tensor) -> torch.Tensor:
        h = F.silu(getattr(self, f"{prefix}_0")(h))
        h = F.silu(getattr(self, f"{prefix}_2")(h))
        return getattr(self, f"{prefix}_4")(h)

    def forward(self, boxes: torch.Tensor, masks: torch.Tensor, text_masks: torch.Tensor,
                image_masks: torch.Tensor, text_embeddings: torch.Tensor,
                image_embeddings: torch.Tensor) -> torch.Tensor:
        m, tm, im = (t[..., None].float() for t in (masks, text_masks, image_masks))
        xyxy = fourier_embed(boxes.float(), num_freqs=self.fourier_freqs)
        xyxy = xyxy * m + (1 - m) * self.null_position_feature
        text = text_embeddings.float() * tm + (1 - tm) * self.null_text_feature
        image = image_embeddings.float() * im + (1 - im) * self.null_image_feature
        objs_text = self._mlp("linears_text", torch.cat([text, xyxy], dim=-1))
        objs_image = self._mlp("linears_image", torch.cat([image, xyxy], dim=-1))
        return torch.cat([objs_text, objs_image], dim=1)


GROUNDING_NETS.register(
    "text_image", "ldm.modules.diffusionmodules.text_image_grounding_net.PositionNet"
)(TextImagePositionNet)
