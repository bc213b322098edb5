"""Box+text grounding tokenizer (counterpart of
``gligen_tpu/models/grounding/text.py``).

Fourier-embeds xyxy boxes (8 freqs -> 64-d), substitutes the learned null
features for padded slots through the presence mask, and maps
[phrase embedding | box embedding] through a 3-layer SiLU MLP to
(B, N, out_dim) grounding tokens.  The CFG null batch is all zeros.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.layers import Dense
from gligen_tpu_torch.ops.basic import fourier_embed


class TextPositionNet(nn.Module):
    def __init__(self, in_dim: int = 768, out_dim: int = 768, fourier_freqs: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.fourier_freqs = fourier_freqs
        position_dim = fourier_freqs * 2 * 4  # sin&cos x xyxy
        self.null_positive_feature = nn.Parameter(torch.zeros(in_dim))
        self.null_position_feature = nn.Parameter(torch.zeros(position_dim))
        self.linears_0 = Dense(in_dim + position_dim, 512, dtype=dtype)
        self.linears_2 = Dense(512, 512, dtype=dtype)
        self.linears_4 = Dense(512, out_dim, dtype=dtype)

    def forward(self, boxes: torch.Tensor, masks: torch.Tensor,
                positive_embeddings: torch.Tensor) -> torch.Tensor:
        m = masks[..., None].float()
        xyxy = fourier_embed(boxes.float(), num_freqs=self.fourier_freqs)
        emb = positive_embeddings.float() * m + (1 - m) * self.null_positive_feature
        xyxy = xyxy * m + (1 - m) * self.null_position_feature
        h = F.silu(self.linears_0(torch.cat([emb, xyxy], dim=-1)))
        h = F.silu(self.linears_2(h))
        return self.linears_4(h)
