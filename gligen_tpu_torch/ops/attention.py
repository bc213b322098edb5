"""Attention entry point (counterpart of ``gligen_tpu/ops/attention.py``).

Every attention site of the UNet and the VAE calls
``multi_head_attention``.  On a CUDA tensor it always launches the flash
kernel (``ops/flash_attention.py``), at every site: self-attention, the
gated fuser, the 77-token cross-attention, the 64-token middle block and
the VAE's single 512-wide head.  On a CPU tensor it runs the kernel's
plain version.  Per-head scale ``dim_head ** -0.5``, softmax over keys in
fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from gligen_tpu_torch.ops.flash_attention import flash_attention_packed


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, N, H*C), k/v: (B, M, H*C), key_mask: optional (B, M) bool
    (True = attend).  Returns (B, N, H*C) in q's dtype."""
    return flash_attention_packed(q, k, v, heads, key_mask=key_mask)
