"""Frozen CLIP ViT-L/14 text encoder (counterpart of
``gligen_tpu/models/clip_text.py``): 12 pre-LN causal transformer layers,
d=768, 12 heads, quick-GELU MLPs, 77-token context, final LayerNorm.

Its attention is plain torch, as it is a plain einsum in the JAX package:
77 tokens, run twice per request.
"""

from __future__ import annotations

import torch
from torch import nn

from gligen_tpu_torch.models.layers import Dense, LayerNorm as _LayerNorm
from gligen_tpu_torch.ops.basic import layer_norm_xla


class LayerNorm(_LayerNorm):
    """CLIP's LayerNorm stays plain whatever GLIGEN_TPU_FUSED_NORM says:
    the JAX CLIP uses flax's nn.LayerNorm (clip_text.py:53), not the
    dispatching one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_xla(x, self.weight, self.bias, eps=self.eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 12, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(dim, dim, dtype=dtype)
        self.k_proj = Dense(dim, dim, dtype=dtype)
        self.v_proj = Dense(dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        head_dim = d // self.heads
        split = lambda t: t.reshape(b, n, self.heads, head_dim).float()
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        sim = torch.einsum("bnhc,bmhc->bhnm", q, k) * head_dim**-0.5 + causal_mask
        attn = torch.softmax(sim, dim=-1).to(x.dtype).float()
        out = torch.einsum("bhnm,bmhc->bnhc", attn, v)
        return self.out_proj(out.reshape(b, n, d).to(x.dtype))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 12, dtype=torch.float32):
        super().__init__()
        self.layer_norm1 = LayerNorm(dim)
        self.self_attn = CLIPAttention(dim, heads, dtype=dtype)
        self.layer_norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, 4 * dim, dtype=dtype)
        self.mlp_fc2 = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp_fc2(quick_gelu(self.mlp_fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, vocab_size: int = 49408, hidden_size: int = 768, layers: int = 12,
                 heads: int = 12, max_positions: int = 77, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, hidden_size)
        self.position_embedding = nn.Embedding(max_positions, hidden_size)
        for i in range(layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(hidden_size, heads, dtype=dtype))
        self.final_layer_norm = LayerNorm(hidden_size)

    def forward(self, input_ids: torch.Tensor):
        """(B, N) token ids -> (last, penultimate, pooled): the
        last_hidden_state after the final LayerNorm (B, N, hidden); the
        hidden states before the last layer (the dataset's "before" layer
        select); and ``last`` at each row's end-of-text token, the
        argmax of its ids (CLIP's pooler output, the text feature of
        box+text+image grounding)."""
        b, n = input_ids.shape
        pos = torch.arange(n, device=input_ids.device)
        x = (self.token_embedding(input_ids) + self.position_embedding(pos)[None]).to(self.dtype)
        neg = torch.finfo(torch.float32).min
        causal = torch.triu(
            torch.full((n, n), neg, dtype=torch.float32, device=input_ids.device), diagonal=1
        )
        penultimate = None
        for i in range(self.layers):
            if i == self.layers - 1:
                penultimate = x
            x = getattr(self, f"layers_{i}")(x, causal)
        last = self.final_layer_norm(x)
        pooled = last[torch.arange(b, device=input_ids.device), input_ids.argmax(dim=-1)]
        return last, penultimate, pooled

    def encode(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, 77) token ids -> last_hidden_state (B, 77, hidden), after the
        final LayerNorm (what FrozenCLIPEmbedder.encode returns)."""
        return self(input_ids)[0]
