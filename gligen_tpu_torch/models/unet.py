"""GLIGEN UNet (counterpart of ``gligen_tpu/models/unet.py``).

The SD-1.4 epsilon-predictor UNet with grounding-token plumbing, NHWC.
Submodule names mirror the JAX parameter tree (``input_blocks_1_0``,
``middle_block_1``, ``out_2``...).  The alpha-stage dual first conv is a
host-side select: ``use_sd_conv`` picks the original SD 4-channel conv
(``first_conv_sd``) or the GLIGEN one, and only the chosen conv runs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.grounding.text import TextPositionNet
from gligen_tpu_torch.models.layers import Conv2d, Dense, Normalize, SpatialTransformer
from gligen_tpu_torch.ops.basic import nearest_upsample_2x, timestep_embedding
from gligen_tpu_torch.ops.fused_conv import gn_silu_conv3x3

# The JAX package's routing table for GLIGEN_TPU_FUSED_CONV=auto, carried as
# it is (gligen_tpu/models/unet.py:81): the (H, out_channels) of the
# ResBlocks that take the fused conv.  It is not an H100 measurement.
_FUSED_CONV_WINS = {(32, 640)}


def _fused_conv_mode() -> str:
    """GLIGEN_TPU_FUSED_CONV, read at call time (unet.py:84-99): '0' (the
    default) runs every ResBlock as GroupNorm and Conv2d modules, '1' sends
    each ResBlock whose W is a multiple of 8 through the fused GN -> SiLU
    -> conv3x3 kernel (ops/fused_conv.py), 'auto' only those in
    ``_FUSED_CONV_WINS``.  On the CPU the kernel's plain version runs."""
    mode = os.environ.get("GLIGEN_TPU_FUSED_CONV", "0")
    return mode if mode in ("1", "auto") else "0"


def fuses_conv(mode: str, h: int, w: int, out_channels: int) -> bool:
    """Whether a ResBlock on an (H, W) map takes the fused kernel (unet.py:
    145-149): W % 8 is the TPU kernel's sublane rule, kept so that both
    packages route the same blocks."""
    return mode != "0" and w % 8 == 0 and (mode == "1" or (h, out_channels) in _FUSED_CONV_WINS)


class GroupNorm32(Normalize):
    """32-group, fp32-statistics GroupNorm with eps 1e-5."""

    def __init__(self, channels: int, act: Optional[str] = None):
        super().__init__(channels, eps=1e-5, act=act)


class ResBlock(nn.Module):
    """GN -> SiLU -> conv3x3, + time embedding, GN -> SiLU -> conv3x3
    (zero-init), + (1x1-projected) input.  Both paths read the same
    parameters, so the state dict does not depend on the route."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int, dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.in_layers_0 = GroupNorm32(in_channels, act="silu")
        self.in_layers_2 = Conv2d(in_channels, out_channels, 3, dtype=dtype)
        self.emb_layers_1 = Dense(emb_dim, out_channels, dtype=dtype)
        self.out_layers_0 = GroupNorm32(out_channels, act="silu")
        self.out_layers_3 = Conv2d(out_channels, out_channels, 3, dtype=dtype, zero_init=True)
        self.skip_connection = (
            Conv2d(in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if fuses_conv(_fused_conv_mode(), x.shape[1], x.shape[2], self.out_channels):
            return self._fused(x, emb)
        h = self.in_layers_2(self.in_layers_0(x))
        h = h + self.emb_layers_1(F.silu(emb))[:, None, None, :].to(h.dtype)
        h = self.out_layers_3(self.out_layers_0(h))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h

    def _fused(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """Both GN -> SiLU -> conv3x3 chains as fused kernels (unet.py:
        165-187); the residual rides the second one's epilogue.  conv2's
        statistics are those of its own input, h + emb."""
        n1, c1, n2, c2 = self.in_layers_0, self.in_layers_2, self.out_layers_0, self.out_layers_3
        h = gn_silu_conv3x3(x, n1.weight, n1.bias, c1.weight, c1.bias, eps=n1.eps)
        h = h + self.emb_layers_1(F.silu(emb))[:, None, None, :].to(h.dtype)
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return gn_silu_conv3x3(h, n2.weight, n2.bias, c2.weight, c2.bias, residual=x, eps=n2.eps)


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class UNetModel(nn.Module):
    """forward(x, timesteps, context, grounding, *, gate_scale, use_sd_conv,
    objs, skip_fusers)

      x: (B, H, W, in_channels) latent, NHWC
      timesteps: (B,) int
      context: (B, 77, context_dim) text encoding
      grounding: the tokenizer's inputs (boxes, masks, positive_embeddings)
      gate_scale: the alpha schedule's value for every gated fuser
      use_sd_conv: run the original SD first conv instead of GLIGEN's
      objs: precomputed ``grounding_tokens(grounding)``, so the position
        net runs once per request, not once per step
      skip_fusers: run no fuser (exact where the gate is 0)

    ``use_checkpoint`` (training, gligen_tpu unet.py:251) recomputes each
    transformer block in the backward; it is off by default here, where
    generation is the first use, and the trainer turns it on.
    """

    def __init__(
        self,
        in_channels: int = 4,
        model_channels: int = 320,
        out_channels: int = 4,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        transformer_depth: int = 1,
        context_dim: int = 768,
        fuser_type: str = "gatedSA",
        grounding_tokenizer: Optional[Dict[str, Any]] = None,
        use_checkpoint: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        tok_cfg = grounding_tokenizer or {"target": "text", "params": {}}
        if tok_cfg["target"] != "text":
            raise ValueError(f"grounding tokenizer {tok_cfg['target']!r} is not ported")
        self.dtype = dtype
        self.model_channels = model_channels
        self.position_net = TextPositionNet(**tok_cfg.get("params", {}), dtype=dtype)
        objs_dim = tok_cfg.get("params", {}).get("out_dim", 768)
        emb_dim = model_channels * 4
        self.time_embed_0 = Dense(model_channels, emb_dim, dtype=dtype)
        self.time_embed_2 = Dense(emb_dim, emb_dim, dtype=dtype)
        self.input_blocks_0_0 = Conv2d(in_channels, model_channels, 3, dtype=dtype)
        self.first_conv_sd = Conv2d(in_channels, model_channels, 3, dtype=dtype)

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, emb_dim, dtype=dtype))
            return name

        def st(name, ch):
            self.add_module(name, SpatialTransformer(
                ch, context_dim, objs_dim, num_heads, ch // num_heads,
                depth=transformer_depth, fuser_type=fuser_type, dtype=dtype,
                use_checkpoint=use_checkpoint,
            ))
            return name

        # Each entry is one block: module names applied in order.  The down
        # branch pushes each block's output; the up branch pops one skip
        # per block and concatenates it on the channel axis first.
        self.input_blocks = []
        ch = model_channels
        input_block_chans = [ch]
        ds = 1
        idx = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                block = [res(f"input_blocks_{idx}_0", ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    block.append(st(f"input_blocks_{idx}_1", ch))
                self.input_blocks.append(block)
                input_block_chans.append(ch)
                idx += 1
            if level != len(channel_mult) - 1:
                self.add_module(f"input_blocks_{idx}_0", Downsample(ch, dtype=dtype))
                self.input_blocks.append([f"input_blocks_{idx}_0"])
                input_block_chans.append(ch)
                ds *= 2
                idx += 1

        self.middle_block = [
            res("middle_block_0", ch, ch), st("middle_block_1", ch), res("middle_block_2", ch, ch)
        ]

        self.output_blocks = []
        idx = 0
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                cin = ch + input_block_chans.pop()
                ch = model_channels * mult
                block = [res(f"output_blocks_{idx}_0", cin, ch)]
                j = 1
                if ds in attention_resolutions:
                    block.append(st(f"output_blocks_{idx}_{j}", ch))
                    j += 1
                if level and i == num_res_blocks:
                    self.add_module(f"output_blocks_{idx}_{j}", Upsample(ch, dtype=dtype))
                    block.append(f"output_blocks_{idx}_{j}")
                    ds //= 2
                self.output_blocks.append(block)
                idx += 1

        self.out_0 = GroupNorm32(ch, act="silu")
        self.out_2 = Conv2d(ch, out_channels, 3, dtype=dtype, zero_init=True)

    def grounding_tokens(self, grounding: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The position net's (B, N, objs_dim) tokens for the tokenizer's inputs."""
        return self.position_net(**grounding)

    def _run(self, names, h, emb, ctx, objs, gate_scale, skip_fusers):
        for name in names:
            layer = getattr(self, name)
            if isinstance(layer, ResBlock):
                h = layer(h, emb)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, ctx, objs, gate_scale, skip_fusers)
            else:
                h = layer(h)
        return h

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor,
        grounding: Optional[Dict[str, torch.Tensor]] = None,
        *,
        gate_scale: float = 1.0,
        use_sd_conv: bool = False,
        objs: Optional[torch.Tensor] = None,
        skip_fusers: bool = False,
    ) -> torch.Tensor:
        if objs is None and not (skip_fusers and grounding is None):
            objs = self.grounding_tokens(grounding)

        t_emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_2(F.silu(self.time_embed_0(t_emb)))

        h = x.to(self.dtype)
        h = self.first_conv_sd(h) if use_sd_conv else self.input_blocks_0_0(h)
        ctx = context.to(self.dtype)
        run = lambda names, h: self._run(names, h, emb, ctx, objs, gate_scale, skip_fusers)

        hs = [h]
        for names in self.input_blocks:
            h = run(names, h)
            hs.append(h)
        h = run(self.middle_block, h)
        for names in self.output_blocks:
            h = run(names, torch.cat([h, hs.pop()], dim=-1))
        h = self.out_2(self.out_0(h))
        return h.float()
