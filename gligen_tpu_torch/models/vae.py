"""AutoencoderKL, the frozen SD first stage (counterpart of
``gligen_tpu/models/vae.py``), NHWC.

The Encoder and Decoder (ResnetBlock, single-head AttnBlock, the
encoder's asymmetric-pad Downsample, Upsample), ``quant_conv`` /
``post_quant_conv``, the diagonal-Gaussian posterior (``encode_moments``
with the logvar clamp, ``encode`` with the posterior noise passed in,
``encode_mode``) and ``decode``, with ``scale_factor``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.models.layers import Conv2d, Dense, Normalize, computing_in
from gligen_tpu_torch.models.unet import Upsample  # the same nearest 2x + conv3x3
from gligen_tpu_torch.ops.attention import multi_head_attention
from gligen_tpu_torch.ops.basic import tf32_off


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv3x3, twice, + (1x1-projected) input."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = Normalize(in_channels, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, dtype=dtype)
        self.norm2 = Normalize(out_channels, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, dtype=dtype)
        self.nin_shortcut = (
            Conv2d(in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention; q/k/v/proj_out are 1x1 convs,
    i.e. Dense over channels."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = Normalize(channels)
        self.q = Dense(channels, channels, dtype=dtype)
        self.k = Dense(channels, channels, dtype=dtype)
        self.v = Dense(channels, channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hn = self.norm(x).reshape(b, h * w, c)
        out = multi_head_attention(self.q(hn), self.k(hn), self.v(hn), heads=1)
        return x + self.proj_out(out.to(x.dtype)).reshape(b, h, w, c)


class Downsample(nn.Module):
    """The encoder's stride-2 3x3 conv after an asymmetric (0, 1) pad of H
    and W (vae.py:86-99).  Not the UNet's Downsample, which pads 1 on both
    sides: that one gives the same shape and other values."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)
        self.conv.padding = (0, 0)  # the input is padded here instead

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Encoder(nn.Module):
    """Image (B, H, W, 3) -> (B, H/f, W/f, 2 z_channels) posterior moments
    before quant_conv, f = 2^(len(ch_mult) - 1) (vae.py:116-147)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, z_channels: int = 4, in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype)
        self.down_names = []  # module names in forward order
        block_in, curr_res = ch, resolution
        for i_level, mult in enumerate(ch_mult):
            for i_block in range(num_res_blocks):
                name = f"down_{i_level}_block_{i_block}"
                self.add_module(name, ResnetBlock(block_in, ch * mult, dtype=dtype))
                self.down_names.append(name)
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    name = f"down_{i_level}_attn_{i_block}"
                    self.add_module(name, AttnBlock(block_in, dtype=dtype))
                    self.down_names.append(name)
            if i_level != len(ch_mult) - 1:
                name = f"down_{i_level}_downsample"
                self.add_module(name, Downsample(block_in, dtype=dtype))
                self.down_names.append(name)
                curr_res //= 2
        self.mid_block_1 = ResnetBlock(block_in, block_in, dtype=dtype)
        self.mid_attn_1 = AttnBlock(block_in, dtype=dtype)
        self.mid_block_2 = ResnetBlock(block_in, block_in, dtype=dtype)
        self.norm_out = Normalize(block_in, act="silu")
        self.conv_out = Conv2d(block_in, 2 * z_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for name in self.down_names:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


def sample_posterior(mean: torch.Tensor, logvar: torch.Tensor, noise: torch.Tensor,
                     scale_factor: float) -> torch.Tensor:
    """(mean + exp(logvar / 2) * noise) * scale_factor in mean's dtype, the
    logvar clamped to [-30, 20] (distributions.py:24-33): the body of
    ``encode``, shared with the trainer's cached-moments branch so that both
    give the same latent for the same draws."""
    logvar = logvar.to(mean.dtype).clamp(-30.0, 20.0)
    return (mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)) * scale_factor


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, z_channels: int = 4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, dtype=dtype)
        self.mid_block_1 = ResnetBlock(block_in, block_in, dtype=dtype)
        self.mid_attn_1 = AttnBlock(block_in, dtype=dtype)
        self.mid_block_2 = ResnetBlock(block_in, block_in, dtype=dtype)
        self.up_names = []  # module names in forward order
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        for i_level in reversed(range(len(ch_mult))):
            for i_block in range(num_res_blocks + 1):
                name = f"up_{i_level}_block_{i_block}"
                self.add_module(name, ResnetBlock(block_in, ch * ch_mult[i_level], dtype=dtype))
                self.up_names.append(name)
                block_in = ch * ch_mult[i_level]
                if curr_res in attn_resolutions:
                    name = f"up_{i_level}_attn_{i_block}"
                    self.add_module(name, AttnBlock(block_in, dtype=dtype))
                    self.up_names.append(name)
            if i_level != 0:
                name = f"up_{i_level}_upsample"
                self.add_module(name, Upsample(block_in, dtype=dtype))
                self.up_names.append(name)
                curr_res *= 2
        self.norm_out = Normalize(block_in, act="silu")
        self.conv_out = Conv2d(block_in, out_ch, 3, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.to(self.dtype))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for name in self.up_names:
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """The SD AutoencoderKL (autoencoder.py:17-44); ``scale_factor`` 0.18215."""

    def __init__(self, embed_dim: int = 4, scale_factor: float = 0.18215, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 z_channels: int = 4, out_ch: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale_factor = scale_factor
        self.embed_dim = embed_dim
        self.downsample_factor = 2 ** (len(ch_mult) - 1)
        common = dict(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                      attn_resolutions=attn_resolutions, resolution=resolution,
                      z_channels=z_channels, dtype=dtype)
        self.encoder = Encoder(**common)
        self.decoder = Decoder(out_ch=out_ch, **common)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, dtype=dtype)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar) of the posterior, each (B, H/f, W/f, embed_dim) in
        the compute dtype, logvar clamped to [-30, 20].  x: (B, H, W, 3) in
        [-1, 1]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """A posterior sample * scale_factor (autoencoder.py:34-38).  The
        standard-normal ``noise`` (the latent's shape) is passed in, so a
        caller (or a test) chooses the draw."""
        mean, logvar = self.encode_moments(x)
        return sample_posterior(mean, logvar, noise, self.scale_factor)

    def encode_fp32(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """``encode`` computed in fp32 whatever this module's ``dtype``, over
        its fp32 parameters: the inpaint encode (the JAX pipeline's
        ``vae.clone(dtype=float32)``, pipeline.py:295-310), whose rounding
        the per-step blend would carry into the image.  On the card its
        GroupNorms and its attention take the fp32 routes of the GroupNorm
        and flash kernels, and its convs and products are cuDNN's and
        cuBLAS's.  The method pins those to fp32 itself: both TF32 switches
        (``torch.backends.cudnn.allow_tf32``, on by default, and
        ``torch.backends.cuda.matmul.allow_tf32``) are off for the encode's
        duration and restored afterwards, also when it raises."""
        with tf32_off(), computing_in(self, torch.float32):
            return self.encode(x.float(), noise.float())

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior mode * scale_factor (deterministic)."""
        return self.encode_moments(x)[0] * self.scale_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, embed_dim) latent -> (B, 8h, 8w, out_ch) image in the
        compute dtype, roughly in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z / self.scale_factor))
