"""End-to-end grounded generation (counterpart of
``gligen_tpu/inference/pipeline.py``): CLIP text encode, grounding tokens
once per request (the CFG null pair included), PLMS over the GLIGEN UNet
with the CFG pair batched as one UNet call on 2B rows, the fuser-free
tail of the alpha schedule, and VAE decode.

PyTorch runs eagerly, so where the JAX package compiles one program, this
pipeline is a Python loop of UNet calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from gligen_tpu_torch.diffusion.samplers import plms_sample
from gligen_tpu_torch.diffusion.schedule import DiffusionSchedule
from gligen_tpu_torch.models.clip_text import CLIPTextModel
from gligen_tpu_torch.models.layers import Conv2d, Dense
from gligen_tpu_torch.models.unet import UNetModel
from gligen_tpu_torch.models.vae import AutoencoderKL

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def random_init_(root: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``generator``: lecun
    normal for Dense/Conv weights (zeros where the module is zero-init),
    zero biases, unit norm scales, zero fuser alphas and null features."""
    with torch.no_grad():
        for m in root.modules():
            if isinstance(m, (Dense, Conv2d)):
                if m.zero_init:
                    m.weight.zero_()
                else:
                    std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim**-0.5, generator=generator)
            else:
                for name, p in m.named_parameters(recurse=False):
                    p.fill_(1.0 if name == "weight" else 0.0)


@dataclasses.dataclass
class GligenComponents:
    """The UNet, VAE, text encoder and schedule of one GLIGEN model."""

    unet: UNetModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    schedule: DiffusionSchedule

    @classmethod
    def create(
        cls,
        unet_config: Optional[Dict[str, Any]] = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device: Any = "cuda",
        vae_config: Optional[Dict[str, Any]] = None,
        text_config: Optional[Dict[str, Any]] = None,
    ) -> "GligenComponents":
        """Components with the SD-1.4 GLIGEN architecture by default
        (configs/flickr_text.yaml), fp32 parameters on ``device`` (the card
        unless the caller asks for the CPU), drawn from a generator seeded
        with ``seed``; real weights come through ``convert/from_jax.py``."""
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GligenComponents.create: no CUDA device for device="
                f"{device!r}; pass device='cpu' to build on the CPU"
            )
        unet_config = dict(unet_config or {})
        unet_config.setdefault("grounding_tokenizer", {"target": "text", "params": {}})
        with torch.device(device):
            unet = UNetModel(dtype=dtype, **unet_config).eval()
            vae = AutoencoderKL(dtype=dtype, **(vae_config or {})).eval()
            text = CLIPTextModel(dtype=dtype, **(text_config or {})).eval()
        gen = torch.Generator(device=device).manual_seed(seed)
        for module in (unet, vae, text):
            random_init_(module, gen)
        schedule = DiffusionSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
        return cls(unet, vae, text, schedule)


class GenerationPipeline:
    """Grounded text-to-image generation."""

    def __init__(self, components: GligenComponents):
        self.c = components
        self.device = next(components.unet.parameters()).device

    @torch.no_grad()
    def generate(
        self,
        input_ids,
        uc_input_ids,
        grounding: Dict[str, Any],
        *,
        steps: int = 50,
        guidance_scale: float = 7.5,
        alpha_stages: Optional[Sequence[float]] = None,
        latent_size: int = 64,
        noise=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """PLMS generation.  Returns images in [0, 1], (B, 8*latent,
        8*latent, 3) float32.

        input_ids/uc_input_ids: (B, 77) tokenized prompt / negative prompt.
        grounding: the box tokenizer's inputs (boxes, masks,
        positive_embeddings).  noise: optional (B, latent, latent, 4)
        starting noise; drawn from ``generator`` otherwise."""
        c, dev = self.c, self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        uc_ids = torch.as_tensor(uc_input_ids, device=dev).long()
        b = ids.shape[0]
        grounding = {k: torch.as_tensor(v, device=dev) for k, v in grounding.items()}

        context = c.text_encoder.encode(ids)
        uc = c.text_encoder.encode(uc_ids)
        # grounding tokens are loop-invariant: once per request, null pair included
        objs_c = c.unet.grounding_tokens(grounding)
        objs_u = c.unet.grounding_tokens({k: torch.zeros_like(v) for k, v in grounding.items()})

        scale = float(guidance_scale)
        use_cfg = scale != 1.0
        ctx = torch.cat([context, uc]) if use_cfg else context
        objs = torch.cat([objs_c, objs_u]) if use_cfg else objs_c

        def make_eps_fn(skip):
            def eps_fn(x, t, gate, use_sd):
                if use_cfg:
                    x, t = torch.cat([x, x]), torch.cat([t, t])
                e = c.unet(x, t, ctx, gate_scale=gate, use_sd_conv=use_sd,
                           objs=None if skip else objs, skip_fusers=skip)
                if not use_cfg:
                    return e
                e_c, e_u = e.chunk(2)
                return e_u + scale * (e_c - e_u)

            return eps_fn

        if noise is None:
            noise = torch.randn((b, latent_size, latent_size, 4), generator=generator, device=dev)
        # the gate-0 tail of the alpha schedule runs a fuser-free UNet: exact
        # for the alpha-scheduled gatedSA fuser, the one the port has
        z = plms_sample(
            make_eps_fn(False), c.schedule, torch.as_tensor(noise, device=dev).float(),
            steps=steps, alpha_stages=alpha_stages, eps_fn_gate0=make_eps_fn(True),
        )
        img = c.vae.decode(z)
        return img.float().clamp(-1.0, 1.0) * 0.5 + 0.5
