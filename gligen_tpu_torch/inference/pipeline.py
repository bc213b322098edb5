"""End-to-end grounded generation (counterpart of
``gligen_tpu/inference/pipeline.py``): CLIP text encode, grounding tokens
once per request (the CFG null pair included), a spatial map's downsampler
channels once per request, the inpaint image's fp32 VAE encode, PLMS or
DDIM over the GLIGEN UNet with the CFG pair batched as one UNet call on 2B
rows, the fuser-free tail of the alpha schedule, and VAE decode.

PyTorch runs eagerly, so where the JAX package compiles one program, this
pipeline is a Python loop of UNet calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from gligen_tpu_torch.diffusion.samplers import ddim_sample, plms_sample
from gligen_tpu_torch.diffusion.schedule import DiffusionSchedule
from gligen_tpu_torch.inference.adapters import null_input
from gligen_tpu_torch.models.clip_text import CLIPTextModel
from gligen_tpu_torch.models.clip_vision import CLIPVisionModel, PatchEmbedding
from gligen_tpu_torch.models.grounding.convnext import LAYER_SCALE_INIT, ConvNeXtBlock
from gligen_tpu_torch.models.grounding.spatial import SpatialPositionNet
from gligen_tpu_torch.models.layers import Conv2d, Dense
from gligen_tpu_torch.models.unet import UNetModel
from gligen_tpu_torch.models.vae import AutoencoderKL

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def random_init_(root: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``generator``: lecun
    normal for Dense/Conv weights (zeros where the module is zero-init),
    zero biases, unit norm scales, zero fuser alphas and null features,
    CLIP vision's class embedding and the spatial tokenizers' position
    embedding ~ N(0, 0.02^2), and ConvNeXt's layer scale ``gamma`` 1e-6."""
    with torch.no_grad():
        for m in root.modules():
            if isinstance(m, (Dense, Conv2d, PatchEmbedding)):
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
                else:
                    std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim**-0.5, generator=generator)
            elif isinstance(m, CLIPVisionModel):
                nn.init.normal_(m.class_embedding, std=0.02, generator=generator)
            elif isinstance(m, SpatialPositionNet):
                nn.init.normal_(m.pos_embedding, std=0.02, generator=generator)
                m.null_feature.zero_()
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.fill_(LAYER_SCALE_INIT)
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
        schedule_config: Optional[Dict[str, Any]] = None,
    ) -> "GligenComponents":
        """Components with the SD-1.4 GLIGEN architecture by default
        (configs/flickr_text.yaml), fp32 parameters on ``device`` (the card
        unless the caller asks for the CPU), drawn from a generator seeded
        with ``seed``; real weights come through ``convert/from_reference.py``
        (``inference/cli.py:components_from_checkpoint``) or
        ``convert/from_jax.py``.  ``unet_config`` may ask for
        ``inpaint_mode``; ``schedule_config`` overrides the
        ``DiffusionSchedule.create`` keywords (a checkpoint's own,
        pipeline.py:66-68)."""
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
        sched_kwargs = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
        sched_kwargs.update(schedule_config or {})
        return cls(unet, vae, text, DiffusionSchedule.create(**sched_kwargs))


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
        sampler: str = "plms",
        alpha_stages: Optional[Sequence[float]] = None,
        grounding_extra=None,
        inpaint_image=None,
        inpaint_mask=None,
        inpainting_extra=None,
        latent_size: int = 64,
        noise=None,
        encode_noise=None,
        blend_noise=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """PLMS or DDIM (``sampler``, eta 0) generation.  Returns images in
        [0, 1], (B, 8*latent, 8*latent, 3) float32.

        input_ids/uc_input_ids: (B, 77) tokenized prompt / negative prompt.
        grounding: the UNet's tokenizer's inputs (``inference/adapters.py``:
        boxes, masks, positive_embeddings for text; text_image's boxes,
        masks, text and image masks and embeddings; keypoint's points,
        masks; a spatial modality's map and mask); the null batch of CFG
        is its zeros (``adapters.null_input``).  grounding_extra: the
        spatial map of a UNet with a grounding downsampler (the adapter's
        ``prepare_extra``); its channels are computed once, from this
        conditional map, and serve both halves of the CFG pair: they are
        never nulled (pipeline.py:312-331).  inpaint_image: (B, H, W, 3) in
        [-1, 1] and inpaint_mask: (B, latent, latent, 1) keep-mask (1 =
        known region) inpaint; the UNet must be an inpaint UNet.
        inpainting_extra: (B, latent, latent, 5) concat(z * m, m) given as it
        is to an inpaint UNet, with no blend of a known region (the
        training preview, trainer.py:522-530).  The random draws are
        injected or come from ``generator``: noise (B, latent, latent, 4),
        the starting noise; encode_noise (the same shape), the inpaint
        encode's posterior noise; blend_noise (S, B, latent, latent, 4),
        each step's blend noise (the JAX package's fold_in(k_blend, i) for
        PLMS, fold_in(fold_in(k_blend, 1), i) for DDIM)."""
        if sampler not in ("plms", "ddim"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if (inpaint_image is None) != (inpaint_mask is None):
            raise ValueError("inpaint_image and inpaint_mask go together")
        if inpaint_image is not None and inpainting_extra is not None:
            raise ValueError("inpainting_extra replaces inpaint_image and inpaint_mask")
        c, dev = self.c, self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        uc_ids = torch.as_tensor(uc_input_ids, device=dev).long()
        b = ids.shape[0]
        grounding = {k: torch.as_tensor(v, device=dev) for k, v in grounding.items()}

        context = c.text_encoder.encode(ids)
        uc = c.text_encoder.encode(uc_ids)
        # grounding tokens are loop-invariant: once per request, null pair included
        objs_c = c.unet.grounding_tokens(grounding)
        objs_u = c.unet.grounding_tokens(null_input(grounding))

        scale = float(guidance_scale)
        use_cfg = scale != 1.0
        pair = (lambda t: torch.cat([t, t])) if use_cfg else (lambda t: t)
        ctx = torch.cat([context, uc]) if use_cfg else context
        objs = torch.cat([objs_c, objs_u]) if use_cfg else objs_c
        ds = None
        if grounding_extra is not None:
            ds = pair(c.unet.downsampler_features(torch.as_tensor(grounding_extra, device=dev)))

        latent_shape = (b, latent_size, latent_size, 4)
        mask = x0 = extra = None
        if inpaint_image is not None:
            # fp32 encode whatever the serving dtype (pipeline.py:295-310):
            # the blend carries the encode's rounding into the image
            image = torch.as_tensor(inpaint_image, device=dev).float()
            if encode_noise is None:
                encode_noise = torch.randn(latent_shape, generator=generator, device=dev)
            x0 = c.vae.encode_fp32(image, torch.as_tensor(encode_noise, device=dev).float())
            mask = torch.as_tensor(inpaint_mask, device=dev).float()
            extra = pair(torch.cat([x0 * mask, mask], dim=-1))
        elif inpainting_extra is not None:
            extra = pair(torch.as_tensor(inpainting_extra, device=dev).float())

        def make_eps_fn(skip):
            def eps_fn(x, t, gate, use_sd):
                e = c.unet(pair(x), pair(t), ctx, gate_scale=gate, use_sd_conv=use_sd,
                           inpainting_extra=extra, grounding_extra_features=ds,
                           objs=None if skip else objs, skip_fusers=skip)
                if not use_cfg:
                    return e
                e_c, e_u = e.chunk(2)
                return e_u + scale * (e_c - e_u)

            return eps_fn

        if noise is None:
            noise = torch.randn(latent_shape, generator=generator, device=dev)
        # the gate-0 tail of the alpha schedule runs a fuser-free UNet, exact
        # for the fusers that gate (pipeline.py:395-399)
        eps_fn0 = make_eps_fn(True) if c.unet.fuser_type in ("gatedSA", "gatedCA") else None
        common = dict(steps=steps, alpha_stages=alpha_stages,
                      first_conv_restorable=c.unet.first_conv_restorable, mask=mask, x0=x0,
                      blend_noise=blend_noise, generator=generator, eps_fn_gate0=eps_fn0)
        run = plms_sample if sampler == "plms" else ddim_sample
        z = run(make_eps_fn(False), c.schedule, torch.as_tensor(noise, device=dev).float(),
                **common)
        img = c.vae.decode(z)
        return img.float().clamp(-1.0, 1.0) * 0.5 + 0.5
