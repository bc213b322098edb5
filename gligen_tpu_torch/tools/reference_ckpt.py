"""Reference-format checkpoints written from the port's components: the
inverse of ``convert/from_reference.py``.

``reference_checkpoint`` gives the monolithic dict the reference trainer
saves (trainer.py:472-484): {model, ema, autoencoder, text_encoder (under
FrozenCLIPEmbedder's ``transformer.`` prefix), diffusion, config_dict
{"_content": ...}}, with the reference's key names and layouts (the Dense
1x1 convs back to (O, I, 1, 1), ``to_out`` back to ``to_out.0``, the VAE's
levels and CLIP's prefixes restored).  It is how a test or the smoke run
builds a checkpoint with no download; the tensors are the components' own
(no copy) where the layout is the same.

Only ``torch`` is imported.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

_CONV_AS_DENSE_NAMES = {"proj_in", "proj_out", "q", "k", "v"}
_MERGED = re.compile(r"(.*?)((?:_\d+)+)")


def _layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A Dense 1x1 conv's (O, I) weight back to the reference's (O, I, 1, 1)."""
    parts = name.split(".")
    if parts[-1] == "weight" and t.dim() == 2 and len(parts) > 1 \
            and parts[-2] in _CONV_AS_DENSE_NAMES:
        return t[:, :, None, None]
    return t


def _split_merged(part: str) -> str:
    """``input_blocks_3_0`` -> ``input_blocks.3.0``; ``to_out`` -> ``to_out.0``."""
    if part == "to_out":
        return "to_out.0"
    m = _MERGED.fullmatch(part)
    return part if m is None else m.group(1) + m.group(2).replace("_", ".")


def unet_to_reference(state: Mapping[str, torch.Tensor]
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """The port's UNet state dict -> (reference UNet state dict, the SD
    first conv as ``SD_input_conv_weight_bias.pth`` holds it, or None for an
    inpaint UNet, which has none)."""
    out, sd_conv = {}, None
    for name, t in state.items():
        if name.startswith("first_conv_sd."):
            sd_conv = sd_conv or {}
            sd_conv[name.split(".")[-1]] = t
            continue
        key = ".".join(_split_merged(p) for p in name.split("."))
        out[key] = _layout(name, t)
    return out, sd_conv


def vae_to_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's AutoencoderKL state dict -> CompVis names."""
    out = {}
    for name, t in state.items():
        key = re.sub(r"\b(down|up)_(\d+)_(block|attn)_(\d+)\.", r"\1.\2.\3.\4.", name)
        key = re.sub(r"\b(down|up)_(\d+)_(downsample|upsample)\.", r"\1.\2.\3.", key)
        key = re.sub(r"\bmid_(block|attn)_", r"mid.\1_", key)
        out[key] = _layout(name, t)
    return out


def clip_to_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's CLIPTextModel state dict -> HF CLIPTextModel names, with
    the ``position_ids`` buffer HF keeps (which the loader drops)."""
    out = {}
    for name, t in state.items():
        key = re.sub(r"\.mlp_fc(\d)\.", r".mlp.fc\1.", ".".join(
            _split_merged(p) for p in name.split(".")))
        if key.startswith(("token_embedding.", "position_embedding.")):
            key = "text_model.embeddings." + key
        elif key.startswith("layers."):
            key = "text_model.encoder." + key
        else:
            key = "text_model." + key
        out[key] = t
    positions = state["position_embedding.weight"].shape[0]
    device = state["position_embedding.weight"].device
    out["text_model.embeddings.position_ids"] = torch.arange(positions, device=device)[None]
    return out


def clip_vision_to_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's CLIPVisionModel state dict -> HF
    CLIPVisionModelWithProjection names, with the ``position_ids`` buffer
    HF keeps (which the loader drops)."""
    out = {}
    for name, t in state.items():
        key = re.sub(r"\.mlp_fc(\d)\.", r".mlp.fc\1.", ".".join(
            _split_merged(p) for p in name.split(".")))
        if key.startswith(("class_embedding", "patch_embedding.", "position_embedding.")):
            key = "vision_model.embeddings." + key
        elif key.startswith("layers."):
            key = "vision_model.encoder." + key
        elif not key.startswith("visual_projection."):
            key = "vision_model." + key
        out[key] = t
    positions = state["position_embedding.weight"].shape[0]
    device = state["position_embedding.weight"].device
    out["vision_model.embeddings.position_ids"] = torch.arange(positions, device=device)[None]
    return out


def _vae_config(vae) -> Dict[str, Any]:
    """The reference's AutoencoderKL config section of ``vae``."""
    enc = vae.encoder
    ch = enc.conv_in.weight.shape[0]
    mults = [getattr(enc, n).conv1.weight.shape[0] // ch
             for n in enc.down_names if n.endswith("_block_0")]
    blocks = sum(n.startswith("down_0_block_") for n in enc.down_names)
    return {"target": "ldm.models.autoencoder.AutoencoderKL", "params": {
        "embed_dim": vae.embed_dim, "scale_factor": vae.scale_factor,
        "ddconfig": {"double_z": True, "z_channels": vae.post_quant_conv.weight.shape[0],
                     "resolution": 256, "in_channels": 3,
                     "out_ch": vae.decoder.conv_out.weight.shape[0], "ch": ch,
                     "ch_mult": mults, "num_res_blocks": blocks,
                     "attn_resolutions": [], "dropout": 0.0}}}


def reference_checkpoint(components, unet_config: Mapping[str, Any],
                         schedule_config: Mapping[str, Any],
                         ema_gate: Optional[float] = None) -> Tuple[Dict[str, Any], Any]:
    """(the reference's checkpoint dict of ``components``, the SD first conv
    dict or None).

    ``unet_config``: the UNet's keywords (the config's ``model.params``,
    written with the reference's ``image_size`` and ``use_checkpoint``);
    ``schedule_config``: the diffusion keywords (linear schedule).  ``ema``
    holds the model's tensors, but every fuser gate is ``ema_gate`` where
    one is given, so that an EMA overlay shows.  The VAE's
    ``attn_resolutions`` are written empty, the port's default."""
    model, sd_conv = unet_to_reference(components.unet.state_dict())
    ema = dict(model)
    if ema_gate is not None:
        for key, t in model.items():
            if key.endswith((".alpha_attn", ".alpha_dense")):
                ema[key] = torch.full_like(t, ema_gate)
    sched = components.schedule
    diffusion = {name: torch.from_numpy(getattr(sched, name).copy())
                 for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                              "sqrt_one_minus_alphas_cumprod")}
    text = {f"transformer.{k}": v
            for k, v in clip_to_reference(components.text_encoder.state_dict()).items()}
    content = {
        "model": {"target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
                  "params": {"image_size": 64, "use_checkpoint": False, **unet_config}},
        "autoencoder": _vae_config(components.vae),
        "text_encoder": {"target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder",
                         "params": {}},
        "diffusion": {"target": "ldm.models.diffusion.ldm.LatentDiffusion",
                      "params": dict(schedule_config)},
    }
    ckpt = {
        "model": model,
        "ema": ema,
        "autoencoder": vae_to_reference(components.vae.state_dict()),
        "text_encoder": text,
        "diffusion": diffusion,
        "iters": 0,
        "config_dict": {"_content": content, "_metadata": None},
    }
    return ckpt, sd_conv
