"""Reference-format checkpoint loading (counterpart of the torch-file part
of ``gligen_tpu/training/checkpoints.py``, :38-88).

The reference saves monolithic torch dicts {model, ema, autoencoder,
text_encoder, diffusion, opt, scheduler, iters, config_dict}
(trainer.py:472-484) whose embedded config describes the model
(gligen_inference.py:70-86); the official SD checkpoint is one state dict
split by key prefix (trainer.py:64-85).  Each loader is ``torch.load``
followed by a function of the loaded dict, so a checkpoint already in
memory (on any device) loads the same way.  Native save/resume is the
Trainer's (ROADMAP M11b).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from gligen_tpu_torch.convert.from_reference import (
    convert_clip_text,
    convert_unet,
    convert_vae,
    split_official_sd_ckpt,
)

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def _strip_prefix(state: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state.items()}


def checkpoint_config(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """The embedded config: ``config_dict``, or its ``_content`` (the
    reference saves ``vars(OmegaConf)``)."""
    config = ckpt.get("config_dict", {})
    if isinstance(config, Mapping) and "_content" in config:
        config = config["_content"]
    return dict(config)


def gligen_state_dicts(
    ckpt: Mapping[str, Any],
    sd_first_conv: Optional[Mapping[str, Any]] = None,
    use_ema: bool = False,
) -> Tuple[StateDicts, Dict[str, Any]]:
    """A loaded GLIGEN checkpoint -> ({"model", "autoencoder",
    "text_encoder"} port state dicts, embedded config).

    ``use_ema`` overlays the checkpoint's ``ema`` state dict (the EMA
    shadow, same names as ``model``) on the model's before conversion.
    The UNet gets its SD first conv (from ``sd_first_conv`` or its own
    first 4 input channels) unless the config's UNet is an inpaint one."""
    config = checkpoint_config(ckpt)
    model_sd = ckpt["model"]
    if use_ema:
        if "ema" not in ckpt:
            raise ValueError("the checkpoint has no 'ema' entry (trained without enable_ema)")
        model_sd = {**model_sd, **ckpt["ema"]}
    inpaint = bool(config.get("model", {}).get("params", {}).get("inpaint_mode", False))
    state = {
        "model": convert_unet(model_sd, sd_first_conv=sd_first_conv, restorable=not inpaint),
        "autoencoder": convert_vae(ckpt["autoencoder"]),
        "text_encoder": convert_clip_text(_strip_prefix(ckpt["text_encoder"], "transformer.")),
    }
    return state, config


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_gligen_torch_checkpoint(
    path: str, sd_first_conv_path: Optional[str] = None, use_ema: bool = False
) -> Tuple[StateDicts, Dict[str, Any]]:
    """A released GLIGEN ``.pth`` -> ``gligen_state_dicts`` of it, the SD
    first conv read from ``sd_first_conv_path`` when that file exists."""
    sd_conv = None
    if sd_first_conv_path and os.path.exists(sd_first_conv_path):
        sd_conv = _load(sd_first_conv_path)
    return gligen_state_dicts(_load(path), sd_first_conv=sd_conv, use_ema=use_ema)


def official_sd_state_dicts(ckpt: Mapping[str, Any]) -> StateDicts:
    """A loaded official SD checkpoint (``sd-v1-4.ckpt``) -> the 3-way port
    state dicts; its UNet is a restorable 4-channel one."""
    split = split_official_sd_ckpt(ckpt.get("state_dict", ckpt))
    return {
        "model": convert_unet(split["model"]),
        "autoencoder": convert_vae(split["autoencoder"]),
        "text_encoder": convert_clip_text(_strip_prefix(split["text_encoder"], "transformer.")),
    }


def load_official_sd_checkpoint(path: str) -> StateDicts:
    """``sd-v1-4.ckpt`` -> ``official_sd_state_dicts`` of it."""
    return official_sd_state_dicts(_load(path))
