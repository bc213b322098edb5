"""Checkpoints (counterpart of ``gligen_tpu/training/checkpoints.py``):
reference-format loading (:38-88) and the Trainer's native save/resume
(:91-177).

The reference saves monolithic torch dicts {model, ema, autoencoder,
text_encoder, diffusion, opt, scheduler, iters, config_dict}
(trainer.py:472-484) whose embedded config describes the model
(gligen_inference.py:70-86); the official SD checkpoint is one state dict
split by key prefix (trainer.py:64-85).  Each loader is ``torch.load``
followed by a function of the loaded dict, so a checkpoint already in
memory (on any device) loads the same way.

A native training checkpoint is one ``torch.save`` file,
``<tag dir>/checkpoint_<step:08d>``, of {"step", "train_params" and
optionally "ema_params" (the trainable tensors by the UNet's parameter
names), "optimizer" (AdamW's ``state_dict``), "scheduler" (the LR
schedule's)}, beside a ``checkpoint_latest`` marker naming the newest and
the run's ``config.json``; runs resume from the newest ``tagNN`` directory
that holds one (trainer.py:126-153), as in the JAX package, whose
checkpoints are orbax trees of the same content.
"""

from __future__ import annotations

import json
import os
import re
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


# ---------------------------------------------------------- native

def save_training_checkpoint(directory: str, step: int, state: Mapping[str, Any],
                             config: Optional[Dict] = None) -> str:
    """Write ``<directory>/checkpoint_<step:08d>`` (``torch.save`` of
    ``state``, its tensors on the CPU), then ``config.json`` and the
    ``checkpoint_latest`` marker; each file is written under a temporary
    name and renamed, so a reader never sees half a file."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_{step:08d}")
    torch.save(_to_cpu(state), path + ".tmp")
    os.replace(path + ".tmp", path)
    if config is not None:
        _write_text(os.path.join(directory, "config.json"),
                    json.dumps(config, indent=2, default=str))
    _write_text(os.path.join(directory, "checkpoint_latest"), os.path.basename(path))
    return path


def _write_text(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint the marker names, else the highest-numbered one."""
    marker = os.path.join(directory, "checkpoint_latest")
    if os.path.exists(marker):
        with open(marker) as f:
            name = f.read().strip()
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return path
    steps = sorted(
        n for n in (os.listdir(directory) if os.path.isdir(directory) else [])
        if re.fullmatch(r"checkpoint_\d+", n)
    )
    return os.path.join(directory, steps[-1]) if steps else None


def restore_training_checkpoint(path: str) -> Dict[str, Any]:
    """The state ``save_training_checkpoint`` wrote, tensors on the CPU
    (tensors and plain values only: nothing is unpickled)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_training_params(path_or_dir: str, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """A native checkpoint's trainable tensors by UNet parameter name, for
    serving: ``path_or_dir`` is a checkpoint file or a tag dir (its latest
    is taken); ``use_ema`` gives the EMA shadow (trainer.py:252-257)."""
    path = path_or_dir
    if not os.path.basename(os.path.normpath(path)).startswith("checkpoint_"):
        found = latest_checkpoint(path_or_dir)
        if found is None:
            raise FileNotFoundError(f"no checkpoint_* under {path_or_dir}")
        path = found
    state = restore_training_checkpoint(path)
    key = "ema_params" if use_ema else "train_params"
    if state.get(key) is None:
        raise ValueError(f"{path} has no {key!r}"
                         + (" (trained without enable_ema)" if use_ema else ""))
    return dict(state[key])


def find_resume_dir(output_root: str, name: str) -> Tuple[str, Optional[str]]:
    """Auto-resume tag scan (trainer.py:126-153): (tag dir to use,
    checkpoint or None).  Existing tags are scanned newest first; one with
    a checkpoint is resumed in place, else a fresh tagNN is made."""
    base = os.path.join(output_root, name)
    os.makedirs(base, exist_ok=True)
    tags = sorted((t for t in os.listdir(base) if re.fullmatch(r"tag\d\d", t)), reverse=True)
    for tag in tags:
        ckpt = latest_checkpoint(os.path.join(base, tag))
        if ckpt:
            return os.path.join(base, tag), ckpt
    tag_dir = os.path.join(base, f"tag{len(tags):02d}")
    os.makedirs(tag_dir, exist_ok=True)
    return tag_dir, None
