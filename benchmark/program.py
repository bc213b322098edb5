"""The system under test, ``gligen_tpu_torch``, as the benchmark builds
it: its modules on the meta device, moved to the card empty and loaded
with the benchmark's weights (as a checkpoint is loaded), in the
configuration's compute dtype over fp32 parameters.  Everything the
benchmark takes from the program passes through here or through the
wrappers of ``spans.py``."""

from __future__ import annotations

import os
from typing import Dict

import torch

from benchmark.reference import model as M
from benchmark.reference import params as ref_params
from benchmark.weights import select


def all_shapes(cfg: Dict) -> Dict:
    """Every weight of the configuration, by the program's module
    (``unet.``, ``vae.``, ``text.``)."""
    out = {}
    text = cfg.get("text", M.TEXT)
    for prefix, shapes in (("unet", ref_params.unet_shapes(cfg["unet"])),
                           ("vae", ref_params.vae_shapes(cfg.get("vae", M.VAE))),
                           ("text", ref_params.clip_shapes(d=text["hidden_size"],
                                                           layers=text["layers"]))):
        out.update({f"{prefix}.{k}": v for k, v in shapes.items()})
    return out


def apply_env(cfg: Dict) -> None:
    """The program's switches as the configuration states them."""
    os.environ.update({k: str(v) for k, v in cfg["program"]["env"].items()})


def build(cfg: Dict, weights: Dict[str, torch.Tensor], device, use_checkpoint: bool = False):
    """The port's ``GligenComponents`` with ``weights`` loaded strictly:
    a parameter the benchmark did not make, or one of another shape, is
    an error."""
    from gligen_tpu_torch.diffusion.schedule import DiffusionSchedule
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.models.clip_text import CLIPTextModel
    from gligen_tpu_torch.models.unet import UNetModel
    from gligen_tpu_torch.models.vae import AutoencoderKL

    dtype = getattr(torch, cfg["program"]["compute_dtype"])
    unet_cfg = {k: v for k, v in cfg["unet"].items() if k not in ("image_size",)}
    with torch.device("meta"):
        modules = {"unet": UNetModel(dtype=dtype, use_checkpoint=use_checkpoint, **unet_cfg),
                   "vae": AutoencoderKL(dtype=dtype, **cfg.get("vae", M.VAE)),
                   "text": CLIPTextModel(dtype=dtype, **cfg.get("text", M.TEXT))}
    for prefix, module in modules.items():
        module.to_empty(device=device)
        part = select(weights, prefix)
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        want = {k: tuple(v.shape) for k, v in part.items()}
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))[:8]
            raise RuntimeError(f"the program's {prefix} parameters differ from the "
                               f"configuration's: {diff}")
        module.load_state_dict(part, strict=True)
        module.eval()
    schedule = DiffusionSchedule.create(**cfg["schedule"])
    return GligenComponents(modules["unet"], modules["vae"], modules["text"], schedule)
