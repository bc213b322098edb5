"""Components from a reference checkpoint: the checkpoint half of
``gligen_tpu/inference/cli.py`` (``_vae_config_from_reference`` :260-279
and ``build_pipeline``'s checkpoint branch :313-332).

Checkpoints are self-describing: the UNet's keywords, the first stage's
``ddconfig`` and the diffusion schedule ride in the embedded config, and
the reference instantiates all its modules from it
(gligen_inference.py:72-77).  The tokenizer, the scenarios and the rest of
the command line are ROADMAP M10.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.training.checkpoints import gligen_state_dicts

SCHEDULE_KEYS = ("timesteps", "linear_start", "linear_end")


def _vae_config_from_reference(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's AutoencoderKL config section -> ``AutoencoderKL``
    keywords: ``embed_dim``/``scale_factor`` from ``params``, the rest from
    ``params.ddconfig``; a key not there keeps the SD-1.4 default."""
    p = dict(cfg.get("params", {}) or {})
    dd = dict(p.get("ddconfig", {}) or {})
    out: Dict[str, Any] = {k: p[k] for k in ("embed_dim", "scale_factor") if k in p}
    out.update({k: dd[k] for k in ("ch", "num_res_blocks", "resolution", "z_channels", "out_ch")
                if k in dd})
    out.update({k: tuple(dd[k]) for k in ("ch_mult", "attn_resolutions") if k in dd})
    return out


def components_from_checkpoint(
    ckpt: Mapping[str, Any],
    sd_first_conv: Optional[Mapping[str, Any]] = None,
    use_ema: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
    text_config: Optional[Dict[str, Any]] = None,
) -> GligenComponents:
    """A loaded reference GLIGEN checkpoint (``torch.load`` of the ``.pth``,
    or the same dict in memory) -> its ``GligenComponents`` on ``device``
    (the card unless the caller asks for the CPU): the architecture and
    schedule of its embedded config, every weight loaded strictly (a
    missing or unexpected tensor raises).  The config does not carry the
    text encoder's size (every released checkpoint has CLIP ViT-L/14's):
    ``text_config`` sets another one."""
    state, config = gligen_state_dicts(ckpt, sd_first_conv=sd_first_conv, use_ema=use_ema)
    unet_config = dict(config.get("model", {}).get("params", {}))
    unet_config.pop("image_size", None)
    unet_config.pop("use_checkpoint", None)
    diffusion = config.get("diffusion", {}).get("params", {})
    comps = GligenComponents.create(
        unet_config=unet_config, dtype=dtype, device=device, text_config=text_config,
        vae_config=_vae_config_from_reference(config.get("autoencoder", {})),
        schedule_config={k: v for k, v in diffusion.items() if k in SCHEDULE_KEYS},
    )
    for key, module in (("model", comps.unet), ("autoencoder", comps.vae),
                        ("text_encoder", comps.text_encoder)):
        module.load_state_dict(state[key], strict=True)
    return comps
