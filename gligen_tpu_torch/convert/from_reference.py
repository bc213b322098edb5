"""Reference checkpoints -> the port's state dicts (counterpart of
``gligen_tpu/convert/torch_to_jax.py``).

The reference's released checkpoints are torch state dicts keyed by its
module paths.  The port's module names are the JAX parameter paths, so the
key map is the JAX converter's, without its layout transposes:

  * ``to_out.0`` -> ``to_out`` (the Sequential index flax flattens away);
  * numeric path parts merge into the name before them
    (``input_blocks.3.0`` -> ``input_blocks_3_0``);
  * the VAE's levels flatten (``down.0.block.1`` -> ``down_0_block_1``,
    ``down.0.downsample`` -> ``down_0_downsample``, ``mid.block_1`` ->
    ``mid_block_1``);
  * CLIP's ``text_model.embeddings.`` / ``text_model.encoder.`` /
    ``text_model.`` prefixes go (``vision_model.`` ones for the vision
    tower), ``mlp.fc`` -> ``mlp_fc``, and the ``position_ids`` buffer is
    dropped.

Layouts: Linear (O, I) and Conv2d (O, I, kh, kw) stay as they are (the
port's modules are torch's); the 1x1 convs that the port runs as Dense
(``proj_in``/``proj_out`` of a SpatialTransformer, the VAE attention's
``q``/``k``/``v``/``proj_out``) become (O, I); norm weights, embeddings,
biases and the fuser gates stay.  Tensors keep their device and dtype, and
a tensor that needs no layout change is passed on as it is.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

# the 1x1 convs the port runs as Dense layers
_CONV_AS_DENSE_NAMES = {"proj_in", "proj_out", "q", "k", "v"}


def _tensor(t: Any) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(t)


def reference_key_to_port(key: str, tensor: Any) -> Tuple[str, torch.Tensor]:
    """One reference state-dict key and tensor -> (port name, tensor)
    (torch_to_jax.py:45-84)."""
    t = _tensor(tensor)
    key = key.replace("to_out.0.", "to_out.")
    parts = key.split(".")
    merged: list = []
    for p in parts[:-1]:
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    if (parts[-1] == "weight" and t.dim() == 4 and merged and merged[-1] in _CONV_AS_DENSE_NAMES
            and tuple(t.shape[2:]) == (1, 1)):
        t = t[:, :, 0, 0]
    return ".".join(merged + [parts[-1]]), t


def convert_state_dict(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference state dict -> the port's names and layouts."""
    return dict(reference_key_to_port(k, v) for k, v in state.items())


def convert_vae(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An AutoencoderKL state dict (CompVis names, torch_to_jax.py:100-113)."""
    renamed = {}
    for k, v in state.items():
        k = re.sub(r"\b(down|up)\.(\d+)\.(block|attn)\.(\d+)\.", r"\1_\2_\3_\4.", k)
        k = re.sub(r"\b(down|up)\.(\d+)\.(downsample|upsample)\.", r"\1_\2_\3.", k)
        renamed[k.replace("mid.", "mid_")] = v
    return convert_state_dict(renamed)


def convert_clip_text(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF CLIPTextModel state dict, the ``transformer.`` prefix already
    stripped (torch_to_jax.py:116-128)."""
    renamed = {}
    for k, v in state.items():
        if "position_ids" in k:
            continue  # a buffer, not a parameter
        for prefix in ("text_model.embeddings.", "text_model.encoder.", "text_model."):
            k = k.replace(prefix, "")
        renamed[k.replace("mlp.fc", "mlp_fc")] = v
    return convert_state_dict(renamed)


def convert_clip_vision(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF CLIPVisionModelWithProjection state dict, the image tower of
    box+text+image grounding (torch_to_jax.py:131-143): the
    ``vision_model.embeddings.`` / ``vision_model.encoder.`` /
    ``vision_model.`` prefixes go, ``mlp.fc`` -> ``mlp_fc``, and the
    ``position_ids`` buffer is dropped."""
    renamed = {}
    for k, v in state.items():
        if "position_ids" in k:
            continue
        for prefix in ("vision_model.embeddings.", "vision_model.encoder.", "vision_model."):
            k = k.replace(prefix, "")
        renamed[k.replace("mlp.fc", "mlp_fc")] = v
    return convert_state_dict(renamed)


def convert_unet(
    state: Mapping[str, Any],
    sd_first_conv: Optional[Mapping[str, Any]] = None,
    restorable: bool = True,
) -> Dict[str, torch.Tensor]:
    """A GLIGEN UNet state dict (torch_to_jax.py:146-167).  A restorable UNet
    (not an inpaint one) also gets ``first_conv_sd``, the original SD first
    conv the gate-0 steps switch to: from ``sd_first_conv`` (the reference's
    ``SD_input_conv_weight_bias.pth``: weight, bias) when given, else the
    first 4 input channels of the GLIGEN conv (exact where that conv was
    not widened).  An inpaint UNet has no such conv, so gets none."""
    out = convert_state_dict(state)
    if not restorable:
        return out
    if sd_first_conv is not None:
        out["first_conv_sd.weight"] = _tensor(sd_first_conv["weight"])
        out["first_conv_sd.bias"] = _tensor(sd_first_conv["bias"])
    elif "input_blocks_0_0.weight" in out:
        out["first_conv_sd.weight"] = out["input_blocks_0_0.weight"][:, :4]
        out["first_conv_sd.bias"] = out["input_blocks_0_0.bias"]
    return out


def split_official_sd_ckpt(state: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The 4-way split of an official SD checkpoint by key prefix
    (torch_to_jax.py:170-185)."""
    out: Dict[str, Dict[str, Any]] = {
        "model": {}, "autoencoder": {}, "text_encoder": {}, "diffusion": {}, "others": {}
    }
    prefixes = (("model.diffusion_model.", "model"), ("first_stage_model.", "autoencoder"),
                ("cond_stage_model.", "text_encoder"))
    for k, v in state.items():
        for prefix, part in prefixes:
            if k.startswith(prefix):
                out[part][k[len(prefix):]] = v
                break
        else:
            out["others"][k] = v
    return out
