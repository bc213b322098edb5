"""LPIPS for the fidelity gate (counterpart of ``gligen_tpu/eval/lpips.py``).

The canonical LPIPS runs an ImageNet-trained VGG or AlexNet, whose weights
are not in the repository.  Two backbones feed the same aggregation
(``metrics.lpips_distance``):

* ``conv``: ``PerceptualConvStack``, a VGG-shaped pyramid of 3 x 3 convs
  with seeded random filters (a ``torch.Generator``), a perceptual proxy
  that needs no asset: it grows with the strength of a corruption and sees
  where it is;
* ``clip``: the patch grids of chosen layers of the port's CLIP ViT-L/14
  vision tower (``models/clip_vision.py``), once real weights are loaded.

Distances are fp32 with TF32 off, on the backbone's device.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gligen_tpu_torch.eval.metrics import image_names, lpips_distance, read_image
from gligen_tpu_torch.ops.basic import tf32_off

# ImageNet's normalisation (the canonical LPIPS "scaling layer")
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
_TRUNC_STD = 0.87962566103423978  # flax's lecun_normal: a normal truncated at 2 std


class PerceptualConvStack(nn.Module):
    """A VGG-shaped pyramid: per stage two SAME 3 x 3 convs with ReLU, the
    stage's map kept, then a 2 x 2 average pool.  forward: NHWC images ->
    the stages' NHWC maps.  The convs are ``conv_{i}a`` and ``conv_{i}b``,
    the JAX module's names (so ``convert/from_jax.py:state_dict_from_jax``
    carries its flax parameters across); the weights are lecun-normal from
    a generator seeded with ``seed``, the biases zero."""

    def __init__(self, features: Sequence[int] = (64, 128, 256, 512, 512), seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.stages = len(features)
        cin = 3
        for i, ch in enumerate(features):
            for part, c_in in (("a", cin), ("b", ch)):
                conv = nn.Conv2d(c_in, ch, 3, padding=1)
                std = (9 * c_in) ** -0.5 / _TRUNC_STD
                with torch.no_grad():
                    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=gen)
                    conv.bias.zero_()
                self.add_module(f"conv_{i}{part}", conv)
            cin = ch

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        feats = []
        for i in range(self.stages):
            x = F.relu(getattr(self, f"conv_{i}a")(x))
            x = F.relu(getattr(self, f"conv_{i}b")(x))
            feats.append(x.permute(0, 2, 3, 1))
            if i + 1 < self.stages:  # no pool after the last stage: a 1 x 1 map has none
                x = F.avg_pool2d(x, 2)
        return feats


def make_lpips_fn(
    backbone: str = "conv",
    *,
    module: Optional[nn.Module] = None,
    clip_layers: Sequence[int] = (2, 6, 12, 18, 23),
    seed: int = 0,
    device="cuda",
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """``(a, b) -> (B,) LPIPS`` over NHWC images in [0, 1].

    backbone "conv": ``module`` a ``PerceptualConvStack`` (one seeded with
    ``seed`` when None), moved to ``device``; "clip": ``module`` the
    port's ``CLIPVisionModel`` with its weights, on its own device, and
    ``clip_layers`` the layers whose patch grids are compared."""
    if backbone == "conv":
        model = (module or PerceptualConvStack(seed=seed)).to(device).eval()
        mean, std = (torch.from_numpy(v).to(device) for v in (_MEAN, _STD))

        def stack(x):
            return model((x - mean) / std)

    elif backbone == "clip":
        if module is None:
            raise ValueError("backbone='clip' needs the vision tower as module")
        from gligen_tpu_torch.models.clip_vision import clip_preprocess

        model = module.eval()
        device = next(model.parameters()).device
        size = model.grid * model.patch_embedding.patch

        def stack(x):
            _, _, hidden = model(clip_preprocess(x, size=size), output_hidden_states=True)
            return [hidden[i] for i in clip_layers]

    else:
        raise ValueError(f"unknown LPIPS backbone {backbone!r}")

    @torch.no_grad()
    def fn(a, b) -> np.ndarray:
        a, b = (torch.as_tensor(np.asarray(x, np.float32), device=device) for x in (a, b))
        with tf32_off():
            return lpips_distance(stack(a), stack(b)).float().cpu().numpy()

    return fn


def lpips_over_folders(folder_a: str, folder_b: str, lpips_fn: Optional[Callable] = None,
                       batch_size: int = 8) -> float:
    """The mean LPIPS over the image pairs of the same name in two folders
    (PNG or JPEG, read by the port's decoders); ``lpips_fn`` by default the
    seeded "conv" proxy on the card."""
    lpips_fn = lpips_fn or make_lpips_fn()
    names_b = set(image_names(folder_b))
    common = [n for n in image_names(folder_a) if n in names_b]
    if not common:
        raise ValueError(f"no aligned image pairs between {folder_a} and {folder_b}")
    vals = []
    for i in range(0, len(common), batch_size):
        chunk = common[i:i + batch_size]
        a = np.stack([read_image(os.path.join(folder_a, n)) for n in chunk])
        b = np.stack([read_image(os.path.join(folder_b, n)) for n in chunk])
        vals.append(lpips_fn(a, b))
    return float(np.concatenate(vals).mean())
