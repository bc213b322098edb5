"""Random weights of a configuration, made on the device from the seed in
one draw: one standard-normal vector for every parameter, cut into the
parameters (in name order) and shaped by kind.

  * matrices and conv kernels: N(0, 1 / fan_in), fan_in the product of
    the dimensions after the first (the zero-initialised output convs
    too, so that every layer moves the output);
  * biases: N(0, 0.02^2); norm scales: 1 + N(0, 0.1^2);
  * the fusers' gates ``alpha_attn`` / ``alpha_dense``: 0.5;
  * the tokenizers' null features: N(0, 1); the position embedding:
    N(0, 0.1^2); ConvNeXt's layer scales ``gamma``: 0.5 + N(0, 0.1^2).

The program and the reference are handed the same values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    names = sorted(shapes)
    sizes = [max(1, _numel(shapes[n])) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    with torch.no_grad():
        for name, size in zip(names, sizes):
            shape = shapes[name]
            z = flat[at:at + size].view(shape)
            at += size
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("alpha_attn", "alpha_dense"):
                z.fill_(0.5)
            elif leaf.startswith("null_"):
                pass
            elif leaf == "pos_embedding":
                z.mul_(0.1)
            elif leaf == "gamma":
                z.mul_(0.1).add_(0.5)
            elif leaf == "bias":
                z.mul_(0.02)
            elif len(shape) == 1:
                z.mul_(0.1).add_(1.0)
            else:
                z.mul_(_numel(shape[1:]) ** -0.5)
            out[name] = z
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def select(weights: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix.``, the prefix removed."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in weights.items() if k.startswith(p)}
