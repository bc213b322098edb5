"""First-conv widening (counterpart of ``gligen_tpu/convert/widen.py``,
the reference's convert_ckpt.py).

Widens the UNet's GLIGEN input conv from C to C + N input channels, zeros
for the new ones: the inpainting extra (z0 * mask, mask: +5) or a grounding
downsampler's channels (trainer.py:189-194).  The port's conv weight is
OIHW, so the input channels are axis 1 (the JAX package widens axis 2 of
HWIO).
"""

from __future__ import annotations

from typing import Dict

import torch

FIRST_CONV = "input_blocks_0_0.weight"


def add_additional_channels(state: Dict[str, torch.Tensor],
                            num_additional: int) -> Dict[str, torch.Tensor]:
    """A UNet state dict whose ``input_blocks_0_0`` weight (O, C, kh, kw)
    becomes (O, C + num_additional, kh, kw), zeros for the new channels;
    every other tensor is the same object."""
    if num_additional == 0:
        return state
    w = state[FIRST_CONV]
    o, c, kh, kw = w.shape
    wide = torch.zeros((o, c + num_additional, kh, kw), dtype=w.dtype, device=w.device)
    wide[:, :c] = w
    return {**state, FIRST_CONV: wide}
