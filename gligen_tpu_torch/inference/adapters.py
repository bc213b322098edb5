"""Grounding input adapters (counterpart of
``gligen_tpu/inference/adapters.py``, the reference's ``grounding_input/``).

Each adapter maps a dataset or inference batch to the keyword arguments of
its grounding tokenizer.  The null input of classifier-free guidance and of
training's grounding drop is the zero tree of those arguments, which is what
every reference adapter's ``get_null_input`` builds, so ``null_input`` is
generic.  The adapters of the spatial modalities come with those modalities
(ROADMAP M9c).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from gligen_tpu_torch.utils.registry import INPUT_ADAPTERS


class InputAdapter:
    """A batch -> tokenizer keywords map: ``key_map`` takes each tokenizer
    keyword to its batch key."""

    def __init__(self, key_map: Dict[str, str]):
        self.key_map = key_map

    def prepare(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {kw: torch.as_tensor(batch[bk]) for kw, bk in self.key_map.items()}


def null_input(grounding: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The null grounding batch: zeros of every input's shape and dtype
    (grounding_input/*_input.py get_null_input)."""
    return {k: torch.zeros_like(torch.as_tensor(v)) for k, v in grounding.items()}


_ADAPTERS = {
    "text": InputAdapter(
        {"boxes": "boxes", "masks": "masks", "positive_embeddings": "text_embeddings"}
    ),
    "text_image": InputAdapter(
        {
            "boxes": "boxes",
            "masks": "masks",
            "text_masks": "text_masks",
            "image_masks": "image_masks",
            "text_embeddings": "text_embeddings",
            "image_embeddings": "image_embeddings",
        }
    ),
    "keypoint": InputAdapter({"points": "points", "masks": "masks"}),
}

# the reference's module names, its spelling ("tokinzer") kept
_REF_PREFIX = "grounding_input."
for _name, _adapter in _ADAPTERS.items():
    _aliases = [f"{_REF_PREFIX}{_name}_grounding_tokinzer_input.GroundingNetInput"]
    if _name != "text_image":
        _aliases.append(f"{_REF_PREFIX}{_name}_grounding_downsampler_input.GroundingDSInput")
    INPUT_ADAPTERS.register(_name, *_aliases)(lambda _a=_adapter: _a)


def get_adapter(name: str) -> InputAdapter:
    """The adapter of a tokenizer name or reference alias."""
    return INPUT_ADAPTERS.get(name)()
