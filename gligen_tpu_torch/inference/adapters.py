"""Grounding input adapters (counterpart of
``gligen_tpu/inference/adapters.py``, the reference's ``grounding_input/``).

Each adapter maps a dataset or inference batch to the keyword arguments of
its grounding tokenizer and, for a spatial modality, takes out the map its
grounding downsampler reads (``prepare_extra``).  The null input of
classifier-free guidance and of training's grounding drop is the zero tree
of the tokenizer's arguments, which is what every reference adapter's
``get_null_input`` builds, so ``null_input`` is generic.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from gligen_tpu_torch.utils.registry import INPUT_ADAPTERS


class InputAdapter:
    """A batch -> tokenizer keywords map: ``key_map`` takes each tokenizer
    keyword to its batch key; ``extra_key`` names the batch key of the
    grounding downsampler's map, where the modality has one."""

    def __init__(self, key_map: Dict[str, str], extra_key: Optional[str] = None):
        self.key_map = key_map
        self.extra_key = extra_key

    def prepare(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {kw: torch.as_tensor(batch[bk]) for kw, bk in self.key_map.items()}

    def prepare_extra(self, batch: Mapping[str, Any]) -> Optional[torch.Tensor]:
        """The downsampler's map (``generate``'s ``grounding_extra``), or
        None for a modality without one."""
        return None if self.extra_key is None else torch.as_tensor(batch[self.extra_key])


def null_input(grounding: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The null grounding batch: zeros of every input's shape and dtype
    (grounding_input/*_input.py get_null_input).

    A spatial modality's null batch is a zeroed map (uint8 zeros, which the
    tokenizer reads as -1 everywhere) with ``mask`` 0.  That map is only
    ever read behind ``mask = 0``, where the null feature takes the place of
    every token, so its value does not matter; the downsampler never reads
    it, as its channels always come from the conditional map (the pipeline
    and the reference's ``GroundingDSInput`` null none)."""
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
    "hed": InputAdapter({"hed_edge": "hed_edge", "mask": "mask"}, extra_key="hed_edge"),
    "canny": InputAdapter({"canny_edge": "canny_edge", "mask": "mask"}, extra_key="canny_edge"),
    "depth": InputAdapter({"depth": "depth", "mask": "mask"}, extra_key="depth"),
    "normal": InputAdapter({"normal": "normal", "mask": "mask"}, extra_key="normal"),
    "sem": InputAdapter({"sem": "sem", "mask": "mask"}, extra_key="sem"),
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
