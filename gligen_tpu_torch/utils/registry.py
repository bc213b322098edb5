"""Typed component registry (counterpart of ``gligen_tpu/utils/registry.py``).

The reference wires its pluggable components through dotted-path
reflection (``instantiate_from_config``).  The config surface stays
``{"target": name, "params": {...}}``, but targets resolve through an
explicit registry, and a registered entry carries the reference's dotted
names as aliases, so the reference's configs (those embedded in its
checkpoints) load as they are.  Torch-free: the defining modules register.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """Name -> constructor registry with legacy-alias support."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, *aliases: str) -> Callable:
        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            for key in (name, *aliases):
                if key in self._entries:
                    raise KeyError(f"{self.kind}: duplicate registration {key!r}")
                self._entries[key] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"{self.kind}: unknown target {name!r}. Known: {known}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries


# The grounding tokenizers, downsamplers, input adapters and training
# datasets, registered by their modules; the other kinds of the JAX
# package's registry come with the modules that use them.
GROUNDING_NETS = Registry("grounding_tokenizer")
DOWNSAMPLERS = Registry("grounding_downsampler")
INPUT_ADAPTERS = Registry("grounding_input")
DATASETS = Registry("dataset")
