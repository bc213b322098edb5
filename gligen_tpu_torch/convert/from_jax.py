"""Weight bridge: ``gligen_tpu`` parameter trees -> the port's state dicts.

The port's modules carry the JAX parameter paths as their names, so each
leaf maps mechanically:

  * Dense ``kernel`` (I, O)  -> Linear ``weight`` (O, I)
  * Conv ``kernel`` HWIO     -> Conv2d ``weight`` OIHW
  * norm ``scale``           -> ``weight``
  * Embed ``embedding``      -> ``weight``
  * everything else (biases, fuser alphas, null features) as it is

``first_conv_sd`` (the restorable SD first conv, which only the JAX
package and this port have) is an ordinary conv leaf.  Subtrees the port
does not have yet are skipped by an explicit list, never silently: the
load is ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# top-level JAX subtrees with no counterpart in the port, per component
SKIPPED: Dict[str, Tuple[str, ...]] = {
    "model": (),
    "autoencoder": (),
    "text_encoder": (),
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def state_dict_from_jax(params: Mapping[str, Any], skip: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """One component's nested parameter tree (numpy or JAX arrays) -> a
    torch state dict, leaving out the top-level subtrees in ``skip``."""
    out = {}
    for path, leaf in _leaves(params):
        if path[0] in skip:
            continue
        arr = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'.'.join(path)}: kernel of rank {arr.ndim}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(arr, order="C"))
    return out


def load_jax_params(components, params: Mapping[str, Mapping[str, Any]]) -> None:
    """Load ``GligenComponents.params`` of the JAX package ({"model",
    "autoencoder", "text_encoder"}) into the port's components, strictly."""
    modules: Dict[str, nn.Module] = {
        "model": components.unet,
        "autoencoder": components.vae,
        "text_encoder": components.text_encoder,
    }
    for key, module in modules.items():
        module.load_state_dict(state_dict_from_jax(params[key], SKIPPED[key]), strict=True)
