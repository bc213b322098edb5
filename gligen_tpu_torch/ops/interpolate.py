"""Image resizing with ``F.interpolate``'s semantics, as two matmuls
(counterpart of ``gligen_tpu/ops/interpolate.py``).

Every resize of the model has static shapes, so the (out, in)
interpolation matrices are built once on the host in numpy (torch's
bicubic kernel, A = -0.75, with border clamping; bilinear; nearest;
align_corners=False) and applied as two fp32 products over an NHWC
tensor.  The matrices are the JAX package's, so the port's resize equals
the JAX one to fp32 rounding, which ``F.interpolate`` (a gather with its
own sum order) would not guarantee.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from gligen_tpu_torch.ops.basic import tf32_off


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel, torch's A=-0.75 variant."""
    at = np.abs(t)
    w1 = (a + 2) * at**3 - (a + 3) * at**2 + 1
    w2 = a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a
    return np.where(at <= 1, w1, np.where(at < 2, w2, 0.0))


@lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, mode: str) -> np.ndarray:
    """(n_out, n_in) row-stochastic interpolation matrix, align_corners=False."""
    if mode == "nearest":
        # torch 'nearest': src = floor(i * n_in / n_out)
        idx = np.minimum((np.arange(n_out) * n_in // n_out), n_in - 1)
        m = np.zeros((n_out, n_in), dtype=np.float32)
        m[np.arange(n_out), idx] = 1.0
        return m

    scale = n_in / n_out
    coords = (np.arange(n_out) + 0.5) * scale - 0.5
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if mode == "bilinear":
        lo = np.floor(coords).astype(int)
        frac = coords - lo
        for tap, w in ((lo, 1 - frac), (lo + 1, frac)):
            np.add.at(m, (np.arange(n_out), np.clip(tap, 0, n_in - 1)), w)
    elif mode == "bicubic":
        base = np.floor(coords).astype(int)
        frac = coords - base
        for k in range(-1, 3):
            tap = base + k
            w = _cubic_kernel(frac - k)
            np.add.at(m, (np.arange(n_out), np.clip(tap, 0, n_in - 1)), w)
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return m.astype(np.float32)


def resize_2d(x: torch.Tensor, out_hw: Tuple[int, int], mode: str = "bicubic") -> torch.Tensor:
    """Resize an NHWC tensor to (out_h, out_w): out = M_h @ x @ M_w^T per
    (batch, channel), in fp32 with TF32 off whatever the caller's switches
    (the JAX package runs these products at HIGHEST precision); returns
    x's dtype."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow) and mode != "bicubic":
        return x
    mh = torch.from_numpy(_resize_matrix(h, oh, mode)).to(x.device)
    mw = torch.from_numpy(_resize_matrix(w, ow, mode)).to(x.device)
    with tf32_off():
        y = torch.einsum("oh,bhwc->bowc", mh, x.float())
        y = torch.einsum("pw,bowc->bopc", mw, y)
    return y.to(x.dtype)
