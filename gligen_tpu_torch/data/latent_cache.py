"""Offline VAE-latent cache for training (counterpart of
``gligen_tpu/data/latent_cache.py``).

The frozen VAE encode of a training image is deterministic given the TSV
row and the flip bit (``center_crop_arr`` draws nothing), so its posterior
moments can be computed once, offline (``tools/prepare_latents.py``); the
train step then samples ``z = (mean + exp(0.5 logvar) eps) * scale_factor``
from them (``training/train_step.py``), the same loss as the live encode
for the same draws.

Layout on disk, the JAX package's:

  <out>.npy   fp32 (N, 2, h, w, 2z): dim 1 is the orientation (0 as
              stored, 1 flipped horizontally), the last axis mean | logvar
              as ``AutoencoderKL.encode_moments`` gives them.
  <out>.json  {"image_size", "n", "latent_hw", "z_channels",
               "params_digest", "tsv"}: the digest guards against training
              on moments of other VAE weights.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from gligen_tpu_torch.data.transforms import center_crop_arr
from gligen_tpu_torch.data.tsv import TSVFile, decode_item


def _jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    """A parameter in the JAX package's layout (``convert/from_jax.py``
    inverted): Dense (I, O), Conv HWIO."""
    arr = t.detach().float().cpu().numpy()
    if name.endswith(".weight") and arr.ndim == 2:
        return arr.T
    if name.endswith(".weight") and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    return arr


def params_digest(module: nn.Module) -> str:
    """Cheap fingerprint of the VAE's weights: the float64 sum of every
    parameter and their count.  Equal to the JAX package's for the same
    weights: each tensor summed in its JAX layout, in the JAX tree's order
    (the names' parts sorted; each of the VAE's convs and norms has a bias
    and one weight, whose JAX names "kernel"/"scale" sort after "bias" as
    "weight" does)."""
    params = sorted(module.named_parameters(), key=lambda kv: tuple(kv[0].split(".")))
    total = 0.0
    for name, p in params:
        total += float(np.float64(np.sum(np.asarray(_jax_layout(name, p), np.float64))))
    return f"{len(params)}:{total:.6e}"


def write_latent_cache(
    tsv_path: str,
    out_path: str,
    vae: nn.Module,
    image_size: int = 512,
    batch: int = 8,
    max_images: Optional[int] = None,
    progress: bool = False,
) -> str:
    """Encode every TSV row's center-cropped image (both orientations)
    through the frozen VAE on its parameters' device and write the
    moments cache: one encode of 2 * ``batch`` images per call."""
    tsv = TSVFile(tsv_path)
    n = len(tsv)
    if max_images:
        n = min(n, max_images)
    device = next(vae.parameters()).device
    out = None
    for start in range(0, n, batch):
        rows = []
        for i in range(start, min(start + batch, n)):
            _, payload = tsv[i][:2]
            arr, _ = center_crop_arr(decode_item(payload)["image"], image_size)
            arr = arr.astype(np.float32) / 127.5 - 1.0
            rows.append(arr)
            rows.append(arr[:, ::-1])
        with torch.no_grad():
            mean, logvar = vae.encode_moments(torch.from_numpy(np.stack(rows)).to(device))
            m = torch.cat([mean, logvar], dim=-1).float().cpu().numpy()
        if out is None:
            h, w, c = m.shape[1:]
            out = np.lib.format.open_memmap(
                out_path, mode="w+", dtype=np.float32, shape=(n, 2, h, w, c))
        out[start : start + m.shape[0] // 2] = m.reshape(-1, 2, *m.shape[1:])
        if progress:
            print(f"latent cache: {min(start + batch, n)}/{n}", flush=True)
    if out is None:
        raise ValueError(f"{tsv_path} has no row")
    out.flush()

    meta = {
        "image_size": image_size,
        "n": int(n),
        "latent_hw": [int(out.shape[2]), int(out.shape[3])],
        "z_channels": int(out.shape[4]) // 2,
        "params_digest": params_digest(vae),
        "tsv": os.path.basename(tsv_path),
    }
    with open(_meta_path(out_path), "w") as f:
        json.dump(meta, f, indent=1)
    return out_path


def _meta_path(npy_path: str) -> str:
    return npy_path[: -len(".npy")] + ".json" if npy_path.endswith(".npy") else npy_path + ".json"


class LatentCache:
    """mmap'd reader: ``cache.get(row_index, flipped)`` -> (h, w, 2z) fp32."""

    def __init__(self, npy_path: str, expect_image_size: Optional[int] = None):
        self.path = npy_path
        self.arr = np.load(npy_path, mmap_mode="r")
        if self.arr.ndim != 5 or self.arr.shape[1] != 2:
            raise ValueError(f"latent cache {npy_path}: shape {self.arr.shape}, "
                             "expected (N, 2, h, w, 2z)")
        self.meta = {}
        mp = _meta_path(npy_path)
        if os.path.exists(mp):
            with open(mp) as f:
                self.meta = json.load(f)
        if expect_image_size is not None and self.meta.get("image_size") not in (
            None, expect_image_size,
        ):
            raise ValueError(
                f"latent cache {npy_path} was built at image_size="
                f"{self.meta['image_size']}, dataset wants {expect_image_size}"
            )

    def __len__(self) -> int:
        return self.arr.shape[0]

    def get(self, index: int, flipped: bool) -> np.ndarray:
        return np.asarray(self.arr[index, 1 if flipped else 0], np.float32)


def cache_path_for(tsv_path: str, cache_dir: str) -> str:
    stem = os.path.splitext(os.path.basename(tsv_path))[0]
    return os.path.join(cache_dir, stem + ".latents.npy")
