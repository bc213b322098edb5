"""Evaluation metrics (counterpart of ``gligen_tpu/eval/metrics.py``).

* The Frechet distance over feature Gaussians (the FID core) in numpy, the
  matrix square root by ``eigh`` of the symmetrised product, with any
  (B, H, W, 3) -> (B, D) feature function (CLIP-FID through
  ``clip_feature_fn``: InceptionV3's weights are not in the repository).
* PSNR, SSIM and the LPIPS aggregation on torch tensors, in fp32, on the
  tensors' device.

Images are NHWC in [0, 1]; a folder's images are read by the port's PNG
and JPEG decoders (``data/png.py:open_image``), with no PIL.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gligen_tpu_torch.data import png

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def image_names(folder: str) -> list:
    """The sorted PNG and JPEG file names of ``folder``."""
    return sorted(f for f in os.listdir(folder) if f.lower().endswith(IMAGE_SUFFIXES))


def read_image(path: str) -> np.ndarray:
    """An image file as float32 (H, W, 3) in [0, 1]."""
    return png.open_image(path, "RGB").astype(np.float32) / 255.0


def folder_images(folder: str) -> Iterator[np.ndarray]:
    """``read_image`` of each of ``image_names(folder)``, in order."""
    for name in image_names(folder):
        yield read_image(os.path.join(folder, name))


# --------------------------------------------------------------- FID core

def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an (N, D) feature matrix."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """The square root of a (near-)PSD symmetric matrix by ``eigh``."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), the trace of
    sqrt(S1 S2) taken in the symmetric form sqrt(sqrt(S1) S2 sqrt(S1))."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    return frechet_distance(*gaussian_stats(real), *gaussian_stats(fake))


def fid_from_folders(
    real: Union[str, Iterable[np.ndarray]],
    fake: Union[str, Iterable[np.ndarray]],
    feature_fn: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 32,
) -> float:
    """The FID of two image sets, each a folder (read by ``folder_images``)
    or an iterable of (H, W, 3) images in [0, 1]; ``feature_fn``: (B, H, W,
    3) in [0, 1] -> (B, D)."""

    def collect(images):
        images = folder_images(images) if isinstance(images, str) else images
        feats, buf = [], []
        for img in images:
            buf.append(img)
            if len(buf) == batch_size:
                feats.append(np.asarray(feature_fn(np.stack(buf))))
                buf = []
        if buf:
            feats.append(np.asarray(feature_fn(np.stack(buf))))
        return np.concatenate(feats, axis=0)

    return fid_from_features(collect(real), collect(fake))


# ------------------------------------------------------------ image metrics

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def psnr(a, b, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio per batch element; inputs (..., H, W, C)."""
    mse = ((_f32(a) - _f32(b)) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range**2 / mse.clamp_min(1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def ssim(a, b, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM per batch element of NHWC images (Wang et al.'s defaults:
    an 11 x 11 Gaussian window of sigma 1.5 over VALID positions, k1 0.01,
    k2 0.03)."""
    a, b = _f32(a), _f32(b)
    win = _gaussian_window()
    c = a.shape[-1]
    kernel = torch.from_numpy(np.outer(win, win)).to(a.device).expand(c, 1, -1, -1)

    def blur(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=c).permute(0, 2, 3, 1)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a**2
    var_b = blur(b * b) - mu_b**2
    cov = blur(a * b) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1)
                                                     * (var_a + var_b + c2))
    return s.mean(dim=(-3, -2, -1))


# ------------------------------------------------------------------- LPIPS

def lpips_distance(feats_a: Sequence[torch.Tensor], feats_b: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """The LPIPS aggregation of backbone feature pairs (NHWC): each layer's
    channels unit-normalised, the mean squared channel distance over the
    positions, times the channels, summed over the layers (the "baseline"
    LPIPS, linear weights 1)."""
    total = 0.0
    for fa, fb in zip(feats_a, feats_b):
        na = fa / torch.linalg.vector_norm(fa, dim=-1, keepdim=True).clamp_min(1e-10)
        nb = fb / torch.linalg.vector_norm(fb, dim=-1, keepdim=True).clamp_min(1e-10)
        total = total + ((na - nb) ** 2).mean(dim=(-3, -2, -1)) * fa.shape[-1]
    return total


def clip_feature_fn(vision_model) -> Callable[[np.ndarray], np.ndarray]:
    """CLIP-FID's feature function on the port's vision tower
    (``models/clip_vision.py``, on its parameters' device): (B, H, W, 3)
    in [0, 1] -> the (B, projection_dim) image embeddings."""
    from gligen_tpu_torch.models.clip_vision import clip_preprocess

    device = next(vision_model.parameters()).device
    size = vision_model.grid * vision_model.patch_embedding.patch  # 224 for ViT-L/14

    @torch.no_grad()
    def fn(images: np.ndarray) -> np.ndarray:
        pixels = clip_preprocess(torch.as_tensor(np.asarray(images, np.float32), device=device),
                                 size=size)
        embeds, _ = vision_model(pixels)
        return embeds.float().cpu().numpy()

    return fn
