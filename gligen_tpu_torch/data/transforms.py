"""Host-side image and box transforms of the training data (counterpart of
``gligen_tpu/data/transforms.py``, the reference's
dataset/base_dataset.py), on uint8 (H, W, 3) arrays instead of PIL images.

The crop resizes exactly as PIL's ``Image.resize`` with ``Image.BOX`` and
``Image.BICUBIC`` (Pillow's ``libImaging/Resample.c``), so the pixels that
train the model do not depend on whether PIL is installed: two separable
passes, horizontal then vertical; each output pixel's taps span the
filter's support widened by the downscale factor, centred at
(x + 0.5) * scale; the weights, normalised to sum 1 in double, become
integers in 22-bit fixed point rounded half away from zero; each pass sums
uint8 x weight from 2^21 (the rounding half) and clips the sum shifted
down by 22 bits to [0, 255].  A size already at the target is a copy.
``resize(..., "nearest")`` is ``Image.NEAREST`` (Geometry.c's
``ImagingScaleAffine``): source index ``int(x0)`` of a coordinate stepped
from ``scale / 2`` by repeated double additions of ``scale``.

The spatial datasets' helpers: ``center_crop_square`` (the crop of their
``_center_crop_resize``), ``to_luma`` (``convert("L")`` from RGB), and an
array flip in place of ``ImageOps.mirror``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _box(x: float) -> float:
    return 1.0 if -0.5 < x <= 0.5 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


FILTERS = {"box": (_box, 0.5), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=256)
def resample_coeffs(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """(first tap (out,), fixed-point weights (out, ksize) int32) of one
    axis, as Resample.c's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``; weights past an output's last tap are 0."""
    fn, support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        total = 0.0
        for v in w:  # in order, in double, as the C loop (not math.fsum)
            total += v
        for x, v in enumerate(w):
            v = v / total if total != 0.0 else v
            weights[xx, x] = int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0 else \
                int(0.5 + v * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, weights


@functools.lru_cache(maxsize=256)
def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel along one axis, as
    ``ImagingScaleAffine`` tabulates it (``xo += a[0]`` in double)."""
    step = in_size / out_size
    out = np.empty(out_size, np.int64)
    pos = step * 0.5
    for x in range(out_size):
        out[x] = int(pos)
        pos += step
    return out


def _pass(pixels: np.ndarray, out_size: int, kind: str, axis: int) -> np.ndarray:
    """One separable pass along ``axis`` (1: horizontal, 0: vertical)."""
    in_size = pixels.shape[axis]
    first, weights = resample_coeffs(in_size, out_size, kind)
    shape = [1] * pixels.ndim
    shape[axis] = out_size
    # int32 sums, as Resample.c's: 255 times the weights' absolute sum,
    # about 2^22, stays below 2^31
    acc = np.full(pixels.shape[:axis] + (out_size,) + pixels.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for k in range(weights.shape[1]):
        # a tap past an output's span has weight 0: clamp its index
        taps = np.take(pixels, np.minimum(first + k, in_size - 1), axis=axis)
        acc += taps.astype(np.int32) * weights[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(pixels: np.ndarray, size: Tuple[int, int], kind: str) -> np.ndarray:
    """uint8 (H, W[, C]) pixels resized to ``size`` = (width, height), as
    PIL's ``Image.resize(size, resample=Image.BOX, BICUBIC or NEAREST)``
    (``kind`` "box", "bicubic" or "nearest")."""
    w, h = size
    if (h, w) == pixels.shape[:2]:
        return pixels.copy()
    if kind == "nearest":
        rows = nearest_index(pixels.shape[0], h)
        cols = nearest_index(pixels.shape[1], w)
        return pixels[rows][:, cols]
    if w != pixels.shape[1]:
        pixels = _pass(pixels, w, kind, axis=1)
    if h != pixels.shape[0]:
        pixels = _pass(pixels, h, kind, axis=0)
    return pixels


def center_crop_arr(image: np.ndarray, image_size: int):
    """BOX-downsample by powers of two then bicubic + center crop
    (base_dataset.py:156-182); ``image`` uint8 (H, W, 3)."""
    hh, ww = image.shape[:2]
    while min(image.shape[:2]) >= 2 * image_size:
        image = resize(image, (image.shape[1] // 2, image.shape[0] // 2), "box")
    scale = image_size / min(image.shape[:2])
    image = resize(image, (round(image.shape[1] * scale), round(image.shape[0] * scale)),
                   "bicubic")
    performed_scale = image_size / min(ww, hh)
    crop_y = (image.shape[0] - image_size) // 2
    crop_x = (image.shape[1] - image_size) // 2
    info = {
        "performed_scale": performed_scale,
        "crop_y": crop_y,
        "crop_x": crop_x,
        "WW": ww,
        "HH": hh,
    }
    return image[crop_y : crop_y + image_size, crop_x : crop_x + image_size], info


def center_crop_square(pixels: np.ndarray) -> np.ndarray:
    """The centred square of side min(H, W) (spatial_datasets.py:30-37,
    torchvision's ``center_crop`` offsets)."""
    h, w = pixels.shape[:2]
    crop = min(w, h)
    left, top = (w - crop) // 2, (h - crop) // 2
    return pixels[top:top + crop, left:left + crop]


def to_luma(pixels: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> (H, W) L, PIL's ``convert("L")``: ITU-R 601-2
    luma, (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    rgb = pixels.astype(np.uint32)
    luma = (19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000) >> 16
    return luma.astype(np.uint8)


def random_crop_arr(
    image: np.ndarray,
    image_size: int,
    rng: np.random.Generator,
    min_crop_frac: float = 0.8,
    max_crop_frac: float = 1.0,
):
    """base_dataset.py:185-206 (unused by shipped configs; kept for parity)."""
    min_s = math.ceil(image_size / max_crop_frac)
    max_s = math.ceil(image_size / min_crop_frac)
    smaller = int(rng.integers(min_s, max_s + 1))
    while min(image.shape[:2]) >= 2 * smaller:
        image = resize(image, (image.shape[1] // 2, image.shape[0] // 2), "box")
    scale = smaller / min(image.shape[:2])
    image = resize(image, (round(image.shape[1] * scale), round(image.shape[0] * scale)),
                   "bicubic")
    crop_y = int(rng.integers(0, image.shape[0] - image_size + 1))
    crop_x = int(rng.integers(0, image.shape[1] - image_size + 1))
    return image[crop_y : crop_y + image_size, crop_x : crop_x + image_size]


def transform_image(
    image: np.ndarray,
    image_size: int,
    random_flip: bool,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, Dict]:
    """base_dataset.py:135-152, HWC float32 in [-1, 1]."""
    arr, info = center_crop_arr(image, image_size)
    info["performed_flip"] = False
    if random_flip and rng.random() < 0.5:
        arr = arr[:, ::-1]
        info["performed_flip"] = True
    return arr.astype(np.float32) / 127.5 - 1.0, info


def to_valid(x0, y0, x1, y1, image_size: int, min_box_size: float):
    """Clamp into the image; reject fully-cropped/too-small boxes
    (base_dataset.py:40-55)."""
    if x0 > image_size or y0 > image_size or x1 < 0 or y1 < 0:
        return False, (None, None, None, None)
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, image_size), min(y1, image_size)
    if (x1 - x0) * (y1 - y0) / (image_size * image_size) < min_box_size:
        return False, (None, None, None, None)
    return True, (x0, y0, x1, y1)


def recalculate_box_and_verify_if_valid(
    x, y, w, h, trans_info: Dict, image_size: int, min_box_size: float
):
    """Re-project an xywh box through scale/crop/flip (base_dataset.py:62-87)."""
    s = trans_info["performed_scale"]
    x0 = x * s - trans_info["crop_x"]
    y0 = y * s - trans_info["crop_y"]
    x1 = (x + w) * s - trans_info["crop_x"]
    y1 = (y + h) * s - trans_info["crop_y"]
    valid, (x0, y0, x1, y1) = to_valid(x0, y0, x1, y1, image_size, min_box_size)
    if valid and trans_info["performed_flip"]:
        x0, x1 = image_size - x1, image_size - x0
    return valid, (x0, y0, x1, y1)


def xyhw2xyxy(box):
    x0, y0, w, h = box
    return [x0, y0, x0 + w, y0 + h]


def make_a_sentence(obj_names, clean: bool = False) -> str:
    """Detection pseudo-caption "name1, name2, ..." (tsv_dataset.py:80-97)."""
    if clean:
        obj_names = [n[:-6] if "-other" in n else n for n in obj_names]
    return ", ".join(obj_names)
