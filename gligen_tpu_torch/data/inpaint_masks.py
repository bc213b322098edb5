"""Inpainting masks (counterpart of ``gligen_tpu/data/inpaint_masks.py``,
the reference's inpaint_mask_func.py), numpy only.

``draw_masks_from_boxes`` gives the serving path's box masks; the stroke
masks (thick polylines rasterised as distance-to-segment bands with round
caps and joints, what cv2.line + cv2.circle compose to in the reference,
no cv2) are training's random fore- and background masks.

Outputs are NHWC (B, size, size, 1) float32 keep-masks: 1 = known region,
0 = the region to inpaint.  Randomness is an explicit numpy Generator.
As in the JAX package, random strokes start at (x, y), not the
reference's swapped (y, x); the stroke statistics are the same.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _disk(mask: np.ndarray, cx: float, cy: float, r: float) -> None:
    h, w = mask.shape
    y0, y1 = max(int(cy - r) - 1, 0), min(int(cy + r) + 2, h)
    x0, x1 = max(int(cx - r) - 1, 0), min(int(cx + r) + 2, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask[y0:y1, x0:x1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1.0


def _thick_segment(mask: np.ndarray, p0, p1, width: float) -> None:
    """Round-capped stroke of given width between p0=(x0,y0), p1=(x1,y1)."""
    r = width / 2.0
    x0, y0 = p0
    x1, y1 = p1
    h, w = mask.shape
    lo_y = max(int(min(y0, y1) - r) - 1, 0)
    hi_y = min(int(max(y0, y1) + r) + 2, h)
    lo_x = max(int(min(x0, x1) - r) - 1, 0)
    hi_x = min(int(max(x0, x1) + r) + 2, w)
    if lo_y >= hi_y or lo_x >= hi_x:
        return
    yy, xx = np.mgrid[lo_y:hi_y, lo_x:hi_x]
    dx, dy = x1 - x0, y1 - y0
    seg_len2 = dx * dx + dy * dy
    if seg_len2 == 0:
        t = np.zeros_like(xx, dtype=np.float64)
    else:
        t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / seg_len2, 0.0, 1.0)
    dist2 = (xx - (x0 + t * dx)) ** 2 + (yy - (y0 + t * dy)) ** 2
    mask[lo_y:hi_y, lo_x:hi_x][dist2 <= r * r] = 1.0


def np_free_form_mask(
    rng: np.random.Generator,
    max_vertex: int,
    max_length: int,
    min_brush: int,
    max_brush: int,
    max_angle: int,
    h: int,
    w: int,
) -> np.ndarray:
    """One random polyline stroke (inpaint_mask_func.py:137-158)."""
    mask = np.zeros((h, w), np.float32)
    num_vertex = rng.integers(1, max_vertex + 1)
    start_y = float(rng.integers(1, h))
    start_x = float(rng.integers(1, w))
    brush = 0
    for i in range(num_vertex):
        angle = rng.integers(1, max_angle + 1) / 360.0 * 2 * np.pi
        if i % 2 == 0:
            angle = 2 * np.pi - angle
        length = rng.integers(0, max_length + 1)
        brush = int(rng.integers(min_brush, max_brush + 1)) // 2 * 2
        next_y = float(np.clip(start_y + length * np.cos(angle), 0, h - 1))
        next_x = float(np.clip(start_x + length * np.sin(angle), 0, w - 1))
        _thick_segment(mask, (start_x, start_y), (next_x, next_y), brush)
        _disk(mask, start_x, start_y, brush // 2)
        start_y, start_x = next_y, next_x
    _disk(mask, start_x, start_y, brush // 2)
    return mask


def generate_stroke_mask(
    rng: np.random.Generator,
    im_size=(64, 64),
    max_parts: int = 10,
    max_vertex: int = 20,
    max_length: int = 100,
    min_brush: int = 10,
    max_brush: int = 24,
    max_angle: int = 360,
) -> np.ndarray:
    if min_brush > max_brush:
        raise ValueError(f"min_brush {min_brush} > max_brush {max_brush}")
    mask = np.zeros(im_size, np.float32)
    for _ in range(int(rng.integers(1, max_parts + 1))):
        mask = mask + np_free_form_mask(
            rng, max_vertex, max_length, min_brush, max_brush, max_angle, *im_size
        )
    return np.minimum(mask, 1.0)


def get_a_fg_mask(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """~75%-area object mask, drawn at 64x64 then nearest-resized
    (inpaint_mask_func.py:47-86)."""
    if height < 4 or width < 4:
        raise ValueError(f"a foreground mask needs at least 4x4, got {height}x{width}")
    mask = 1.0 - generate_stroke_mask(
        rng, (64, 64), max_parts=6, max_vertex=10, max_length=80,
        min_brush=10, max_brush=32, max_angle=360,
    )
    # nearest resize 64x64 -> (height, width): torch F.interpolate semantics
    yi = (np.arange(height) * 64 // height).clip(max=63)
    xi = (np.arange(width) * 64 // width).clip(max=63)
    return mask[np.ix_(yi, xi)]


def get_a_bg_mask(rng: np.random.Generator, size: int = 64) -> np.ndarray:
    """~30%-area whole-image mask, drawn at 64x64 then nearest-resized
    (inpaint_mask_func.py:94-115; the reference only ever uses size=64)."""
    mask = 1.0 - generate_stroke_mask(
        rng, (64, 64), max_parts=4, max_vertex=10, max_length=32,
        min_brush=3, max_brush=12, max_angle=360,
    )
    if size == 64:
        return mask
    idx = (np.arange(size) * 64 // size).clip(max=63)
    return mask[np.ix_(idx, idx)]


def draw_masks_from_boxes(
    boxes: np.ndarray,
    size: int = 64,
    randomize_fg_mask: bool = False,
    random_add_bg_mask: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Batch of latent keep-masks from normalized xyxy boxes
    (inpaint_mask_func.py:16-41).  Returns (B, size, size, 1) float32."""
    rng = rng or np.random.default_rng()
    out = np.ones((len(boxes), size, size, 1), np.float32)
    for bi, box_set in enumerate(np.asarray(boxes)):
        image_mask = out[bi, :, :, 0]
        for bx in box_set:
            x0, y0, x1, y1 = (np.asarray(bx, np.float64) * size).astype(int)
            ow, oh = x1 - x0, y1 - y0
            if randomize_fg_mask and rng.uniform() < 0.5 and oh >= 4 and ow >= 4:
                image_mask[y0:y1, x0:x1] *= get_a_fg_mask(rng, oh, ow)
            else:
                image_mask[y0:y1, x0:x1] = 0.0
        if random_add_bg_mask and rng.uniform() < 0.5:
            image_mask *= get_a_bg_mask(rng, size)
    return out
