"""The checkpoint and feature halves of ``gligen_tpu/inference/cli.py``.

Components from a reference checkpoint (``_vae_config_from_reference``
:260-279 and ``build_pipeline``'s checkpoint branch :313-332): checkpoints
are self-describing, the UNet's keywords, the first stage's ``ddconfig``
and the diffusion schedule ride in the embedded config, and the reference
instantiates all its modules from it (gligen_inference.py:72-77).

The grounding inputs of a scenario's meta (:34-227): CLIP phrase and image
features (``FeatureExtractor``) and the per-modality batches
(``prepare_batch_box`` for box+text(+image), ``prepare_batch_kp``,
``prepare_batch_spatial`` for hed/canny/depth/normal maps,
``prepare_batch_sem``), picked by ``prepare_batch_for``.  The tokenizer,
the scenarios, the command line and PNG saving are ROADMAP M10.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.models.clip_vision import clip_preprocess
from gligen_tpu_torch.training.checkpoints import gligen_state_dicts

SCHEDULE_KEYS = ("timesteps", "linear_start", "linear_end")


def _vae_config_from_reference(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's AutoencoderKL config section -> ``AutoencoderKL``
    keywords: ``embed_dim``/``scale_factor`` from ``params``, the rest from
    ``params.ddconfig``; a key not there keeps the SD-1.4 default."""
    p = dict(cfg.get("params", {}) or {})
    dd = dict(p.get("ddconfig", {}) or {})
    out: Dict[str, Any] = {k: p[k] for k in ("embed_dim", "scale_factor") if k in p}
    out.update({k: dd[k] for k in ("ch", "num_res_blocks", "resolution", "z_channels", "out_ch")
                if k in dd})
    out.update({k: tuple(dd[k]) for k in ("ch_mult", "attn_resolutions") if k in dd})
    return out


def components_from_checkpoint(
    ckpt: Mapping[str, Any],
    sd_first_conv: Optional[Mapping[str, Any]] = None,
    use_ema: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
    text_config: Optional[Dict[str, Any]] = None,
) -> GligenComponents:
    """A loaded reference GLIGEN checkpoint (``torch.load`` of the ``.pth``,
    or the same dict in memory) -> its ``GligenComponents`` on ``device``
    (the card unless the caller asks for the CPU): the architecture and
    schedule of its embedded config, every weight loaded strictly (a
    missing or unexpected tensor raises).  The config does not carry the
    text encoder's size (every released checkpoint has CLIP ViT-L/14's):
    ``text_config`` sets another one."""
    state, config = gligen_state_dicts(ckpt, sd_first_conv=sd_first_conv, use_ema=use_ema)
    unet_config = dict(config.get("model", {}).get("params", {}))
    unet_config.pop("image_size", None)
    unet_config.pop("use_checkpoint", None)
    diffusion = config.get("diffusion", {}).get("params", {})
    comps = GligenComponents.create(
        unet_config=unet_config, dtype=dtype, device=device, text_config=text_config,
        vae_config=_vae_config_from_reference(config.get("autoencoder", {})),
        schedule_config={k: v for k, v in diffusion.items() if k in SCHEDULE_KEYS},
    )
    for key, module in (("model", comps.unet), ("autoencoder", comps.vae),
                        ("text_encoder", comps.text_encoder)):
        module.load_state_dict(state[key], strict=True)
    return comps


MAX_OBJS = 30
FEATURE_DIM = 768  # CLIP ViT-L/14's text and reprojected image features
FEATURE_NORM = 28.7  # the reprojected image feature's norm (gligen_inference.py:116)


def complete_mask(has_mask, max_objs: int = MAX_OBJS) -> np.ndarray:
    """A meta's ``text_mask`` / ``image_mask`` as a (1, max_objs) mask
    (gligen_inference.py:131-141): all ones when absent, a scalar times
    ones, or a per-slot list over ones."""
    mask = np.ones((1, max_objs), np.float32)
    if has_mask is None:
        return mask
    if isinstance(has_mask, (int, float)):
        return mask * has_mask
    for idx, value in enumerate(has_mask):
        mask[0, idx] = value
    return mask


class FeatureExtractor:
    """CLIP phrase and image features (gligen_inference.py:100-127).

    ``text_feature``: the pooled CLIP text output of ``tokenizer([phrase])``
    (a callable giving (1, 77) token ids; the port's tokenizer is ROADMAP
    M10).  ``image_feature``: the vision tower's image embedding, then
    ``@ projection_matrix`` into the text-penultimate space, renormed to
    28.7.  ``allow_random`` (a smoke run without CLIP vision weights or the
    projection): a deterministic pseudo-feature of the image's pixels in
    their place.  Features come back as fp32 numpy (768,)."""

    def __init__(self, text_encoder, tokenizer: Optional[Callable[[Sequence[str]], Any]] = None,
                 vision=None, projection_matrix: Optional[np.ndarray] = None,
                 allow_random: bool = False):
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.vision = vision
        self.projection_matrix = projection_matrix
        self.allow_random = allow_random

    @torch.no_grad()
    def text_feature(self, phrase: str) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError("text_feature needs a tokenizer")
        device = next(self.text_encoder.parameters()).device
        ids = torch.as_tensor(np.asarray(self.tokenizer([phrase])), device=device).long()
        _, _, pooled = self.text_encoder(ids)
        return pooled[0].float().cpu().numpy()

    def image_feature(self, image) -> np.ndarray:
        """``image``: a path (read with PIL, imported here) or a uint8
        (H, W, 3) array."""
        if isinstance(image, (str, os.PathLike)):
            from PIL import Image

            image = np.asarray(Image.open(image).convert("RGB"))
        return self.image_feature_from_array(image)

    @torch.no_grad()
    def image_feature_from_array(self, image: np.ndarray) -> np.ndarray:
        """The feature of a uint8 (H, W, 3) image, whole (CLIP's resize to
        224^2 is ``clip_preprocess``'s)."""
        if (self.vision is None or self.projection_matrix is None) and self.allow_random:
            seed = int(np.asarray(image, np.uint8).sum()) % (2**31)
            feat = np.random.default_rng(seed).standard_normal(FEATURE_DIM).astype(np.float32)
            return feat / np.linalg.norm(feat) * FEATURE_NORM
        if self.vision is None or self.projection_matrix is None:
            raise ValueError("image grounding needs CLIP vision weights and projection_matrix")
        device = next(self.vision.parameters()).device
        pixels = clip_preprocess(torch.as_tensor(np.asarray(image, np.float32), device=device)[None])
        embeds, _ = self.vision(pixels)
        # reproject into the text-penultimate space, renorm to 28.7
        # (gligen_inference.py:113-116: project(feature, P.T) == feature @ P)
        feat = embeds[0].float().cpu().numpy() @ self.projection_matrix
        return feat / np.linalg.norm(feat) * FEATURE_NORM


def prepare_batch_box(meta: Mapping[str, Any], batch: int, features: FeatureExtractor,
                      max_objs: int = MAX_OBJS) -> Dict[str, np.ndarray]:
    """Box+text(+image) grounding (gligen_inference.py:144-187): per box
    slot a phrase, an image or both (``meta["locations"]``, ``"phrases"``,
    ``"images"``), and ``text_mask`` / ``image_mask`` from the meta; the
    arrays repeated over ``batch`` rows.  The text tokenizer takes
    ``positive_embeddings`` = ``text_embeddings``
    (``inference/adapters.py``)."""
    phrases = meta.get("phrases")
    images = meta.get("images")
    images = [None] * len(phrases) if images is None else images
    phrases = [None] * len(images) if phrases is None else phrases

    boxes = np.zeros((max_objs, 4), np.float32)
    masks = np.zeros(max_objs, np.float32)
    text_masks = np.zeros(max_objs, np.float32)
    image_masks = np.zeros(max_objs, np.float32)
    text_embeddings = np.zeros((max_objs, FEATURE_DIM), np.float32)
    image_embeddings = np.zeros((max_objs, FEATURE_DIM), np.float32)

    for idx, (box, phrase, image) in enumerate(zip(meta["locations"], phrases, images)):
        boxes[idx] = box
        masks[idx] = 1
        if phrase is not None:
            text_embeddings[idx] = features.text_feature(phrase)
            text_masks[idx] = 1
        if image is not None:
            image_embeddings[idx] = features.image_feature(image)
            image_masks[idx] = 1

    rep = lambda a: np.repeat(a[None], batch, axis=0)
    return {
        "boxes": rep(boxes),
        "masks": rep(masks),
        "text_masks": rep(text_masks) * complete_mask(meta.get("text_mask"), max_objs),
        "image_masks": rep(image_masks) * complete_mask(meta.get("image_mask"), max_objs),
        "text_embeddings": rep(text_embeddings),
        "image_embeddings": rep(image_embeddings),
    }


def prepare_batch_kp(meta: Mapping[str, Any], batch: int,
                     max_persons: int = 8) -> Dict[str, np.ndarray]:
    """Keypoint grounding (gligen_inference.py:199-218): each person's 17
    (x, y) points in order (``meta["locations"]``), a point at (0, 0)
    invisible (mask 0); repeated over ``batch`` rows."""
    points = np.zeros((max_persons * 17, 2), np.float32)
    idx = 0
    for person in meta["locations"]:
        for kp in person:
            points[idx] = kp
            idx += 1
    masks = (points.mean(axis=1) != 0).astype(np.float32)
    return {
        "points": np.repeat(points[None], batch, 0),
        "masks": np.repeat(masks[None], batch, 0),
    }


MAP_SIZE = 512  # the reference's map size (gligen_inference.py:222-338)


def _meta_image(meta: Mapping[str, Any], *keys: str):
    """The meta's map under the first of ``keys`` it has: the reference's
    metas name it ``hed_image``/``canny_image`` or ``normal``/``depth``/``sem``
    (gligen_inference.py:532-578)."""
    for k in keys:
        if k in meta:
            return meta[k]
    raise KeyError(f"meta missing any of {keys}: {sorted(meta)}")


def _open_square(path, size: int, mode: str, resample=None) -> np.ndarray:
    """The image at ``path`` (read with PIL, imported here) in ``mode``,
    center-cropped to a square and resized to ``size``^2 (the JAX CLI's
    ``crop_and_resize``, gligen_inference.py:190-195)."""
    from PIL import Image

    img = Image.open(path).convert(mode)
    w, h = img.size
    crop = min(w, h)
    left, top = (w - crop) // 2, (h - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    img = img.resize((size, size)) if resample is None else img.resize((size, size), resample)
    return np.asarray(img, np.uint8)


def _map_array(image, shape: tuple, what: str) -> np.ndarray:
    """A map given as an array: uint8 of ``shape`` (already cropped and
    resized), or a ValueError."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8 or arr.shape != shape:
        raise ValueError(f"{what}: a map array must be uint8 {shape} (or give its path), got "
                         f"{arr.dtype} {arr.shape}")
    return arr


def prepare_batch_spatial(meta: Mapping[str, Any], batch: int, key: str,
                          image_key: str) -> Dict[str, np.ndarray]:
    """A hed, canny, depth or normal map (gligen_inference.py:222-297) as
    raw uint8 pixels, (batch, 512, 512, 3), with ``mask`` ones: the
    tokenizer and the downsampler normalise them on the device
    (``prepare_spatial_map``).  The meta gives a path (read as RGB,
    center-cropped and resized to 512^2) or a uint8 (512, 512, 3) array."""
    image = _meta_image(meta, image_key, image_key.replace("_image", ""))
    if isinstance(image, (str, os.PathLike)):
        arr = _open_square(image, MAP_SIZE, "RGB")
    else:
        arr = _map_array(image, (MAP_SIZE, MAP_SIZE, 3), key)
    return {key: np.repeat(arr[None], batch, 0), "mask": np.ones(batch, np.float32)}


def prepare_batch_sem(meta: Mapping[str, Any], batch: int,
                      num_classes: int = 152) -> Dict[str, np.ndarray]:
    """A semantic label map (gligen_inference.py:317-338) as uint8 labels,
    (batch, 512, 512), with ``mask`` ones: the one-hot happens on the
    device (``prepare_spatial_map``).  The meta gives a path (read as
    grayscale, center-cropped, resized to 512^2 by nearest) or a uint8
    (512, 512) array.  A label of ``num_classes`` or more is a ValueError
    (the device's one-hot would give its pixels no class)."""
    image = _meta_image(meta, "sem_image", "sem")
    if isinstance(image, (str, os.PathLike)):
        from PIL import Image

        sem = _open_square(image, MAP_SIZE, "L", Image.NEAREST)
    else:
        sem = _map_array(image, (MAP_SIZE, MAP_SIZE), "sem")
    if int(sem.max()) >= num_classes:
        raise ValueError(f"sem: label {int(sem.max())} is not below num_classes {num_classes}")
    return {"sem": np.repeat(sem[None], batch, 0), "mask": np.ones(batch, np.float32)}


SPATIAL_KEYS = (("hed", "hed_edge", "hed_image"), ("canny", "canny_edge", "canny_image"),
                ("depth", "depth", "depth_image"), ("normal", "normal", "normal_image"))


def prepare_batch_for(meta: Mapping[str, Any], batch: int,
                      features: Optional[FeatureExtractor] = None) -> Dict[str, np.ndarray]:
    """The raw batch of the modality that ``meta["ckpt"]`` names
    (gligen_inference.py:361-376: keypoint, the spatial maps, sem, else
    box+text(+image), which needs ``features``); the modality's input
    adapter maps it to the tokenizer's keywords and the downsampler's map."""
    ckpt = meta["ckpt"]
    if "keypoint" in ckpt:
        return prepare_batch_kp(meta, batch)
    for modality, key, image_key in SPATIAL_KEYS:
        if modality in ckpt:
            return prepare_batch_spatial(meta, batch, key, image_key)
    if "sem" in ckpt:
        return prepare_batch_sem(meta, batch)
    if features is None:
        raise ValueError("box grounding needs a FeatureExtractor")
    return prepare_batch_box(meta, batch, features)
