"""The inference command line (counterpart of ``gligen_tpu/inference/cli.py``,
the reference's gligen_inference.py).

    python -m gligen_tpu_torch.inference.cli --ckpt random --dezero [--meta meta.json]
        [--scenarios generation_box_text,hed] [--device cuda|cpu] [--dtype bfloat16|float32]

runs grounded generation scenarios, by default the reference's 11
(``default_meta_list``): per-modality batch preparation, CLIP phrase and
image features (``FeatureExtractor``), alpha stages, inpainting (a box
mask and the pm1 image), PLMS (50 steps) or DDIM (``--no_plms``, 250), and
sequentially numbered PNGs (``save_images``, through ``data/png.py``: no
PIL).  ``--ckpt random[:tags]`` runs randomly initialised weights with the
modality of each tag, a smoke and speed mode, not image quality;
``--ckpt <path>`` a reference checkpoint.

Components from a reference checkpoint (``_vae_config_from_reference``
:260-279 and ``build_pipeline``'s checkpoint branch :313-332): checkpoints
are self-describing, the UNet's keywords, the first stage's ``ddconfig``
and the diffusion schedule ride in the embedded config, and the reference
instantiates all its modules from it (gligen_inference.py:72-77).

The grounding inputs of a scenario's meta (:34-227): CLIP phrase and image
features (``FeatureExtractor``) and the per-modality batches
(``prepare_batch_box`` for box+text(+image), ``prepare_batch_kp``,
``prepare_batch_spatial`` for hed/canny/depth/normal maps,
``prepare_batch_sem``), picked by ``prepare_batch_for``.  An image is a
path (a PNG or a JPEG through ``data/png.py:open_image``, with no PIL;
resizes PIL's bit for bit, ``data/transforms.py``) or a uint8 array already
at its size.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gligen_tpu_torch.data import png
from gligen_tpu_torch.data.transforms import center_crop_square, resize
from gligen_tpu_torch.data.inpaint_masks import draw_masks_from_boxes
from gligen_tpu_torch.data.tokenizer import load_tokenizer
from gligen_tpu_torch.inference.adapters import get_adapter
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.models.clip_vision import clip_preprocess
from gligen_tpu_torch.ops.basic import tf32_off
from gligen_tpu_torch.parallel.mesh import Mesh, make_mesh
from gligen_tpu_torch.training.checkpoints import (
    checkpoint_config,
    gligen_state_dicts,
    load_training_params,
)

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
        """``image``: a path (``png.open_image``) or a uint8 (H, W, 3) array."""
        if isinstance(image, (str, os.PathLike)):
            image = png.open_image(image, "RGB")
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


def crop_and_resize(pixels: np.ndarray, size: int = 512, nearest: bool = False) -> np.ndarray:
    """Center-crop uint8 pixels to a square and resize it to ``size``^2
    (gligen_inference.py:190-195, the JAX CLI's ``crop_and_resize``), with
    PIL's default filter (bicubic) or, when ``nearest``, nearest neighbour,
    bit for bit PIL's (``data/transforms.py:resize``).  A square already at
    ``size`` is returned as it is, which is what PIL's ``resize`` gives it
    (a copy)."""
    pixels = center_crop_square(pixels)
    if pixels.shape[0] == size:
        return pixels
    return resize(np.ascontiguousarray(pixels), (size, size), "nearest" if nearest else "bicubic")


def _open_square(path, size: int, mode: str, nearest: bool = False) -> np.ndarray:
    """The image at ``path`` in ``mode``, center-cropped to a square and
    resized to ``size``^2."""
    return crop_and_resize(png.open_image(path, mode), size, nearest)


def load_image_pm1(image, size: int = 512, mode: str = "RGB") -> np.ndarray:
    """An image in [-1, 1], (size, size, channels) float32: ``image`` a path
    or uint8 pixels, center-cropped and resized (cli.py:46-53)."""
    pixels = (_open_square(image, size, mode) if isinstance(image, (str, os.PathLike))
              else crop_and_resize(np.asarray(image, np.uint8), size))
    arr = np.asarray(pixels, dtype=np.float32) / 255.0 * 2.0 - 1.0
    return arr[..., None] if arr.ndim == 2 else arr


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
        sem = _open_square(image, MAP_SIZE, "L", nearest=True)
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


# -------------------------------------------------------------------- run

GATES = ("alpha_attn", "alpha_dense")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MODALITIES = ("text_image", "keypoint", "hed", "canny", "depth", "normal", "sem")
RANDOM_TAGS = ("keypoint", "hed", "canny", "depth", "normal", "sem", "inpaint", "text_image")
SEM_CLASSES = 152


@torch.no_grad()
def dezero_(module: nn.Module) -> None:
    """De-zero a fresh model in place so that a random-weight run is not
    vacuous (the JAX CLI's ``dezero_params``, cli.py:230-257): the fusers'
    ``alpha_attn``/``alpha_dense`` gates -> 0.5, and every all-zero tensor
    of one dimension or more (zero-init convs, null features, biases) ->
    N(0, 1) / sqrt(fan_in), fan_in the product of its dims after the first
    (torch's layout: a weight's inputs) or, for a vector, its size.  The
    values come from a generator on the parameter's device seeded with
    crc32 of the parameter's name, so two processes de-zero the same model
    on the same device alike (they are not the JAX package's values: its
    generator differs)."""
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] in GATES:
            p.fill_(0.5)
        elif p.dim() >= 1 and not bool(p.any()):
            fan_in = math.prod(p.shape[1:]) if p.dim() >= 2 else p.numel()
            gen = torch.Generator(device=p.device).manual_seed(zlib.crc32(name.encode()) % 2**31)
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype)
                    / max(fan_in, 1) ** 0.5)


def random_unet_config(ckpt: str) -> Dict[str, Any]:
    """The UNet keywords of ``--ckpt random[:tags]`` (cli.py:293-305): an
    inpaint UNet for "inpaint", and the grounding tokenizer (and the
    downsampler of a spatial modality) of the modality a tag names."""
    unet_config: Dict[str, Any] = {}
    if "inpaint" in ckpt:
        unet_config["inpaint_mode"] = True
    if "text_image" in ckpt:
        unet_config["grounding_tokenizer"] = {"target": "text_image", "params": {}}
    for tag in ("keypoint", "hed", "canny", "depth", "normal", "sem"):
        if tag in ckpt:
            params = {"in_dim": SEM_CLASSES} if tag == "sem" else {}
            unet_config["grounding_tokenizer"] = {"target": tag, "params": params}
            if tag != "keypoint":
                unet_config["grounding_downsampler"] = {"target": tag, "params": dict(params)}
    return unet_config


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


def build_pipeline(ckpt: str, args, create: Callable[..., GligenComponents] = GligenComponents.create
                   ) -> GenerationPipeline:
    """The pipeline of ``ckpt`` (cli.py:282-367) on ``args.device`` (``parser``'s
    arguments), with its
    tokenizer as ``pipe.tokenizer`` and the UNet's keywords as
    ``pipe.unet_config``: "random[:tags]" builds random components with
    ``create`` (``GligenComponents.create``'s keywords; a test passes a
    smaller model), de-zeroed with ``--dezero``; a path loads a reference
    checkpoint (``--sd_input_conv``, ``--use_ema``).  ``--train_ckpt``
    then overlays a native training run's trainable tensors (its EMA shadow
    with ``--use_ema``; cli.py:333-348).  Real weights need a
    CLIP vocab (``--vocab_path`` / $GLIGEN_TPU_ASSETS) unless
    ``--allow_hash_tokenizer``: the hash fallback would condition on
    garbage."""
    dtype, device = DTYPES[args.dtype], torch.device(args.device)
    is_random = ckpt == "random" or ckpt.startswith("random:")
    allow_hash = is_random or args.allow_hash_tokenizer
    try:
        tokenizer = load_tokenizer(args.vocab_path, allow_fallback=allow_hash)
    except FileNotFoundError as e:
        raise SystemExit(
            f"{e}\nReal checkpoint given but no CLIP vocab available: tokenization would be "
            "garbage. Provide --vocab_path/$GLIGEN_TPU_ASSETS or pass --allow_hash_tokenizer "
            "to opt into the smoke fallback."
        ) from e
    if is_random:
        unet_config = random_unet_config(ckpt)
        comps = create(unet_config=unet_config, dtype=dtype, seed=args.seed, device=device)
        if args.dezero:
            dezero_(comps.unet)
    else:
        ckpt_dict = _load(ckpt)
        conv = args.sd_input_conv
        sd_conv = _load(conv) if conv and os.path.exists(conv) else None
        comps = components_from_checkpoint(ckpt_dict, sd_first_conv=sd_conv,
                                           use_ema=args.use_ema, dtype=dtype,
                                           device=device)
        unet_config = dict(checkpoint_config(ckpt_dict).get("model", {}).get("params", {}))
    if args.train_ckpt:
        overlay_training_params(comps.unet, load_training_params(args.train_ckpt,
                                                                 use_ema=args.use_ema))
    pipe = GenerationPipeline(comps, mesh=data_parallel_mesh(args, device))
    pipe.tokenizer = tokenizer
    pipe.unet_config = unet_config
    return pipe


def data_parallel_mesh(args, device: torch.device) -> Optional[Mesh]:
    """``--data_parallel``'s mesh: every card, where the pipeline is on a
    card and the machine has more than one (cli.py:350-353); else None,
    said on stderr."""
    if not getattr(args, "data_parallel", False):
        return None
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards > 1:
        return make_mesh()
    print(f"--data_parallel: {cards} card(s) for a pipeline on {device}: one device, no mesh",
          file=sys.stderr, flush=True)
    return None


def overlay_training_params(unet: nn.Module, loaded: Mapping[str, torch.Tensor]) -> None:
    """Copy a native training checkpoint's tensors (``load_training_params``:
    the fusers, the position net, the downsampler, a widened first conv)
    into the UNet's parameters of the same names: train on the card, serve
    the result.  A name the UNet does not have raises ``ValueError``."""
    params = dict(unet.named_parameters())
    missing = sorted(set(loaded) - set(params))
    if missing:
        raise ValueError(f"train_ckpt tensors not in the UNet: {missing[:4]}"
                         + (f" and {len(missing) - 4} more" if len(missing) > 4 else ""))
    with torch.no_grad():
        for name, val in loaded.items():
            params[name].copy_(val)


def load_projection_matrix(path: str) -> np.ndarray:
    """The CLIP image -> text projection (box_dataset.py:197-204): a
    torch-saved 768 x 768 tensor, or a .npy file."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return np.asarray(_load(path), dtype=np.float32)


def load_vision(path: str, device) -> nn.Module:
    """CLIP ViT-L/14's vision tower (fp32) from an HF
    CLIPVisionModelWithProjection checkpoint."""
    from gligen_tpu_torch.convert.from_reference import convert_clip_vision
    from gligen_tpu_torch.models.clip_vision import CLIPVisionModel

    state = _load(path)
    state = state.get("state_dict", state)
    with torch.device(device):
        vision = CLIPVisionModel().eval()
    vision.load_state_dict(convert_clip_vision(state), strict=True)
    return vision


def modality_of(pipe: GenerationPipeline) -> str:
    """The modality of the pipeline's grounding tokenizer (its target or
    reference alias names it; "text" when it names none)."""
    target = (pipe.unet_config.get("grounding_tokenizer") or {"target": "text"})["target"]
    return next((m for m in MODALITIES if m in target), "text")


def run(meta: Mapping[str, Any], args, create: Callable[..., GligenComponents] = GligenComponents.create
        ) -> List[str]:
    """One scenario end to end (cli.py:370-437); returns the saved paths.
    An image in the meta is a path or uint8 pixels."""
    pipe = build_pipeline(meta["ckpt"], args, create)
    projection = None
    if args.projection_matrix and os.path.exists(args.projection_matrix):
        projection = load_projection_matrix(args.projection_matrix)
    vision = None
    if args.clip_vision_ckpt and os.path.exists(args.clip_vision_ckpt):
        vision = load_vision(args.clip_vision_ckpt, pipe.device)
    features = FeatureExtractor(pipe.c.text_encoder, pipe.tokenizer, vision=vision,
                                projection_matrix=projection,
                                allow_random=meta["ckpt"].startswith("random"))

    batch = args.batch_size
    raw = prepare_batch_for(meta, batch, features)
    adapter = get_adapter(modality_of(pipe))
    grounding = adapter.prepare(raw)
    grounding_extra = (adapter.prepare_extra(raw) if pipe.unet_config.get("grounding_downsampler")
                       else None)

    ids = pipe.tokenizer([meta["prompt"]] * batch)
    uc_ids = pipe.tokenizer([args.negative_prompt or ""] * batch)

    inpaint_image = inpaint_mask = None
    if "input_image" in meta:
        inpaint_mask = draw_masks_from_boxes(
            np.repeat(np.asarray(meta["locations"], np.float32)[None], batch, 0), 64)
        inpaint_image = np.repeat(load_image_pm1(meta["input_image"], 512)[None], batch, 0)

    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    # fp32 means fp32: cuBLAS's and cuDNN's TF32 off (bf16 products never use it)
    with tf32_off():
        images = pipe.generate(
            ids, uc_ids, grounding,
            steps=args.steps or (250 if args.no_plms else 50),
            sampler="ddim" if args.no_plms else "plms",
            guidance_scale=args.guidance_scale,
            alpha_stages=meta.get("alpha_type"),
            grounding_extra=grounding_extra,
            inpaint_image=inpaint_image,
            inpaint_mask=inpaint_mask,
            generator=generator,
        )
    return save_images(images.cpu().numpy(),
                       os.path.join(args.folder, meta["save_folder_name"]))


def save_images(images: np.ndarray, folder: str) -> List[str]:
    """Images in [0, 1], (B, H, W, 3), as PNGs numbered on from the files
    the folder holds (gligen_inference.py:434-446); each pixel is
    ``(img * 255).astype(uint8)``, truncated as in the JAX CLI."""
    os.makedirs(folder, exist_ok=True)
    start = len(os.listdir(folder))
    paths = []
    for i, img in enumerate(images):
        path = os.path.join(folder, f"{start + i}.png")
        png.write_png(path, (img * 255).astype(np.uint8))
        paths.append(path)
    return paths


# The reference's two full 17-keypoint skeletons (gligen_inference.py:588-631,
# "from id=18150 val set in coco2017k").
KEYPOINT_DEMO_SKELETONS = [
    [
        [0.7598, 0.2542], [0.7431, 0.2104], [0.8118, 0.2021], [0.0, 0.0],
        [0.9514, 0.1813], [0.7806, 0.2917], [0.0, 0.0], [0.6785, 0.5125],
        [0.0, 0.0], [0.5389, 0.6479], [0.6785, 0.6750], [0.7973, 0.7042],
        [0.0, 0.0], [0.6181, 0.7375], [0.9764, 0.8458], [0.0, 0.0], [0.0, 0.0],
    ],
    [
        [0.2681, 0.4313], [0.2514, 0.3979], [0.0, 0.0], [0.0785, 0.3854],
        [0.0, 0.0], [0.0910, 0.5583], [0.0, 0.0], [0.1243, 0.8479],
        [0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0],
        [0.0, 0.0], [0.2410, 0.8146], [0.1202, 0.6146], [0.0, 0.0],
        [0.2743, 0.7188],
    ],
]


def default_meta_list(ckpt_root: str = "gligen_checkpoints") -> List[Dict[str, Any]]:
    """All 11 of the reference's demonstration scenarios
    (gligen_inference.py:467-637), in the reference's order."""
    j = lambda name: os.path.join(ckpt_root, name)
    return [
        dict(
            ckpt=j("checkpoint_generation_text.pth"),
            prompt="a teddy bear sitting next to a bird",
            phrases=["a teddy bear", "a bird"],
            locations=[[0.0, 0.09, 0.33, 0.76], [0.55, 0.11, 1.0, 0.8]],
            alpha_type=[0.3, 0.0, 0.7],
            save_folder_name="generation_box_text",
        ),
        dict(
            ckpt=j("checkpoint_inpainting_text.pth"),
            input_image="inference_images/dalle2_museum.jpg",
            prompt="a corgi and a cake",
            phrases=["corgi", "cake"],
            locations=[[0.25, 0.28, 0.42, 0.52], [0.14, 0.58, 0.58, 0.92]],
            save_folder_name="inpainting_box_text",
        ),
        dict(
            ckpt=j("checkpoint_generation_text_image.pth"),
            prompt="an alarm clock sitting on the beach",
            images=["inference_images/clock.png"],
            phrases=["alarm clock"],
            locations=[[0.0, 0.09, 0.53, 0.76]],
            alpha_type=[1.0, 0.0, 0.0],
            save_folder_name="generation_box_image",
        ),
        # Style grounding: a pseudo-phrase slot carrying a style image whose
        # text feature is masked out and image feature kept
        # (gligen_inference.py:505-516).
        dict(
            ckpt=j("checkpoint_generation_text_image.pth"),
            prompt="a brick house in the woods, anime, oil painting",
            phrases=["a brick house", "placehoder"],
            images=["inference_images/placeholder.png", "inference_images/style_golden.jpg"],
            locations=[[0.4, 0.2, 1.0, 0.8], [0.0, 1.0, 0.0, 1.0]],
            alpha_type=[1.0, 0.0, 0.0],
            text_mask=[1, 0],   # the second text feature is masked
            image_mask=[0, 1],  # the first image feature is masked
            save_folder_name="generation_box_text_style",
        ),
        # Inpainting grounded by a reference image (gligen_inference.py:519-527).
        dict(
            ckpt=j("checkpoint_inpainting_text_image.pth"),
            input_image="inference_images/beach.jpg",
            prompt="a bigben on the beach",
            images=["inference_images/bigben.jpg"],
            locations=[[0.18, 0.08, 0.62, 0.75]],
            save_folder_name="inpainting_box_image",
        ),
        dict(
            ckpt=j("checkpoint_generation_hed.pth"),
            prompt="a man is eating breakfast",
            hed_image="inference_images/hed.png",
            alpha_type=[0.9, 0.0, 0.1],
            save_folder_name="hed",
        ),
        dict(
            ckpt=j("checkpoint_generation_canny.pth"),
            prompt="A Humanoid Robot Designed for Companionship",
            canny_image="inference_images/canny.png",
            alpha_type=[0.9, 0.0, 0.1],
            save_folder_name="canny",
        ),
        dict(
            ckpt=j("checkpoint_generation_normal.pth"),
            prompt="a large tree with no leaves in front of a building",
            normal="inference_images/normal.png",
            alpha_type=[0.7, 0.0, 0.3],
            save_folder_name="normal",
        ),
        dict(
            ckpt=j("checkpoint_generation_depth.pth"),
            prompt="a Vibrant colorful Bird Sitting on Tree Branch",
            depth="inference_images/depth.png",
            alpha_type=[0.7, 0.0, 0.3],
            save_folder_name="depth",
        ),
        dict(
            ckpt=j("checkpoint_generation_sem.pth"),
            prompt="a living room filled with lots of furniture and plants",
            sem="inference_images/sem.png",
            alpha_type=[0.7, 0.0, 0.3],
            save_folder_name="sem",
        ),
        dict(
            ckpt=j("checkpoint_generation_keypoint.pth"),
            prompt="A young man and a small boy are talking",
            locations=KEYPOINT_DEMO_SKELETONS,
            alpha_type=[0.3, 0.0, 0.7],
            save_folder_name="keypoint",
        ),
    ]


def _tag_random(meta: Mapping[str, Any], base: str) -> str:
    """``base`` ("random") with the modality tags the meta's folder or
    checkpoint name carries, so the modality dispatch works on random
    weights; a meta may carry several (inpainting_box_image: inpaint and
    text_image)."""
    tags = [tag for tag in RANDOM_TAGS
            if tag in meta.get("save_folder_name", "") or tag in meta["ckpt"]]
    return ":".join([base] + tags) if tags else base


def parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags and defaults (cli.py:571-630), and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--folder", type=str, default="generation_samples")
    ap.add_argument("--batch_size", type=int, default=5)
    ap.add_argument("--no_plms", action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="override sampler steps (default 50 PLMS / 250 DDIM)")
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument(
        "--negative_prompt", type=str,
        default="longbody, lowres, bad anatomy, bad hands, missing fingers, "
        "extra digit, fewer digits, cropped, worst quality, low quality",
    )
    ap.add_argument("--ckpt", type=str, default=None,
                    help="single ckpt override; 'random' for smoke")
    ap.add_argument("--meta", type=str, default=None, help="json file with meta dict(s)")
    ap.add_argument("--ckpt_root", type=str, default="gligen_checkpoints")
    ap.add_argument("--sd_input_conv", type=str, default="SD_input_conv_weight_bias.pth")
    ap.add_argument("--projection_matrix", type=str, default="projection_matrix")
    ap.add_argument("--clip_vision_ckpt", type=str, default=None)
    ap.add_argument("--vocab_path", type=str, default=None)
    ap.add_argument("--allow_hash_tokenizer", action="store_true",
                    help="permit the hash-fallback tokenizer even with real weights (smoke only)")
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", type=str, default="cuda",
                    help="the card (default) or 'cpu' (the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_parallel", action="store_true",
                    help="split the batch over every card (one replica each, rows padded to "
                    "a multiple of the cards), where the machine has more than one")
    ap.add_argument("--train_ckpt", type=str, default=None,
                    help="a native training checkpoint (a checkpoint_<step> file or its tag "
                    "dir) whose trainable tensors overlay the model's (--use_ema: its EMA shadow)")
    ap.add_argument("--dezero", action="store_true",
                    help="de-zero a random-init model's zero-init tensors and fuser gates "
                    "(deterministic in the parameter name) so random-weight runs exercise "
                    "every path")
    ap.add_argument("--use_ema", action="store_true",
                    help="load the EMA shadow of the trainable params (the checkpoint's 'ema' "
                    "entry) instead of the live weights")
    ap.add_argument("--scenarios", type=str, default=None,
                    help="comma-separated save_folder_name filter over the meta list "
                    "(e.g. 'generation_box_text,hed'); default runs all")
    return ap


def main(argv: Optional[Sequence[str]] = None,
         create: Callable[..., GligenComponents] = GligenComponents.create) -> None:
    args = parser().parse_args(argv)
    if args.meta:
        with open(args.meta) as f:
            metas = json.load(f)
        metas = metas if isinstance(metas, list) else [metas]
    else:
        metas = default_meta_list(args.ckpt_root)
    if args.ckpt:
        for m in metas:
            m["ckpt"] = args.ckpt if "random" not in args.ckpt else _tag_random(m, args.ckpt)
    if args.scenarios:
        keep = {s.strip() for s in args.scenarios.split(",") if s.strip()}
        metas = [m for m in metas if m.get("save_folder_name") in keep]

    for meta in metas:
        paths = run(meta, args, create)
        print(f"{meta['save_folder_name']}: wrote {len(paths)} images -> {paths[0]}", flush=True)


if __name__ == "__main__":
    main()
