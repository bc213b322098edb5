"""Offline grounding-TSV preparation (counterpart of
``gligen_tpu/data/prepare_grounding.py``, the reference's
DATA/process_grounding.py and DATA/mydata_to_tsv.py).

For each image and its box annotations: each entity's CLIP features, the
text phrase's and the box crop's, both BEFORE projection (the pooled
penultimate tower outputs, what the diffusion model consumes) and AFTER
(the normalised CLIP-aligned embeddings, process_grounding.py:225-229),
then one row a TSV in the schema of DATA/README.MD:29-45: base64 fp32
features and the base64 image.

The towers are the port's (``models/clip_text.py``'s pooled output,
``models/clip_vision.py``'s ``clip_preprocess``, image embeds and pooled
output), on the card unless the caller asks for the CPU.  Crops are uint8
arrays: the box truncated to ints and clipped to the image, then PIL's
bicubic resize to 224^2 (``data/transforms.py``, bit for bit).  The row's
image is a PNG (``tsv.encode_base64_image``): the port has no JPEG
encoder, where the JAX package writes JPEG through PIL; both packages read
either.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gligen_tpu_torch.data.transforms import resize
from gligen_tpu_torch.data.tsv import TSVWriter, encode_base64_fp32, encode_base64_image
from gligen_tpu_torch.models.clip_vision import clip_preprocess


def project(x: np.ndarray, projection_matrix: np.ndarray) -> np.ndarray:
    """Penultimate -> CLIP-aligned (process_grounding.py:32-39)."""
    return x @ projection_matrix.T


def inv_project(y: np.ndarray, projection_matrix: np.ndarray) -> np.ndarray:
    """CLIP-aligned -> penultimate (process_grounding.py:42-52)."""
    return y @ np.linalg.inv(projection_matrix).T


def _normalized(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class CLIPFeaturizer:
    """Batched before and after CLIP features from the port's towers.

    text_model: ``CLIPTextModel``; vision_model: ``CLIPVisionModel``;
    text_projection: CLIP's text-projection Linear weight (768, 768);
    tokenizer: phrases -> (N, 77) ids.  The towers move to ``device``."""

    def __init__(self, text_model, vision_model, text_projection: np.ndarray,
                 tokenizer: Callable[[List[str]], np.ndarray], device="cuda"):
        self.device = torch.device(device)
        self.text_model = text_model.to(self.device).eval()
        self.vision_model = vision_model.to(self.device).eval()
        self.text_projection = np.asarray(text_projection, np.float32)
        self.tokenizer = tokenizer

    @torch.no_grad()
    def text_features(self, phrases: Sequence[str]):
        """(before (N, D) unnormalised, after (N, D) normalised)."""
        ids = torch.as_tensor(np.asarray(self.tokenizer(list(phrases))), device=self.device)
        pooled = self.text_model(ids.long())[2].float().cpu().numpy()
        return pooled, _normalized(project(pooled, self.text_projection))

    @torch.no_grad()
    def image_features(self, crops: np.ndarray):
        """crops: (N, 224, 224, 3) in [0, 255] -> (before: the pooled
        output, after: the normalised image embeds)."""
        pixels = clip_preprocess(torch.as_tensor(np.asarray(crops), device=self.device))
        embeds, pooled = self.vision_model(pixels)
        return pooled.float().cpu().numpy(), _normalized(embeds.float().cpu().numpy())


def crop_box(image: np.ndarray, bbox: Sequence[float], crop_size: int = 224) -> np.ndarray:
    """The xywh box of uint8 ``image`` (H, W, 3) cut at int-truncated,
    clipped corners and resized (bicubic) to crop_size^2, float32
    (prepare_grounding.py:94, PIL's crop + resize)."""
    h, w = image.shape[:2]
    x, y, bw, bh = bbox
    left, top = max(int(x), 0), max(int(y), 0)
    right, bottom = min(int(x + bw), w), min(int(y + bh), h)
    if right <= left or bottom <= top:
        raise ValueError(f"box {list(bbox)} holds no pixel of a {w}x{h} image")
    crop = np.ascontiguousarray(image[top:bottom, left:right])
    return resize(crop, (crop_size, crop_size), "bicubic").astype(np.float32)


def item_to_row(item: Dict, image: np.ndarray, featurizer: Optional[CLIPFeaturizer] = None,
                crop_size: int = 224) -> List:
    """One dataset item ({data_id, caption, is_det, annos: [{bbox, caption or
    category_name}]}) and its uint8 image (H, W, 3) -> [id, json payload]
    (DATA/mydata_to_tsv.py:26-47); zero features without a featurizer."""
    phrases, crops = [], []
    for anno in item["annos"]:
        phrases.append(anno.get("caption") or anno.get("category_name") or "")
        crops.append(crop_box(image, anno["bbox"], crop_size))

    if featurizer is not None and phrases:
        t_before, t_after = featurizer.text_features(phrases)
        i_before, i_after = featurizer.image_features(np.stack(crops))
    else:
        n, d = len(phrases), 768
        t_before = t_after = np.zeros((n, d), np.float32)
        i_before = i_after = np.zeros((n, d), np.float32)

    annos_out = []
    for k, anno in enumerate(item["annos"]):
        annos_out.append({
            "bbox": list(map(float, anno["bbox"])),
            "caption": phrases[k],
            "category_name": anno.get("category_name"),
            "text_embedding_before": encode_base64_fp32(t_before[k]),
            "text_embedding_after": encode_base64_fp32(t_after[k]),
            "image_embedding_before": encode_base64_fp32(i_before[k]),
            "image_embedding_after": encode_base64_fp32(i_after[k]),
        })
    payload = {
        "data_id": item["data_id"],
        "caption": item.get("caption", ""),
        "is_det": item.get("is_det", False),
        "image": encode_base64_image(image),
        "annos": annos_out,
    }
    return [item["data_id"], json.dumps(payload)]


def write_grounding_tsv(items, images, out_path: str, featurizer=None) -> int:
    """items: iterable of {data_id, caption, annos: [{bbox, caption}]};
    images: the matching uint8 (H, W, 3) arrays.  Returns the row count."""
    writer = TSVWriter(out_path)
    n = 0
    for item, image in zip(items, images):
        writer.write(item_to_row(item, image, featurizer))
        n += 1
    writer.close()
    return n
