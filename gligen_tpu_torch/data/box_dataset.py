"""Box-grounding TSV dataset (counterpart of
``gligen_tpu/data/box_dataset.py``, the reference's dataset/tsv_dataset.py).

Decodes a grounding-TSV row, center-crop/flips with box re-projection and
validity filtering, selects the top-N boxes by area, picks the CLIP text
embedding layer, renorms/reprojects image embeddings (x28.7, the
empirical text-penultimate norm), applies random text/image-embedding
drop and caption drop — producing fixed-shape numpy batch items for the
NHWC device pipeline.  The draws (flip, embedding drop, caption drop) come
from the dataset's seeded numpy generator in the JAX package's order, so
the same TSV, seed and projection matrix give the same items.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from gligen_tpu_torch.data.transforms import (
    make_a_sentence,
    recalculate_box_and_verify_if_valid,
    transform_image,
)
from gligen_tpu_torch.data.tsv import TSVFile, decode_item
from gligen_tpu_torch.utils.registry import DATASETS

EMBEDDING_LEN = 768


def project(x: np.ndarray, projection_matrix: np.ndarray) -> np.ndarray:
    """CLIP penultimate -> projected space (tsv_dataset.py:138-146)."""
    return x @ projection_matrix.T


def inv_project(y: np.ndarray, projection_matrix: np.ndarray) -> np.ndarray:
    """Projected -> penultimate (tsv_dataset.py:149-159)."""
    return y @ np.linalg.inv(projection_matrix).T


def mask_for_random_drop_text_or_image_feature(
    masks: np.ndarray, random_drop_embedding: str, rng: np.random.Generator
):
    """tsv_dataset.py:104-132: drop either feature per token (never both)."""
    n = masks.shape[0]
    if random_drop_embedding == "both":
        temp = np.ones((2, n), np.float32)
        for i in range(n):
            if rng.uniform() < 0.5:
                temp[rng.integers(0, 2), i] = 0
        return temp[0] * masks, temp[1] * masks
    if random_drop_embedding == "image":
        return masks * (rng.random(n) > 0.5), masks
    raise ValueError(random_drop_embedding)


@DATASETS.register("tsv_box", "dataset.tsv_dataset.TSVDataset")
class TSVBoxDataset:
    """tsv_dataset.py:163-320."""

    def __init__(
        self,
        tsv_path: str,
        which_layer_text: str = "before",
        which_layer_image: str = "after_reproject",
        prob_use_caption: float = 1.0,
        random_drop_embedding: str = "none",
        image_size: int = 512,
        min_box_size: float = 0.01,
        max_boxes_per_data: int = 8,
        max_images: Optional[int] = None,
        random_crop: bool = False,
        random_flip: bool = True,
        projection_matrix_path: Optional[str] = None,
        seed: int = 0,
        latent_cache: Optional[str] = None,
    ):
        for name, value, allowed in (
                ("which_layer_text", which_layer_text, ("before", "after")),
                ("which_layer_image", which_layer_image,
                 ("after", "after_renorm", "after_reproject")),
                ("random_drop_embedding", random_drop_embedding, ("none", "both", "image"))):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}: one of {allowed}")
        if random_crop:
            raise ValueError("random_crop is used by no shipped config")
        if max_boxes_per_data > 99:
            raise ValueError(f"max_boxes_per_data={max_boxes_per_data} > 99")

        self.tsv_file = TSVFile(tsv_path)
        self.which_layer_text = which_layer_text
        self.which_layer_image = which_layer_image
        self.prob_use_caption = prob_use_caption
        self.random_drop_embedding = random_drop_embedding
        self.image_size = image_size
        self.min_box_size = min_box_size
        self.max_boxes = max_boxes_per_data
        self.max_images = max_images
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

        # Optional precomputed VAE posterior moments (data/latent_cache.py):
        # items gain a "latent_moments" key and the train step skips the
        # frozen VAE encode entirely.
        self.latent_cache = None
        if latent_cache is not None:
            from gligen_tpu_torch.data.latent_cache import LatentCache

            self.latent_cache = LatentCache(latent_cache, expect_image_size=image_size)

        self.projection_matrix = None
        path = projection_matrix_path or os.environ.get("GLIGEN_TPU_PROJECTION_MATRIX")
        if path and os.path.exists(path):
            self.projection_matrix = _load_projection_matrix(path)
        elif which_layer_image == "after_reproject":
            raise FileNotFoundError(
                "which_layer_image='after_reproject' needs the CLIP projection "
                "matrix; set projection_matrix_path or $GLIGEN_TPU_PROJECTION_MATRIX"
            )

    def __len__(self) -> int:
        n = len(self.tsv_file)
        return min(n, self.max_images) if self.max_images else n

    total_images = __len__

    def _map_image_embedding(self, emb: np.ndarray) -> np.ndarray:
        """tsv_dataset.py:210-223."""
        if self.which_layer_image == "after":
            return emb
        if self.which_layer_image == "after_renorm":
            return emb * 28.7
        emb = project(emb[None], self.projection_matrix.T)[0]
        return emb / np.linalg.norm(emb) * 28.7

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        _, payload = self.tsv_file[index][:2]
        item = decode_item(payload)
        is_det = item.get("is_det", False)

        image, trans_info = transform_image(
            item["image"], self.image_size, self.random_flip, self.rng
        )

        text_key = f"text_embedding_{self.which_layer_text}"
        areas, cand = [], []
        for anno in item["annos"]:
            x, y, w, h = anno["bbox"]
            valid, (x0, y0, x1, y1) = recalculate_box_and_verify_if_valid(
                x, y, w, h, trans_info, self.image_size, self.min_box_size
            )
            if valid:
                areas.append((x1 - x0) * (y1 - y0))
                cand.append(
                    (
                        np.asarray([x0, y0, x1, y1], np.float32) / self.image_size,
                        anno[text_key],
                        self._map_image_embedding(anno["image_embedding_after"]),
                        anno.get("category_name"),
                    )
                )

        order = np.argsort(-np.asarray(areas))[: self.max_boxes] if areas else []
        n = self.max_boxes
        boxes = np.zeros((n, 4), np.float32)
        masks = np.zeros(n, np.float32)
        text_embeddings = np.zeros((n, EMBEDDING_LEN), np.float32)
        image_embeddings = np.zeros((n, EMBEDDING_LEN), np.float32)
        category_names = []
        for i, idx in enumerate(order):
            box, temb, iemb, cname = cand[idx]
            boxes[i], masks[i] = box, 1.0
            text_embeddings[i], image_embeddings[i] = temb, iemb
            category_names.append(cname)

        if self.random_drop_embedding != "none":
            image_masks, text_masks = mask_for_random_drop_text_or_image_feature(
                masks, self.random_drop_embedding, self.rng
            )
        else:
            image_masks = text_masks = masks

        if self.rng.uniform() < self.prob_use_caption:
            caption = make_a_sentence(category_names) if is_det else item.get("caption", "")
        else:
            caption = ""

        out = {
            "id": item.get("data_id", index),
            "image": image,
            "boxes": boxes,
            "masks": masks,
            "image_masks": image_masks.astype(np.float32),
            "text_masks": text_masks.astype(np.float32),
            "text_embeddings": text_embeddings,
            "image_embeddings": image_embeddings,
            "caption": caption,
        }
        if self.latent_cache is not None:
            out["latent_moments"] = self.latent_cache.get(
                index, trans_info["performed_flip"])
        return out


def _load_projection_matrix(path: str) -> np.ndarray:
    """The shipped file is a torch-saved 768x768 tensor; also accept .npy."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import torch

    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(torch.as_tensor(t).float().numpy(), dtype=np.float32)
