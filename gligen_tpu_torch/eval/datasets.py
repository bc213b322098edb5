"""Eval-time datasets (counterpart of ``gligen_tpu/eval/datasets.py``, the
reference's demo/dataset/{cd,grounding,layout}_dataset.py).

COCO-style detection and caption loading for quantitative eval (the
layout2img FID/AP protocol): each item is the real image with the padded
box-grounding conditioning; text embeddings come from a feature function
(eval data has no precomputed TSV embeddings) or from per-annotation and
per-category embedding files.

Images are read by the port's PNG and JPEG decoders (``data/png.py``,
``data/jpeg.py``), with no PIL; the crop and resizes are PIL's bit for bit
(``data/transforms.py``).  Each dataset draws its flips and caption drops
from ``np.random.default_rng(seed)`` in the JAX package's order, so its
items are the JAX items.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from gligen_tpu_torch.data import png
from gligen_tpu_torch.data.transforms import (
    make_a_sentence,
    recalculate_box_and_verify_if_valid,
    resize,
    transform_image,
)


class COCOEvalDataset:
    """Detection + caption eval items (demo/dataset/cd_dataset.py shape)."""

    def __init__(
        self,
        image_root: str,
        instances_json_path: str,
        caption_json_path: Optional[str] = None,
        image_size: int = 512,
        max_boxes_per_data: int = 30,
        min_box_size: float = 0.01,
        max_images: Optional[int] = None,
        text_feature_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
        seed: int = 0,
    ):
        self.image_root = image_root
        self.image_size = image_size
        self.max_boxes = max_boxes_per_data
        self.min_box_size = min_box_size
        self.text_feature_fn = text_feature_fn
        self.rng = np.random.default_rng(seed)

        with open(instances_json_path) as f:
            inst = json.load(f)
        self.cat_names = {c["id"]: c["name"] for c in inst.get("categories", [])}
        self.image_id_to_objects = defaultdict(list)
        for anno in inst["annotations"]:
            self.image_id_to_objects[anno["image_id"]].append(anno)

        self.image_id_to_captions = defaultdict(list)
        if caption_json_path:
            with open(caption_json_path) as f:
                caps = json.load(f)
            for anno in caps["annotations"]:
                self.image_id_to_captions[anno["image_id"]].append(anno["caption"])

        self.items = []
        for image_data in inst["images"]:
            if image_data["id"] in self.image_id_to_objects:
                self.items.append((image_data["id"], image_data["file_name"]))
        if max_images:
            self.items = self.items[:max_images]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict:
        image_id, filename = self.items[index]
        image = png.open_image(os.path.join(self.image_root, filename), "RGB")
        arr, trans_info = transform_image(image, self.image_size, False, self.rng)

        names, areas, boxes_list = [], [], []
        for anno in self.image_id_to_objects[image_id]:
            x, y, w, h = anno["bbox"]
            valid, (x0, y0, x1, y1) = recalculate_box_and_verify_if_valid(
                x, y, w, h, trans_info, self.image_size, self.min_box_size
            )
            if valid:
                areas.append((x1 - x0) * (y1 - y0))
                boxes_list.append(np.asarray([x0, y0, x1, y1]) / self.image_size)
                names.append(self.cat_names.get(anno.get("category_id"), "object"))

        order = np.argsort(-np.asarray(areas))[: self.max_boxes] if areas else []
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        masks = np.zeros(self.max_boxes, np.float32)
        embeddings = np.zeros((self.max_boxes, 768), np.float32)
        chosen = [names[i] for i in order]
        for i, idx in enumerate(order):
            boxes[i], masks[i] = boxes_list[idx], 1.0
        if self.text_feature_fn is not None and chosen:
            embeddings[: len(chosen)] = self.text_feature_fn(chosen)

        caps = self.image_id_to_captions[image_id]
        caption = caps[0] if caps else ", ".join(chosen)
        return {
            "id": image_id,
            "image": arr,
            "boxes": boxes,
            "masks": masks,
            "text_embeddings": embeddings,
            "caption": caption,
        }


def _load_embedding(path: str) -> np.ndarray:
    """A per-annotation embedding file: ``.npy`` (``path`` or ``path +
    '.npy'``) or a torch-saved tensor (the reference stores torch tensors,
    grounding_dataset.py:181)."""
    if path.endswith(".npy") or os.path.exists(path + ".npy"):
        return np.load(path if path.endswith(".npy") else path + ".npy")
    import torch

    loaded = torch.load(path, map_location="cpu", weights_only=False)
    return loaded.numpy() if isinstance(loaded, torch.Tensor) else np.asarray(loaded)


class GroundingEvalDataset:
    """Phrase-grounding eval items (demo/dataset/grounding_dataset.py).

    COCO-format JSON whose 'images' carry real captions and whose
    annotations point at precomputed per-annotation embedding files;
    area-sorted top-N box selection, caption kept with prob_real_caption.
    Emits the adapters' schema ('text_embeddings' = the reference's
    'positive_embeddings')."""

    def __init__(
        self,
        image_root: str,
        json_path: str,
        annotation_embedding_path: str,
        prob_real_caption: float = 1.0,
        image_size: int = 256,
        min_box_size: float = 0.01,
        max_boxes_per_data: int = 8,
        max_images: Optional[int] = None,
        random_flip: bool = False,
        embedding_len: int = 768,
        seed: int = 0,
    ):
        self.image_root = image_root
        self.embedding_path = annotation_embedding_path
        self.prob_real_caption = prob_real_caption
        self.image_size = image_size
        self.min_box_size = min_box_size
        self.max_boxes = max_boxes_per_data
        self.random_flip = random_flip
        self.embedding_len = embedding_len
        self.rng = np.random.default_rng(seed)

        with open(json_path) as f:
            raw = json.load(f)
        self.data = {d["id"]: d for d in raw["images"]}
        self.data_id_list = [d["id"] for d in raw["images"]]
        self.data_id_to_annos = defaultdict(list)
        for anno in raw["annotations"]:
            self.data_id_to_annos[anno["image_id"]].append(anno)
        if max_images:
            # one data point per unique file (the COCO2017P 30k protocol)
            seen, keep = set(), []
            for did in self.data_id_list:
                fn = self.data[did]["file_name"]
                if fn not in seen:
                    seen.add(fn)
                    keep.append(did)
                if len(keep) >= max_images:
                    break
            self.data_id_list = keep

    def __len__(self):
        return len(self.data_id_list)

    def __getitem__(self, index: int) -> Dict:
        data_id = self.data_id_list[index]
        datum = self.data[data_id]
        image = png.open_image(os.path.join(self.image_root, datum["file_name"]), "RGB")
        arr, trans_info = transform_image(image, self.image_size, self.random_flip, self.rng)
        caption = (
            datum.get("caption", "")
            if self.rng.uniform() < self.prob_real_caption else ""
        )

        areas, boxes_list, embs = [], [], []
        for anno in self.data_id_to_annos[data_id]:
            x, y, w, h = anno["bbox"]
            valid, (x0, y0, x1, y1) = recalculate_box_and_verify_if_valid(
                x, y, w, h, trans_info, self.image_size, self.min_box_size
            )
            if valid:
                areas.append((x1 - x0) * (y1 - y0))
                boxes_list.append(np.asarray([x0, y0, x1, y1]) / self.image_size)
                embs.append(_load_embedding(os.path.join(self.embedding_path, str(anno["id"]))))

        order = np.argsort(-np.asarray(areas))[: self.max_boxes] if areas else []
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        masks = np.zeros(self.max_boxes, np.float32)
        embeddings = np.zeros((self.max_boxes, self.embedding_len), np.float32)
        for i, idx in enumerate(order):
            boxes[i], masks[i] = boxes_list[idx], 1.0
            embeddings[i] = embs[idx]
        return {
            "id": data_id,
            "image": arr,
            "boxes": boxes,
            "masks": masks,
            "text_embeddings": embeddings,
            "caption": caption,
        }


class LayoutEvalDataset:
    """layout2img protocol eval items (demo/dataset/layout_dataset.py):
    COCO instances + stuff merged, relative-area min_box_size filter at
    the ORIGINAL resolution, images pruned to [min, max] objects, a square
    resize (no crop; PIL's default bicubic), per-CATEGORY embeddings,
    empty or made captions."""

    def __init__(
        self,
        image_root: str,
        instances_json_path: str,
        stuff_json_path: str,
        category_embedding_path: str,
        fake_caption_type: str = "empty",
        image_size: int = 256,
        max_samples: Optional[int] = None,
        min_box_size: float = 0.02,
        min_boxes_per_image: int = 3,
        max_boxes_per_image: int = 8,
        include_other: bool = False,
        random_flip: bool = True,
        seed: int = 0,
    ):
        if fake_caption_type not in ("empty", "made"):
            raise ValueError(f"fake_caption_type {fake_caption_type!r}: 'empty' or 'made'")
        self.image_root = image_root
        self.fake_caption_type = fake_caption_type
        self.image_size = image_size
        self.max_samples = max_samples
        self.max_boxes = max_boxes_per_image
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

        with open(instances_json_path) as f:
            instances = json.load(f)
        with open(stuff_json_path) as f:
            stuff = json.load(f)

        self.category_embeddings = self._load_category_embeddings(category_embedding_path)
        self.embedding_len = len(next(iter(self.category_embeddings.values())))

        self.image_id_to_filename = {}
        self.image_id_to_size = {}
        image_ids = []
        for d in instances["images"]:
            image_ids.append(d["id"])
            self.image_id_to_filename[d["id"]] = d["file_name"]
            self.image_id_to_size[d["id"]] = (d["width"], d["height"])

        self.object_idx_to_name = {}
        for cat in instances.get("categories", []) + stuff.get("categories", []):
            self.object_idx_to_name[cat["id"]] = cat["name"]

        self.image_id_to_objects = defaultdict(list)
        for anno in instances["annotations"] + stuff["annotations"]:
            image_id = anno["image_id"]
            _, _, w, h = anno["bbox"]
            W, H = self.image_id_to_size[image_id]
            name = self.object_idx_to_name[anno["category_id"]]
            if (w * h) / (W * H) > min_box_size and (name != "other" or include_other):
                self.image_id_to_objects[image_id].append(anno)

        self.image_ids = [
            i for i in image_ids
            if min_boxes_per_image <= len(self.image_id_to_objects[i]) <= max_boxes_per_image
        ]

    @staticmethod
    def _load_category_embeddings(path: str) -> Dict[str, np.ndarray]:
        """{category name: embedding} from ``.npz``, a pickled dict in
        ``.npy``, or a torch-saved dict."""
        if path.endswith((".npz", ".npy")):
            loaded = np.load(path, allow_pickle=True)
            if hasattr(loaded, "files"):
                return {k: np.asarray(loaded[k]) for k in loaded.files}
            return dict(loaded.item())
        import torch

        state = torch.load(path, map_location="cpu", weights_only=False)
        return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in state.items()}

    def __len__(self):
        n = len(self.image_ids)
        return min(n, self.max_samples) if self.max_samples else n

    def __getitem__(self, index: int) -> Dict:
        image_id = self.image_ids[index]
        image = png.open_image(
            os.path.join(self.image_root, self.image_id_to_filename[image_id]), "RGB")
        HH, WW = image.shape[:2]
        flip = self.random_flip and self.rng.uniform() < 0.5
        if flip:
            image = image[:, ::-1]
        # layout2img protocol: SQUASH-resize to image_size (no crop)
        image = resize(np.ascontiguousarray(image), (self.image_size, self.image_size), "bicubic")
        arr = image.astype(np.float32) / 255.0 * 2.0 - 1.0

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        masks = np.zeros(self.max_boxes, np.float32)
        embeddings = np.zeros((self.max_boxes, self.embedding_len), np.float32)
        obj_names = []
        for idx, anno in enumerate(self.image_id_to_objects[image_id]):
            name = self.object_idx_to_name[anno["category_id"]]
            obj_names.append(name)
            x, y, w, h = anno["bbox"]
            x0, y0, x1, y1 = x / WW, y / HH, (x + w) / WW, (y + h) / HH
            if flip:
                x0, x1 = 1 - x1, 1 - x0
            boxes[idx] = [x0, y0, x1, y1]
            masks[idx] = 1.0
            embeddings[idx] = self.category_embeddings[name]

        caption = "" if self.fake_caption_type == "empty" else make_a_sentence(
            obj_names, clean=True
        )
        return {
            "id": image_id,
            "image": arr,
            "boxes": boxes,
            "masks": masks,
            "text_embeddings": embeddings,
            "caption": caption,
        }
