"""COCO person-keypoint training dataset (counterpart of
``gligen_tpu/data/keypoint_dataset.py``, the reference's
dataset/dataset_kp.py + base_dataset_kp.py), on uint8 arrays.

17 keypoints a person, up to ``max_persons_per_image`` persons chosen by
box area; an invisible keypoint becomes (0, 0) with mask 0; boxes and
keypoints are re-projected through the crop's scale, offset and flip.
Each item holds ``points`` (P * 17, 2), normalised xy, and ``masks``
(P * 17,).  Images open through the port's decoders (``data/png.py``:
PNG, and JPEG with no library); the crop is ``transforms.transform_image``,
PIL's pixels bit for bit.  The draws come from ``default_rng(seed)`` in the
JAX package's order: the flip, then the caption and its choice.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from gligen_tpu_torch.data.png import open_image
from gligen_tpu_torch.data.transforms import transform_image
from gligen_tpu_torch.utils.registry import DATASETS


def clean_kps(kps: List[float]) -> List[Dict]:
    """COCO's 51 floats (x, y, visibility) -> [{loc, valid}]
    (dataset_kp.py:20-31)."""
    if len(kps) != 51:
        raise ValueError(f"a COCO person has 17 keypoints (51 numbers), got {len(kps)}")
    out = []
    for i in range(17):
        x, y, v = kps[3 * i : 3 * i + 3]
        valid = v == 2
        out.append({"loc": [x, y] if valid else [0, 0], "valid": valid})
    return out


def _kp_to_valid(x0, y0, x1, y1, kps, image_size, min_box_size):
    """base_dataset_kp.py to_valid: clamp the box, drop off-image keypoints."""
    if x0 > image_size or y0 > image_size or x1 < 0 or y1 < 0:
        return False, (None,) * 4, kps
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, image_size), min(y1, image_size)
    if (x1 - x0) * (y1 - y0) / (image_size * image_size) < min_box_size:
        return False, (None,) * 4, kps
    for kp in kps:
        if kp["valid"]:
            kx, ky = kp["loc"]
            if kx < 0 or kx > image_size or ky < 0 or ky > image_size:
                kp["valid"] = False
                kp["loc"] = [0, 0]
    return True, (x0, y0, x1, y1), kps


def recalculate_box_kps_and_verify_if_valid(x, y, w, h, kps, trans_info, image_size,
                                            min_box_size):
    """base_dataset_kp.py:86-123."""
    s = trans_info["performed_scale"]
    x0 = x * s - trans_info["crop_x"]
    y0 = y * s - trans_info["crop_y"]
    x1 = (x + w) * s - trans_info["crop_x"]
    y1 = (y + h) * s - trans_info["crop_y"]
    for kp in kps:
        if kp["valid"]:
            kx, ky = kp["loc"]
            kp["loc"] = [kx * s - trans_info["crop_x"], ky * s - trans_info["crop_y"]]
    valid, (x0, y0, x1, y1), kps = _kp_to_valid(x0, y0, x1, y1, kps, image_size, min_box_size)
    if valid and trans_info["performed_flip"]:
        x0, x1 = image_size - x1, image_size - x0
        for kp in kps:
            if kp["valid"]:
                kx, ky = kp["loc"]
                kp["loc"] = [image_size - kx, ky]
    return valid, (x0, y0, x1, y1), kps


@DATASETS.register("keypoint", "dataset.dataset_kp.KeypointDataset")
class KeypointDataset:
    def __init__(
        self,
        image_root: str,
        keypoints_json_path: str,
        caption_json_path: Optional[str] = None,
        prob_real_caption: float = 0.0,
        image_size: int = 512,
        max_images: Optional[int] = None,
        min_box_size: float = 0.0,
        max_persons_per_image: int = 8,
        random_crop: bool = False,
        random_flip: bool = True,
        seed: int = 0,
    ):
        if random_crop:
            raise ValueError("random_crop is used by no shipped config")
        if max_persons_per_image > 99:
            raise ValueError(f"max_persons_per_image={max_persons_per_image} > 99")
        if prob_real_caption > 0 and caption_json_path is None:
            raise ValueError("prob_real_caption > 0 needs caption_json_path")
        self.image_root = image_root
        self.prob_real_caption = prob_real_caption
        self.image_size = image_size
        self.max_images = max_images
        self.min_box_size = min_box_size
        self.max_persons = max_persons_per_image
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

        with open(keypoints_json_path) as f:
            kp_data = json.load(f)
        self.image_id_to_objects = defaultdict(list)
        for anno in kp_data["annotations"]:
            self.image_id_to_objects[anno["image_id"]].append(anno)

        self.image_id_to_captions = defaultdict(list)
        if caption_json_path is not None:
            with open(caption_json_path) as f:
                cap_data = json.load(f)
            for anno in cap_data["annotations"]:
                self.image_id_to_captions[anno["image_id"]].append(anno)

        self.image_ids, self.image_id_to_filename = [], {}
        for image_data in kp_data["images"]:
            if image_data["id"] in self.image_id_to_objects:
                self.image_ids.append(image_data["id"])
                self.image_id_to_filename[image_data["id"]] = image_data["file_name"]

    def __len__(self) -> int:
        n = len(self.image_ids)
        return min(n, self.max_images) if self.max_images else n

    total_images = __len__

    def __getitem__(self, index: int):
        image_id = self.image_ids[index]
        image = open_image(os.path.join(self.image_root, self.image_id_to_filename[image_id]),
                           "RGB")
        image_arr, trans_info = transform_image(image, self.image_size, self.random_flip,
                                                self.rng)

        areas, all_kps = [], []
        for anno in self.image_id_to_objects[image_id]:
            x, y, w, h = anno["bbox"]
            kps = clean_kps(list(anno["keypoints"]))
            valid, (x0, y0, x1, y1), kps = recalculate_box_kps_and_verify_if_valid(
                x, y, w, h, kps, trans_info, self.image_size, self.min_box_size)
            if valid:
                areas.append((x1 - x0) * (y1 - y0))
                for kp in kps:  # normalise (dataset_kp.py:34-39)
                    if kp["valid"]:
                        kp["loc"] = [c / self.image_size for c in kp["loc"]]
                all_kps.append(kps)

        order = np.argsort(-np.asarray(areas))[: self.max_persons] if areas else []
        points = np.zeros((self.max_persons * 17, 2), np.float32)
        masks = np.zeros(self.max_persons * 17, np.float32)
        i = 0
        for idx in order:
            for kp in all_kps[idx]:
                points[i] = kp["loc"]
                masks[i] = 1.0 if kp["valid"] else 0.0
                i += 1

        caption = ""
        if self.rng.uniform() < self.prob_real_caption:
            caps = self.image_id_to_captions[image_id]
            caption = caps[int(self.rng.integers(0, len(caps)))]["caption"]

        return {
            "id": image_id,
            "image": image_arr,
            "points": points,
            "masks": masks,
            "caption": caption,
        }
