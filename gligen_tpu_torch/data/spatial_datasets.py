"""Spatially-conditioned training datasets (counterpart of
``gligen_tpu/data/spatial_datasets.py``, the reference's
dataset/dataset_{hed,canny,depth,normal,sem}.py), on uint8 arrays instead
of PIL images.

One paired-TSV dataset covers hed, canny and depth (an image TSV and a
condition-map TSV whose rows share ``data_id``); ``NormalDataset`` reads
DIODE image files and ``.npy`` normals with BLIP captions;
``SemanticDataset`` reads ADE20K images and label PNGs.  Each item's
``image`` is HWC float32 in [-1, 1] (x / 255 * 2 - 1, as the JAX package);
the condition map stays uint8 pixels (hed/canny/depth/normal, (H, W, 3))
or uint8 class labels (sem, (H, W)), which the grounding nets expand on the
card.  Crops and resizes are PIL's bit for bit (``data/transforms.py``):
the centred square, then bicubic (labels: nearest) to ``image_size``.  The
draws come from ``default_rng(seed)`` in the JAX package's order: the flip,
then the caption.

Where the JAX package asserts (paired rows, sizes, labels), the port
raises ``ValueError``; a label of ``num_classes`` or more names its file.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from gligen_tpu_torch.data.png import open_image
from gligen_tpu_torch.data.transforms import center_crop_square, resize
from gligen_tpu_torch.data.tsv import TSVFile, decode_base64_image
from gligen_tpu_torch.utils.registry import DATASETS


def _center_crop_resize(pixels: np.ndarray, image_size: int, kind: str = "bicubic"):
    """TF.center_crop(min side) + resize (spatial_datasets.py:30-37)."""
    return resize(center_crop_square(pixels), (image_size, image_size), kind)


def _to_pm1(pixels: np.ndarray) -> np.ndarray:
    return pixels.astype(np.float32) / 255.0 * 2.0 - 1.0


def _same_size(a: np.ndarray, b: np.ndarray, what: str) -> None:
    if a.shape[:2] != b.shape[:2]:
        raise ValueError(f"{what}: image {a.shape[1]}x{a.shape[0]} and map "
                         f"{b.shape[1]}x{b.shape[0]} differ in size")


def _flip(rng: np.random.Generator, random_flip: bool, *arrays):
    """Mirror every array left-right on one draw (ImageOps.mirror)."""
    if random_flip and rng.random() < 0.5:
        return tuple(np.ascontiguousarray(a[:, ::-1]) for a in arrays)
    return arrays


class PairedTSVDataset:
    """dataset_hed.py:48-124 generalised over the condition key."""

    cond_key = "hed_edge"

    def __init__(self, tsv_path: str, cond_tsv_path: str, prob_use_caption: float = 1.0,
                 image_size: int = 512, random_flip: bool = False, seed: int = 0):
        self.tsv_file = TSVFile(tsv_path)
        self.cond_tsv_file = TSVFile(cond_tsv_path)
        self.prob_use_caption = prob_use_caption
        self.image_size = image_size
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.tsv_file)

    total_images = __len__

    def __getitem__(self, index: int):
        item = json.loads(self.tsv_file[index][1])
        cond_item = json.loads(self.cond_tsv_file[index][1])
        if item["data_id"] != cond_item["data_id"]:
            raise ValueError(f"row {index}: data_id {item['data_id']!r} of "
                             f"{self.tsv_file.tsv_file} is {cond_item['data_id']!r} in "
                             f"{self.cond_tsv_file.tsv_file}")
        image = decode_base64_image(item["image"])
        cond = decode_base64_image(cond_item[self.cond_key])
        _same_size(image, cond, f"row {index} of {self.cond_tsv_file.tsv_file}")

        image = _center_crop_resize(image, self.image_size)
        cond = _center_crop_resize(cond, self.image_size)
        image, cond = _flip(self.rng, self.random_flip, image, cond)

        caption = item["caption"] if self.rng.uniform() < self.prob_use_caption else ""
        return {
            "id": item["data_id"],
            "image": _to_pm1(image),
            self.cond_key: cond,
            "mask": np.float32(1.0),
            "caption": caption,
        }


@DATASETS.register("hed", "dataset.dataset_hed.HedDataset")
class HedDataset(PairedTSVDataset):
    cond_key = "hed_edge"

    def __init__(self, tsv_path, hed_tsv_path, **kw):
        super().__init__(tsv_path, hed_tsv_path, **kw)


@DATASETS.register("canny", "dataset.dataset_canny.CannyDataset")
class CannyDataset(PairedTSVDataset):
    cond_key = "canny_edge"

    def __init__(self, tsv_path, canny_tsv_path, **kw):
        super().__init__(tsv_path, canny_tsv_path, **kw)


@DATASETS.register("depth", "dataset.dataset_depth.DepthDataset")
class DepthDataset(PairedTSVDataset):
    cond_key = "depth"

    def __init__(self, tsv_path, depth_tsv_path, **kw):
        super().__init__(tsv_path, depth_tsv_path, **kw)


def recursively_read(rootdir: str, must_contain: str = "", exts: Optional[List[str]] = None):
    """Every file under ``rootdir`` whose extension is one of ``exts`` and
    whose path holds ``must_contain``, in ``os.walk`` order."""
    exts = exts or ["jpg", "png", "npy"]
    out = []
    for root, _, files in os.walk(rootdir):
        for f in files:
            if f.split(".")[-1] in exts and must_contain in os.path.join(root, f):
                out.append(os.path.join(root, f))
    return out


@DATASETS.register("normal", "dataset.dataset_normal.NormalDataset")
class NormalDataset:
    """dataset_normal.py:53-130: DIODE .npy normals + BLIP captions."""

    def __init__(self, image_rootdir, normal_rootdir, caption_path, prob_use_caption=1.0,
                 image_size=512, random_flip=False, seed=0):
        self.image_files = sorted(recursively_read(image_rootdir, exts=["jpg", "png"]))
        self.normal_files = sorted(recursively_read(normal_rootdir, exts=["npy"]))
        for imf, nmf in zip(self.image_files, self.normal_files):
            base_i = os.path.basename(imf).split(".")[0]
            base_n = os.path.basename(nmf).split(".")[0]
            if base_i != base_n[:-7]:
                raise ValueError(f"{imf} and {nmf} are not a pair (<name>_normal.npy)")
        with open(caption_path) as f:
            self.captions = json.load(f)
        self.prob_use_caption = prob_use_caption
        self.image_size = image_size
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.image_files)

    total_images = __len__

    def __getitem__(self, index):
        image = open_image(self.image_files[index], "RGB")
        normal = np.load(self.normal_files[index])  # [-1, 1] float
        normal = ((normal * 0.5 + 0.5) * 255).astype("uint8")
        _same_size(image, normal, self.normal_files[index])

        image = _center_crop_resize(image, self.image_size)
        normal = _center_crop_resize(normal, self.image_size)
        image, normal = _flip(self.rng, self.random_flip, image, normal)

        name = os.path.basename(self.image_files[index])
        caption = self.captions[name] if self.rng.uniform() < self.prob_use_caption else ""
        return {
            "id": index,
            "image": _to_pm1(image),
            "normal": normal,
            "mask": np.float32(1.0),
            "caption": caption,
        }


@DATASETS.register("sem", "dataset.dataset_sem.SemanticDataset")
class SemanticDataset:
    """dataset_sem.py:53-135: ADE20K label maps (class ids, one-hot on the
    card)."""

    num_classes = 152

    def __init__(self, image_rootdir, sem_rootdir, caption_path, prob_use_caption=1.0,
                 image_size=512, random_flip=False, seed=0):
        self.image_files = sorted(recursively_read(image_rootdir, exts=["jpg"]))
        self.sem_files = sorted(recursively_read(sem_rootdir, exts=["png"]))
        with open(caption_path) as f:
            self.captions = json.load(f)
        if not len(self.image_files) == len(self.sem_files) == len(self.captions):
            raise ValueError(f"{len(self.image_files)} images, {len(self.sem_files)} label "
                             f"maps and {len(self.captions)} captions: one each per image")
        self.prob_use_caption = prob_use_caption
        self.image_size = image_size
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.image_files)

    total_images = __len__

    def __getitem__(self, index):
        image = open_image(self.image_files[index], "RGB")
        sem = open_image(self.sem_files[index], "L")
        _same_size(image, sem, self.sem_files[index])

        image = _center_crop_resize(image, self.image_size)
        sem = _center_crop_resize(sem, self.image_size, "nearest")
        image, sem = _flip(self.rng, self.random_flip, image, sem)

        top = int(sem.max())
        if top >= self.num_classes:
            raise ValueError(f"{self.sem_files[index]}: label {top} is not below the "
                             f"{self.num_classes} classes")

        name = os.path.basename(self.image_files[index])
        caption = self.captions[name] if self.rng.uniform() < self.prob_use_caption else ""
        return {
            "id": index,
            "image": _to_pm1(image),
            "sem": sem,
            "mask": np.float32(1.0),
            "caption": caption,
        }
