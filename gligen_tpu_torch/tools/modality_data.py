"""Seeded training data for the keypoint and spatial modalities, on disk in
the reference's formats at ``data/catalog.py``'s paths under a root:

  * COCO keypoints: ``COCO/images/<file>`` and
    ``COCO/annotations2017/{person_keypoints,captions}_train2017.json``;
  * CC3M hed / canny / depth: the image TSV
    ``GROUNDING/CC3M/tsv/train-00.tsv`` and one condition TSV each
    (``tsv_hed``, ``tsv_canny``, ``tsv_depth``), rows paired by ``data_id``;
  * DIODE normals: ``normal/image_train/<name>.<ext>``,
    ``normal/normal_train/<name>_normal.npy`` (float32 in [-1, 1]) and the
    captions ``normal/diode_cation.json``;
  * ADE20K: ``ADE/ADEChallengeData2016/{images,annotations}/training``
    (``<name>.jpg`` and grayscale ``<name>.png`` labels in [0, 151]) and
    ``ADE/ade_train_images_cation.json``.

Images are given as encoded bytes (a PNG or a JPEG file's), written as they
are; maps and labels are seeded arrays written as PNG.  Nothing here needs
PIL.  ``chip_smoke.py`` and the CPU tests write their datasets with it.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gligen_tpu_torch.data import png, tsv
from gligen_tpu_torch.data.catalog import dataset_catalog

# (file name, encoded bytes, (height, width)) of one image
EncodedImage = Tuple[str, bytes, Tuple[int, int]]
MAP_KEYS = {"hed": "hed_edge", "canny": "canny_edge", "depth": "depth"}
SEM_CLASSES = 152


def image_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of PNG or JPEG bytes."""
    if data[:8] == png.SIGNATURE:
        return png.decode_png(data)[0].shape[:2]
    from gligen_tpu_torch.data import jpeg

    return jpeg.decode(data)[0].shape[:2]


def images_from_files(paths: Sequence[str]) -> List[EncodedImage]:
    out = []
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        out.append((os.path.basename(path), data, image_size(data)))
    return out


def _params(root: str, name: str) -> Dict:
    return dataset_catalog(root)[name]["train_params"]


def write_keypoint_tree(root: str, images: Sequence[EncodedImage],
                        rng: np.random.Generator) -> Dict:
    """COCO2017Keypoint: every image gets 1 to 3 people, each a box inside
    the image and 17 keypoints inside its box, visibility drawn from
    {0, 1, 2}, and two captions.  Returns the catalog's train_params."""
    params = _params(root, "COCO2017Keypoint")
    os.makedirs(params["image_root"], exist_ok=True)
    os.makedirs(os.path.dirname(params["keypoints_json_path"]), exist_ok=True)
    entries, annos, caps = [], [], []
    for i, (name, data, (h, w)) in enumerate(images):
        with open(os.path.join(params["image_root"], name), "wb") as f:
            f.write(data)
        image_id = 1000 + i
        entries.append({"id": image_id, "file_name": name, "height": h, "width": w})
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(0.15, 0.6) * w, rng.uniform(0.2, 0.7) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            kps = []
            for _ in range(17):
                kps += [float(x0 + rng.uniform(0, bw)), float(y0 + rng.uniform(0, bh)),
                        int(rng.integers(0, 3))]
            annos.append({"id": len(annos) + 1, "image_id": image_id,
                          "bbox": [float(x0), float(y0), float(bw), float(bh)],
                          "keypoints": kps, "num_keypoints": 17, "category_id": 1})
        for k in range(2):
            caps.append({"id": len(caps) + 1, "image_id": image_id,
                         "caption": f"a person in picture {i}, take {k}"})
    with open(params["keypoints_json_path"], "w") as f:
        json.dump({"images": entries, "annotations": annos}, f)
    with open(params["caption_json_path"], "w") as f:
        json.dump({"images": entries, "annotations": caps}, f)
    return params


def write_paired_tsvs(root: str, images: Sequence[EncodedImage], rng: np.random.Generator,
                      modalities: Sequence[str] = ("hed", "canny", "depth")) -> Dict[str, Dict]:
    """CC3M's image TSV (rows [data_id, {data_id, image, caption}] with the
    images' bytes as base64) and one condition TSV a modality (rows
    [data_id, {data_id, <key>: base64 PNG}]) of seeded maps at each image's
    size.  Returns {modality: the catalog's train_params}."""
    names = {"hed": "CC3MGroundingHed", "canny": "CC3MGroundingCanny",
             "depth": "CC3MGroundingDepth"}
    params = {m: _params(root, names[m]) for m in modalities}
    image_tsv = next(iter(params.values()))["tsv_path"]
    os.makedirs(os.path.dirname(image_tsv), exist_ok=True)
    writer = tsv.TSVWriter(image_tsv)
    for i, (_, data, _) in enumerate(images):
        writer.write([i, json.dumps({"data_id": i, "image": base64.b64encode(data).decode(),
                                     "caption": f"a captioned scene number {i}"})])
    writer.close()
    for m, p in params.items():
        path = p[f"{m}_tsv_path"]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        writer = tsv.TSVWriter(path)
        for i, (_, _, (h, w)) in enumerate(images):
            pixels = rng.integers(0, 256, (h, w, 3), np.uint8)
            writer.write([i, json.dumps({"data_id": i,
                                         MAP_KEYS[m]: tsv.encode_base64_image(pixels)})])
        writer.close()
    return params


def write_normal_tree(root: str, images: Sequence[EncodedImage],
                      rng: np.random.Generator) -> Dict:
    """DIODENormal: the images as ``<stem>.<ext>``, a seeded unit-normal
    map each as ``<stem>_normal.npy``, BLIP-style captions by file name."""
    params = _params(root, "DIODENormal")
    for d in (params["image_rootdir"], params["normal_rootdir"]):
        os.makedirs(d, exist_ok=True)
    captions = {}
    for i, (name, data, (h, w)) in enumerate(images):
        with open(os.path.join(params["image_rootdir"], name), "wb") as f:
            f.write(data)
        n = rng.standard_normal((h, w, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        stem = name.split(".")[0]
        np.save(os.path.join(params["normal_rootdir"], f"{stem}_normal.npy"), n)
        captions[name] = f"an indoor scene number {i}"
    with open(params["caption_path"], "w") as f:
        json.dump(captions, f)
    return params


def write_sem_tree(root: str, images: Sequence[EncodedImage], rng: np.random.Generator) -> Dict:
    """ADESemantic: the images (JPEG bytes, as ``.jpg``) and a grayscale
    label PNG each, 16 x 16 blocks of seeded labels in [0, 151], the top
    one always present."""
    params = _params(root, "ADESemantic")
    for d in (params["image_rootdir"], params["sem_rootdir"]):
        os.makedirs(d, exist_ok=True)
    captions = {}
    for i, (name, data, (h, w)) in enumerate(images):
        stem = name.split(".")[0]
        with open(os.path.join(params["image_rootdir"], f"{stem}.jpg"), "wb") as f:
            f.write(data)
        blocks = rng.integers(0, SEM_CLASSES, (-(-h // 16), -(-w // 16)), np.uint8)
        labels = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[:h, :w]
        labels[0, 0] = SEM_CLASSES - 1
        png.write_png(os.path.join(params["sem_rootdir"], f"{stem}.png"), labels)
        captions[f"{stem}.jpg"] = f"a labelled scene number {i}"
    with open(params["caption_path"], "w") as f:
        json.dump(captions, f)
    return params
