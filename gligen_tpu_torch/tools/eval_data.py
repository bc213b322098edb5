"""Seeded eval data in the formats of the eval datasets (``eval/datasets.py``):

  python3 -m gligen_tpu_torch.tools.eval_data --out DIR [--seed 0]

writes, under ``DIR``:

* ``images/``: the repository's ``inference_images`` PNGs and JPEGs, copied
  byte for byte (512^2 and 224^2; one grayscale PNG);
* ``instances.json`` and ``captions.json``: COCO detection and caption
  annotations over those images (``COCOEvalDataset``): 1 to 6 boxes an
  image of seeded categories, some too small or outside the centre crop,
  one image with no box, some images with no caption;
* ``grounding.json`` and ``embeddings/``: phrase-grounding annotations
  with a caption per image (``GroundingEvalDataset``) and one embedding
  file per annotation, ``<id>.npy`` or a torch-saved tensor named ``<id>``;
* ``stuff.json`` and ``category_embeddings.npz``: COCO-stuff annotations
  beside the instances (``LayoutEvalDataset``) and one 768-d embedding per
  category name.

Real COCO, stuff and embedding files are not in the repository; these
stand in for them at their formats.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path
from typing import Dict

import numpy as np

REPO = Path(__file__).resolve().parents[2]
IMAGE_DIR = REPO / "inference_images"
THINGS = ("person", "dog", "bicycle", "clock", "car", "bird")
STUFF = ("sky-other", "grass", "other", "wall-brick")
EMBED_DIM = 768


def _size(path: Path):
    """(width, height) of a PNG or JPEG, read by the port's decoders."""
    from gligen_tpu_torch.data import png

    h, w = png.open_image(path, "RGB").shape[:2]
    return w, h


def _box(rng, w, h, tiny=False):
    bw, bh = ((rng.uniform(1, 4), rng.uniform(1, 4)) if tiny
              else (rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h))
    return [float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh)), float(bw), float(bh)]


def write_eval_data(out: str, seed: int = 0) -> Dict[str, str]:
    """Write the files above under ``out`` (replacing what is there);
    returns their paths by name: image_root, instances, captions,
    grounding, embeddings, stuff, category_embeddings."""
    import torch

    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    images_dir, emb_dir = out / "images", out / "embeddings"
    images_dir.mkdir(parents=True)
    emb_dir.mkdir()
    rng = np.random.default_rng(seed)
    files = sorted(p for p in IMAGE_DIR.iterdir() if p.suffix in (".png", ".jpg"))
    images, annos, captions, stuff_annos = [], [], [], []
    things = [{"id": i + 1, "name": n} for i, n in enumerate(THINGS)]
    stuff_cats = [{"id": 100 + i, "name": n} for i, n in enumerate(STUFF)]
    anno_id = 1
    for i, src in enumerate(files):
        shutil.copyfile(src, images_dir / src.name)
        w, h = _size(src)
        image_id = 1000 + i
        images.append({"id": image_id, "file_name": src.name, "width": w, "height": h,
                       "caption": f"a photo of {src.stem.replace('_', ' ')}"})
        n_box = 0 if i == 2 else 1 + int(rng.integers(0, 6))
        for k in range(n_box):
            annos.append({"id": anno_id, "image_id": image_id,
                          "category_id": int(rng.integers(1, len(THINGS) + 1)),
                          "bbox": _box(rng, w, h, tiny=(k == 3))})
            anno_id += 1
        for _ in range(int(rng.integers(0, 3))):
            stuff_annos.append({"id": anno_id, "image_id": image_id,
                                "category_id": 100 + int(rng.integers(0, len(STUFF))),
                                "bbox": _box(rng, w, h)})
            anno_id += 1
        if i % 3 != 1:
            captions.append({"id": 5000 + i, "image_id": image_id,
                             "caption": f"a scene with {src.stem}"})
    for a in annos:
        vec = rng.standard_normal(EMBED_DIM).astype(np.float32)
        if a["id"] % 4 == 0:  # the reference stores torch tensors
            torch.save(torch.from_numpy(vec), emb_dir / str(a["id"]))
        else:
            np.save(emb_dir / f"{a['id']}.npy", vec)
    paths = {"image_root": str(images_dir), "embeddings": str(emb_dir)}
    for name, obj in (
            ("instances", {"images": images, "annotations": annos, "categories": things}),
            ("captions", {"images": images, "annotations": captions}),
            ("grounding", {"images": images, "annotations": annos}),
            ("stuff", {"images": images, "annotations": stuff_annos, "categories": stuff_cats})):
        paths[name] = str(out / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    paths["category_embeddings"] = str(out / "category_embeddings.npz")
    np.savez(paths["category_embeddings"], **{
        n: rng.standard_normal(EMBED_DIM).astype(np.float32) for n in THINGS + STUFF})
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    paths = write_eval_data(args.out, args.seed)
    print(json.dumps(paths))
    return paths


if __name__ == "__main__":
    main()
