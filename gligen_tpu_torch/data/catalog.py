"""Dataset catalog (counterpart of ``gligen_tpu/data/catalog.py``, the
reference's dataset/catalog.py:3-140): the 12 named training datasets
mapped to {target, train_params}.  Targets are ``DATASETS`` registry names
(``utils/registry.py``); the reference's dotted paths are the registered
aliases.  Importing this module registers all of them: the box-grounding
TSVs (``data/box_dataset.py``), COCO keypoints
(``data/keypoint_dataset.py``) and the spatial modalities
(``data/spatial_datasets.py``)."""

from __future__ import annotations

import os
from typing import Dict

from gligen_tpu_torch.data import box_dataset, keypoint_dataset, spatial_datasets  # noqa: F401


def dataset_catalog(root: str) -> Dict[str, Dict]:
    j = lambda *p: os.path.join(root, *p)
    box = "dataset.tsv_dataset.TSVDataset"
    return {
        "VGGrounding": {
            "target": box,
            "train_params": dict(tsv_path=j("GROUNDING/gqa/tsv/train-00.tsv")),
        },
        "FlickrGrounding": {
            "target": box,
            "train_params": dict(tsv_path=j("GROUNDING/flickr30k/tsv/train-00.tsv")),
        },
        "SBUGrounding": {
            "target": box,
            "train_params": dict(tsv_path=j("GROUNDING/SBU/tsv/train-00.tsv")),
        },
        "CC3MGrounding": {
            "target": box,
            "train_params": dict(tsv_path=j("GROUNDING/CC3M/tsv/train-00.tsv")),
        },
        "CC12MGrounding": {
            "target": box,
            "train_params": dict(tsv_path=j("GROUNDING/CC12M/tsv/train-00.tsv")),
        },
        "Obj365Detection": {
            "target": box,
            "train_params": dict(tsv_path=j("OBJECTS365/tsv/train-00.tsv")),
        },
        "CC3MGroundingHed": {
            "target": "dataset.dataset_hed.HedDataset",
            "train_params": dict(
                tsv_path=j("GROUNDING/CC3M/tsv/train-00.tsv"),
                hed_tsv_path=j("GROUNDING/CC3M/tsv_hed/train-00.tsv"),
            ),
        },
        "CC3MGroundingCanny": {
            "target": "dataset.dataset_canny.CannyDataset",
            "train_params": dict(
                tsv_path=j("GROUNDING/CC3M/tsv/train-00.tsv"),
                canny_tsv_path=j("GROUNDING/CC3M/tsv_canny/train-00.tsv"),
            ),
        },
        "CC3MGroundingDepth": {
            "target": "dataset.dataset_depth.DepthDataset",
            "train_params": dict(
                tsv_path=j("GROUNDING/CC3M/tsv/train-00.tsv"),
                depth_tsv_path=j("GROUNDING/CC3M/tsv_depth/train-00.tsv"),
            ),
        },
        "COCO2017Keypoint": {
            "target": "dataset.dataset_kp.KeypointDataset",
            "train_params": dict(
                image_root=j("COCO/images"),
                keypoints_json_path=j("COCO/annotations2017/person_keypoints_train2017.json"),
                caption_json_path=j("COCO/annotations2017/captions_train2017.json"),
            ),
        },
        "DIODENormal": {
            "target": "dataset.dataset_normal.NormalDataset",
            "train_params": dict(
                image_rootdir=j("normal/image_train"),
                normal_rootdir=j("normal/normal_train"),
                caption_path=j("normal/diode_cation.json"),
            ),
        },
        "ADESemantic": {
            "target": "dataset.dataset_sem.SemanticDataset",
            "train_params": dict(
                image_rootdir=j("ADE/ADEChallengeData2016/images/training"),
                sem_rootdir=j("ADE/ADEChallengeData2016/annotations/training"),
                caption_path=j("ADE/ade_train_images_cation.json"),
            ),
        },
    }
