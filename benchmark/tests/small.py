"""Small copies of the benchmark's configurations and cells, for the CPU
tests: the same modules and paths at a width and depth a test can run."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["unet"].update(model_channels=32, channel_mult=[1, 2], attention_resolutions=[1, 2],
                       num_res_blocks=1, num_heads=2, context_dim=64)
    tok = cfg["unet"]["grounding_tokenizer"]
    if tok["target"] == "text":
        tok["params"] = {"in_dim": 64, "out_dim": 64}
    else:
        tok["params"] = {"resize_input": 64, "out_dim": 64}
    cfg["text"] = {"hidden_size": 64, "layers": 2, "heads": 2}
    cfg["vae"] = {"ch": 32, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 1}
    return cfg


def workload(name: str, steps: int = 4, images: int = 2) -> dict:
    """Batch 2, ``steps`` PLMS steps (4: box+text's alpha stages give the
    first a fuser, hed's the first three), 256^2 where the configuration
    allows it (the hed downsampler fixes 512^2)."""
    with open(BENCH / "workloads" / f"{name}.json") as f:
        wl = json.load(f)
    wl = copy.deepcopy(wl)
    wl.update(batch=2, steps=steps, warmup_steps=2)
    if not name.startswith("hed."):
        wl["image_size"] = 256
    wl["check"].update(images=images, block_rows=2)
    return wl


def train_workload(name: str = "box_text.train_b32") -> dict:
    with open(BENCH / "workloads" / f"{name}.json") as f:
        wl = json.load(f)
    wl.update(batch=2, image_size=64, check_steps=3)
    wl["check"]["block_rows"] = 1
    return wl
