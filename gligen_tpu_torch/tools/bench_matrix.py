"""The operating-point matrix: samplers x modalities (counterpart of the JAX
package's ``tools/bench_matrix.py``).

Rows at 512^2, batch 8 (the users' operating point), bf16, the demo alpha
schedule [0.3, 0, 0.7], random SD-1.4-width weights (not de-zeroed, as in
the JAX tool):

  samplers   -- PLMS-50 (the headline), DDIM-50 and DDIM-250 (the
                reference's other sampler, gligen_inference.py:386-387) on
                the box+text model;
  modalities -- box_text_image, keypoint, hed and sem at PLMS-50: the
                grounding tokens are computed once a request, outside the
                UNet loop, so every modality should cost about what
                box_text does.

Each row reports img/s and s/img, the best of ``--repeats`` warm requests
by the host's clock around a synchronised request, and ``first_call_s``,
the first request's time, kernel builds and warm-up included (the JAX
tool's ``compile_sec``).  It runs on the card unless asked for the CPU,
where the times are the CPU's, no device number.  Usage:

  python3 gligen_tpu_torch/tools/bench_matrix.py                 # all rows
  python3 gligen_tpu_torch/tools/bench_matrix.py --rows plms50,hed --repeats 1
  python3 gligen_tpu_torch/tools/bench_matrix.py --json out.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]

# (tokenizer config, downsampler config) per modality, from configs/*.yaml
MODALITIES = {
    "box_text": (
        {"target": "text", "params": {"in_dim": 768, "out_dim": 768}}, None),
    "box_text_image": (
        {"target": "text_image", "params": {"in_dim": 768, "out_dim": 768}}, None),
    "keypoint": (
        {"target": "keypoint",
         "params": {"max_persons_per_image": 8, "out_dim": 768}}, None),
    "hed": (
        {"target": "hed", "params": {"resize_input": 448, "out_dim": 768}},
        {"target": "hed", "params": {"out_dim": 1}}),
    "sem": (
        {"target": "sem",
         "params": {"resize_input": 256, "in_dim": 152, "out_dim": 768}},
        {"target": "sem",
         "params": {"resize_input": 256, "in_dim": 152, "out_dim": 8}}),
}
# row: (modality, sampler, steps)
ROWS = {
    "plms50": ("box_text", "plms", 50),
    "ddim50": ("box_text", "ddim", 50),
    "ddim250": ("box_text", "ddim", 250),
    "box_text_image": ("box_text_image", "plms", 50),
    "keypoint": ("keypoint", "plms", 50),
    "hed": ("hed", "plms", 50),
    "sem": ("sem", "plms", 50),
}
ALPHA = [0.3, 0.0, 0.7]
BOS, EOS = 49406, 49407


def _grounding(modality: str, b: int):
    """One live grounding slot in the tokenizer's static shapes, and the
    downsampler's map (or None): the JAX tool's numpy arrays, bit for bit."""
    rng = np.random.default_rng(0)
    if modality == "box_text":
        g = {
            "boxes": np.zeros((b, 30, 4), np.float32),
            "masks": np.zeros((b, 30), np.float32),
            "positive_embeddings": np.zeros((b, 30, 768), np.float32),
        }
        g["boxes"][:, 0] = [0.1, 0.2, 0.5, 0.8]
        g["masks"][:, 0] = 1.0
        g["positive_embeddings"][:, 0] = rng.standard_normal(768) * 0.1
        return g, None
    if modality == "box_text_image":
        g = {
            "boxes": np.zeros((b, 30, 4), np.float32),
            "masks": np.zeros((b, 30), np.float32),
            "text_masks": np.zeros((b, 30), np.float32),
            "image_masks": np.zeros((b, 30), np.float32),
            "text_embeddings": np.zeros((b, 30, 768), np.float32),
            "image_embeddings": np.zeros((b, 30, 768), np.float32),
        }
        g["boxes"][:, 0] = [0.1, 0.2, 0.5, 0.8]
        g["masks"][:, 0] = g["text_masks"][:, 0] = 1.0
        g["text_embeddings"][:, 0] = rng.standard_normal(768) * 0.1
        return g, None
    if modality == "keypoint":
        g = {
            "points": np.clip(rng.random((b, 8 * 17, 2)), 0, 1).astype(np.float32),
            "masks": np.zeros((b, 8 * 17), np.float32),
        }
        g["masks"][:, :17] = 1.0
        return g, None
    if modality == "hed":
        # raw uint8 pixels, normalised on the device (prepare_spatial_map)
        m = rng.integers(0, 256, (b, 512, 512, 3)).astype(np.uint8)
        return {"hed_edge": m, "mask": np.ones((b,), np.float32)}, m
    if modality == "sem":
        # uint8 class labels, one-hot on the device
        lab = rng.integers(0, 152, (b, 512, 512)).astype(np.uint8)
        return {"sem": lab, "mask": np.ones((b,), np.float32)}, lab
    raise ValueError(modality)


def bench_row(name: str, modality: str, sampler: str, steps: int, batch: int, repeats: int,
              device: Any = "cuda", unet_config: Optional[Dict[str, Any]] = None,
              latent_size: int = 64, **create_kw) -> Dict[str, Any]:
    """One row: the modality's model at SD-1.4 width (``unet_config`` and
    ``create_kw``, GligenComponents.create's other keywords, replace parts of
    it: the CPU test's small model), one first request, then the best of
    ``repeats`` warm ones.  Prints and returns the row."""
    import torch

    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents

    tok, ds = MODALITIES[modality]
    unet_cfg: Dict[str, Any] = {"grounding_tokenizer": tok}
    if ds is not None:
        unet_cfg["grounding_downsampler"] = ds
    unet_cfg.update(unet_config or {})
    device = torch.device(device)
    comps = GligenComponents.create(unet_config=unet_cfg, dtype=torch.bfloat16, seed=0,
                                    device=device, **create_kw)
    pipe = GenerationPipeline(comps)
    ids = np.full((batch, 77), EOS, np.int64)
    ids[:, 0] = BOS
    grounding, extra = _grounding(modality, batch)

    def run(seed: int):
        t0 = time.perf_counter()
        img = pipe.generate(ids, ids.copy(), grounding, grounding_extra=extra, steps=steps,
                            guidance_scale=7.5, sampler=sampler, alpha_stages=ALPHA,
                            latent_size=latent_size,
                            generator=torch.Generator(device=device).manual_seed(seed))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return img, time.perf_counter() - t0

    img, first = run(0)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"{name}: non-finite image")
    best = min(run(i + 1)[1] for i in range(repeats))
    row = {
        "row": name, "modality": modality, "sampler": sampler, "steps": steps, "batch": batch,
        "img_per_sec": batch / best, "sec_per_img": best / batch, "first_call_s": first,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "clock": "host wall around a synchronised request",
    }
    print(json.dumps(row), flush=True)
    return row


def table(rows) -> str:
    lines = ["| Row | Sampler | Steps | Batch | img/s | s/img | first call s |",
             "|---|---|---|---|---|---|---|"]
    lines += [f"| {r['row']} ({r['modality']}) | {r['sampler']} | {r['steps']} | {r['batch']} "
              f"| {r['img_per_sec']:.4f} | {r['sec_per_img']:.4f} | {r['first_call_s']:.2f} |"
              for r in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    where = "cpu (host times, no device number)"
    if args.device != "cpu":
        where = card_setup("bench_matrix")
    print(f"bench_matrix: batch {args.batch}, best of {args.repeats} on {where}", flush=True)
    rows = []
    for key in args.rows.split(","):
        modality, sampler, steps = ROWS[key.strip()]
        rows.append(bench_row(key.strip(), modality, sampler, steps, args.batch, args.repeats,
                              args.device))
    print(table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
