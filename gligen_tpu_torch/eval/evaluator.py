"""Batch evaluator (counterpart of ``gligen_tpu/eval/evaluator.py``, the
reference's demo/gligen/evaluator.py:67-211 with its empty ``fire_fid``
stub implemented).

Generates a fake image for every item of an eval dataset through the
port's ``GenerationPipeline``, writes the real and fake folders as PNGs
(``ckpt_to_folder_name`` naming, evaluator.py:59-64), then computes FID
from a pluggable feature function, LPIPS and PSNR over the folders:

  python -m gligen_tpu_torch.eval.evaluator --a REAL --b FAKE --psnr \\
      [--lpips [--lpips_backbone clip --clip_vision_ckpt CKPT]] [--fid] \\
      [--allow_random_features] [--device cuda|cpu]

prints one JSON line.  Without real backbone weights LPIPS and FID use
seeded random features (``eval/lpips.py``): the command refuses them
unless ``--allow_random_features`` asks for them.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gligen_tpu_torch.data import png
from gligen_tpu_torch.eval.metrics import fid_from_folders, folder_images, psnr
from gligen_tpu_torch.inference.adapters import get_adapter


def ckpt_to_folder_name(basename: str) -> str:
    """evaluator.py:59-64: checkpoint_00450001.pth -> tag000450001."""
    dot_index = basename.rfind(".")
    under_index = basename.rfind("_")
    return "tag" + basename[under_index + 1 : dot_index].zfill(9)


class Evaluator:
    """Fakes for an eval dataset's items, in batches of ``batch_size``
    (a remainder short of a batch is left out, as in the reference)."""

    def __init__(
        self,
        pipeline,
        dataset,
        output_dir: str,
        batch_size: int = 4,
        steps: int = 50,
        guidance_scale: float = 7.5,
        grounding_modality: str = "text",
    ):
        self.pipeline = pipeline
        self.dataset = dataset
        self.output_dir = output_dir
        self.batch_size = batch_size
        self.steps = steps
        self.guidance_scale = guidance_scale
        self.adapter = get_adapter(grounding_modality)

    def start_evaluating(self, max_items: Optional[int] = None) -> Dict[str, str]:
        """Write the ``real/`` and ``fake/`` folders (evaluator.py:154-198):
        item ``i`` as ``i.png`` in each.  Each batch's draws come from a
        ``torch.Generator`` on the pipeline's device seeded with the
        batch's first index (the JAX package's ``PRNGKey(start)``)."""
        real_dir = os.path.join(self.output_dir, "real")
        fake_dir = os.path.join(self.output_dir, "fake")
        os.makedirs(real_dir, exist_ok=True)
        os.makedirs(fake_dir, exist_ok=True)

        n = min(len(self.dataset), max_items or len(self.dataset))
        tok = self.pipeline.tokenizer
        device = self.pipeline.device
        for start in range(0, n - self.batch_size + 1, self.batch_size):
            items = [self.dataset[i] for i in range(start, start + self.batch_size)]
            ids = tok([it["caption"] for it in items])
            uc_ids = tok([""] * len(items))
            raw = {
                k: np.stack([np.asarray(it[k]) for it in items])
                for k in items[0]
                if k not in ("image", "caption", "id")
            }
            fake = self.pipeline.generate(
                ids, uc_ids, self.adapter.prepare(raw),
                steps=self.steps, guidance_scale=self.guidance_scale,
                grounding_extra=self.adapter.prepare_extra(raw),
                generator=torch.Generator(device=device).manual_seed(start),
            ).cpu().numpy()
            for i, it in enumerate(items):
                idx = start + i
                real = ((np.asarray(it["image"]) * 0.5 + 0.5) * 255).astype(np.uint8)
                png.write_png(os.path.join(real_dir, f"{idx}.png"), real)
                png.write_png(os.path.join(fake_dir, f"{idx}.png"),
                              (fake[i] * 255).astype(np.uint8))
        return {"real": real_dir, "fake": fake_dir}

    def fire_fid(self, folders: Dict[str, str],
                 feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
        """The computation the reference left as a stub (evaluator.py:200-211)."""
        return fid_from_folders(folders["real"], folders["fake"], feature_fn)

    def fire_lpips(self, folders: Dict[str, str], lpips_fn=None) -> float:
        """The mean LPIPS over the aligned real/fake pairs (``lpips_fn`` by
        default the seeded "conv" proxy on the pipeline's device)."""
        from gligen_tpu_torch.eval.lpips import lpips_over_folders, make_lpips_fn

        lpips_fn = lpips_fn or make_lpips_fn(device=self.pipeline.device)
        return lpips_over_folders(folders["real"], folders["fake"], lpips_fn)


def conv_fid_feature_fn(device) -> Callable[[np.ndarray], np.ndarray]:
    """The FID features with no vision tower given: the deepest stage of
    the seeded ``PerceptualConvStack`` (seed 0), mean-pooled, fp32 with
    TF32 off, on ``device``."""
    from gligen_tpu_torch.eval.lpips import PerceptualConvStack
    from gligen_tpu_torch.ops.basic import tf32_off

    model = PerceptualConvStack(seed=0).to(device).eval()

    @torch.no_grad()
    def feat(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=device)
        with tf32_off():
            return model(x)[-1].mean(dim=(1, 2)).cpu().numpy()

    return feat


def main(argv=None):
    """``python -m gligen_tpu_torch.eval.evaluator --a DIR --b DIR --psnr
    [--lpips] [--fid]``: metrics over two image folders (aligned file names
    pair up), one JSON line."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--a", required=True, help="first folder (e.g. reference outputs)")
    ap.add_argument("--b", required=True, help="second folder (e.g. our outputs)")
    ap.add_argument("--lpips", action="store_true")
    ap.add_argument("--lpips_backbone", default="conv", choices=["conv", "clip"])
    ap.add_argument("--clip_vision_ckpt", default=None)
    ap.add_argument("--fid", action="store_true")
    ap.add_argument("--psnr", action="store_true")
    ap.add_argument(
        "--allow_random_features", action="store_true",
        help="permit the seeded-random fallback feature extractors (conv LPIPS backbone / "
        "conv FID features). Numbers from random features are self-consistent but NOT "
        "comparable to published FID/LPIPS; without this flag the command refuses rather "
        "than printing them.",
    )
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' for the backbones")
    args = ap.parse_args(argv)

    def _require_random_ok(what: str) -> None:
        if not args.allow_random_features:
            ap.error(
                f"{what} would use seeded-RANDOM features (no pretrained weights supplied): "
                "the values are not comparable to published numbers. Pass "
                "--allow_random_features to proceed, or supply --lpips_backbone clip "
                "--clip_vision_ckpt for real features."
            )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluator: no CUDA device; pass --device cpu")
    out = {}
    if args.lpips:
        from gligen_tpu_torch.eval.lpips import lpips_over_folders, make_lpips_fn

        if args.lpips_backbone == "conv":
            _require_random_ok("--lpips (conv backbone)")
            out["lpips_features"] = "random"
            fn = make_lpips_fn("conv", device=device)
        else:
            if not args.clip_vision_ckpt:
                ap.error("--lpips_backbone clip needs --clip_vision_ckpt")
            from gligen_tpu_torch.inference.cli import load_vision

            fn = make_lpips_fn("clip", module=load_vision(args.clip_vision_ckpt, device))
        out["lpips"] = lpips_over_folders(args.a, args.b, fn)
    if args.fid:
        # CLIP weights may be absent: the conv stack's deepest stage pooled
        # is the FID feature when no vision tower is supplied
        _require_random_ok("--fid (conv feature fallback)")
        out["fid_features"] = "random"
        out["fid"] = fid_from_folders(args.a, args.b, conv_fid_feature_fn(device))
    if args.psnr:
        out["psnr"] = float(np.mean([float(psnr(x[None], y[None]))
                                     for x, y in zip(folder_images(args.a),
                                                     folder_images(args.b))]))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
