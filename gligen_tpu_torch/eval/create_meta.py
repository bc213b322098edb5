"""Eval scenario generation (counterpart of ``gligen_tpu/eval/create_meta.py``,
the reference's demo/gligen/create_meta.py).

Exports CLI-consumable meta JSON (prompt, phrases and normalised boxes per
item) from an eval dataset, so that quantitative runs share the inference
surface of ``gligen_tpu_torch.inference.cli``:

  python -m gligen_tpu_torch.eval.create_meta --image_root IMAGES \\
      --instances_json instances.json [--captions_json captions.json] \\
      --ckpt CKPT --out metas.json [--max_items N]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def metas_from_dataset(
    dataset,
    ckpt: str,
    save_folder_name: str = "eval",
    max_items: Optional[int] = None,
    alpha_type: Optional[List[float]] = None,
) -> List[Dict]:
    """One meta per item (create_meta.py:14-41): the items need caption,
    boxes (N, 4) normalised, masks (N,), and optionally the category
    names as 'phrases' (else the caption stands for each box)."""
    metas = []
    n = min(len(dataset), max_items or len(dataset))
    for i in range(n):
        item = dataset[i]
        live = item["masks"] > 0
        boxes = [list(map(float, b)) for b in item["boxes"][live]]
        phrases = item.get("phrases") or [item["caption"]] * len(boxes)
        metas.append(
            dict(
                ckpt=ckpt,
                prompt=item["caption"],
                phrases=list(phrases)[: len(boxes)],
                locations=boxes,
                alpha_type=alpha_type,
                save_folder_name=save_folder_name,
                eval_id=int(item.get("id", i)),
            )
        )
    return metas


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_root", required=True)
    p.add_argument("--instances_json", required=True)
    p.add_argument("--captions_json", default=None)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max_items", type=int, default=None)
    args = p.parse_args(argv)

    from gligen_tpu_torch.eval.datasets import COCOEvalDataset

    ds = COCOEvalDataset(args.image_root, args.instances_json, args.captions_json,
                         max_images=args.max_items)
    metas = metas_from_dataset(ds, args.ckpt, max_items=args.max_items)
    with open(args.out, "w") as f:
        json.dump(metas, f, indent=1)
    print(f"wrote {len(metas)} metas -> {args.out}")
    return metas


if __name__ == "__main__":
    main()
