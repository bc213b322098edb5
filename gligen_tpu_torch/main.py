"""The training command line (counterpart of the root ``main.py``, the
reference's main.py).

  python -m gligen_tpu_torch.main --yaml_file configs/flickr_text.yaml --name test \\
      --DATA_ROOT DATA --OUTPUT_ROOT OUTPUT [--official_ckpt_name sd-v1-4.ckpt] ...

Loads a reference-format YAML (``config.py``, no PyYAML), merges the flags
over it and trains on the card (``training/trainer.py``); ``--device cpu``
runs the kernels' plain versions, for small test configs only.  The flags
are the root ``main.py``'s, names and defaults, and ``--device``.  One
card: the batch is ``--batch_size``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--DATA_ROOT", type=str, default="DATA", help="dataset root")
    p.add_argument("--OUTPUT_ROOT", type=str, default="OUTPUT")
    p.add_argument("--name", type=str, default="test")
    p.add_argument("--yaml_file", type=str, default="configs/flickr_text.yaml")
    p.add_argument("--base_learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=10000)
    p.add_argument("--scheduler_type", type=str, default="constant")
    p.add_argument("--batch_size", type=int, default=2, help="per device")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--official_ckpt_name", type=str, default=None,
                   help="path to sd-v1-4.ckpt (4-way split + convert)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="GLIGEN ckpt to start from (inpainting training)")
    p.add_argument("--inpaint_mode", action="store_true")
    p.add_argument("--randomize_fg_mask", action="store_true")
    p.add_argument("--random_add_bg_mask", action="store_true")
    p.add_argument("--enable_ema", action="store_true")
    p.add_argument("--ema_rate", type=float, default=0.9999)
    p.add_argument("--total_iters", type=int, default=500000)
    p.add_argument("--save_every_iters", type=int, default=5000)
    p.add_argument("--grounding_modality", type=str, default=None,
                   help="override; else inferred from the yaml adapter target")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--seed", type=int, default=123, help="used in sampler (reference main.py:21)")
    p.add_argument(
        "--disable_inference_in_training", type=lambda x: x.lower() == "true",
        default=False,
        help="skip the periodic PLMS preview grids at checkpoints (reference main.py:47)",
    )
    p.add_argument("--multihost", action="store_true",
                   help="several hosts (ROADMAP M12: not ported; raises)")
    p.add_argument(
        "--cached_latents", type=str, default=None,
        help="directory of <tsv-stem>.latents.npy posterior-moment caches "
        "(gligen_tpu_torch/tools/prepare_latents.py); skips the frozen VAE encode",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="the card (default) or 'cpu' (the kernels' plain versions)")
    return p.parse_args(argv)


def modality_from_config(config) -> str:
    target = config.get("grounding_tokenizer_input", {}).get("target", "")
    for mod in ("text_image", "keypoint", "hed", "canny", "depth", "normal", "sem"):
        if mod in target:
            return mod
    return "text"


def main(argv: Optional[Sequence[str]] = None):
    """Train as the flags say; returns the ``Trainer``."""
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError("--multihost trains over several hosts: ROADMAP M12 "
                                  "(multi-GPU) has not been ported")

    from gligen_tpu_torch.config import load_yaml_config, normalize_model_config
    from gligen_tpu_torch.training.trainer import Trainer, TrainerConfig

    config = normalize_model_config(load_yaml_config(args.yaml_file))
    run = TrainerConfig(
        name=args.name,
        output_root=args.OUTPUT_ROOT,
        data_root=args.DATA_ROOT,
        base_learning_rate=args.base_learning_rate,
        weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps,
        scheduler_type=args.scheduler_type,
        total_iters=args.total_iters,
        batch_size=args.batch_size,
        save_every_iters=args.save_every_iters,
        enable_ema=args.enable_ema,
        ema_rate=args.ema_rate,
        inpaint_mode=args.inpaint_mode,
        randomize_fg_mask=args.randomize_fg_mask,
        random_add_bg_mask=args.random_add_bg_mask,
        official_ckpt_name=args.official_ckpt_name,
        ckpt=args.ckpt,
        grounding_modality=args.grounding_modality or modality_from_config(config),
        dtype=args.dtype,
        seed=args.seed,
        workers=args.workers,
        preview_samples=not args.disable_inference_in_training,
        cached_latents=args.cached_latents,
    )
    trainer = Trainer(config, run, device=args.device)
    trainer.start_training()
    return trainer


if __name__ == "__main__":
    main()
