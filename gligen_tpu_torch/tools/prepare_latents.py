"""Build offline VAE-latent caches for grounding TSVs (counterpart of the
JAX package's ``tools/prepare_latents.py``).

One pass of the frozen VAE encoder over every row's center-cropped image,
both flip orientations, batched on the card; the Trainer's
``--cached_latents`` then samples from the cached posterior moments
instead of encoding 512^2 pixels every step (``data/latent_cache.py``).

  python3 gligen_tpu_torch/tools/prepare_latents.py --tsv DATA/flickr/train.tsv \\
      --out_dir DATA/latents [--official_ckpt sd-v1-4.ckpt | --ckpt gligen.pth] [--batch 8]

Without a checkpoint the VAE is random, drawn from ``--seed`` (smoke runs
only): the cache records a weight digest and the Trainer refuses a cache
built from other weights.  A caller in the same process passes its VAE
module to ``main(argv, vae=...)``.  The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

REPO = Path(__file__).resolve().parents[2]


def random_vae(seed: int, dtype, device):
    """The SD-1.4 VAE with the JAX package's initialisers, from ``seed``."""
    import torch

    from gligen_tpu_torch.inference.pipeline import random_init_
    from gligen_tpu_torch.models.vae import AutoencoderKL

    with torch.device(device):
        vae = AutoencoderKL(dtype=dtype).eval()
    random_init_(vae, torch.Generator(device=device).manual_seed(seed))
    return vae


def main(argv: Optional[Sequence[str]] = None, vae=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tsv", required=True, nargs="+", help="grounding TSV file(s)")
    ap.add_argument("--out_dir", required=True,
                    help="cache dir; files land as <tsv-stem>.latents.npy")
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8,
                    help="TSV rows per encode (2x images: both flips)")
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--official_ckpt", type=str, default=None,
                    help="sd-v1-4.ckpt with the real VAE weights")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="a GLIGEN .pth with the real VAE weights")
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=("bfloat16", "float32"),
                    help="must match the training --dtype")
    ap.add_argument("--seed", type=int, default=0, help="the random VAE's seed")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch

    from gligen_tpu_torch.data.latent_cache import cache_path_for, write_latent_cache

    if vae is None:
        dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
        vae = random_vae(args.seed, dtype, args.device)
        state = None
        if args.official_ckpt:
            from gligen_tpu_torch.training.checkpoints import load_official_sd_checkpoint

            state = load_official_sd_checkpoint(args.official_ckpt)["autoencoder"]
        elif args.ckpt:
            from gligen_tpu_torch.training.checkpoints import load_gligen_torch_checkpoint

            state = load_gligen_torch_checkpoint(args.ckpt)[0]["autoencoder"]
        if state is not None:
            vae.load_state_dict(state, strict=True)

    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for tsv in args.tsv:
        out = cache_path_for(tsv, args.out_dir)
        t0 = time.time()
        write_latent_cache(tsv, out, vae, image_size=args.image_size, batch=args.batch,
                           max_images=args.max_images, progress=True)
        print(f"{out}: {time.time() - t0:.1f}s", flush=True)
        paths.append(out)
    return paths


if __name__ == "__main__":
    main()
