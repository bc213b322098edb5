"""The fidelity gate of the served configuration (counterpart of the JAX
package's ``tools/fidelity_gate.py``): how far the bf16 serving path, with
its fused kernels, strays from a reference-grade fp32 run of the same
weights, noise and inputs.

  arm A (fp32, reference-grade): ``--dtype float32``,
        GLIGEN_TPU_FUSED_PROJ=0, GLIGEN_TPU_FUSED_NORM=none,
        GLIGEN_TPU_FUSED_CONV=0 and NVIDIA_TF32_OVERRIDE=0 (cuDNN's convs
        and cuBLAS run in full fp32, not TF32); attention stays on the
        flash kernel's fp32 route (3xTF32);
  arm B (bf16, the serving default): ``--dtype bfloat16``, the fused
        projections and GroupNorm kernels, TF32 as PyTorch leaves it.

Both arms pin every switch (a stale export in the caller's shell must not
turn one arm into the other), share the de-zeroed random weights
(``--dezero`` is deterministic in the parameter's name), the seed and the
grounding inputs, and run the reference's 11 scenarios through the port's
CLI in a subprocess each (the switches are read by the process).  Each
pair of images of the same name is scored: proxy-LPIPS (the seeded conv
backbone of ``eval/lpips.py``, or CLIP's with ``--clip_vision_ckpt``),
PSNR and max |Δpixel|, against the budget LPIPS <= 0.025, PSNR >= 20 dB.

    python3 gligen_tpu_torch/tools/fidelity_gate.py --steps 50 --batch 2
    python3 gligen_tpu_torch/tools/fidelity_gate.py --report build/fidelity   # score only

Writes ``<out>/fidelity.json`` (by default ``build/fidelity/``), never the
repository's ``FIDELITY.json``, and prints a table.  It runs on the card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]

# a value of None removes the variable from the arm's environment
ARM_ENV = {
    "fp32": {"GLIGEN_TPU_FUSED_PROJ": "0", "GLIGEN_TPU_FUSED_NORM": "none",
             "GLIGEN_TPU_FUSED_CONV": "0", "NVIDIA_TF32_OVERRIDE": "0"},
    "bf16": {"GLIGEN_TPU_FUSED_PROJ": "1", "GLIGEN_TPU_FUSED_NORM": "gn",
             "GLIGEN_TPU_FUSED_CONV": "0", "NVIDIA_TF32_OVERRIDE": None},
}
ARM_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}

SCENARIOS = [
    "generation_box_text", "inpainting_box_text", "generation_box_image",
    "generation_box_text_style", "inpainting_box_image", "hed", "canny",
    "normal", "depth", "sem", "keypoint",
]
LPIPS_MAX = 0.025  # half of the 0.05 end-to-end budget (tests/test_serving_fidelity.py)
PSNR_MIN = 20.0


def arm_env(arm: str) -> Dict[str, str]:
    env = dict(os.environ)
    for key, value in ARM_ENV[arm].items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    return env


def run_arm(arm: str, out_dir: str, steps: int, batch: int, seed: int,
            scenarios: Optional[List[str]] = None, ckpt: str = "random",
            device: str = "cuda") -> None:
    """The CLI over ``scenarios`` in a subprocess with ``arm``'s switches;
    each scenario's folder is emptied first (the CLI numbers on from the
    files a folder holds)."""
    for sc in scenarios or SCENARIOS:
        shutil.rmtree(os.path.join(out_dir, sc), ignore_errors=True)
    cmd = [sys.executable, "-m", "gligen_tpu_torch.inference.cli", "--ckpt", ckpt,
           "--dtype", ARM_DTYPE[arm], "--batch_size", str(batch), "--steps", str(steps),
           "--seed", str(seed), "--folder", out_dir, "--device", device]
    if ckpt.startswith("random"):
        cmd.append("--dezero")
    if scenarios:
        cmd += ["--scenarios", ",".join(scenarios)]
    print(f"[{arm}] {' '.join(cmd)}", flush=True)
    subprocess.run(cmd, env=arm_env(arm), cwd=REPO, check=True)


def score(out_root: str, clip_vision_ckpt: Optional[str] = None, device: str = "cuda") -> dict:
    """Per scenario the mean LPIPS and PSNR and the largest |Δpixel| over
    the images of the same name under ``<out_root>/fp32`` and ``/bf16``
    ({"status": "missing"} where either folder is absent)."""
    from gligen_tpu_torch.eval.lpips import lpips_over_folders, make_lpips_fn
    from gligen_tpu_torch.eval.metrics import image_names, psnr, read_image

    if clip_vision_ckpt and os.path.exists(clip_vision_ckpt):
        from gligen_tpu_torch.inference.cli import load_vision

        fn, backbone = make_lpips_fn("clip", module=load_vision(clip_vision_ckpt, device)), "clip"
    else:
        fn, backbone = make_lpips_fn(device=device), "conv(random)"
    results: dict = {}
    for sc in SCENARIOS:
        a_dir, b_dir = (os.path.join(out_root, arm, sc) for arm in ("fp32", "bf16"))
        if not (os.path.isdir(a_dir) and os.path.isdir(b_dir)):
            results[sc] = {"status": "missing"}
            continue
        psnrs, maxds = [], []
        names = image_names(a_dir)
        for n in names:
            a, b = read_image(os.path.join(a_dir, n)), read_image(os.path.join(b_dir, n))
            psnrs.append(float(psnr(a[None], b[None])[0]))
            maxds.append(float(np.abs(a - b).max()))
        results[sc] = {
            "lpips": lpips_over_folders(a_dir, b_dir, fn),
            "psnr": float(np.mean(psnrs)),
            "max_abs_pixel_delta": float(np.max(maxds)),
            "images": len(names),
        }
    results["_meta"] = {"lpips_backbone": backbone, "lpips_max": LPIPS_MAX, "psnr_min": PSNR_MIN}
    return results


def over_budget(results: dict, scenarios: Optional[List[str]] = None) -> List[str]:
    """The scenarios that are missing or over the budget."""
    return [sc for sc in scenarios or SCENARIOS
            if "lpips" not in results.get(sc, {})
            or results[sc]["lpips"] > LPIPS_MAX or results[sc]["psnr"] < PSNR_MIN]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "build" / "fidelity"))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arm", choices=["fp32", "bf16", "both", "none"], default="both",
                    help="the arm(s) to run before scoring")
    ap.add_argument("--report", default=None, help="score an existing output folder only")
    ap.add_argument("--clip_vision_ckpt", default=None)
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated scenarios passed to the CLI (default: all 11)")
    ap.add_argument("--ckpt", default="random",
                    help="the CLI's checkpoint: 'random' (de-zeroed random weights) or a .pth")
    ap.add_argument("--device", default="cuda", help="the card (default) or 'cpu'")
    args = ap.parse_args(argv)

    out_root = args.report or args.out
    if Path(out_root).resolve() == REPO:
        raise SystemExit("fidelity_gate: --out must not be the repository's root")
    scenarios = [s.strip() for s in args.scenarios.split(",") if s.strip()] if args.scenarios \
        else None
    if args.report is None:
        for arm in ("fp32", "bf16"):
            if args.arm in (arm, "both"):
                run_arm(arm, os.path.join(out_root, arm), args.steps, args.batch, args.seed,
                        scenarios, args.ckpt, args.device)
    results = score(out_root, args.clip_vision_ckpt, args.device)
    path = os.path.join(out_root, "fidelity.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    label = "LPIPS" if results["_meta"]["lpips_backbone"] == "clip" else "proxy-LPIPS"
    print(f"| Scenario | PSNR (dB) | {label} (bf16 vs fp32) | max |Δpixel| | budget |")
    print("|---|---|---|---|---|")
    bad = over_budget(results, scenarios)
    for sc in SCENARIOS:
        r = results[sc]
        if "lpips" in r:
            print(f"| {sc} | {r['psnr']:.4f} | {r['lpips']:.6f} | {r['max_abs_pixel_delta']:.4f} "
                  f"| {'over' if sc in bad else 'within'} |")
    print(f"wrote {path}", flush=True)
    return results


if __name__ == "__main__":
    main()
