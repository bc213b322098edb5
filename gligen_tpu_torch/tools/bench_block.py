#!/usr/bin/env python3
"""Timing sandbox for ONE ds1 transformer block of the port.

    python3 gligen_tpu_torch/tools/bench_block.py [--iters 10] [--batch 16] [--profile]
    GLIGEN_TPU_FUSED_PROJ=0 python3 gligen_tpu_torch/tools/bench_block.py   # the module path

Counterpart of ``tools/bench_block.py``: one ``SpatialTransformer``
(GroupNorm, proj_in, self-attention, the gated self-attention fuser,
cross-attention, feed-forward, proj_out) at the 512^2 hot shape: 8 heads
x 40, depth 1, bf16, x (B, 64, 64, 320), context (B, 77, 768), grounding
tokens (B, 30, 768), B = 16 (the CFG batch), gate scale 1, seeded weights
de-zeroed by ``timing.dezero_``.  It prints the device ms per block
forward (``timing.timed``) under the switches in force
(``GLIGEN_TPU_FUSED_PROJ``, ``GLIGEN_TPU_FUSED_NORM``), so the flash and
fused-projection kernels can be timed inside their block without a whole
request.  ``--profile`` traces one more forward under ``torch.profiler``
(CUDA activity) and prints its device ms by kernel category
(``perf_probe.device_breakdown``).

The card is the default; ``device="cpu"`` (the tests) runs the plain
versions and gives the host's wall time, no device number.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONTEXT_DIM = 768  # CLIP ViT-L/14's width: the text context and the grounding tokens


def run(batch: int = 16, hw: int = 64, heads: int = 8, dim_head: int = 40, iters: int = 10,
        device="cuda", profile: bool = False) -> dict:
    """ms per block forward; ``switches``: what the block's projections
    and norms took; ``out_finite``; ``breakdown``: the traced forward's
    ``device_breakdown`` categories when ``profile``, else None."""
    import torch

    from gligen_tpu_torch.inference.pipeline import random_init_
    from gligen_tpu_torch.models.layers import SpatialTransformer, _fused_proj_ok
    from gligen_tpu_torch.ops.basic import _fused_norm_mode
    from gligen_tpu_torch.tools import perf_probe, timing

    device = torch.device(device)
    c = heads * dim_head
    with torch.device(device):
        st = SpatialTransformer(c, CONTEXT_DIM, CONTEXT_DIM, heads, dim_head, depth=1,
                                fuser_type="gatedSA", dtype=torch.bfloat16,
                                use_checkpoint=False).eval()
    gen = torch.Generator(device=device).manual_seed(0)
    random_init_(st, gen)
    timing.dezero_(st, gen)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    x = randn(batch, hw, hw, c)
    ctx, objs = randn(batch, 77, CONTEXT_DIM), randn(batch, 30, CONTEXT_DIM)
    with torch.no_grad():
        def forward():
            return st(x, ctx, objs, gate_scale=1.0)

        out = forward()
        finite = bool(torch.isfinite(out).all()) and tuple(out.shape) == tuple(x.shape)
        ms = timing.ms_per_call(forward, iters, device)
        breakdown = perf_probe.device_breakdown(perf_probe.traced(forward)[1])[0] if profile else None
    switches = {"FUSED_PROJ": "1" if _fused_proj_ok(hw * hw) else "0",
                "FUSED_NORM": _fused_norm_mode()}
    return dict(ms=ms, switches=switches, out_finite=finite, breakdown=breakdown,
                shape=(batch, hw, hw, c))


def lines(result: dict) -> list:
    """The result as the tool prints it."""
    from gligen_tpu_torch.tools import perf_probe

    b, h, w, c = result["shape"]
    switches = " ".join(f"{k}={v}" for k, v in result["switches"].items())
    out = [f"block forward: {result['ms']:.4f} ms (B={b}, {h}x{w}x{c}, {switches}, output finite "
           f"{result['out_finite']})"]
    return out + [f"profile:   {line}"
                  for line in perf_probe.breakdown_lines(result["breakdown"] or {})]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16, help="CFG batch (2B)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_block")
    result = run(batch=args.batch, iters=args.iters, profile=args.profile)
    print(f"bench_block: device ms per call over {args.iters} calls on {card}")
    print("\n".join(lines(result)))


if __name__ == "__main__":
    main()
