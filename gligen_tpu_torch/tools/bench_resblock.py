#!/usr/bin/env python3
"""Timing sandbox for UNet ResBlocks of the port at the ds1 hot shape.

    python3 gligen_tpu_torch/tools/bench_resblock.py [--iters 10] [--blocks 1] [--profile]
    GLIGEN_TPU_FUSED_CONV=1 python3 gligen_tpu_torch/tools/bench_resblock.py   # the fused conv

Counterpart of ``tools/bench_resblock.py``: a chain of ``--blocks``
``ResBlock``s (GN -> SiLU -> conv3x3, + time embedding, GN -> SiLU ->
conv3x3, + input) of 320 channels at 64^2, B = 16, a (B, 1280) time
embedding, bf16, seeded weights de-zeroed by ``timing.dezero_``.  It
prints the device ms per chain forward (``timing.timed``) and the
conv-only TF/s estimate (two C -> C 3x3 convs per block) under
``GLIGEN_TPU_FUSED_NORM`` and ``GLIGEN_TPU_FUSED_CONV``.  The JAX tool
also prints ``GLIGEN_TPU_GN_SPLIT_STATS``; the port has no such switch.
``--profile`` traces one more forward under ``torch.profiler`` (CUDA
activity) and prints its device ms by kernel category.

The card is the default; ``device="cpu"`` (the tests) runs the plain
versions and gives the host's wall time, no device number.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
EMB_DIM = 1280  # SD-1.4's time embedding, 4 x 320


def run(batch: int = 16, hw: int = 64, channels: int = 320, blocks: int = 1, iters: int = 10,
        device="cuda", profile: bool = False) -> dict:
    """ms per chain forward, ``tflops`` (its conv-only estimate),
    ``switches``, ``out_finite``, ``breakdown`` and ``takes`` (as in
    ``bench_block.run``)."""
    import torch

    from gligen_tpu_torch.inference.pipeline import random_init_
    from gligen_tpu_torch.models.unet import ResBlock, _fused_conv_mode
    from gligen_tpu_torch.ops.basic import _fused_norm_mode
    from gligen_tpu_torch.tools import perf_probe, timing

    device = torch.device(device)
    c = channels
    with torch.device(device):
        chain = torch.nn.ModuleList(ResBlock(c, c, EMB_DIM, dtype=torch.bfloat16)
                                    for _ in range(blocks)).eval()
    gen = torch.Generator(device=device).manual_seed(0)
    random_init_(chain, gen)
    timing.dezero_(chain, gen)
    x = torch.randn((batch, hw, hw, c), generator=gen, device=device).to(torch.bfloat16)
    emb = torch.randn((batch, EMB_DIM), generator=gen, device=device).to(torch.bfloat16)

    def forward():
        y = x
        for rb in chain:
            y = rb(y, emb)
        return y

    with torch.no_grad():
        out = forward()
        finite = bool(torch.isfinite(out).all()) and tuple(out.shape) == tuple(x.shape)
        ms = timing.ms_per_call(forward, iters, device)
        breakdown = takes = None
        if profile:
            trace = perf_probe.traced(forward, tries=perf_probe.TRACE_TRIES)[1]
            breakdown = perf_probe.device_breakdown(trace)[0]
            takes = (trace["takes"], perf_probe.unanswered_launches(trace))
    flops = blocks * 2 * 2 * batch * hw * hw * 9 * c * c
    return dict(ms=ms, tflops=flops / ms / 1e9, blocks=blocks, out_finite=finite,
                switches={"FUSED_NORM": _fused_norm_mode(), "FUSED_CONV": _fused_conv_mode()},
                breakdown=breakdown, takes=takes, shape=(batch, hw, hw, c))


def lines(result: dict) -> list:
    """The result as the tool prints it."""
    from gligen_tpu_torch.tools import perf_probe

    b, h, w, c = result["shape"]
    switches = " ".join(f"{k}={v}" for k, v in result["switches"].items())
    out = [f"resblock x{result['blocks']}: {result['ms']:.4f} ms ({result['tflops']:.1f} TF/s "
           f"conv-only est; B={b}, {h}x{w}x{c}, {switches}, output finite {result['out_finite']})"]
    if result["takes"] is not None:
        out.append("profile: traces of the forward taken {}, launch calls of the last with no "
                   "device record {}".format(*result["takes"]))
    return out + [f"profile:   {line}"
                  for line in perf_probe.breakdown_lines(result["breakdown"] or {})]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ch", type=int, default=320)
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_resblock")
    result = run(batch=args.batch, hw=args.hw, channels=args.ch, blocks=args.blocks,
                 iters=args.iters, profile=args.profile)
    print(f"bench_resblock: device ms per call over {args.iters} calls on {card}")
    print("\n".join(lines(result)))


if __name__ == "__main__":
    main()
