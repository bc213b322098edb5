#!/usr/bin/env python3
"""Where the time of a 512^2 request goes on one NVIDIA GPU, and what each
fused projection kernel costs against the module path's chain.

    python3 gligen_tpu_torch/tools/perf_probe.py request [--root DIR] [--fused 1|0]
    python3 gligen_tpu_torch/tools/perf_probe.py chains

request: builds SD-1.4 GLIGEN at full width with ``chip_smoke.py``'s
seeded, de-zeroed random weights and generates one warm-up request
(batch 2, 512^2, 10 PLMS steps, alpha stages [0.3, 0, 0.7]), then
three timed ones.  It then traces one more under ``torch.profiler``
(CUDA activity only, to keep the profiler's host cost low) and prints
the device time by kernel category, the launches,
and the device's idle share of the wall (1 - busy/wall, busy being the
union of kernel and copy intervals), against the profiled wall and
against the mean unprofiled one; then one more unprofiled request, which
shows whether the profiler left a cost behind.  ``GLIGEN_TPU_FUSED_PROJ``
is set to ``--fused``.  ``--root`` imports ``gligen_tpu_torch`` from
another checkout (e.g. an older commit unpacked with ``git archive``), so
two trees compare on one card, each run in its own process.

chains: at every fused-projection shape of ``chip_smoke.proj_cases``, the
kernel's wrapper against the module path's chain for the same function
(LayerNorm and Dense modules, the elementwise gate, residual and GELU),
both given the fp32 parameters they get in the model (so both cast the
weights to bf16 at each call): device ms and host ms per call, timed by
``chip_smoke.timed``.

Every line names the card and its power limit.  JAX is not imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _setup(root: Path):
    """Put ``root``'s package first on the path and this checkout's
    ``chip_smoke.py`` after it; return (torch, chip_smoke, card line)."""
    import importlib.util

    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    if not torch.cuda.is_available():
        raise SystemExit("perf_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, chip_smoke, chip_smoke.card_line()


def category(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "fused_proj_kernel" in name:
        mode = name.split("fused_proj_kernel<", 1)[1][0]
        return {"0": "ln_matmuls", "1": "matmul_residual", "2": "ln_geglu"}[mode]
    low = name.lower()
    # cuDNN's convolutions are implicit GEMMs: named before cuBLAS's
    if any(s in low for s in ("conv", "cudnn", "fprop", "implicit")):
        return "conv (cuDNN)"
    if "nvjet" in low or "gemm" in low or "cutlass" in low:
        return "gemm (cuBLAS)"
    if "reduce" in low or "norm" in low:
        return "reductions (norm stats)"
    if "copy" in low or "cat" in low or "memcpy" in low or "memset" in low:
        return "copy/cast/cat"
    return "elementwise/other"


def device_breakdown(trace: dict):
    """Per-category device ms and launches, the busy ms (union of the
    kernel and copy intervals) and the kernel count of a chrome trace."""
    spans, by_cat = [], {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((start, start + dur))
        cat = category(ev.get("name", "")) if ev["cat"] == "kernel" else "copy/cast/cat"
        ms, n = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms + dur / 1e3, n + 1)
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return by_cat, busy / 1e3, len(spans)


def request(args) -> None:
    root = Path(args.root).resolve()
    torch, cs, card = _setup(root)
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents

    os.environ["GLIGEN_TPU_FUSED_PROJ"] = args.fused
    device = torch.device("cuda", 0)
    comps = GligenComponents.create(dtype=torch.bfloat16, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    cs.dezero_(comps.unet, gen)
    pipe = GenerationPipeline(comps)
    rng = np.random.default_rng(0)
    kw = dict(steps=10, guidance_scale=7.5, alpha_stages=[0.3, 0.0, 0.7],
              latent_size=64, generator=gen)

    def run() -> float:
        ids, uc, grounding = cs.make_request(rng, 2, 49408, 768)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(ids, uc, grounding, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    tag = f"root {root.name} GLIGEN_TPU_FUSED_PROJ={args.fused}"
    first = run()
    walls = [run() for _ in range(3)]
    mean = sum(walls) / len(walls)
    print(f"request: {tag}: first {first:.1f} ms, warm {', '.join(f'{w:.1f}' for w in walls)} ms "
          f"(mean {mean:.1f} ms = {mean / 2e3:.4f} s/img) on {card}", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = run()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            by_cat, busy, n = device_breakdown(json.load(f))
    total = sum(ms for ms, _ in by_cat.values())
    after = run()
    print(f"profile: {tag}: profiled wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"device time {total:.1f} ms over {n} kernels and copies; idle {1 - busy / wall:.1%} "
          f"of the profiled wall, {1 - busy / mean:.1%} of the mean unprofiled wall; "
          f"unprofiled request after the trace {after:.1f} ms", flush=True)
    for cat, (ms, k) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"profile:   {cat:26s} {ms:9.2f} ms {ms / total:6.1%} {k:7d} launches")


def module_chain(torch, kind, c, k, device):
    """(kernel call, module-path call) on the same inputs for one shape:
    the model's fp32 parameters, so both cast the weights at each call."""
    from gligen_tpu_torch.models.layers import GEGLU, Dense, LayerNorm
    from gligen_tpu_torch.ops import fused_proj as fp

    def modules(*ms):
        for m in ms:
            with torch.no_grad():
                for p in m.parameters():
                    p.normal_(0.0, 0.1 if p.dim() == 1 else p.shape[1] ** -0.5)
            m.to(device)
        return ms

    bf16 = torch.bfloat16
    if kind == "ln_matmuls":
        norm, *ws = modules(LayerNorm(c), *(Dense(c, c, bias=False, dtype=bf16) for _ in range(k)))
        weights = [w.weight for w in ws]
        return (lambda x: fp.ln_matmuls(x, norm.weight, norm.bias, weights),
                lambda x: [w(norm(x)) for w in ws])
    if kind == "matmul_residual":
        (dense,) = modules(Dense(k, c, dtype=bf16))
        # the fuser's device gate on to_out; net_2 of the block has none
        gate = torch.tensor(0.37, device=device) if k == c else None
        return (lambda h, x: fp.matmul_residual(h, dense.weight, dense.bias, x, gate=gate),
                lambda h, x: dense(h) + x if gate is None else x + gate * dense(h))
    norm, geglu = modules(LayerNorm(c), GEGLU(c, 4 * c, dtype=bf16))
    return (lambda x: fp.ln_geglu(x, norm.weight, norm.bias, geglu.proj.weight, geglu.proj.bias),
            lambda x: geglu(norm(x)))


def chains(args) -> None:
    torch, cs, card = _setup(REPO)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(2)
    print(f"chains: device ms (host ms) per call on {card}", flush=True)
    with torch.no_grad():
        for name, kind, b, n, c, k in cs.proj_cases(2):
            x = torch.randn((b, n, c), generator=gen, device=device).to(torch.bfloat16)
            kernel, module = module_chain(torch, kind, c, k, device)
            inputs = (x,)
            if kind == "matmul_residual":
                inputs = (torch.randn((b, n, k), generator=gen, device=device).to(torch.bfloat16), x)
            kd, kh = cs.timed(lambda: kernel(*inputs))
            md, mh = cs.timed(lambda: module(*inputs))
            print(f"chains: {kind:15s} {name:12s} kernel {kd:.4f} ({kh:.4f}) ms  module path "
                  f"{md:.4f} ({mh:.4f}) ms  kernel/module device {kd / md:.2f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    req = sub.add_parser("request")
    req.add_argument("--root", default=str(REPO))
    req.add_argument("--fused", choices=("0", "1"), default="1")
    sub.add_parser("chains")
    args = ap.parse_args()
    request(args) if args.mode == "request" else chains(args)


if __name__ == "__main__":
    main()
