#!/usr/bin/env python3
"""Where the time of a 512^2 request or train step goes on one NVIDIA GPU,
and what each fused kernel costs against the module path's chain.

    python3 gligen_tpu_torch/tools/perf_probe.py request [--root DIR] [--fused 1|0]
        [--norm gn|0|ln|both] [--conv 0|1|auto] [--model text|hed|sem] [--batch 2] [--steps 10]
        [--dtype bfloat16|float32] [--bf16_params]
    python3 gligen_tpu_torch/tools/perf_probe.py train [--root DIR] [--fused 1|0]
        [--norm gn|0|ln|both] [--conv 0|1|auto] [--remat full|dots|none] [--batch 4]
        [--steps 5] [--dtype bfloat16|float32]
    python3 gligen_tpu_torch/tools/perf_probe.py chains
    python3 gligen_tpu_torch/tools/perf_probe.py norms
    python3 gligen_tpu_torch/tools/perf_probe.py convs [--sweep]

request: builds SD-1.4 GLIGEN at full width with ``chip_smoke.py``'s
seeded, de-zeroed random weights and generates one warm-up request
(batch 2, 512^2, 10 PLMS steps, alpha stages [0.3, 0, 0.7]; ``--batch``
and ``--steps`` set the users' 8 and 50), then three timed ones.  It then traces one more under ``torch.profiler``
(CUDA activity only, to keep the profiler's host cost low) and prints
the device time by kernel category, the launches,
and the device's idle share of the wall (1 - busy/wall, busy being the
union of kernel and copy intervals), against the profiled wall and
against the mean unprofiled one; then one more unprofiled request, which
shows whether the profiler left a cost behind.  ``--model`` names a spatial
model of ``chip_smoke.SPATIAL_MODELS`` in place of box+text, hed for the
448^2 tokenizer (canny, depth and normal differ from it only in their
downsampler's two small convs) or sem for the 256^2 one: its
config, a seeded uint8 map each request (``chip_smoke.spatial_request``)
and its scenario's alpha stages.  ``--dtype float32`` serves the model in
fp32 (every fused kernel on its fp32 route) and adds a line with the
fp32 K2, K6 and flash kernels' device ms and share.  ``--bf16_params``
serves the model after ``inference/pipeline.py:cast_params_bf16`` (the
JAX ``bench.py --bf16_params``): every matrix and conv weight stored in
bf16, so no cast copies them per call.  ``GLIGEN_TPU_FUSED_PROJ``
is set to ``--fused``, ``GLIGEN_TPU_FUSED_NORM`` to ``--norm`` and
``GLIGEN_TPU_FUSED_CONV`` to ``--conv``.  ``--root`` imports
``gligen_tpu_torch`` from
another checkout (e.g. an older commit unpacked with ``git archive``, one
that has ``gligen_tpu_torch/tools/timing.py``), so two trees compare on
one card, each run in its own process.

train: the train step (``training/train_step.py``) at full SD-1.4 GLIGEN
width with ``chip_smoke.py``'s seeded, de-zeroed random weights: 512^2
images, live VAE encode, per-block remat (``--remat``), AdamW with a
one-step warmup.  One warm-up step, ``--steps`` timed ones (wall, s/step,
img/s, peak memory), then one traced under ``torch.profiler`` (CPU and
CUDA activity, so the step's "train_step.loss" range reaches the device
timeline): device time by kernel category and by phase -- loss, backward,
optimizer (``train_phases``); the backward's flash forwards are the remat
recompute -- and the device's idle share of the wall; then one more
unprofiled step.  ``--remat`` sets ``GLIGEN_TPU_REMAT_POLICY``; a line
gives the device ms of the forward kernels in the backward phase (the
recompute's flash forwards, K2 and LayerNorms; its GEMMs and elementwise
work are not told from the backward's own: the backward phase's ms
against a ``--remat none`` run's gives the whole recompute).  ``--dtype
float32`` trains the model in fp32 (every kernel on its fp32 route, TF32
off for matmul and cuDNN) and adds a line with the flash backward's fp32
kernels' device ms and share (K4′: the
3xTF32 dq and dk/dv kernels, the d <= 160 class's on their own, and a
parent tree's FMA kernel).

chains: at every fused-projection shape of ``chip_smoke.proj_cases``, the
kernel's wrapper against the module path's chain for the same function
(LayerNorm and Dense modules, the elementwise gate, residual and GELU),
both given the fp32 parameters they get in the model (so both cast the
weights to bf16 at each call): device ms and host ms per call, timed by
``timing.timed``.

norms: at every GroupNorm and LayerNorm shape of ``chip_smoke.norm_cases``
and ``ln_cases``, the kernel's wrapper against the module path's chain
(``GLIGEN_TPU_FUSED_NORM=0``: the fp32 ``*_xla`` form, then the SiLU) and,
without the SiLU, against the library's F.group_norm / F.layer_norm.

convs: at every ResBlock conv of ``chip_smoke.conv_cases``, the fused
GN -> SiLU -> conv3x3 against the ``GLIGEN_TPU_FUSED_CONV=0`` chain of
modules (the GroupNorm kernel with its SiLU, cuDNN's bf16 conv, the
residual add), and the conv kernel alone (bf16 (F, 3, 3, C) weight, a and
v given) against cuDNN's bf16 conv alone.  ``--sweep``: the conv kernel at
every shape, at the table's plan (``fused_conv.conv_plan``) and at each
configuration of the sweep library (``SWEEP_CONV_TILES``, built from
csrc/fused_conv_sweep.cu), each with the split ``conv_split`` gives it and
without split, every output held against ``_ref_chain``; exits 1 on a
mismatch.

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
    ``chip_smoke.py`` (its cases and requests) after it; return (torch,
    chip_smoke, card line).  ``root`` needs ``gligen_tpu_torch/tools/
    timing.py``, which chip_smoke.py imports."""
    import importlib.util

    sys.path.insert(0, str(root))
    import torch

    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("perf_probe")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return torch, chip_smoke, card


def fused_proj_template(name: str):
    """(MODE, BM, BN, STAGES) of a ``fused_proj_kernel<MODE, BM, BN,
    STAGES>`` kernel name: the kernel's mode (0 ln_matmuls, 1
    matmul_residual, 2 ln_geglu, 3 mm_only) and the tile configuration the
    table (``ops/fused_proj.py:proj_tiles``) gave the launch."""
    mode, bm, bn, stages = name.split("fused_proj_kernel<", 1)[1].split(">", 1)[0].split(",")
    return int(mode), int(bm), int(bn), int(stages)


FP32_PROJ = ("ln_matmuls fp32 (K2)", "matmul_residual fp32 (K2)", "ln_geglu fp32 (K2)")
FP32_CONV = "gn_silu_conv3x3 fp32 (K6)"
FP32_FLASH = ("flash_fwd fp32 (K3)", "flash_fwd fp32 qm (K1/K3)")


def category(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_fwd_f32_kernel" in name:
        return "flash_fwd fp32 (K3)"
    if "flash_fwd_f32_qm_kernel" in name:
        return "flash_fwd fp32 qm (K1/K3)"
    # the fp32 routes of K2 and K6: the 3xTF32 kernels and their split
    # reductions, and the CUDA-core kernels they replaced (a parent tree's)
    for kernel in ("proj_tf32_kernel<", "proj_split_reduce_f32<", "fused_proj_f32_kernel<"):
        if kernel in name:
            return FP32_PROJ[int(name.split(kernel, 1)[1].split(",", 1)[0].split(">", 1)[0])]
    if any(k in name for k in ("conv3x3_tf32_kernel", "conv_split_reduce_f32", "conv3x3_f32_kernel")):
        return FP32_CONV
    # the flash backward's fp32 route (K4'): the 3xTF32 kernels, those of
    # the d <= 160 class (ds4 and the middle block; Cfg<160, ...) apart, and
    # a parent tree's fp32 FMA kernel (d = 160), whose Cfg ends in false
    # (dq) or true (dk/dv)
    for kernel, kind in (("flash_bwd_dq_tf32", "dq"), ("flash_bwd_dkv_tf32", "dk/dv")):
        if kernel + "_kernel" in name:
            d160 = " d160" if "Cfg<160," in name else ""
            return f"flash_bwd {kind} fp32 3xTF32{d160} (K4')"
    if "flash_bwd_f32_kernel" in name:
        return f"flash_bwd {'dk/dv' if 'true>' in name else 'dq'} fp32 FMA (K4')"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd dq (K4)"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd dk/dv (K4)"
    if "gn_fused_kernel" in name:
        return "group_norm one launch (K5)"
    if "gn_partial_kernel" in name or "gn_combine_kernel" in name:
        return "group_norm stats (K5)"
    if "gn_normalize_kernel" in name:
        return "group_norm normalise (K5)"
    if "layer_norm_kernel" in name:
        return "layer_norm (K5)"
    if "conv3x3_kernel" in name or "conv_split_reduce" in name:
        return "gn_silu_conv3x3 (K6)"
    if "fused_proj_kernel" in name:
        return ("ln_matmuls", "matmul_residual", "ln_geglu",
                "mm_only (K7)")[fused_proj_template(name)[0]]
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "optimizer (foreach)"
    # cuDNN's convolutions are implicit GEMMs: named before cuBLAS's
    if "dgrad" in low or "wgrad" in low:
        return "conv backward (cuDNN)"
    if any(s in low for s in ("conv", "cudnn", "fprop", "implicit")):
        return "conv (cuDNN)"
    if "nvjet" in low or "gemm" in low or "cutlass" in low:
        return "gemm (cuBLAS)"
    if "reduce" in low or "norm" in low:
        return "reductions (norm stats)"
    if "copy" in low or "cat" in low or "memcpy" in low or "memset" in low:
        return "copy/cast/cat"
    return "elementwise/other"


# the chrome-trace categories of device work, and the CUDA API calls that
# put work on the device (cudaLaunchKernel[ExC], cuLaunchKernel[Ex],
# cudaMemcpy*/cudaMemset* and their driver forms)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
# On the H100, CUPTI now and then drops the device records of the first
# kernels after the profiler starts (a call's first GroupNorm launches,
# the whole of a short call), while their launch calls stay in the trace.
# ``traced`` first launches this many one-element kernels, then cuts
# them from the trace; now and then CUPTI drops more than these, so a
# repeatable call may be traced again (``first_whole``).
WARM_LAUNCHES = 64
# how often ``bench_block`` and ``bench_resblock`` trace their repeatable
# forwards before they take a trace with dropped records
TRACE_TRIES = 4


def device_breakdown(trace: dict, phase_of=None):
    """Per-category device ms and launches, the busy ms (union of the
    kernel and copy intervals) and the kernel count of a chrome trace; and
    per (category, phase) device ms, ``phase_of(start, category)`` naming a
    device event's phase."""
    spans, by_cat, by_phase = [], {}, {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((start, start + dur))
        cat = category(ev.get("name", "")) if ev["cat"] == "kernel" else "copy/cast/cat"
        ms, n = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms + dur / 1e3, n + 1)
        if phase_of is not None:
            key = (cat, phase_of(start, cat))
            by_phase[key] = by_phase.get(key, 0.0) + dur / 1e3
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return by_cat, busy / 1e3, len(spans), by_phase


def launch_calls(trace: dict):
    """({correlation: (name, start µs)} of a chrome trace's launch calls,
    [(correlation, start µs) of each device record]): the calls are host
    events (``cuda_runtime``, ``cuda_driver``) named by LAUNCH_PREFIXES;
    the records are the device's kernels, copies and memsets."""
    calls, records = {}, []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        corr, ts = ev.get("args", {}).get("correlation"), float(ev.get("ts", 0.0))
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and \
                ev.get("name", "").startswith(LAUNCH_PREFIXES):
            calls[corr] = (ev["name"], ts)
        elif ev.get("cat") in DEVICE_CATS:
            records.append((corr, ts))
    return calls, records


def without_first_launches(trace: dict, n: int) -> dict:
    """``trace`` less its first ``n`` launch calls (by start) and every
    event that shares their correlation: their device records and flows."""
    calls = launch_calls(trace)[0]
    first = set(sorted(calls, key=lambda c: calls[c][1])[:n])
    keep = [ev for ev in trace.get("traceEvents", [])
            if ev.get("args", {}).get("correlation") not in first
            and not (ev.get("cat") == "ac2g" and ev.get("id") in first)]
    return {**trace, "traceEvents": keep}


def unanswered_launches(trace: dict) -> int:
    """The launch calls of a chrome trace that no device record answers."""
    calls, records = launch_calls(trace)
    return len(set(calls) - {corr for corr, _ in records})


def first_whole(take, tries: int):
    """``take()`` -> (out, trace), taken until every launch call of the
    trace has its device record, at most ``tries`` times: the first whole
    (out, trace), else the last; the trace's "takes" says how many were
    taken."""
    for takes in range(1, tries + 1):
        out, trace = take()
        if not unanswered_launches(trace):
            break
    return out, {**trace, "takes": takes}


def traced(fn, cpu: bool = False, tries: int = 1):
    """(``fn()``, the chrome trace of that call under ``torch.profiler``):
    CUDA activity only, to keep the profiler's host cost low, or CPU too
    where a host range must reach the device timeline.  WARM_LAUNCHES
    kernels run first inside the window and are cut from the trace.  A
    repeatable ``fn`` may be traced up to ``tries`` times, until CUPTI
    drops none of its device records (``first_whole``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    warm = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]

    def take():
        with profile(activities=activities) as prof:
            for _ in range(WARM_LAUNCHES):
                warm.add_(1)
            torch.cuda.synchronize()
            out = fn()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                return out, without_first_launches(json.load(f), WARM_LAUNCHES)

    return first_whole(take, tries)


def breakdown_lines(by_cat) -> list:
    """One line per category of ``device_breakdown``, largest first:
    device ms, share and launches."""
    total = sum(ms for ms, _ in by_cat.values())
    return [f"{cat:26s} {ms:9.2f} ms {ms / total:6.1%} {k:7d} launches"
            for cat, (ms, k) in sorted(by_cat.items(), key=lambda kv: -kv[1][0])]


def request(args) -> None:
    root = Path(args.root).resolve()
    torch, cs, card = _setup(root)
    import numpy as np

    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
    from gligen_tpu_torch.tools.timing import dezero_

    os.environ.update(GLIGEN_TPU_FUSED_PROJ=args.fused, GLIGEN_TPU_FUSED_NORM=args.norm,
                      GLIGEN_TPU_FUSED_CONV=args.conv)
    device = torch.device("cuda", 0)
    spatial = args.model != "text"
    unet_config = dict(cs.SPATIAL_MODELS[args.model]) if spatial else None
    comps = GligenComponents.create(unet_config=unet_config, dtype=getattr(torch, args.dtype),
                                    seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    dezero_(comps.unet, gen)
    if args.bf16_params:  # imported only when asked: an older --root tree lacks it
        from gligen_tpu_torch.inference.pipeline import cast_params_bf16

        cast_params_bf16(comps)
    pipe = GenerationPipeline(comps)
    rng = np.random.default_rng(0)
    alpha = cs.SPATIAL_ALPHA[args.model] if spatial else [0.3, 0.0, 0.7]
    kw = dict(steps=args.steps, guidance_scale=7.5, alpha_stages=alpha, latent_size=64,
              generator=gen)

    def run() -> float:
        ids, uc, grounding = cs.make_request(rng, args.batch, 49408, 768)
        extra = {}
        if spatial:
            grounding, extra["grounding_extra"] = cs.spatial_request(rng, args.model, args.batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(ids, uc, grounding, **kw, **extra)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    tag = (f"root {root.name} {args.model} {args.dtype}"
           f"{' bf16_params' if args.bf16_params else ''} PROJ={args.fused} NORM={args.norm} "
           f"CONV={args.conv} batch {args.batch} {args.steps} steps")
    first = run()
    walls = [run() for _ in range(3)]
    mean = sum(walls) / len(walls)
    print(f"request: {tag}: first {first:.1f} ms, warm {', '.join(f'{w:.1f}' for w in walls)} ms "
          f"(mean {mean:.1f} ms = {mean / (args.batch * 1e3):.4f} s/img) on {card}", flush=True)
    wall, trace = traced(run)
    by_cat, busy, n, _ = device_breakdown(trace)
    total = sum(ms for ms, _ in by_cat.values())
    after = run()
    print(f"profile: {tag}: profiled wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"device time {total:.1f} ms over {n} kernels and copies; idle {1 - busy / wall:.1%} "
          f"of the profiled wall, {1 - busy / mean:.1%} of the mean unprofiled wall; "
          f"unprofiled request after the trace {after:.1f} ms", flush=True)
    for line in breakdown_lines(by_cat):
        print(f"profile:   {line}")
    if args.dtype == "float32":
        k2 = sum(by_cat.get(c, (0.0, 0))[0] for c in FP32_PROJ)
        k6 = by_cat.get(FP32_CONV, (0.0, 0))[0]
        fa = sum(by_cat.get(c, (0.0, 0))[0] for c in FP32_FLASH)
        print(f"profile: {tag}: K2 fp32 {k2:.1f} ms ({k2 / total:.1%} of device time), K6 fp32 "
              f"{k6:.1f} ms ({k6 / total:.1%}), flash fp32 {fa:.1f} ms ({fa / total:.1%})",
              flush=True)


TRAIN_PHASES = ("loss", "backward", "optimizer")
# the categories of kernels that only a forward launches: in the backward
# phase, the remat recompute's
RECOMPUTED = ("flash_fwd", "flash_fwd fp32 qm (K1/K3)", "ln_matmuls", "matmul_residual",
              "ln_geglu", "layer_norm (K5)", *FP32_PROJ)


def train_phases(trace: dict):
    """``phase_of`` for one train step on one stream, whose phases run in
    order: the loss (the device span of its "train_step.loss" range, from
    its first piece's start to its last one's end: the profiler may cut it
    into several pieces), the backward (the autograd engine's own thread
    launches it, so no range of the step's thread reaches it on the device:
    everything after the loss and before the optimizer), the optimizer
    (from its first foreach kernel on)."""
    events = [ev for ev in trace.get("traceEvents", []) if ev.get("ph") == "X"]
    loss = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))) for ev in events
            if ev.get("cat") == "gpu_user_annotation" and ev.get("name") == "train_step.loss"]
    if not loss:
        raise RuntimeError("no device span of train_step.loss in the trace")
    lo, hi = min(a for a, _ in loss), max(b for _, b in loss)
    opt = min(float(ev["ts"]) for ev in events if ev.get("cat") == "kernel"
              and category(ev.get("name", "")) == "optimizer (foreach)")

    def phase_of(start, _cat):
        if lo <= start < hi:
            return "loss"
        return "optimizer" if start >= opt else ("backward" if start >= hi else "other")

    return phase_of


def train(args) -> None:
    root = Path(args.root).resolve()
    torch, cs, card = _setup(root)
    import numpy as np

    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.tools.timing import dezero_
    from gligen_tpu_torch.training.train_step import create_train_state, make_train_step

    os.environ.update(GLIGEN_TPU_FUSED_PROJ=args.fused, GLIGEN_TPU_FUSED_NORM=args.norm,
                      GLIGEN_TPU_FUSED_CONV=args.conv, GLIGEN_TPU_REMAT_POLICY=args.remat)
    device = torch.device("cuda", 0)
    comps = GligenComponents.create(dtype=getattr(torch, args.dtype), seed=0, device=device,
                                    unet_config={"use_checkpoint": True})
    gen = torch.Generator(device=device).manual_seed(1)
    dezero_(comps.unet, gen)
    state = create_train_state(comps.unet, base_lr=1e-4, warmup_steps=1)
    step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    data = cs.train_batch(torch, np, np.random.default_rng(0), args.batch, 512, 49408, 768,
                          device)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, data, generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    tag = (f"root {root.name} {args.dtype} PROJ={args.fused} NORM={args.norm} CONV={args.conv} "
           f"remat {args.remat} batch {args.batch}")
    first = run()
    torch.cuda.reset_peak_memory_stats()
    walls = [run() for _ in range(args.steps)]
    mean = sum(walls) / len(walls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: {tag}: first {first:.1f} ms, warm {', '.join(f'{w:.1f}' for w in walls)} ms "
          f"(mean {mean:.1f} ms = {mean / 1e3:.4f} s/step = {args.batch * 1e3 / mean:.3f} img/s), "
          f"peak memory {peak:.2f} GiB on {card}", flush=True)
    wall, trace = traced(run, cpu=True)
    by_cat, busy, n, by_phase = device_breakdown(trace, train_phases(trace))
    total = sum(ms for ms, _ in by_cat.values())
    after = run()
    print(f"profile: {tag}: profiled wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"device time {total:.1f} ms over {n} kernels and copies; idle {1 - busy / wall:.1%} "
          f"of the profiled wall, {1 - busy / mean:.1%} of the mean unprofiled wall; "
          f"unprofiled step after the trace {after:.1f} ms", flush=True)
    phases = (*TRAIN_PHASES, "other")
    print(f"profile:   {'category':26s} {'ms':>9s} {'share':>6s} {'launches':>8s}  "
          + " ".join(f"{p:>9s}" for p in phases))
    for cat, (ms, k) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        cells = " ".join(f"{by_phase.get((cat, p), 0.0):9.2f}" for p in phases)
        print(f"profile:   {cat:26s} {ms:9.2f} {ms / total:6.1%} {k:8d}  {cells}")
    phase_ms = {p: sum(v for (c, q), v in by_phase.items() if q == p) for p in phases}
    print("profile:   by phase: " + ", ".join(f"{p} {ms:.1f} ms" for p, ms in phase_ms.items()),
          flush=True)
    recompute = {c: by_phase[c, "backward"] for c in RECOMPUTED if (c, "backward") in by_phase}
    print(f"profile: {tag}: forward kernels in the backward phase (the recompute's) "
          f"{sum(recompute.values()):.1f} ms: "
          + ", ".join(f"{c} {ms:.1f} ms" for c, ms in sorted(recompute.items())), flush=True)
    if args.dtype == "float32":
        k4 = {c: ms for c, (ms, _) in by_cat.items() if "fp32" in c and "(K4')" in c}
        print(f"profile: {tag}: flash backward fp32 (K4') {sum(k4.values()):.1f} ms "
              f"({sum(k4.values()) / total:.1%} of device time): "
              + ", ".join(f"{c} {ms:.1f} ms" for c, ms in sorted(k4.items())), flush=True)


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
    from gligen_tpu_torch.tools.timing import timed

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
            kd, kh = timed(lambda: kernel(*inputs))
            md, mh = timed(lambda: module(*inputs))
            print(f"chains: {kind:15s} {name:12s} kernel {kd:.4f} ({kh:.4f}) ms  module path "
                  f"{md:.4f} ({mh:.4f}) ms  kernel/module device {kd / md:.2f}", flush=True)


def _compare(label, kernel, others) -> None:
    """One line: the kernel's and each other call's device (host) ms."""
    from gligen_tpu_torch.tools.timing import timed

    kd, kh = timed(kernel)
    cells = [f"kernel {kd:.4f} ({kh:.4f})"]
    for name, fn in others.items():
        d, h = timed(fn)
        cells.append(f"{name} {d:.4f} ({h:.4f}) kernel/{name} {kd / d:.2f}")
    print(f"{label}: " + "  ".join(cells), flush=True)


def _meta_models(torch):
    """The SD-1.4 GLIGEN UNet and VAE with no storage: their shapes only."""
    from gligen_tpu_torch.models.unet import UNetModel
    from gligen_tpu_torch.models.vae import AutoencoderKL

    with torch.device("meta"):
        return UNetModel(), AutoencoderKL()


def norms(args) -> None:
    torch, cs, card = _setup(REPO)
    import torch.nn.functional as F

    from gligen_tpu_torch.ops import basic
    from gligen_tpu_torch.ops import fused_norm as fn

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(4)
    unet, vae = _meta_models(torch)
    os.environ["GLIGEN_TPU_FUSED_NORM"] = "0"  # the dispatchers' plain forms: the module path
    print(f"norms: device ms (host ms) per call on {card}", flush=True)
    with torch.no_grad():
        for name, shape, silu, eps in cs.norm_cases(unet, vae, 2):
            c = shape[-1]
            x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
            s, b = torch.ones(c, device=device), torch.zeros(c, device=device)
            act = "silu" if silu else None
            others = {"module": lambda: basic.group_norm(x, s, b, 32, eps, act)}
            if not silu:
                xc, sc, bc = x.reshape(shape[0], -1, c).transpose(1, 2), s.bfloat16(), b.bfloat16()
                others["F.group_norm"] = lambda: F.group_norm(xc, 32, sc, bc, eps)
            _compare(f"norms: group_norm {name:16s} {str(shape):22s}",
                     lambda: fn.group_norm_fused(x, s, b, 32, eps, silu), others)
        for name, rows, c, eps in cs.ln_cases(2):
            x = torch.randn((rows, c), generator=gen, device=device).to(torch.bfloat16)
            s, b = torch.ones(c, device=device), torch.zeros(c, device=device)
            sc, bc = s.bfloat16(), b.bfloat16()
            _compare(f"norms: layer_norm {name:14s} ({rows}, {c})",
                     lambda: fn.layer_norm_fused(x, s, b, eps),
                     {"module": lambda: basic.layer_norm(x, s, b, eps),
                      "F.layer_norm": lambda: F.layer_norm(x, (c,), sc, bc, eps)})


def convs(args) -> None:
    torch, cs, card = _setup(REPO)
    from gligen_tpu_torch.models.layers import Conv2d
    from gligen_tpu_torch.models.unet import GroupNorm32
    from gligen_tpu_torch.ops import fused_conv as fc
    from gligen_tpu_torch.tools.timing import timed

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(5)
    unet, _ = _meta_models(torch)
    os.environ["GLIGEN_TPU_FUSED_NORM"] = "gn"  # the module chain of the default configuration
    print(f"convs: device ms (host ms) per call on {card}", flush=True)
    bad = []
    with torch.no_grad():
        for name, b, h, cin, cout, residual in cs.conv_cases(unet, 2):
            norm = GroupNorm32(cin, act="silu").to(device)
            conv = Conv2d(cin, cout, 3, dtype=torch.bfloat16).to(device)
            conv.weight.normal_(0.0, (9 * cin) ** -0.5, generator=gen)
            x = torch.randn((b, h, h, cin), generator=gen, device=device).to(torch.bfloat16)
            res = (torch.randn((b, h, h, cout), generator=gen, device=device).to(torch.bfloat16)
                   if residual else None)
            xn = norm(x)
            a, v = fc.gn_affine(x, norm.weight, norm.bias)
            wt = conv.weight.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
            wb = conv.bias.float()
            desc = f"convs: {name:16s} ({b},{h},{h},{cin}) -> {cout}"
            if not args.sweep:
                _compare(desc, lambda: fc.gn_silu_conv3x3(x, norm.weight, norm.bias, conv.weight,
                                                          conv.bias, residual=res),
                         {"module": lambda: conv(norm(x)) if res is None else conv(norm(x)) + res})
                _compare(f"{desc} conv alone",
                         lambda: fc.gn_silu_conv3x3.conv(x, a, v, wt, wb, res),
                         {"cudnn conv": lambda: conv(xn)})
                continue
            want = fc._ref_chain(x, a, v, conv.weight, conv.bias, res)
            flops = 2 * b * h * h * cout * 9 * cin
            table = fc.conv_plan(b, h, h, cin, cout)
            plans = [(table, None)]
            for tiles in fc.SWEEP_CONV_TILES:
                if fc.conv_smem(tiles, h) > fc.MAX_BLOCK_SMEM:
                    continue
                split = fc.conv_split(b * h * h, cin, cout, tiles, 8)
                plans += [((*tiles, s), "fused_conv_sweep") for s in sorted({1, split})]
            for plan, library in plans:
                got = fc.gn_silu_conv3x3.conv(x, a, v, wt, wb, res, plan=plan, library=library)
                ok = torch.allclose(got.float(), want.float(), atol=2e-2, rtol=1e-2)
                ms = timed(lambda: fc.gn_silu_conv3x3.conv(x, a, v, wt, wb, res, plan=plan,
                                                           library=library))[0]
                print(f"{desc} {'table' if library is None else 'sweep'} "
                      f"{'x'.join(map(str, plan[:3]))} split {plan[3]}: {ms:.4f} ms "
                      f"{flops / ms / 1e9:.1f} TF/s {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append(f"{name} {plan}")
    if bad:
        raise SystemExit(f"convs --sweep: outputs off the plain version: {', '.join(bad)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("request", "train"):
        req = sub.add_parser(mode)
        req.add_argument("--root", default=str(REPO))
        req.add_argument("--fused", choices=("0", "1"), default="1")
        req.add_argument("--norm", choices=("gn", "0", "ln", "both"), default="gn")
        req.add_argument("--conv", choices=("0", "1", "auto"), default="0")
    sub.choices["request"].add_argument(
        "--model", choices=("text", "hed", "sem"), default="text")
    sub.choices["request"].add_argument("--batch", type=int, default=2)
    sub.choices["request"].add_argument("--dtype", choices=("bfloat16", "float32"),
                                        default="bfloat16")
    sub.choices["request"].add_argument("--steps", type=int, default=10)
    sub.choices["request"].add_argument("--bf16_params", action="store_true")
    train_args = sub.choices["train"]
    train_args.add_argument("--remat", choices=("full", "dots", "none"), default="full")
    train_args.add_argument("--batch", type=int, default=4)
    train_args.add_argument("--steps", type=int, default=5)
    train_args.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    for mode in ("chains", "norms", "convs"):
        sub.add_parser(mode)
    sub.choices["convs"].add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    {"request": request, "train": train, "chains": chains, "norms": norms,
     "convs": convs}[args.mode](args)


if __name__ == "__main__":
    main()
