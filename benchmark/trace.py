"""Device time from a ``torch.profiler`` trace: a frozen copy of
``gligen_tpu_torch/tools/perf_probe.py``'s ``category``,
``device_breakdown``, ``launch_calls``, ``without_first_launches`` and
``traced`` (CUPTI's dropped first records), so that a later change to the
program's tools cannot move the benchmark's yardstick; plus the idle gaps
of the device timeline, each named by the benchmark span that was open on
the host when it began (``spans.py`` keeps the host spans by the Unix
clock; the trace's times are the same clock, from ``baseTimeNanoseconds``,
to a fraction of a millisecond)."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
# one-element kernels launched first inside each profiled window and cut
# from its trace: CUPTI now and then drops the records of the first
# kernels after the profiler starts
WARM_LAUNCHES = 64
FLASH_FWD = ("flash_fwd", "flash_fwd fp32 (K3)", "flash_fwd fp32 qm (K1/K3)")
FLASH_BWD = ("flash_bwd dq (K4)", "flash_bwd dk/dv (K4)")

FP32_PROJ = ("ln_matmuls fp32 (K2)", "matmul_residual fp32 (K2)", "ln_geglu fp32 (K2)")


def category(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_fwd_f32_kernel" in name:
        return "flash_fwd fp32 (K3)"
    if "flash_fwd_f32_qm_kernel" in name:
        return "flash_fwd fp32 qm (K1/K3)"
    for kernel in ("proj_tf32_kernel<", "proj_split_reduce_f32<"):
        if kernel in name:
            return FP32_PROJ[int(name.split(kernel, 1)[1].split(",", 1)[0].split(">", 1)[0])]
    if any(k in name for k in ("conv3x3_tf32_kernel", "conv_split_reduce_f32")):
        return "gn_silu_conv3x3 fp32 (K6)"
    for kernel, kind in (("flash_bwd_dq_tf32", "dq"), ("flash_bwd_dkv_tf32", "dk/dv")):
        if kernel + "_kernel" in name:
            return f"flash_bwd {kind} fp32 (K4')"
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
        mode = int(name.split("fused_proj_kernel<", 1)[1].split(",", 1)[0].split(">", 1)[0])
        return ("ln_matmuls", "matmul_residual", "ln_geglu", "mm_only (K7)")[mode]
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "optimizer (foreach)"
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


def device_intervals(trace: dict) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, category) of every kernel, copy and memset."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        cat = category(ev.get("name", "")) if ev["cat"] == "kernel" else "copy/cast/cat"
        out.append((start, start + dur, cat))
    return out


def device_breakdown(trace: dict):
    """({category: (ms, launches)}, busy ms (the union of the device
    intervals), [(gap start µs, gap µs)] between the union's pieces,
    first device start µs, last device end µs)."""
    spans = device_intervals(trace)
    by_cat: Dict[str, Tuple[float, int]] = {}
    for s, e, cat in spans:
        ms, n = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms + (e - s) / 1e3, n + 1)
    busy, end, gaps = 0.0, None, []
    for s, e, _ in sorted(spans):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s - end))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    first = min((s for s, _, _ in spans), default=0.0)
    return by_cat, busy / 1e3, gaps, first, (end or 0.0)


def launch_calls(trace: dict):
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
    calls = launch_calls(trace)[0]
    first = set(sorted(calls, key=lambda c: calls[c][1])[:n])
    keep = [ev for ev in trace.get("traceEvents", [])
            if ev.get("args", {}).get("correlation") not in first
            and not (ev.get("cat") == "ac2g" and ev.get("id") in first)]
    return {**trace, "traceEvents": keep}


def unanswered_launches(trace: dict) -> int:
    calls, records = launch_calls(trace)
    return len(set(calls) - {corr for corr, _ in records})


def named_gaps(trace: dict, gaps, host=(), top: int = 10) -> List[List]:
    """The ``top`` longest idle gaps as [name, seconds], each named by the
    innermost of the ``host`` spans ((name, start ns, end ns), Unix clock)
    open when the gap began ("no span" outside them)."""
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    spans = [(s / 1e3 - base_us, e / 1e3 - base_us, n) for n, s, e in host]
    out = []
    for start, dur in sorted(gaps, key=lambda g: -g[1])[:top]:
        open_ = [(e - s, n) for s, e, n in spans if s <= start < e]
        out.append([min(open_)[1] if open_ else "no span", dur / 1e6])
    return out


def profiled(fn):
    """(``fn()``, its chrome trace, host wall seconds of ``fn``) under
    ``torch.profiler`` with CUDA activity alone (host activity would slow
    the host and open gaps of its own); ``WARM_LAUNCHES`` kernels run
    first and are cut from the trace."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    warm = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_LAUNCHES):
            warm.add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = without_first_launches(json.load(f), WARM_LAUNCHES)
    return out, trace, wall


def summarize(trace: dict, wall_s: float, host=()) -> dict:
    """What the per-layer readers and the result's ``device`` and
    ``breakdown`` take from one profiled stretch; ``host``: the benchmark's
    host spans (``spans.Spans.host``)."""
    by_cat, busy_ms, gaps, first, last = device_breakdown(trace)
    ops = sorted(((c, ms / 1e3) for c, (ms, _) in by_cat.items()), key=lambda kv: -kv[1])
    return {"by_cat": by_cat, "busy_s": busy_ms / 1e3, "wall_s": wall_s,
            "device_span_s": (last - first) / 1e6, "unanswered": unanswered_launches(trace),
            "device_ops": [[c, s] for c, s in ops[:10]], "idle_gaps": named_gaps(trace, gaps, host)}
