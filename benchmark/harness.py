"""What every cell shares: finding a cell, its configuration, traffic and
metrics by name, the JAX-module check and the result line.  Nothing here
knows a particular cell; a cell, a configuration or a metric is added by
adding its files and its entries in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# compared by whole top-level name: ``gligen_tpu_torch`` is not ``gligen_tpu``
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gligen_tpu")


def load_benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str) -> Dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(ROOT / entry["file"]) as f:
                return json.load(f)
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def workload(name: str) -> Dict:
    with open(BENCH_DIR / "workloads" / f"{name}.json") as f:
        return json.load(f)


def driver(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             cfg_override: Dict = None, wl_override: Dict = None, fault: str = None) -> Dict:
    """One run of cell ``name``; the overrides and ``fault`` are for the
    tests, which run a small copy of a cell on the CPU."""
    entry = cell(bench, name)
    cfg = cfg_override or config(bench, entry["config"])
    wl = wl_override or workload(name)
    return driver(wl["kind"]).run(name, cfg, wl, seed, seconds, trace, device, t0, fault=fault)


def metrics_of(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those whose ``workloads`` list it, or that have no such list."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """``benchmark/metrics/<metric>.py``'s ``read(record)``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def device_info(record: Dict, trace: bool) -> Dict:
    import torch

    on_card = torch.cuda.is_available()
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": int(record.get("memory_peak_bytes", 0))}
    prof = record.get("profile")
    if trace and prof:
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["wall_s"]
    return info


def result(bench: Dict, name: str, record: Dict, trace: bool) -> Dict:
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(record["correct"]),
           "attempted": record.get("attempted", len(record.get("requests", []))),
           "failed": record.get("failed", sum(not r["ok"] for r in record.get("requests", []))),
           "metrics": metrics, "device": device_info(record, trace)}
    prof = record.get("profile")
    if trace and prof:
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in record["check"].items()}
    return out


def print_check(record: Dict) -> None:
    """The set-up's parts, then the numbers compared, each beside its
    limit: the last lines of standard error."""
    parts = record.get("setup_parts", {})
    print("setup " + " ".join(f"{k} {v!r}" for k, v in parts.items()), file=sys.stderr)
    spans = [round(r["end"] - r["start"], 4) for r in record.get("requests", [])]
    cpu = [round(r["cpu_s"], 3) for r in record.get("requests", []) if "cpu_s" in r]
    print(f"window {record.get('window_s')!r} s, {len(spans)} requests or steps of s: {spans}"
          + (f"; host CPU s: {cpu}" if cpu else ""), file=sys.stderr)
    for k, (v, lim) in record["check"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(f"check correct {bool(record['correct'])}", file=sys.stderr, flush=True)
