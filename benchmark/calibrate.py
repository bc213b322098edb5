#!/usr/bin/env python3
"""The readings that a generation cell's limit is set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 3,4,5]
        [--out chiprun_out/calibrate_<cell>.json]

For each seed, in one process: the seed's weights, the program built as a
run builds it, and the seed's first request of the cell's traffic at the
cell's batch; then the reference (fp32, TF32 off) over the images that
a run's check would draw from that request, and the number the check
compares (the worst image's mean absolute pixel difference).  For each
control seed, the same images computed by the control (the reference
with every product's operands rounded to fp8, ``Precision("fp8")``) in
the program's place, against the fp32 reference.  The benchmark's own
runs never run the control.  Prints one JSON line per seed and writes
them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, program  # noqa: E402
from benchmark import weights as bench_weights  # noqa: E402


def reading(cfg, wl, seed, device, control: bool):
    import torch
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline

    from benchmark.traffic import gen_closed as G

    program.apply_env(cfg)
    W = bench_weights.make(program.all_shapes(cfg), seed, device)
    comps = program.build(cfg, W, device)
    del W
    pipe = GenerationPipeline(comps)
    inputs = G.Inputs(cfg, wl, seed)
    t0 = time.perf_counter()
    img = G._generate(pipe, inputs.request(0), inputs.noise(0, device), wl["steps"],
                      cfg["alpha_stages"], wl["guidance"])
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    del pipe, comps
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sample = G.Sample(seed, wl["check"]["images"])
    sample.offer(0, img)
    prog = G.check_images(cfg, wl, seed, inputs, sample.kept, device)
    ref_s = time.perf_counter() - t0
    out = {"seed": seed, "request_s": request_s, "reference_s": ref_s,
           "program": prog["check"]["image_mae"][0], "program_images": prog["check_detail"]}
    out["clamped_share"] = float(((img == 0) | (img == 1)).float().mean())
    if control:
        picked = prog["check_detail"]["picked"]
        t0 = time.perf_counter()
        ctl = G.reference_images(cfg, wl, seed, inputs, picked, device, "fp8")
        ref = G.reference_images(cfg, wl, seed, inputs, picked, device, "fp32")
        maes = [float((c - r).abs().mean()) for c, r in zip(ctl, ref)]
        out.update(control=max(maes), control_maes=maes, control_s=time.perf_counter() - t0)
    return out


def reading_train(cfg, wl, seed, device, control: bool, fault=None):
    """The training cell's three numbers for one seed: the program's (or,
    with ``fault``, the program broken so), and with ``control`` the fp8
    reference's in the program's place, each against the fp32 reference."""
    import torch

    from benchmark.traffic import train_steps as T

    program.apply_env(cfg)
    t0 = time.perf_counter()
    first = T.first_steps(cfg, wl, seed, device, fault)
    steps_s = time.perf_counter() - t0
    losses, grad1, after = first["losses"], first["grad1"], first["after"]
    del first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = T.reference_steps(cfg, wl, seed, device)
    ref_s = time.perf_counter() - t0
    got = T.compare(wl, losses, grad1, after, ref)
    out = {"seed": seed, "fault": fault, "steps_s": steps_s, "reference_s": ref_s,
           "program": {k: v for k, (v, _) in got["check"].items()}, "detail": got["check_detail"]}
    if control:
        ctl = T.reference_steps(cfg, wl, seed, device, "fp8")
        c = T.compare(wl, ctl["losses"], ctl["grad"], ctl["params"], ref)
        out["control"] = {k: v for k, (v, _) in c["check"].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="training: faults planted in the program "
                    "(benchmark/faults.py), read on the --control-seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    entry = harness.cell(bench, args.workload)
    cfg, wl = harness.config(bench, entry["config"]), harness.workload(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    train = wl["kind"] == "train_steps"
    for seed in seeds + [s for s in controls if s not in seeds]:
        if train:
            row = reading_train(cfg, wl, seed, "cuda", seed in controls)
        else:
            row = reading(cfg, wl, seed, "cuda", seed in controls)
        row["card"] = torch.cuda.get_device_name(0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in controls:
            row = reading_train(cfg, wl, seed, "cuda", False, fault)
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = Path(args.out or ROOT / "chiprun_out" / f"calibrate_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
