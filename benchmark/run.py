#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gligen_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``benchmark/configs/``) and its
traffic (``benchmark/workloads/<cell>.json``, whose ``kind`` names the
driver ``benchmark/traffic/<kind>.py``).  The driver makes the weights and
inputs from ``--seed``, sets up and warms the program, measures for
``--seconds`` and checks what the window produced against the plain
reference (``benchmark/reference/``).  The last line of standard output
is the result: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (``benchmark/metrics/<name>.py`` each);
the numbers compared, each beside its limit, end standard error.

Exits 2, printing no result, without a CUDA card or with fewer cards than
the cell asks for; 3 when a JAX module (``jax``, ``jaxlib``, ``flax``,
``optax``, ``gligen_tpu``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_benchmark()
    cell = harness.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    record = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"run.py: JAX modules loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    result = harness.result(bench, args.workload, record, bool(args.trace))
    harness.print_check(record)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
