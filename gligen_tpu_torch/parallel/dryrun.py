"""The multi-process dry run (counterpart of ``__graft_entry__.py:61-79``,
``dryrun_multichip``): the tiny-config train step over n CPU processes in
a gloo group, as data parallelism, as a dp x tp2 grid (n >= 4, even) and
as FSDP, each through ``training/train_step.py:dryrun_train_step``, which
raises unless every rank reports the same finite loss and the same
trainable tensors.

    python -m gligen_tpu_torch.parallel.dryrun [--n 4]
"""

from __future__ import annotations

import argparse
import sys

from gligen_tpu_torch.training.train_step import dryrun_train_step


def dryrun_multichip(n: int) -> None:
    """DP, dp x tp2 (where n is even and at least 4) and FSDP over n
    processes; prints a line each and raises on any disagreement."""
    runs = [("dp", {})]
    if n >= 4 and n % 2 == 0:
        runs.append((f"dp{n // 2} x tp2", {"tp": 2}))
    runs.append(("fsdp", {"fsdp": True}))
    for label, kw in runs:
        got = dryrun_train_step(n, **kw)
        print(f"dryrun_multichip({n}): {label} OK: loss {got['losses'][0]:.6f} on every rank, "
              f"trainable digest {got['digests'][0][:16]}", flush=True)
    print(f"dryrun_multichip({n}): OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4, help="processes (CPU gloo ranks)")
    dryrun_multichip(ap.parse_args(argv).n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
