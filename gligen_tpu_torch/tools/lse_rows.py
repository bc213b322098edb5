#!/usr/bin/env python3
"""The fp32 flash forward's LSE at scaled logits (fault F10), on one GPU.

    python3 gligen_tpu_torch/tools/lse_rows.py [--root DIR]

q and k are drawn N(0, 1) and scaled x 1, x 4 and x 8 at ds1's attn1 and
gatedSA fuser (4 x 8 heads, 4096 queries over 4096 and 4126 keys, d 40)
and ds2's attn1 (1024 over 1024, d 80), batch 4.  Each row holds the fp32
route's LSE (``flash_fwd`` on fp32 card tensors, the queries-as-rows
kernel) against the plain version (TF32 off) and prints beside it:

  * ``plain_fp64``: the plain version's own fp32 LSE against the same LSE
    computed in fp64, which says how close fp32 itself gets;
  * ``tf32``: the plain version with one-pass TF32 products
    (``allow_tf32``) against the plain version: what the tensor cores'
    single pass would give;
  * the row's limit: FP32_LSE_TOL (1e-4, log2 units) at x 1 and x 4, and
    at x 8 the limit ``derived_limit`` gives, which grows with the logits.

``--root DIR`` imports ``gligen_tpu_torch`` from another checkout (its
kernels, built from its own sources): unpack an older commit with ``git
archive`` under ``build/`` and run the same rows against its kernel.
``chip_smoke.py`` phase 3 runs ``lse_rows`` on this checkout.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FP32_LSE_TOL = 1e-4  # log2 units, chip_smoke.FP32_LSE_TOL
# (name, B, N, M, heads, head dim)
CASES = (("attn1_ds1", 4, 4096, 4096, 8, 40), ("attn1_ds2", 4, 1024, 1024, 8, 80),
         ("fuser_ds1", 4, 4096, 4126, 8, 40))
SCALES = (1, 4, 8)
DERIVED_FROM = 8  # the scale from which a row takes the derived limit


def derived_limit(torch, q, k, heads) -> float:
    """FP32_LSE_TOL plus what the two fp32 computations of a score may each
    be off, at the largest A = scale log2e max_ij sum_c |q_ic| |k_jc| of
    these inputs (an LSE moves by at most its scores' largest move):

      * the kernel's 3xTF32 chain (flash_fwd.cu:flash_fwd_f32_qm_kernel):
        each product hi hi + hi lo + lo hi with hi = rna(x) and lo
        truncated to TF32 by the tensor cores drops lo lo (<= 2^-22 |q k|)
        and the truncated parts of lo (<= 2^-21 |q k| each): <= 10 x 2^-23
        of A; its D / 8 hi.hi steps each truncate the running sum, <= 2^-23
        of A a step (the small hi.lo and lo.hi steps come first, at ~2^-11
        of the score, and add ~nothing);
      * the plain version's fp32 sum of d products: <= d 2^-24 of A.

    A worst-case bound: it grows with the logits as the error of fp32
    itself does, and one TF32 pass (2^-11 of each operand) exceeds it."""
    b, n, hc = q.shape
    d = hc // heads
    steps = (d + 7) // 8
    gamma = (10 + steps) * 2.0**-23 + d * 2.0**-24
    qa, ka = (t.abs().reshape(b, -1, heads, d) for t in (q, k))
    a = torch.einsum("bnhc,bmhc->bhnm", qa, ka).amax().item() * d**-0.5 * 1.4426950408889634
    return FP32_LSE_TOL + gamma * a


def lse_rows(torch, device, seed=0, cases=CASES, scales=SCALES):
    """One dict per (case, scale): the errors, the limit and ``ok``."""
    from gligen_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for name, b, n, m, h, d in cases:
        for mul in scales:
            q, k, v = (torch.randn((b, L, h * d), generator=gen, device=device) for L in (n, m, m))
            q, k = q * mul, k * mul
            qm = fa.flash_fwd.fp32_kernels["qm"]
            _, lse = fa.flash_fwd(q, k, v, h)
            torch.cuda.synchronize()
            qm = fa.flash_fwd.fp32_kernels["qm"] - qm
            want = fa.flash_attention_plain(q, k, v, h)[1]
            split = lambda t: t.double().unflatten(2, (h, d))
            s64 = torch.einsum("bnhc,bmhc->bhnm", split(q), split(k)) * d**-0.5
            exact = torch.logsumexp(s64, -1) * fa.LOG2E
            s_max = s64.abs().amax().item() * fa.LOG2E
            del s64
            before = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = (fa.flash_attention_plain(q, k, v, h)[1] - want).abs().max().item()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = before
            err = (lse - want).abs().max().item()
            plain_fp64 = (want.double() - exact).abs().max().item()
            kernel_fp64 = (lse.double() - exact).abs().max().item()
            derived = mul >= DERIVED_FROM
            limit = derived_limit(torch, q, k, h) if derived else FP32_LSE_TOL
            # a derived limit stands only where one TF32 pass exceeds it
            ok = (err <= limit and qm == 1 and bool(torch.isfinite(lse).all())
                  and (not derived or tf32 > limit))
            rows.append(dict(name=f"{name}_x{mul}", shape=(b, n, m, h, d), scale=mul, err=err,
                             limit=limit, derived=derived, plain_fp64=plain_fp64,
                             kernel_fp64=kernel_fp64, tf32=tf32, s_max=s_max, ok=ok))
            del q, k, v, lse, want, exact
            torch.cuda.empty_cache()
    return rows


def row_line(r) -> str:
    b, n, m, h, d = r["shape"]
    return (f"kernel flash_fwd_fp32_lse {r['name']:14s} q ({b},{n},{h}x{d}) kv {m}, q and k x "
            f"{r['scale']} (max |s| {r['s_max']:.1f} log2): lse_err {r['err']:.3e} (tol "
            f"{r['limit']:.3e}{', derived' if r['derived'] else ''}); plain fp32 vs fp64 "
            f"{r['plain_fp64']:.3e}, kernel vs fp64 {r['kernel_fp64']:.3e}; TF32 witness "
            f"{r['tf32']:.3e} ({r['tf32'] / r['limit']:.1f}x the tol) "
            f"{'ok' if r['ok'] else 'FAIL'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO), help="the checkout whose kernels to run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("lse_rows")
    rows = lse_rows(torch, torch.device("cuda", 0), args.seed)
    for r in rows:
        print(row_line(r), flush=True)
    print(f"lse_rows: {Path(args.root).resolve()} on {card}")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
