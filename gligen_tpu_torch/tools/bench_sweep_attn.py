#!/usr/bin/env python3
"""Tile sweep of the flash-attention forward kernel at the ds1 serving
shapes.

    python3 gligen_tpu_torch/tools/bench_sweep_attn.py [--iters 10] [--batch 16] [--m 0]
        [--configs 128x128x2,64x128x2,...]

Counterpart of ``tools/bench_sweep_attn.py``.  At the shapes of a ds1
transformer block at SD-1.4 width (CFG batch 16, 8 heads of 40, N = 4096
queries; M = 4096 keys for attn1, 4126 for the gated fuser's N + 30), on
seeded unit-scale bf16 inputs, it times the kernel of ``csrc/flash_fwd.cu``
once at the wrapper's fixed tiles (``fwd_tiles``) and once at each (BQ
query rows, BK keys, ring stages) of ``--configs``, through the sweep
library (``csrc/flash_fwd_sweep.cu``), and
``F.scaled_dot_product_attention`` on the same inputs as the yardstick
(the port never calls it).  Each row: device ms per call
(``timing.timed``), TF/s on the products (4·B·H·N·M·d), the share of the
bound (``timing.bound``: bound ms over the row's ms), SDPA's ms, and the
row's output and LSE against ``flash_attention_plain`` on every query row
(``plain_by_rows``), with chip_smoke.py's tolerances.  The script exits 1
if a row disagrees.  The kernel's launches here go to no wrapper's count.

Left out of the JAX tool: its ``block_kv="single"`` (the TPU's one-pass
form; this kernel always streams K/V through its ring), ``--fuser`` and
``--fuser_select`` (the TPU's 128-padded fuser keys; the port's kernel
masks the ragged key tile itself, so M = 4126 is the fuser's real form),
the 128-lane head padding (``true_dim``: the port has none), the carry
through q that keeps XLA from hoisting the call, and its inputs' scale of
0.2: at that scale the logits are ~0.04 and the softmax nearly uniform, so
the check against the plain version would barely see P.

The card is the default.  With ``device="cpu"`` (the tests) every row runs
the plain version and ms is the host's wall time per call: no device
number comes from there.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIGS = ((64, 64, 2), (64, 64, 3), (64, 128, 2), (64, 128, 3),
           (128, 64, 2), (128, 64, 3), (128, 128, 2), (128, 128, 3))
# query rows per call of the plain version: its (B, H, rows, M) fp32 scores
# are 1 GiB at the ds1 shapes
CHECK_ROWS = 512
# chip_smoke.py's OUT_TOL, OUT_REL_TOL and LSE_TOL: the bf16 output a few
# ulps off the fp32 plain version, so within OUT_REL_TOL of the plain
# output's largest magnitude (and OUT_TOL absolute); the LSE fp32 on both
# sides, summed in another order
OUT_TOL, OUT_REL_TOL, LSE_TOL = 2e-2, 2e-2, 1e-3


def parse_configs(text: str) -> tuple:
    """"128x128x2,64x64x3" -> ((128, 128, 2), (64, 64, 3))."""
    return tuple(tuple(int(x) for x in item.split("x")) for item in text.split(",") if item)


def sdpa(q, k, v, heads):
    """The library's attention on the packed (B, L, H*C) layout."""
    import torch.nn.functional as F

    split = lambda t: t.unflatten(-1, (heads, -1)).transpose(1, 2)
    return F.scaled_dot_product_attention(split(q), split(k), split(v))


def plain_by_rows(q, k, v, heads, bias=None, rows: int = CHECK_ROWS):
    """``flash_attention_plain`` over every query row, ``rows`` at a time
    (rows are independent), so the score matrix is never whole."""
    import torch

    from gligen_tpu_torch.ops.flash_attention import flash_attention_plain

    parts = [flash_attention_plain(q[:, i:i + rows], k, v, heads, bias=bias)
             for i in range(0, q.shape[1], rows)]
    return torch.cat([o for o, _ in parts], 1), torch.cat([l for _, l in parts], 2)


def out_ok(out, lse, want, want_lse):
    """(max abs error of out, of lse, whether both are finite and within
    the tolerances)."""
    import torch

    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    limit = min(OUT_TOL, OUT_REL_TOL * want.float().abs().max().item())
    return err, lse_err, finite and err <= limit and lse_err <= LSE_TOL


def run(batch: int = 16, n: int = 4096, ms_keys=(4096, 4126), configs=CONFIGS,
        iters: int = 10, device="cuda", heads: int = 8, dim: int = 40,
        check_rows: int = CHECK_ROWS):
    """One dict per row, for each key count M: the fixed table's row
    (``tiles`` None) then one per config: m, tiles, table, ms, tflops,
    bound_ms, bound_by, bound_share (None on the CPU), sdpa_ms,
    max_abs_err, lse_err, ok.  On the CPU every row is the plain version."""
    import torch

    from gligen_tpu_torch.ops.flash_attention import flash_attention_plain, fwd_tiles, launch_fwd
    from gligen_tpu_torch.tools import timing

    device = torch.device(device)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    table = fwd_tiles(dim)
    rows = []
    with torch.no_grad():
        for m in ms_keys:
            q, k, v = (torch.randn((batch, L, heads * dim), generator=gen, device=device)
                       .to(torch.bfloat16) for L in (n, m, m))
            want, want_lse = plain_by_rows(q, k, v, heads, rows=check_rows)
            flops = 4 * batch * heads * n * m * dim
            nbytes = 2 * (2 * batch * n + 2 * batch * m) * heads * dim + 4 * batch * heads * n
            bound_ms, bound_by = timing.bound(nbytes, flops)
            sdpa_ms = timing.ms_per_call(lambda: sdpa(q, k, v, heads), iters, device)
            for tiles in (None, *configs):
                if on_card:
                    library = "flash_fwd" if tiles is None else "flash_fwd_sweep"
                    call = lambda: launch_fwd(library, q, k, v, heads, None, tiles or table)[:2]
                else:
                    call = lambda: flash_attention_plain(q, k, v, heads)
                out, lse = call()
                err, lse_err, ok = out_ok(out, lse, want, want_lse)
                del out, lse
                ms = timing.ms_per_call(call, iters, device)
                rows.append(dict(
                    m=m, tiles=tiles, table=table if tiles is None else None, ms=ms,
                    tflops=flops / ms / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                    bound_share=bound_ms / ms if on_card else None, sdpa_ms=sdpa_ms,
                    max_abs_err=err, lse_err=lse_err, ok=ok))
            del q, k, v, want, want_lse
    return rows


def lines(rows) -> list:
    """The rows as the tool prints them."""
    out = [f"{'M':>5s} {'BQxBKxstages':>14s} {'ms':>9s} {'TF/s':>7s} {'%bound':>7s} "
           f"{'bound ms':>9s} {'SDPA ms':>9s}  vs plain"]
    for r in rows:
        tiles = "x".join(map(str, r["tiles"] or r["table"])) + ("" if r["tiles"] else " table")
        share = "-" if r["bound_share"] is None else f"{100 * r['bound_share']:6.1f}%"
        out.append(f"{r['m']:5d} {tiles:>14s} {r['ms']:9.4f} {r['tflops']:7.1f} {share:>7s} "
                   f"{r['bound_ms']:9.4f} {r['sdpa_ms']:9.4f}  max_abs_err {r['max_abs_err']:.3e} "
                   f"lse_err {r['lse_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=0, help="key count; 0 = both 4096 and 4126")
    ap.add_argument("--configs", default=",".join("x".join(map(str, c)) for c in CONFIGS),
                    help="BQxBKxSTAGES, comma separated")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_sweep_attn")
    ms_keys = (4096, 4126) if args.m == 0 else (args.m,)
    rows = run(batch=args.batch, n=args.n, ms_keys=ms_keys, configs=parse_configs(args.configs),
               iters=args.iters)
    print(f"bench_sweep_attn: B={args.batch} N={args.n} 8x40, device ms per call over "
          f"{args.iters} calls, on {card}")
    print("\n".join(lines(rows)))
    if not all(r["ok"] for r in rows):
        raise SystemExit("bench_sweep_attn: a configuration disagrees with flash_attention_plain")


if __name__ == "__main__":
    main()
