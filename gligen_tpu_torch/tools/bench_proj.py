#!/usr/bin/env python3
"""Budget of the fused projection kernels (K2) at the ds1 serving shapes,
against a matmul-only kernel on the same GEMM core (K7), cuBLAS and the
bound.

    python3 gligen_tpu_torch/tools/bench_proj.py [--iters 10] [--batch 16] [--n 4096]

Counterpart of ``tools/bench_proj.py``.  For every fused-projection site of
a ds1 transformer block at SD-1.4 GLIGEN width (CFG batch 16, N = 4096
tokens, C = 320 = 8 heads x 40), on the same seeded bf16 inputs (scale
0.2, as in the JAX tool), it times

  * the site's K2 kernel (``ln_matmuls`` for q/k/v, ``matmul_residual`` for
    the gated ``to_out`` and for ``net_2``, ``ln_geglu``);
  * K7, ``fused_proj.mm_only``, on the same products: the matmul-only mode
    of the same kernel, on the same GEMM core and row-block rule, with no
    LayerNorm, bias, gate, residual or GELU.  K7 - cuBLAS is what the GEMM
    core costs.  At ``to_out`` and ``net_2`` K7 also runs K2's tile and
    grid, so K2 - K7 is the epilogue's cost.  At q/k/v (K2: one launch
    over 15 column blocks; K7: three launches over 5) and at GEGLU (K2:
    ``GemmTile<BM, 2>`` over 20 column blocks; K7: ``GemmTile<BM, 1>`` over
    40) the grid or the tile differs too, so there K2 - K7 mixes the
    prologue's and epilogue's cost with that difference;
  * ``torch.matmul`` of the same bf16 products (cuBLAS): the library call
    for K7's function, which the port never uses;

and gives each row's bound (``timing.bound``: each input read once and
each output written once at the card's memory rate, or the products at its
bf16 peak, whichever is longer).  Each row: device ms per call
(``timing.timed``), TF/s and the share of 989 TF/s on the row's products,
the bound and what bounds it, the row block of each launch (read from the
kernel's name in a ``torch.profiler`` trace, ``fused_proj_kernel<MODE,
BM>``) and the K7 and K2 launches made while the row was timed (``timed``
may run the calls again behind a longer spin, so a count is not fixed; its
kind is).  Each K7 row also holds K7's outputs against ``mm_only_plain``'s
on the row's own inputs; the script exits 1 if one disagrees.

Left out of the JAX tool:
  * ``%align``: the TPU's matrix unit pads the contraction C = 320 to 384
    lanes, so 83% of peak was its best on true FLOPs.  Hopper's tensor
    cores step K by 16 and pad nothing;
  * ``--block_n``: the port's K2 has no row-block parameter; its row block
    follows ``wide_rows`` (``csrc/gemm_core.cuh``), and each row prints the
    blocks its launches took;
  * ``x * (1 + carry * 0)``, which keeps XLA from hoisting the call out of
    its timing loop: eager PyTorch runs every call it is given.
The port has no 128-lane head padding (ROADMAP §2), so the JAX tool's
1024-wide q/k/v and ``to_out`` are 320 wide here.  ``net_2`` gets a K7 row
too, which the JAX tool lacks: its long K is where K2 lost most to cuBLAS.

The card is the default.  With ``device="cpu"`` (the tests) the kernels'
plain versions run and ms is the host's wall time per call: no device
number comes from there, and the share of peak and the row blocks are
left out.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
K2 = ("ln_matmuls", "matmul_residual", "ln_geglu")
# K7 against mm_only_plain on bf16 outputs: the same bf16 operands summed in
# fp32 in another order, so an output may round to the neighbouring bf16
# value, about one bf16 ulp (2^-7 relative): chip_smoke.py's PROJ_ATOL and
# PROJ_RTOL
ATOL, RTOL = 2e-2, 1e-2


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def row_blocks(fn) -> tuple:
    """The row blocks of the fused-projection kernels that one call of
    ``fn`` launched on the card, read from their names in a
    ``torch.profiler`` trace (``fused_proj_kernel<MODE, BM>``)."""
    from gligen_tpu_torch.tools import perf_probe

    events = perf_probe.traced(fn)[1].get("traceEvents", [])
    return tuple(sorted({perf_probe.fused_proj_template(ev["name"])[1] for ev in events
                         if ev.get("cat") == "kernel"
                         and "fused_proj_kernel<" in ev.get("name", "")}))


def run(batch: int = 16, n: int = 4096, iters: int = 10, device="cuda", channels: int = 320):
    """One dict per row, in the order K2 row then K7 row for each site:
    site, kernel, ms, tflops, peak_share (None on the CPU), flops, bytes,
    bound_ms, bound_by, cublas_ms, row_blocks (the BM of each launch on the
    card, read from a trace after the timings; None on the CPU), launches
    ({"mm_only": n, "K2": n} during the row's timing) and, for a K7 row,
    max_abs_err and ok: K7's outputs against mm_only_plain's on the row's
    own inputs, |K7 - plain| <= ATOL + RTOL * |plain| (None for K2), and
    check_launches, K7's launches made for that comparison."""
    import torch

    from gligen_tpu_torch.ops import fused_proj as fp
    from gligen_tpu_torch.tools import timing

    device = torch.device(device)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)

    def mk(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.2).to(torch.bfloat16)

    c, m = channels, batch * n
    x, h, xr, h2 = mk(batch, n, c), mk(batch, n, c), mk(batch, n, c), mk(batch, n, 4 * c)
    ws3, wo, wg, w2 = [mk(c, c) for _ in range(3)], mk(c, c), mk(8 * c, c), mk(c, 4 * c)
    ones, zeros = torch.ones(c, device=device), torch.zeros(c, device=device)
    bg = torch.zeros(8 * c, device=device)
    gate = torch.tensor(0.37, device=device)  # the fuser's device gate on to_out
    # site, K2 kernel, its call, its inputs, the site's products (a, w): y = a @ w.T
    sites = [
        (f"q/k/v {c}->3x{c}", "ln_matmuls", lambda: fp.ln_matmuls(x, ones, zeros, ws3),
         (x, ones, zeros, *ws3), [(x, w) for w in ws3]),
        (f"to_out {c}->{c} gated", "matmul_residual",
         lambda: fp.matmul_residual(h, wo, zeros, xr, gate), (h, wo, zeros, xr, gate), [(h, wo)]),
        (f"GEGLU {c}->2x{4 * c}", "ln_geglu", lambda: fp.ln_geglu(x, ones, zeros, wg, bg),
         (x, ones, zeros, wg, bg), [(x, wg)]),
        (f"net_2 {4 * c}->{c}", "matmul_residual", lambda: fp.matmul_residual(h2, w2, zeros, xr),
         (h2, w2, zeros, xr), [(h2, w2)]),
    ]
    rows, calls = [], []
    with torch.no_grad():
        for site, kernel, call, inputs, products in sites:
            outs = call()
            outs = outs if isinstance(outs, tuple) else (outs,)
            flops = sum(2 * a.numel() * w.shape[0] for a, w in products)
            cublas_ms = timing.ms_per_call(
                lambda: [torch.matmul(a, w.T) for a, w in products], iters, device)
            k7 = lambda ps=products: [fp.mm_only(a, w) for a, w in ps]  # traced later, too
            for name, fn, nbytes in (
                (kernel, call, _nbytes(inputs) + _nbytes(outs)),
                ("mm_only", k7, sum(_nbytes((a, w)) + 2 * m * w.shape[0] for a, w in products)),
            ):
                before = {k: w.launches for k, w in fp.KERNELS.items()}
                ms = timing.ms_per_call(fn, iters, device)
                made = {k: w.launches - before[k] for k, w in fp.KERNELS.items()}
                launches = {"mm_only": made["mm_only"], "K2": sum(made[k] for k in K2)}
                bound_ms, bound_by = timing.bound(nbytes, flops)
                rows.append(dict(
                    site=site, kernel=name, ms=ms, tflops=flops / ms / 1e9,
                    peak_share=flops / ms / 1e-3 / timing.BF16_TENSOR_FLOP_PER_S if on_card else None,
                    flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                    cublas_ms=cublas_ms, row_blocks=None, launches=launches,
                    max_abs_err=None, ok=None, check_launches=0))
                calls.append(fn)
            del outs
            # K7 against its plain version, one product at a time
            err, ok, before = 0.0, True, fp.mm_only.launches
            for a, w in products:
                got, want = fp.mm_only(a, w).float(), fp.mm_only_plain(a, w).float()
                err = max(err, (got - want).abs().max().item())
                ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape \
                    and torch.allclose(got, want, atol=ATOL, rtol=RTOL)
                del got, want
            rows[-1].update(max_abs_err=err, ok=ok, check_launches=fp.mm_only.launches - before)
        if on_card:  # traced after every timing: a trace may slow the host for the rest
            for row, fn in zip(rows, calls):
                row["row_blocks"] = row_blocks(fn)
    return rows


def lines(rows) -> list:
    """The rows as the tool prints them."""
    out = [f"{'site':24s} {'kernel':16s} {'ms':>9s} {'TF/s':>7s} {'%peak':>6s} "
           f"{'bound ms':>9s} {'by':10s} {'cuBLAS ms':>9s} {'rows':>6s}  launches  vs plain"]
    for r in rows:
        share = "-" if r["peak_share"] is None else f"{100 * r['peak_share']:5.1f}%"
        blocks = "-" if r["row_blocks"] is None else "/".join(map(str, r["row_blocks"]))
        check = ("" if r["ok"] is None else
                 f"  max_abs_err {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
        out.append(f"{r['site']:24s} {r['kernel']:16s} {r['ms']:9.4f} {r['tflops']:7.1f} "
                   f"{share:>6s} {r['bound_ms']:9.4f} {r['bound_by']:10s} {r['cublas_ms']:9.4f} "
                   f"{blocks:>6s}  K7 {r['launches']['mm_only']} K2 {r['launches']['K2']}{check}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_proj")
    rows = run(batch=args.batch, n=args.n, iters=args.iters)
    print(f"bench_proj: B={args.batch} N={args.n} C=320 (M={args.batch * args.n} rows), device ms "
          f"per call over {args.iters} calls, on {card}")
    print("\n".join(lines(rows)))
    if any(r["ok"] is False for r in rows):
        raise SystemExit("bench_proj: K7 disagrees with mm_only_plain")


if __name__ == "__main__":
    main()
