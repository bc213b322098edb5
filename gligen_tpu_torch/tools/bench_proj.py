#!/usr/bin/env python3
"""Budget of the fused projection kernels (K2) at the ds1 serving shapes,
against a matmul-only kernel on the same GEMM core (K7), cuBLAS and the
bound; and the tile sweep of every mode.

    python3 gligen_tpu_torch/tools/bench_proj.py [--iters 10] [--batch 16] [--n 4096]
    python3 gligen_tpu_torch/tools/bench_proj.py --sweep [--iters 10] [--batch 16]

Counterpart of ``tools/bench_proj.py``.  For every fused-projection site of
a ds1 transformer block at SD-1.4 GLIGEN width (CFG batch 16, N = 4096
tokens, C = 320 = 8 heads x 40), on the same seeded bf16 inputs (scale
0.2, as in the JAX tool), it times

  * the site's K2 kernel (``ln_matmuls`` for q/k/v, ``matmul_residual`` for
    the gated ``to_out`` and for ``net_2``, ``ln_geglu``);
  * K7, ``fused_proj.mm_only``, on the same products: the matmul-only mode
    of the same kernel, on the same GEMM core (``csrc/gemm_sm90.cuh``) with
    no LayerNorm, bias, gate, residual or GELU and the A tiles streamed.
    K7 - cuBLAS is what the GEMM core costs.  At ``to_out`` and ``net_2``
    K7 also runs K2's tile and grid, so K2 - K7 is the epilogue's cost.
    At q/k/v (K2: one launch over the three weights' column tiles from one
    normalised panel; K7: three launches, each streaming x) and at GEGLU
    (K2: 128 output columns a tile, a and gate halves side by side; K7:
    256) the grid or the tile differs too, so there K2 - K7 mixes the
    prologue's and epilogue's cost with that difference;
  * ``torch.matmul`` of the same bf16 products (cuBLAS): the library call
    for K7's function, which the port never uses;

and gives each row's bound (``timing.bound``: each input read once and
each output written once at the card's memory rate, or the products at its
bf16 peak, whichever is longer).  Each row: device ms per call
(``timing.timed``), TF/s and the share of 989 TF/s on the row's products,
the bound and what bounds it, the tile configuration (BM x BN x stages) of
each launch (read from the kernel's name in a ``torch.profiler`` trace,
``fused_proj_kernel<MODE, BM, BN, STAGES>``) and the K7 and K2 launches
made while the row was timed (``timed`` may run the calls again behind a
longer spin, so a count is not fixed; its kind is).  Each K7 row also
holds K7's outputs against ``mm_only_plain``'s on the row's own inputs;
the script exits 1 if one disagrees.

``--sweep`` times every mode at the table's tiles and at each of
``SWEEP_TILES`` (built into ``csrc/fused_proj_sweep.cu``) that fits its
shared memory, at the ds1 sites (``batch`` x 4096 rows), at the ds4 and
the middle block's (1280 channels over 4 x 256 and 4 x 64 rows, a 512^2
request's CFG rows), each output held against the plain version; the
table (``ops/fused_proj.py:PROJ_TILES``) is chosen from its output.  Its
launches are not counted: they are the sweep library's, or the serving
library's called at given tiles.

Left out of the JAX tool:
  * ``%align``: the TPU's matrix unit pads the contraction C = 320 to 384
    lanes, so 83% of peak was its best on true FLOPs.  Hopper's tensor
    cores step K by 16 and pad nothing;
  * ``--block_n``: the port's tiles come from the table by shape class
    (``proj_tiles``), and each row prints the tiles its launches took;
    ``--sweep`` times the others;
  * ``x * (1 + carry * 0)``, which keeps XLA from hoisting the call out of
    its timing loop: eager PyTorch runs every call it is given.
The port has no 128-lane head padding (ROADMAP §2), so the JAX tool's
1024-wide q/k/v and ``to_out`` are 320 wide here.  ``net_2`` gets a K7 row
too, which the JAX tool lacks: its long K is where K2 lost most to cuBLAS.

The card is the default.  With ``device="cpu"`` (the tests) the kernels'
plain versions run and ms is the host's wall time per call: no device
number comes from there, and the share of peak and the tiles are left out.
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

# The sweep library's configurations (csrc/fused_proj.cu:dispatch under
# FUSED_PROJ_SWEEP), by mode: (BM, BN, stages) beside the table's.
SWEEP_TILES = {
    "ln_matmuls": ((128, 160, 3), (128, 160, 5), (64, 160, 2), (64, 128, 2)),
    "matmul_residual": ((128, 160, 4), (128, 160, 3), (192, 160, 3), (64, 160, 3)),
    "ln_geglu": ((128, 128, 6), (64, 64, 3), (64, 64, 4), (64, 128, 2)),
    "mm_only": ((128, 160, 4), (128, 160, 3), (192, 160, 3), (128, 192, 3)),
}
# (level, rows, channels) of the sweep beyond ds1: ds4 and the middle
# block at a 512^2 request's 4 CFG rows
SWEEP_LEVELS = (("ds4", 4 * 256, 1280), ("mid", 4 * 64, 1280))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def row_blocks(fn) -> tuple:
    """The tile configurations (BM, BN, stages) of the fused-projection
    kernels that one call of ``fn`` launched on the card, read from their
    names in a ``torch.profiler`` trace (``fused_proj_kernel<MODE, BM, BN,
    STAGES>``)."""
    from gligen_tpu_torch.tools import perf_probe

    events = perf_probe.traced(fn)[1].get("traceEvents", [])
    return tuple(sorted({perf_probe.fused_proj_template(ev["name"])[1:] for ev in events
                         if ev.get("cat") == "kernel"
                         and "fused_proj_kernel<" in ev.get("name", "")}))


def run(batch: int = 16, n: int = 4096, iters: int = 10, device="cuda", channels: int = 320):
    """One dict per row, in the order K2 row then K7 row for each site:
    site, kernel, ms, tflops, peak_share (None on the CPU), flops, bytes,
    bound_ms, bound_by, cublas_ms, row_blocks (the tiles (BM, BN, stages)
    of each launch on the card, read from a trace after the timings; None on
    the CPU), launches
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


def tile_name(tiles) -> str:
    return "x".join(map(str, tiles))


def sweep_sites(batch: int = 16, n: int = 4096, channels: int = 320):
    """(level, kind, rows, K, F, weights) of every sweep site: the ds1
    sites of ``run`` (and K7's three products) at ``batch`` x ``n`` rows,
    then the K2 sites of each of ``SWEEP_LEVELS``."""
    sites = []
    for level, m, c in (("ds1", batch * n, channels), *SWEEP_LEVELS):
        sites += [(level, "ln_matmuls", m, c, c, 3), (level, "matmul_residual", m, c, c, 1),
                  (level, "ln_geglu", m, c, 4 * c, 1), (level, "matmul_residual", m, 4 * c, c, 1)]
        if level == "ds1":
            sites += [(level, "mm_only", m, c, f, 1) for f in (c, 8 * c)]
            sites.append((level, "mm_only", m, 4 * c, c, 1))
    return sites


def run_sweep(batch: int = 16, n: int = 4096, iters: int = 10, device="cuda",
              channels: int = 320, sites=None):
    """One dict per (site, configuration): the table's tiles first (through
    the serving library), then each of ``SWEEP_TILES[kind]`` (the sweep
    library) whose shared memory fits the site's K; level, kind, m, k, f,
    n_w, tiles, table (True for the table's row), ms, tflops, bound_ms,
    bound_by, bound_share (None on the CPU), max_abs_err and ok (the
    outputs against the plain version's, ATOL + RTOL * |plain|).  On the
    CPU every row is the plain version."""
    import torch

    from gligen_tpu_torch.ops import fused_proj as fp
    from gligen_tpu_torch.tools import timing

    device = torch.device(device)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(1)

    def mk(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    rows = []
    for level, kind, m, k, f, n_w in sites or sweep_sites(batch, n, channels):
        a = mk(m, k)
        scale, shift = 1.0 + mk(k, scale=0.1, dtype=torch.float32), mk(k, scale=0.1, dtype=torch.float32)
        if kind == "ln_matmuls":
            args = (a, scale, shift, [mk(f, k, scale=k**-0.5) for _ in range(n_w)])
        elif kind == "matmul_residual":
            gate = torch.tensor(0.37, device=device) if k == f else None
            args = (a, mk(f, k, scale=k**-0.5), mk(f, scale=0.1, dtype=torch.float32), mk(m, f), gate)
        elif kind == "ln_geglu":
            args = (a, scale, shift, mk(2 * f, k, scale=k**-0.5), mk(2 * f, scale=0.1, dtype=torch.float32))
        else:
            args = (a, mk(f, k, scale=k**-0.5))
        with torch.no_grad():
            want = getattr(fp, f"{kind}_plain")(*args)
        want = want if isinstance(want, tuple) else (want,)
        out_cols = f * n_w
        flops = 2 * m * k * f * n_w * (2 if kind == "ln_geglu" else 1)
        nbytes = 2 * (m * k + m * out_cols + n_w * k * f * (2 if kind == "ln_geglu" else 1))
        nbytes += 2 * m * f if kind == "matmul_residual" else 0
        bound_ms, bound_by = timing.bound(nbytes, flops)
        table = fp.proj_tiles(kind, m, k, f)
        for tiles in (table, *(t for t in SWEEP_TILES[kind] if t != table)):
            if fp.proj_smem(kind, tiles, k) > fp.MAX_BLOCK_SMEM:
                continue
            library = "fused_proj" if tiles == table else "fused_proj_sweep"
            call = lambda: fp.sweep_call(kind, tiles, *args, library=library)
            with torch.no_grad():
                got = call()
                got = got if isinstance(got, tuple) else (got,)
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                ok = all(bool(torch.isfinite(g).all()) and g.shape == w.shape
                         and torch.allclose(g.float(), w.float(), atol=ATOL, rtol=RTOL)
                         for g, w in zip(got, want))
                del got
                ms = timing.ms_per_call(call, iters, device)
            rows.append(dict(level=level, kind=kind, m=m, k=k, f=f, n_w=n_w, tiles=tiles,
                             table=tiles == table, ms=ms, tflops=flops / ms / 1e9,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_share=bound_ms / ms if on_card else None,
                             max_abs_err=err, ok=ok))
        del a, args, want
    return rows


def sweep_lines(rows) -> list:
    out = [f"{'level':5s} {'kernel':16s} {'M':>6s} {'K':>5s} {'F':>6s} {'tiles':>10s} "
           f"{'ms':>9s} {'TF/s':>7s} {'bound ms':>9s} {'by':10s} {'%bound':>6s}  vs plain"]
    for r in rows:
        share = "-" if r["bound_share"] is None else f"{100 * r['bound_share']:5.1f}%"
        f = f"{r['n_w']}x{r['f']}" if r["n_w"] > 1 else str(r["f"])
        out.append(f"{r['level']:5s} {r['kind']:16s} {r['m']:6d} {r['k']:5d} {f:>6s} "
                   f"{tile_name(r['tiles']):>10s}{'*' if r['table'] else ' '}{r['ms']:9.4f} "
                   f"{r['tflops']:7.1f} {r['bound_ms']:9.4f} {r['bound_by']:10s} {share:>6s}  "
                   f"max_abs_err {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    return out


def lines(rows) -> list:
    """The rows as the tool prints them."""
    out = [f"{'site':24s} {'kernel':16s} {'ms':>9s} {'TF/s':>7s} {'%peak':>6s} "
           f"{'bound ms':>9s} {'by':10s} {'cuBLAS ms':>9s} {'tiles':>11s}  launches  vs plain"]
    for r in rows:
        share = "-" if r["peak_share"] is None else f"{100 * r['peak_share']:5.1f}%"
        blocks = "-" if r["row_blocks"] is None else "/".join(map(tile_name, r["row_blocks"]))
        check = ("" if r["ok"] is None else
                 f"  max_abs_err {r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
        out.append(f"{r['site']:24s} {r['kernel']:16s} {r['ms']:9.4f} {r['tflops']:7.1f} "
                   f"{share:>6s} {r['bound_ms']:9.4f} {r['bound_by']:10s} {r['cublas_ms']:9.4f} "
                   f"{blocks:>11s}  K7 {r['launches']['mm_only']} K2 {r['launches']['K2']}{check}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--sweep", action="store_true", help="sweep every mode's tiles")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_proj")
    if args.sweep:
        rows = run_sweep(batch=args.batch, n=args.n, iters=args.iters)
        print(f"bench_proj --sweep: ds1 M={args.batch * args.n}, ds4 and mid C=1280, device ms "
              f"per call over {args.iters} calls (* the table's tiles), on {card}")
        print("\n".join(sweep_lines(rows)))
        if not all(r["ok"] for r in rows):
            raise SystemExit("bench_proj: a configuration disagrees with the plain version")
        return
    rows = run(batch=args.batch, n=args.n, iters=args.iters)
    print(f"bench_proj: B={args.batch} N={args.n} C=320 (M={args.batch * args.n} rows), device ms "
          f"per call over {args.iters} calls, on {card}")
    print("\n".join(lines(rows)))
    if any(r["ok"] is False for r in rows):
        raise SystemExit("bench_proj: K7 disagrees with mm_only_plain")


if __name__ == "__main__":
    main()
