#!/usr/bin/env python3
"""Tile sweep of the flash-attention kernels: the forward at the ds1
serving shapes, the backward (``--bwd``) at a training level's shapes.

    python3 gligen_tpu_torch/tools/bench_sweep_attn.py [--iters 10] [--batch 16] [--m 0]
        [--configs 128x128x2,64x128x2,...]
    python3 gligen_tpu_torch/tools/bench_sweep_attn.py --bwd [--level ds1] [--batch 4]
        [--iters 10] [--m 0]
    python3 gligen_tpu_torch/tools/bench_sweep_attn.py --fp32 [--batch 4] [--iters 10] [--m 0]

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

``--bwd`` (``run_bwd``): the backward kernels of ``csrc/flash_bwd.cu`` at
the shapes of one level of the 512^2 training step (ds1: 8 heads of 40
over N = 4096 queries, M = 4096 and 4126 keys; ds2 80 over 1024; ds4 160
over 256), B = 4, on seeded unit-scale bf16 q/k/v and dO with the LSE and
delta of the plain forward.  Each of dq and dk/dv runs once at the
wrapper's table (``bwd_tiles``) and once at each configuration of the
sweep library (``csrc/flash_bwd_sweep.cu``, ``BWD_CONFIGS``); each row:
device ms, TF/s on the kernel's products (3 or 4 of 2·B·H·N·M·d), the
share of the bound, SDPA's backward (dq, dk and dv at once) as the
yardstick, and each gradient against ``flash_attention_bwd_plain`` to
chip_smoke.py's ``BWD_REL_TOL`` of its largest magnitude.

``--fp32`` (``run_fp32``): the fp32 route's kernel for the UNet's heads
(``flash_fwd_f32_qm_kernel``) at ds1 (8 heads of 40 over N = 4096) and ds2
(80 over 1024), M = N and N + 30, B = 4 (a batch-2 request's CFG rows), on
seeded unit-scale fp32 q/k/v: once at the wrapper's table
(``fwd_tiles_f32``) and once at each (BQ, BK, converted buffers) of
``F32_CONFIGS`` through the fp32 sweep library
(``csrc/flash_fwd_f32_sweep.cu``); each row: device ms, TF/s on the
products (4·B·H·N·M·d), the share of the 3xTF32 bound (3 x the products at
the TF32 tensor rate), SDPA in fp32 (TF32 off) as the yardstick, and the
output and LSE against ``flash_attention_plain`` on every query row, to
chip_smoke.py's FP32_REL_TOL of the plain output's largest magnitude and
FP32_LSE_TOL.  The table is what this sweep picks.

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


# The backward sweep library's configurations (csrc/flash_bwd.cu:dispatch
# under FLASH_BWD_SWEEP) by head-dim class: dq's (BQ, BK, stages) and
# dk/dv's (BK keys, BQ, stages).
BWD_CONFIGS = {
    40: (((64, 64, 2), (128, 64, 2), (128, 64, 3), (128, 128, 2)),
         ((64, 64, 2), (128, 64, 2), (128, 64, 3), (128, 32, 2))),
    80: (((64, 64, 2), (128, 64, 2), (128, 64, 3), (128, 128, 2)),
         ((64, 64, 2), (128, 64, 2), (128, 64, 3), (128, 32, 2))),
    160: (((64, 64, 2), (128, 64, 2), (128, 32, 2)), ((64, 64, 2), (64, 32, 2), (64, 32, 3))),
}
# The fp32 sweep library's configurations (csrc/flash_fwd.cu:f32qm::dispatch
# under FLASH_FWD_F32_SWEEP) by head-dim class: (BQ, BK, converted K/V
# buffers).
F32_CONFIGS = {
    40: ((64, 32, 2), (64, 64, 2), (128, 32, 2), (128, 64, 2), (192, 32, 2), (192, 64, 2)),
    80: ((64, 32, 2), (128, 32, 2), (128, 64, 1), (192, 32, 1)),
}
# (N, head dim) of the levels the fp32 sweep times (8 heads)
F32_LEVELS = {"ds1": (4096, 40), "ds2": (1024, 80)}
# chip_smoke.py's FP32_REL_TOL and FP32_LSE_TOL
FP32_REL_TOL, FP32_LSE_TOL = 1e-4, 1e-4
# (N, head dim) of each training level's self-attention (8 heads)
BWD_LEVELS = {"ds1": (4096, 40), "ds2": (1024, 80), "ds4": (256, 160)}
# chip_smoke.py's BWD_REL_TOL: each gradient within 2e-2 of its plain
# version's largest magnitude
BWD_REL_TOL = 2e-2


def bwd_configs(d: int) -> tuple:
    """(dq configurations, dk/dv configurations) of the sweep library for
    head dim ``d``."""
    return next(configs for top, configs in BWD_CONFIGS.items() if d <= top)


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


def run_fp32(batch: int = 4, levels=tuple(F32_LEVELS), ms_keys=None, iters: int = 10,
             device="cuda", heads: int = 8, n: int = 0, dim: int = 0,
             check_rows: int = CHECK_ROWS):
    """One dict per row, for each level and key count M (``ms_keys``,
    default N and N + 30): the table's row (``tiles`` None) then one per
    configuration of ``F32_CONFIGS`` for the level's head dim: level, m,
    tiles, table, ms, tflops, bound_ms, bound_by, bound_share (None on the
    CPU), sdpa_ms, max_abs_err, lse_err, limit, ok.  ``n``/``dim`` override
    the levels' (the tests).  On the CPU every row is the plain version."""
    import torch

    from gligen_tpu_torch.ops.flash_attention import (flash_attention_plain, fwd_tiles_f32,
                                                      launch_fwd_f32)
    from gligen_tpu_torch.tools import timing

    device = torch.device(device)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    with torch.no_grad():
        for level in levels:
            lvl_n, d = n or F32_LEVELS[level][0], dim or F32_LEVELS[level][1]
            table = fwd_tiles_f32(d)[1]
            configs = next(c for top, c in F32_CONFIGS.items() if d <= top)
            for m in ms_keys or (lvl_n, lvl_n + 30):
                q, k, v = (torch.randn((batch, L, heads * d), generator=gen, device=device)
                           for L in (lvl_n, m, m))
                want, want_lse = plain_by_rows(q, k, v, heads, rows=check_rows)
                limit = FP32_REL_TOL * want.abs().max().item()
                flops = 4 * batch * heads * lvl_n * m * d
                nbytes = 4 * (2 * batch * lvl_n + 2 * batch * m) * heads * d
                nbytes += 4 * batch * heads * lvl_n
                bound_ms, bound_by = timing.bound(nbytes, 3 * flops,
                                                  timing.TF32_TENSOR_FLOP_PER_S)
                sdpa_ms = timing.ms_per_call(lambda: sdpa(q, k, v, heads), iters, device)
                for tiles in (None, *configs):
                    if on_card:
                        library = "flash_fwd" if tiles is None else "flash_fwd_f32_sweep"
                        call = lambda: launch_fwd_f32(library, q, k, v, heads, None,
                                                      tiles or table)
                    else:
                        call = lambda: flash_attention_plain(q, k, v, heads)
                    out, lse = call()
                    err = (out - want).abs().max().item()
                    lse_err = (lse - want_lse).abs().max().item()
                    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
                    del out, lse
                    ms = timing.ms_per_call(call, iters, device)
                    rows.append(dict(
                        level=level, m=m, tiles=tiles, table=table if tiles is None else None,
                        ms=ms, tflops=flops / ms / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                        bound_share=bound_ms / ms if on_card else None, sdpa_ms=sdpa_ms,
                        max_abs_err=err, lse_err=lse_err, limit=limit,
                        ok=finite and err <= limit and lse_err <= FP32_LSE_TOL))
                del q, k, v, want, want_lse
    return rows


def fp32_lines(rows) -> list:
    """The fp32 rows as the tool prints them."""
    out = [f"{'level':>5s} {'M':>5s} {'BQxBKxbufs':>14s} {'ms':>9s} {'TF/s':>7s} {'%bound':>7s} "
           f"{'bound ms':>9s} {'SDPA fp32':>9s}  vs plain"]
    for r in rows:
        tiles = "x".join(map(str, r["tiles"] or r["table"])) + ("" if r["tiles"] else " table")
        share = "-" if r["bound_share"] is None else f"{100 * r['bound_share']:6.1f}%"
        out.append(f"{r['level']:>5s} {r['m']:5d} {tiles:>14s} {r['ms']:9.4f} {r['tflops']:7.1f} "
                   f"{share:>7s} {r['bound_ms']:9.4f} {r['sdpa_ms']:9.4f}  max_abs_err "
                   f"{r['max_abs_err']:.3e} (tol {r['limit']:.3e}) lse_err {r['lse_err']:.3e} "
                   f"{'ok' if r['ok'] else 'FAIL'}")
    return out


def sdpa_bwd(q, k, v, heads, do):
    """A function that runs the library attention's backward (dq, dk, dv)
    at this shape: the yardstick, never used by the port."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, heads).transpose(1, 2).flatten(2)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def run_bwd(batch: int = 4, level: str = "ds1", ms_keys=None, configs=None, iters: int = 10,
            device="cuda", heads: int = 8, n: int = 0, dim: int = 0):
    """One dict per row, for each key count M (``ms_keys``, default N and
    N + 30) and each kernel ("dq", "dkv"): the table's row (``tiles``
    None) then one per configuration of ``configs`` (default
    ``bwd_configs(dim)``): kind, m, tiles, table, ms, tflops, bound_ms,
    bound_by, bound_share (None on the CPU), sdpa_ms, rel_err (the largest
    of each gradient's max abs error over its plain version's largest
    magnitude), ok.  ``n``/``dim`` override the level's.  On the CPU every
    row is the plain version."""
    import torch

    from gligen_tpu_torch.ops import flash_attention as fa
    from gligen_tpu_torch.tools import timing

    device = torch.device(device)
    on_card = device.type == "cuda"
    n, dim = n or BWD_LEVELS[level][0], dim or BWD_LEVELS[level][1]
    ms_keys = ms_keys or (n, n + 30)
    configs = configs or bwd_configs(dim)
    tables = fa.bwd_tiles(dim)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for m in ms_keys:
        q, k, v = (torch.randn((batch, L, heads * dim), generator=gen, device=device)
                   .to(torch.bfloat16) for L in (n, m, m))
        do = torch.randn((batch, n, heads * dim), generator=gen, device=device).to(torch.bfloat16)
        with torch.no_grad():
            out, lse = fa.flash_attention_plain(q, k, v, heads)
            delta = fa.attention_delta(out, do, heads)
            args = (q, k, v, heads, do, lse, delta, None)
            want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(*args)))
            del out
        sdpa_ms = timing.ms_per_call(sdpa_bwd(q, k, v, heads, do), iters, device)
        flops = 2 * batch * heads * n * m * dim
        extra = 8 * batch * heads * n  # lse and delta
        for i, kind in enumerate(("dq", "dkv")):
            names = ("dq",) if kind == "dq" else ("dk", "dv")
            ops = (3 if kind == "dq" else 4) * flops
            nbytes = 2 * ((3 * batch * n + 2 * batch * m) if kind == "dq"
                          else (2 * batch * n + 4 * batch * m)) * heads * dim + extra
            bound_ms, bound_by = timing.bound(nbytes, ops)
            for tiles in (None, *configs[i]):
                if on_card:
                    library = "flash_bwd" if tiles is None else "flash_bwd_sweep"
                    call = lambda: fa.launch_bwd(library, kind, *args, tiles or tables[i])[0]
                else:
                    def call():
                        grads = fa.flash_attention_bwd_plain(*args)
                        return grads[0] if kind == "dq" else grads[1:3]
                with torch.no_grad():
                    got = call()
                got = (got,) if kind == "dq" else got[:2]
                errs = [(g.float() - want[name].float()).abs().max().item()
                        / want[name].float().abs().max().item() for name, g in zip(names, got)]
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                del got
                ms = timing.ms_per_call(call, iters, device)
                rows.append(dict(
                    kind=kind, m=m, tiles=tiles, table=tables[i] if tiles is None else None,
                    ms=ms, tflops=ops / ms / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                    bound_share=bound_ms / ms if on_card else None, sdpa_ms=sdpa_ms,
                    rel_err=max(errs), ok=finite and max(errs) <= BWD_REL_TOL))
        del q, k, v, do, lse, delta, args, want
    return rows


def bwd_lines(rows) -> list:
    """The backward rows as the tool prints them."""
    out = [f"{'kernel':>6s} {'M':>5s} {'tiles':>14s} {'ms':>9s} {'TF/s':>7s} {'%bound':>7s} "
           f"{'bound ms':>9s} {'SDPA bwd':>9s}  vs plain"]
    for r in rows:
        tiles = "x".join(map(str, r["tiles"] or r["table"])) + ("" if r["tiles"] else " table")
        share = "-" if r["bound_share"] is None else f"{100 * r['bound_share']:6.1f}%"
        out.append(f"{r['kind']:>6s} {r['m']:5d} {tiles:>14s} {r['ms']:9.4f} {r['tflops']:7.1f} "
                   f"{share:>7s} {r['bound_ms']:9.4f} {r['sdpa_ms']:9.4f}  max_abs_err/max|plain| "
                   f"{r['rel_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    return out


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
    ap.add_argument("--batch", type=int, default=0, help="0 = 16 (forward), 4 (--bwd)")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=0,
                    help="key count; 0 = both N and N + 30 (the forward: 4096 and 4126)")
    ap.add_argument("--configs", default=",".join("x".join(map(str, c)) for c in CONFIGS),
                    help="BQxBKxSTAGES, comma separated (the forward)")
    ap.add_argument("--bwd", action="store_true", help="sweep the backward kernels")
    ap.add_argument("--fp32", action="store_true",
                    help="sweep the fp32 route's kernel at ds1 and ds2")
    ap.add_argument("--level", choices=sorted(BWD_LEVELS), default="ds1",
                    help="the training level whose shapes --bwd times")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_sweep_attn")
    if args.bwd:
        batch = args.batch or 4
        rows = run_bwd(batch=batch, level=args.level, ms_keys=(args.m,) if args.m else None,
                       iters=args.iters)
        n, d = BWD_LEVELS[args.level]
        print(f"bench_sweep_attn --bwd: {args.level} B={batch} N={n} 8x{d}, device ms per call "
              f"over {args.iters} calls, on {card}")
        print("\n".join(bwd_lines(rows)))
        if not all(r["ok"] for r in rows):
            raise SystemExit("bench_sweep_attn: a backward configuration disagrees with "
                             "flash_attention_bwd_plain")
        return
    if args.fp32:
        batch = args.batch or 4
        rows = run_fp32(batch=batch, ms_keys=(args.m,) if args.m else None, iters=args.iters)
        print(f"bench_sweep_attn --fp32: B={batch} ds1 (N=4096, 8x40) and ds2 (N=1024, 8x80), "
              f"device ms per call over {args.iters} calls, on {card}")
        print("\n".join(fp32_lines(rows)))
        if not all(r["ok"] for r in rows):
            raise SystemExit("bench_sweep_attn: an fp32 configuration disagrees with "
                             "flash_attention_plain")
        return
    args.batch = args.batch or 16
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
