#!/usr/bin/env python3
"""Variants of the flash backward's fp32 kernels in the d <= 160 class,
built from edited copies of ``csrc/flash_bwd.cu`` and timed side by side
on one card: what each piece of the design buys, and where the time goes.

    python3 gligen_tpu_torch/tools/bench_bwd_variants.py [--variants base,ks1,...]
        [--iters 20]

Each variant is a list of text edits (old, new) of ``flash_bwd.cu`` (every
``old`` must be in the source, or the tool stops); the copy, with the
headers it includes, is built by ``nvcc`` with the package's flags under
``build/bwd_variants/<name>/`` as a library of the fp32 sweep's
configurations of the d <= 160 class only (its d <= 40 and d <= 80 lists
emptied).  The variants:

  * ``base``: the source as it is;
  * ``ks1``: dq's 64-query blocks in one key part (one warpgroup a block,
    two buffers): the first form of the raw-resident dq;
  * ``noshare``: dk/dv without the P^T exchange (the dK warpgroup computes
    S^T as well: 5 products, d = 80's form);
  * ``steps1``, ``steps4``: dk/dv's raw_chains with 1 or 4 k-steps a commit
    group (the source: 2);
  * ``ring3``: both kernels' raw_chains with 3 groups in flight (the
    source: 2);
  * ``nochain``, ``noparts``, ``nostore`` (timing only, the gradients
    wrong): without the products over the head dim, without the products
    over the tile, without the stores of the next tile into its buffer.

For each variant: ptxas's registers and spills of the d <= 160 kernels,
then at attn1 and the fuser of ds4 (B = 4, 8 heads of 160, 256 queries
over 256 and 286 keys, seeded unit-scale fp32 inputs, the LSE and delta of
the plain forward) the device ms of dq at (64, 16) and (128, 16) and of
dk/dv at (64, 16) (``timing.timed``), each gradient's max abs error over
its plain version's largest magnitude.  Needs a CUDA card and ``nvcc``.
The launches go to no wrapper's count.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "gligen_tpu_torch" / "csrc"
OUT = REPO / "build" / "bwd_variants"

_CHAIN = ("        WgmmaRsTf32<N>::rs(small[i], fh[r][st][i], bl, kk > 0);\n"
          "        WgmmaRsTf32<N>::rs(small[i], fl[r][st][i], bh, 1);\n"
          "        WgmmaRsTf32<N>::rs(big[i], fh[r][st][i], bh, kk > 0);\n")
_STEPS = "static constexpr int kSteps = 2;"
VARIANTS = {
    "base": [],
    "ks1": [("constexpr int ks = raw && R == 64 ? 2 : 1;", "constexpr int ks = 1;")],
    "noshare": [("static constexpr bool kShareP = kRaw && SPLIT == 2;",
                 "static constexpr bool kShareP = false;")],
    "steps1": [(_STEPS, "static constexpr int kSteps = 1;")],
    "steps4": [(_STEPS, "static constexpr int kSteps = 4;")],
    "ring3": [("constexpr int M = TWO ? 2 : 1, RING = 2,",
               "constexpr int M = TWO ? 2 : 1, RING = 3,")],
    "nochain": [(_CHAIN, "")],
    "noparts": [("      rs_chain<C::D, C::BK, C::kPN>(part, fh, fl, kt, 0, n0);\n", ""),
                ("      if constexpr (DV) rs_chain<C::D, C::BQ, C::kPN>(pv, ph, pl, tr, 1, n0);\n",
                 ""),
                ("      if constexpr (DK) rs_chain<C::D, C::BQ, C::kPN>(pk, dh, dl, tr, 0, n0);\n",
                 "")],
    "nostore": [(f"    next.template store<true, {tail}>(buf(i), buf(i) + C::kTileBytes, warp, "
                 "lane);\n", "") for tail in ("false", "true")],
}
# the variants whose gradients are meant to be right
EXACT = ("base", "ks1", "noshare", "steps1", "steps4", "ring3")
SHAPES = {"attn1_ds4": (4, 256, 256, 8, 160), "fuser_ds4": (4, 256, 286, 8, 160)}
TILES = (("dq", (64, 16)), ("dq", (128, 16)), ("dkv", (64, 16)))


def variant_source(edits, source: str) -> str:
    """``source`` with ``edits`` applied, its fp32 sweep lists of the d <= 40
    and d <= 80 classes emptied; raises if an edit's text is missing."""
    for old, new in edits:
        if old not in source:
            raise ValueError(f"bench_bwd_variants: edit not in flash_bwd.cu: {old.strip()[:80]}")
        source = source.replace(old, new)
    sweep = source.index("#else", source.index("#ifndef FLASH_BWD_F32_SWEEP"))
    for cls in ("40", "80"):
        for kind in ("DQ", "DKV"):
            i = source.index(f"#define {kind}{cls}_F32(X)", sweep)
            source = source[:i] + f"#define {kind}{cls}_F32(X)" + source[source.index("\n", i):]
    return source


def build(name: str):
    """Write and compile one variant: (name, library path or None, ptxas
    configurations of its d <= 160 kernels, compiler errors)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gligen_tpu_torch.ops import cuda_build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header in ("hopper.cuh", "wgmma.cuh"):
        shutil.copy(CSRC / header, d / header)
    (d / "flash_bwd.cu").write_text(variant_source(VARIANTS[name],
                                                   (CSRC / "flash_bwd.cu").read_text()))
    (d / "variant.cu").write_text('#define FLASH_BWD_F32_SWEEP\n#include "flash_bwd.cu"\n')
    lib = d / f"libbwd_{name}.so"
    res = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                          str(d / "variant.cu")], capture_output=True, text=True)
    configs = [c for c in chip_smoke.ptxas_configs(res.stderr) if "<160," in c[0]]
    return name, lib if res.returncode == 0 else None, configs, res.stderr[-3000:]


def run(names, iters: int):
    """One dict per (variant, shape, kernel, tiles): ms and rel_err."""
    import torch

    from gligen_tpu_torch.ops import cuda_build
    from gligen_tpu_torch.ops import flash_attention as fa
    from gligen_tpu_torch.tools import timing

    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    libs = {}
    for name, lib, configs, err in built:
        if lib is None:
            raise SystemExit(f"bench_bwd_variants: {name} failed to build:\n{err}")
        for kernel, regs, stores, loads in configs:
            print(f"{name}: {kernel}: {regs} registers, {stores} bytes spill stores, {loads} bytes "
                  f"spill loads", flush=True)
        libs[f"bwd_{name}"] = ctypes.CDLL(str(lib))
    load = cuda_build.load_library
    cuda_build.load_library = lambda lib_name: libs.get(lib_name) or load(lib_name)
    rows = []
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape, (b, n, m, h, d) in SHAPES.items():
            q, k, v, do = (torch.randn((b, L, h * d), generator=gen, device="cuda")
                           for L in (n, m, m, n))
            out, lse = fa.flash_attention_plain(q, k, v, h)
            delta = fa.attention_delta(out, do, h)
            args = (q, k, v, h, do, lse, delta, None)
            want = fa.flash_attention_bwd_plain(*args)
            for name in names:
                for kind, tiles in TILES:
                    call = lambda: fa.launch_bwd(f"bwd_{name}", kind, *args, tiles)[0]
                    got = call()
                    pairs = [(got, want[0])] if kind == "dq" else list(zip(got[:2], want[1:3]))
                    err = max(((g - w).abs().max() / w.abs().max()).item() for g, w in pairs)
                    rows.append(dict(variant=name, shape=shape, kind=kind, tiles=tiles,
                                     ms=timing.timed(call, iters)[0], rel_err=err))
    finally:
        cuda_build.load_library = load
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_bwd_variants")
    names = args.variants.split(",")
    rows = run(names, args.iters)
    print(f"bench_bwd_variants: device ms per call over {args.iters} calls, on {card}")
    for r in rows:
        exact = r["variant"] in EXACT
        print(f"{r['variant']:8s} {r['shape']:9s} {r['kind']:3s} {r['tiles'][0]}x{r['tiles'][1]} "
              f"{r['ms']:.4f} ms  max_abs_err/max|plain| {r['rel_err']:.3e}"
              + ("" if exact else " (timing only)"))
    bad = [r for r in rows if r["variant"] in EXACT and not r["rel_err"] <= 1e-4]
    if bad:
        raise SystemExit("bench_bwd_variants: a variant meant to be right disagrees with "
                         "flash_attention_bwd_plain")


if __name__ == "__main__":
    main()
