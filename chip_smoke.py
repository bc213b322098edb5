#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gligen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 10] [--seed 0]

Phases, each of which fails the run with a non-zero exit:

  1. card: require CUDA; print the card's name and power limit.
  2. build: compile csrc/flash_fwd.cu, flash_fwd_sweep.cu (the same
     kernel at the tile sweep's configurations), flash_bwd.cu,
     flash_bwd_sweep.cu (likewise), fused_proj.cu, fused_proj_sweep.cu
     (likewise), fused_norm.cu and fused_conv.cu with nvcc, in parallel,
     into build/kernels/; print the seconds it took and ptxas's registers,
     spills and wgmma notes (for fused_proj, one line per tile
     configuration).
  3. kernel: compare each kernel with its plain PyTorch version on bf16
     inputs at every shape the 512^2 path launches, with the times of both
     and, where one PyTorch call computes the same function, that call's:
     flash attention (UNet attn1, the gated fuser's N+30 keys,
     cross-attention over 77 text tokens, at ds1/ds2/ds4 and the 64-token
     middle block; the VAE's single 512-wide head over 4096 tokens; and
     attn1 at ds1 of a 1024^2 image, checked 512 query rows at a time;
     each row with its route, TF/s and share of the bound, and every one
     must take the TMA route);
     per level the fused projections (ln_matmuls for q/k/v, for q alone
     and for the fuser's k/v over N+30 rows, matmul_residual for to_out
     and net_2, ln_geglu) and the matmul-only mode of the same kernel
     (mm_only, K7) at the products and rows (16 x 4096) that phase 9's
     projection budget gives it, over the fuser's 16 x 4126 rows and at
     one shape ragged in M, K and F (each projection row with its tile
     configuration, TF/s and share of the bound, and for K2 the time of
     torch.matmul on its products alone); GroupNorm +- SiLU at every UNet and
     VAE map, gn_affine, LayerNorm at every (rows, C) of the module path,
     and the fused GN -> SiLU -> conv3x3 at every ResBlock conv shape.
     Times are device times per call (see ``timing.timed``); each
     kernel's bound is the larger of its bytes over the card's memory
     rate and its operations over the peak rate for their type.
  4. generate: GenerationPipeline.generate at full SD-1.4 GLIGEN width,
     512^2, random de-zeroed weights, two requests of batch 2 (4 UNet rows
     with CFG), PLMS with alpha stages [0.3, 0, 0.7], in each of the
     configurations of ``CONFIGS``; the images must be finite, in [0, 1]
     and not constant, and each kernel's launch count must equal what the
     module structure and the sampler tables predict for the configuration;
     every flash forward launch must take the TMA route.
  5. reference: the same pipeline at a small width on the card (bf16,
     kernels) against its fp32 CPU run (plain versions), same weights and
     noise, in each configuration.
  6. backward kernels: the flash backward's dq and dk/dv kernels against
     their plain version at every backward shape of the training step
     (attn1, the fuser's N+30 keys and the cross-attention's dq at
     ds1/ds2/ds4/mid, batch 4; dbias on one masked case), each gradient
     within BWD_REL_TOL of its plain version's largest magnitude, with its
     route (every launch must take the TMA route), device time, TF/s and
     share of the bound, the plain version's and
     F.scaled_dot_product_attention's backward at the same shape.
  7. train: the training step at full SD-1.4 GLIGEN width (512^2, batch
     4, live VAE encode, per-block remat 'full', the default switches,
     AdamW with a one-step warmup): a warm-up step and 3 timed ones.  The
     loss is finite at every step; after the first backward every
     trainable tensor has a finite, nonzero gradient and the first step
     (learning rate 0) changed nothing; the second changes every trainable
     tensor; the frozen parameters stay bit-identical with no gradient;
     each kernel's launches per step equal the walk of
     ``expected_train_launches``; every flash backward launch takes the
     TMA route.
  8. train reference: the loss and the trainable gradients of one step at
     a small width on the card (bf16, kernels) against the CPU (fp32,
     plain versions), same weights, batch and draws, with and without
     remat; each fuser gate's gradient on its own, beside two witnesses
     held to nothing (the card's module path in bf16, the CPU in bf16).
  9. tools: the port's measurement tools in this process at full ds1
     width, in configuration (a): the projection budget
     (``tools/bench_proj.py``: every K7 row launched K7 and no K2 kernel,
     every K2 row no K7, and K7's outputs on the tool's own inputs agree
     with mm_only_plain's; its K7 launches are mm_only's in the JSON line),
     the projections' tile sweep (``bench_proj.py --sweep``: every mode at
     the table's tiles and the sweep library's, each output held against
     the plain version), one transformer block (``bench_block.py``) and one ResBlock
     (``bench_resblock.py``), each with one profiled forward whose trace
     shows its kernels; and the flash forward's tile sweep
     (``bench_sweep_attn.py``) at ``SWEEP_CONFIGS`` beside the fixed table,
     every configuration's output held against the plain version on
     every query row; and the flash backward's tile sweep
     (``bench_sweep_attn.py --bwd``) at the ds1 training shapes, B = 4,
     every configuration of ``BWD_CONFIGS`` beside the fixed table, each
     gradient held to BWD_REL_TOL against the plain backward.

The last three lines are a JSON object with the kernels' measurements,
the card's name and power limit, and {"ok": true, "device": {...}}.  JAX
is not imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the card's name, the bound, the timer and the de-zeroing, shared with the
# package's tools
from gligen_tpu_torch.tools.timing import (FP32_FLOP_PER_S, bound, card_line, dezero_,
                                           time_ms)

REPO = Path(__file__).resolve().parent
SOURCES = ("flash_fwd", "flash_fwd_sweep", "flash_bwd", "flash_bwd_sweep", "fused_proj",
           "fused_proj_sweep", "fused_norm", "fused_conv")

# flash forward vs plain, bf16 output: the kernel rounds P to bf16 before
# the PV product and O to bf16, a few bf16 ulps (2^-8 relative) of the
# largest outputs.  On unit-scale inputs the softmax spreads over ~M/e
# keys, so an output is ~sqrt(e/M) (0.026 at M = 4096), far below OUT_TOL:
# each case is also held to OUT_REL_TOL of the plain output's largest
# magnitude, which a P.V fault (a wrong V tile, a bad rescale) exceeds
OUT_TOL = 2e-2
OUT_REL_TOL = 2e-2
# log-sum-exp, fp32 sums in another order (log2 units)
LSE_TOL = 1e-3
# fused projections, norms and the fused conv vs plain, bf16 output: the
# same bf16 operands with fp32 sums in another order, and a normalised or
# activated value that may round to the neighbouring bf16 value: about one
# bf16 ulp (2^-7 relative), for outputs up to ~5 in magnitude (a residual
# adds x ~ N(0, 1))
PROJ_ATOL, PROJ_RTOL = 2e-2, 1e-2
# gn_affine's fp32 (a, v) vs plain: fp32 sums of the same values in another
# order, a few fp32 ulps
AFFINE_TOL = 1e-5
# small-width pipeline, bf16 on the card vs fp32 on the CPU: mean absolute
# pixel difference (images in [0, 1])
REF_MEAN_TOL = 2e-2
# flash backward kernels vs plain (fp32 from the same bf16 inputs, LSE and
# delta): the kernels round P and dS to bf16 as product operands and write
# bf16 gradients, a few bf16 ulps (2^-8 relative) of the largest entries
# summed over up to 4126 keys: max abs error <= 2e-2 * max |plain|, per
# tensor (dbias, fp32, the same)
BWD_REL_TOL = 2e-2
# small-width train step, bf16 on the card vs fp32 on the CPU, same draws:
# the loss to 2% (bf16 activations through ~20 norm/projection/attention
# stages, each ~2^-9 relative); each trainable gradient to 10% relative L2
# (a backward doubles the chain).  Each fuser gate's scalar gradient is a
# sum over a whole block output whose terms cancel, so a small one carries
# the rounding of the large terms: bf16 misses every gate by about the same
# absolute amount, whatever its size.  On an H100 every run of phase 8
# (kernels, the module path and the CPU in bf16) missed each gate by at
# most 0.8% of the largest gate gradient.  So each gate is held on its own
# to 10% of itself plus 1% of the largest, and each limit must stay below
# the gate's own size, so that a zero or sign-flipped gradient fails.
TRAIN_LOSS_RTOL = 2e-2
TRAIN_GRAD_RTOL = 1e-1
GATE_RTOL, GATE_ATOL = 1e-1, 1e-2

# The witness of phase 8: the module path in bf16, no K2/K5/K6 kernel.
PLAIN_SWITCHES = {"GLIGEN_TPU_FUSED_PROJ": "0", "GLIGEN_TPU_FUSED_NORM": "0",
                  "GLIGEN_TPU_FUSED_CONV": "0"}

# The switches of each configuration that phase 4 drives.  (a) is the JAX
# package's default serving configuration; (b) the module path with both
# norm kernels; (c) the fused conv on every ResBlock.
CONFIGS = {
    "a": {"GLIGEN_TPU_FUSED_PROJ": "1", "GLIGEN_TPU_FUSED_NORM": "gn", "GLIGEN_TPU_FUSED_CONV": "0"},
    "b": {"GLIGEN_TPU_FUSED_PROJ": "0", "GLIGEN_TPU_FUSED_NORM": "both",
          "GLIGEN_TPU_FUSED_CONV": "0"},
    "c": {"GLIGEN_TPU_FUSED_PROJ": "1", "GLIGEN_TPU_FUSED_NORM": "gn", "GLIGEN_TPU_FUSED_CONV": "1"},
}

# The small-width model of phase 5 (and of the CPU test of the launch
# counts): two UNet levels, a two-level VAE, a 2-layer text encoder.
SMALL = dict(
    unet_config=dict(model_channels=64, num_res_blocks=1, attention_resolutions=(2, 1),
                     channel_mult=(1, 2), num_heads=2, context_dim=64,
                     grounding_tokenizer={"target": "text",
                                          "params": {"in_dim": 64, "out_dim": 64}}),
    vae_config=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=64),
    text_config=dict(vocab_size=1000, hidden_size=64, layers=2, heads=4),
)


def ptxas_configs(report: str) -> list:
    """(kernel, registers, spill stores, spill loads) of every
    ``fused_proj_kernel<MODE, BM, BN, STAGES>`` in a ``-Xptxas -v`` report,
    its name read back from the mangled one."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            tpl = re.search(r"fused_proj_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", entry.group(1))
            name = f"fused_proj_kernel<{', '.join(tpl.groups())}>" if tpl else None
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = tuple(int(x) for x in spill.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out.append((name, int(used.group(1)), *spills))
            name = None
    return out


def set_config(name: str) -> None:
    os.environ.update(CONFIGS[name])


def config_desc(name: str) -> str:
    return f"({name}) " + " ".join(f"{k[len('GLIGEN_TPU_'):]}={v}" for k, v in CONFIGS[name].items())


def kernel_cases(batch: int):
    """(name, rows, N, M, heads, head dim, padded-key bias) of every
    flash launch shape at 512^2 (latent 64), SD-1.4 widths."""
    rows = 2 * batch  # CFG pair in one UNet call
    cases = []
    for level, (n, d) in {"ds1": (4096, 40), "ds2": (1024, 80), "ds4": (256, 160),
                          "mid": (64, 160)}.items():
        cases += [
            (f"attn1_{level}", rows, n, n, 8, d, False),
            (f"fuser_{level}", rows, n, n + 30, 8, d, False),
            (f"cross_{level}", rows, n, 77, 8, d, False),
        ]
    # the TPU's padded fuser form: N+30 keys padded to a multiple of 128,
    # masked by a NEG_INF bias row (exercises the kernel's bias input)
    cases.append(("fuser_ds1_padbias", rows, 4096, 4224, 8, 40, True))
    cases.append(("vae_mid", batch, 4096, 4096, 1, 512, False))
    return cases


def sdpa(torch, q, k, v, h, bias):
    """The library's attention on the packed (B, L, H*C) layout."""
    import torch.nn.functional as F

    split = lambda t: t.unflatten(-1, (h, -1)).transpose(1, 2)
    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    return F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=mask)


def routed(wrapper, call):
    """(the route a flash wrapper's kernel took, the call's result) of one
    call that launches that kernel once."""
    before = dict(wrapper.routes)
    result = call()
    took = [r for r, n in wrapper.routes.items() if n != before[r]]
    if len(took) != 1 or wrapper.routes[took[0]] != before[took[0]] + 1:
        raise RuntimeError(f"expected one launch: routes {before} -> {wrapper.routes}")
    return took[0], result


def out_limit(want) -> float:
    """The flash forward's output limit for a case whose plain output is
    ``want``: OUT_TOL, or OUT_REL_TOL of its largest magnitude if less."""
    return min(OUT_TOL, OUT_REL_TOL * want.float().abs().max().item())


def check_kernel(torch, cases, device):
    from gligen_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_plain, flash_fwd

    gen = torch.Generator(device=device).manual_seed(1)
    results = []
    for name, b, n, m, h, d, padbias in cases:
        q, k, v = (torch.randn((b, L, h * d), generator=gen, device=device).to(torch.bfloat16)
                   for L in (n, m, m))
        bias = None
        if padbias:
            bias = torch.zeros((b, m), device=device)
            bias[:, n + 30:] = NEG_INF
        route, (out, lse) = routed(flash_fwd, lambda: flash_fwd(q, k, v, h, bias=bias))
        torch.cuda.synchronize()
        # the plain version on the same (card) tensors: the wrapper takes it
        # only for CPU tensors, so it is called directly here
        want, want_lse = flash_attention_plain(q, k, v, h, bias=bias)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
        ms = time_ms(lambda: flash_fwd(q, k, v, h, bias=bias))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, h, bias=bias))
        library_ms = time_ms(lambda: sdpa(torch, q, k, v, h, bias))
        nbytes = 2 * (2 * b * n * h * d + 2 * b * m * h * d) + 4 * b * h * n
        nbytes += 0 if bias is None else 4 * b * m
        flops = 4 * b * h * n * m * d
        bound_ms, bound_by = bound(nbytes, flops)
        limit = out_limit(want)
        ok = finite and err <= limit and lse_err <= LSE_TOL and route == "tma"
        print(f"kernel {name:18s} q ({b},{n},{h}x{d}) kv {m}: max_abs_err {err:.3e} "
              f"(tol {limit:.3e}) lse_err {lse_err:.3e} (tol {LSE_TOL}) route {route} "
              f"kernel {ms:.4f} ms {flops / ms / 1e9:.1f} TF/s {100 * bound_ms / ms:.1f}% of bound; "
              f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms "
              f"bound {bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind="flash_fwd", err=err, lse_err=lse_err, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, route=route, ok=ok))
        del q, k, v, out, lse, want, want_lse
    torch.cuda.empty_cache()
    return results


def check_kernel_1024(torch, device, rows=512):
    """attn1 at ds1 of a 1024^2 image: (4, 16384, 8x40) against 16384 keys.
    The plain version's whole score matrix would take ~34 GB in fp32, so it
    runs ``rows`` query rows at a time (rows are independent) over every
    row; plain_ms is the time of one such call."""
    from gligen_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd
    from gligen_tpu_torch.tools.bench_sweep_attn import plain_by_rows

    b, n, h, d = 4, 16384, 8, 40
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn((b, n, h * d), generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    route, (out, lse) = routed(flash_fwd, lambda: flash_fwd(q, k, v, h))
    torch.cuda.synchronize()
    want, want_lse = plain_by_rows(q, k, v, h, rows=rows)
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    ms = time_ms(lambda: flash_fwd(q, k, v, h), iters=3)
    plain_ms = time_ms(lambda: flash_attention_plain(q[:, :rows], k, v, h), iters=3)
    library_ms = time_ms(lambda: sdpa(torch, q, k, v, h, None), iters=3)
    flops = 4 * b * h * n * n * d
    bound_ms, bound_by = bound(2 * 4 * b * n * h * d + 4 * b * h * n, flops)
    limit = out_limit(want)
    ok = finite and err <= limit and lse_err <= LSE_TOL and route == "tma"
    name = "attn1_ds1_1024px"
    print(f"kernel {name:18s} q ({b},{n},{h}x{d}) kv {n}: max_abs_err {err:.3e} over every "
          f"query row (tol {limit:.3e}) lse_err {lse_err:.3e} (tol {LSE_TOL}) route {route} "
          f"kernel {ms:.4f} ms (all rows) {flops / ms / 1e9:.1f} TF/s {100 * bound_ms / ms:.1f}% "
          f"of bound; plain {plain_ms:.4f} ms ({rows} rows) sdpa {library_ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}", flush=True)
    del q, k, v, out, lse, want, want_lse
    torch.cuda.empty_cache()
    return dict(name=name, kind="flash_fwd", err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, route=route, ok=ok)


# (tokens, channels) of the transformer blocks at 512^2 (latent 64), SD-1.4
LEVELS = {"ds1": (4096, 320), "ds2": (1024, 640), "ds4": (256, 1280), "mid": (64, 1280)}


def proj_cases(batch: int):
    """(name, kernel, rows, N, C, K or weights) of every fused-projection
    launch shape at 512^2: 2*batch UNet rows of N tokens each."""
    rows = 2 * batch
    cases = []
    for level, (n, c) in LEVELS.items():
        cases += [
            (f"qkv_{level}", "ln_matmuls", rows, n, c, 3),
            (f"q_{level}", "ln_matmuls", rows, n, c, 1),
            (f"fuser_kv_{level}", "ln_matmuls", rows, n + 30, c, 2),
            (f"to_out_{level}", "matmul_residual", rows, n, c, c),
            (f"net_2_{level}", "matmul_residual", rows, n, c, 4 * c),
            (f"geglu_{level}", "ln_geglu", rows, n, c, None),
        ]
    return cases


# The batch of phase 9's tools: the JAX tools' CFG batch, and K7's only
# path (bench_proj.py) runs at it, so phase 3 holds K7 at its rows.
TOOLS_BATCH = 16


# phase 9's flash tile sweep: (BQ, BK, stages) beside the fixed table's
SWEEP_CONFIGS = ((64, 128, 2), (128, 64, 3), (128, 128, 2))


def mm_cases(rows: int = TOOLS_BATCH):
    """(name, "mm_only", rows, N, F, K) of K7 at the products that
    bench_proj.py gives it at ``rows`` x 4096 tokens (q/k/v and to_out,
    GEGLU, net_2), at 320 -> 320 over the fuser's N+30 rows (a ragged last
    row block), and at one shape whose M, K and F are multiples of no row
    block, of no 64-column slab and of no 32-wide K step."""
    n, c = LEVELS["ds1"]
    return [
        ("mm_320_320_ds1", "mm_only", rows, n, c, c),
        ("mm_320_2560_ds1", "mm_only", rows, n, 8 * c, c),
        ("mm_1280_320_ds1", "mm_only", rows, n, c, 4 * c),
        ("mm_320_320_fuser_ds1", "mm_only", rows, n + 30, c, c),
        ("mm_ragged", "mm_only", 3, 333, 104, 200),
    ]


def compare(torch, got, want, atol=PROJ_ATOL, rtol=PROJ_RTOL):
    """(max abs error, ok) of a kernel output against its plain version:
    |got - want| <= atol + rtol * |want| everywhere."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    ok = all(bool(torch.isfinite(g).all()) and g.shape == w.shape
             and torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol)
             for g, w in zip(got, want))
    return err, ok


def grouped_input(randn, shape):
    """A bf16 (B, ..., C) GroupNorm input whose every (sample, channel)
    has a mean and a spread of its own: N(mu[b, c], sigma[b, c]^2), with mu
    a per-sample N(0, 1) offset plus a per-channel N(0, 1) and sigma from
    0.37 to 2.7.  So every (sample, group) has statistics of its own, and a
    kernel that reads another group's or sample's fails the comparison."""
    import torch

    b, c = shape[0], shape[-1]
    view = (b,) + (1,) * (len(shape) - 2) + (c,)
    mu, sigma = randn(b, 1) + randn(b, c), (0.5 * randn(b, c)).exp()
    return (randn(*shape) * sigma.view(view) + mu.view(view)).to(torch.bfloat16)


def check_proj(torch, cases, device):
    """Each fused-projection kernel against its plain version on the same
    card tensors (bf16 activations and weights, fp32 norm parameters,
    biases and gate), with the times of both, the tile configuration the
    table gave the shape, TF/s and the share of the bound; for K7 (mm_only)
    the time of torch.matmul on the same product (the library call for its
    function), for K2 the time of torch.matmul on its products alone (no
    single library call computes a K2 function)."""
    from gligen_tpu_torch.ops import fused_proj as fp

    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    bf16 = torch.bfloat16
    results = []
    for name, kind, b, n, c, k in cases:
        x = randn(b, n, k if kind == "mm_only" else c, dtype=bf16)
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        m = b * n
        if kind == "ln_matmuls":
            ws = [randn(c, c, scale=c**-0.5, dtype=bf16) for _ in range(k)]
            args, products, shape = (x, s, sb, ws), [(x, w) for w in ws], (m, c, c)
            desc = f"x ({b},{n},{c}) -> {k} x {c}"
            nbytes, flops = 2 * m * c * (1 + k) + 8 * c + 2 * k * c * c, 2 * m * c * c * k
        elif kind == "matmul_residual":
            h = randn(b, n, k, dtype=bf16)
            # the fuser's device gate on to_out; net_2 of the block has none
            gate = torch.tensor(0.37, device=device) if k == c else None
            w = randn(c, k, scale=k**-0.5, dtype=bf16)
            args, products, shape = (h, w, randn(c, scale=0.1), x, gate), [(h, w)], (m, k, c)
            desc = f"h ({b},{n},{k}) -> {c}{' gated' if gate is not None else ''}"
            nbytes, flops = 2 * m * (k + 2 * c) + 2 * c * k + 4 * c + 4, 2 * m * k * c
        elif kind == "mm_only":
            w = randn(c, k, scale=k**-0.5, dtype=bf16)
            args, products, shape = (x, w), [(x, w)], (m, k, c)
            desc = f"x ({b},{n},{k}) -> {c}"
            nbytes, flops = 2 * (m * k + c * k + m * c), 2 * m * k * c
        else:
            w = randn(8 * c, c, scale=c**-0.5, dtype=bf16)
            args, products, shape = (x, s, sb, w, randn(8 * c, scale=0.1)), [(x, w)], (m, c, 4 * c)
            desc = f"x ({b},{n},{c}) -> {8 * c} -> {4 * c}"
            nbytes, flops = 2 * m * 5 * c + 8 * c + 16 * c * c + 32 * c, 16 * m * c * c
        kernel, plain = fp.KERNELS[kind], getattr(fp, f"{kind}_plain")
        tiles = fp.proj_tiles(kind, *shape)
        got = kernel(*args)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, plain(*args))
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        products_ms = time_ms(lambda: [torch.matmul(a, w.T) for a, w in products])
        library_ms = products_ms if kind == "mm_only" else None
        bound_ms, bound_by = bound(nbytes, flops)
        lib = (f" torch.matmul {library_ms:.4f} ms" if kind == "mm_only" else
               f" its products alone (torch.matmul) {products_ms:.4f} ms")
        print(f"kernel {kind:15s} {name:12s} {desc:28s}: max_abs_err {err:.3e} "
              f"(tol {PROJ_ATOL} + {PROJ_RTOL} rel) tile {'x'.join(map(str, tiles))} "
              f"kernel {ms:.4f} ms {flops / ms / 1e9:.1f} TF/s {100 * bound_ms / ms:.1f}% of bound; "
              f"plain {plain_ms:.4f} ms{lib} bound {bound_ms:.4f} ms ({bound_by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind=kind, err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, ok=ok))
        del x, args, got, products
    torch.cuda.empty_cache()
    return results


def unet_maps(unet, latent: int):
    """Walk one UNet call at ``latent`` through the UNet's blocks in order:
    ([(H, C_in, C_out) of every ResBlock], [(H, C, depth) of every
    SpatialTransformer])."""
    from gligen_tpu_torch.models.layers import SpatialTransformer
    from gligen_tpu_torch.models.unet import Downsample, ResBlock, Upsample

    res, sts, size = [], [], latent
    for names in [*unet.input_blocks, unet.middle_block, *unet.output_blocks]:
        for name in names:
            m = getattr(unet, name)
            if isinstance(m, ResBlock):
                res.append((size, m.in_layers_0.weight.numel(), m.out_channels))
            elif isinstance(m, SpatialTransformer):
                sts.append((size, m.norm.weight.numel(), m.depth))
            elif isinstance(m, Downsample):
                size = (size + 1) // 2
            elif isinstance(m, Upsample):
                size *= 2
    return res, sts


def vae_norms(vae, latent: int):
    """(H, C, SiLU) of every GroupNorm of one VAE decode of a ``latent``
    map, walking the decoder's blocks in order."""
    from gligen_tpu_torch.models.unet import Upsample
    from gligen_tpu_torch.models.vae import AttnBlock, ResnetBlock

    dec, out, size = vae.decoder, [], latent
    for name in ["mid_block_1", "mid_attn_1", "mid_block_2", *dec.up_names]:
        m = getattr(dec, name)
        if isinstance(m, ResnetBlock):
            out += [(size, m.norm1.weight.numel(), True), (size, m.norm2.weight.numel(), True)]
        elif isinstance(m, AttnBlock):
            out.append((size, m.norm.weight.numel(), False))
        elif isinstance(m, Upsample):
            size *= 2
    return out + [(size, dec.norm_out.weight.numel(), True)]


def norm_cases(unet, vae, batch: int, latent: int = 64):
    """(name, shape, SiLU, eps) of every distinct GroupNorm input at 512^2:
    the ResBlocks' two norms (eps 1e-5, SiLU) and out_0, the
    SpatialTransformers' (B, N, C) norms (eps 1e-6), on 2*batch UNet rows;
    the VAE decoder's (eps 1e-6) on batch rows."""
    res, sts = unet_maps(unet, latent)
    rows, cases = 2 * batch, {}
    for h, cin, cout in res + [(latent, unet.out_0.weight.numel(), 0)]:
        for c in (cin, cout) if cout else (cin,):
            cases[f"res_{h}x{c}"] = ((rows, h, h, c), True, 1e-5)
    for h, c, _ in sts:
        cases[f"st_{h}x{c}"] = ((rows, h * h, c), False, 1e-6)
    for h, c, silu in vae_norms(vae, latent):
        cases[f"vae_{h}x{c}{'' if silu else '_attn'}"] = ((batch, h, h, c), silu, 1e-6)
    return [(name, *case) for name, case in cases.items()]


def ln_cases(batch: int):
    """(name, rows, C) of the module path's LayerNorms at 512^2: every
    block's N rows, and the fuser's N+30."""
    cases = []
    for level, (n, c) in LEVELS.items():
        cases += [(f"ln_{level}", 2 * batch * n, c), (f"ln_fuser_{level}", 2 * batch * (n + 30), c)]
    return cases


def conv_cases(unet, batch: int, latent: int = 64):
    """(name, B, H, C_in, C_out, residual) of every distinct ResBlock conv
    at 512^2: in_layers (C_in -> C_out) and out_layers (C_out -> C_out, +
    the residual)."""
    res, _ = unet_maps(unet, latent)
    cases = {}
    for h, cin, cout in res:
        cases[f"in_{h}_{cin}_{cout}"] = (2 * batch, h, cin, cout, False)
        cases[f"out_{h}_{cout}"] = (2 * batch, h, cout, cout, True)
    return [(name, *case) for name, case in cases.items()]


def check_norms(torch, gn, ln, device):
    """The GroupNorm kernel (+- SiLU) and gn_affine at every GroupNorm map,
    and the LayerNorm kernel at every LayerNorm shape, against their plain
    versions on the same card tensors, with the library's F.group_norm /
    F.layer_norm where it computes the same function (no SiLU).  The
    GroupNorm inputs come from ``grouped_input``; gn_affine's fp32 (a, v)
    is held to AFFINE_TOL."""
    import torch.nn.functional as F
    from gligen_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device=device).manual_seed(4)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    results = []

    def record(kind, name, desc, got, want, kernel, plain, library, nbytes, ops,
               tol=(PROJ_ATOL, PROJ_RTOL)):
        err, ok = compare(torch, got, want, *tol)
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        library_ms = None if library is None else time_ms(library)
        bound_ms, bound_by = bound(nbytes, ops, FP32_FLOP_PER_S)
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        print(f"kernel {kind:11s} {name:22s} {desc:34s}: max_abs_err {err:.3e} "
              f"(tol {tol[0]} + {tol[1]} rel) kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
              f"{lib} bound {bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind=kind, err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, ok=ok))

    for name, shape, silu, eps in gn:
        c = shape[-1]
        numel = 1
        for d in shape:
            numel *= d
        x = grouped_input(randn, shape)
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        args = (x, s, sb, 32, eps)
        library = None
        if not silu:  # the library's GroupNorm on the (B, C, N) view of the same tensor
            xc, sc, bc = x.reshape(shape[0], -1, c).transpose(1, 2), s.to(x.dtype), sb.to(x.dtype)
            library = lambda: F.group_norm(xc, 32, sc, bc, eps)
        record("group_norm", name, f"x {shape} {'+ SiLU ' if silu else ''}eps {eps:g}",
               fn.group_norm_fused(*args, silu=silu), fn.group_norm_plain(*args, silu=silu),
               lambda: fn.group_norm_fused(*args, silu=silu),
               lambda: fn.group_norm_plain(*args, silu=silu), library,
               4 * numel + 8 * c, (9 if silu else 5) * numel)
        if name.startswith("res_"):  # the fused conv's inputs take gn_affine
            record("gn_affine", name, f"x {shape} -> a, v ({shape[0]}, {c})",
                   fn.gn_affine(*args), fn.gn_affine_plain(*args),
                   lambda: fn.gn_affine(*args), lambda: fn.gn_affine_plain(*args), None,
                   2 * numel + 8 * c + 8 * shape[0] * c, 3 * numel, (AFFINE_TOL, AFFINE_TOL))
        del x, args, library
    for name, rows, c in ln:
        x = randn(rows, c, scale=2.0, dtype=torch.bfloat16) + 0.3
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        sc, bc = s.to(x.dtype), sb.to(x.dtype)
        record("layer_norm", name, f"x ({rows}, {c})", fn.layer_norm_fused(x, s, sb),
               fn.layer_norm_plain(x, s, sb), lambda: fn.layer_norm_fused(x, s, sb),
               lambda: fn.layer_norm_plain(x, s, sb), lambda: F.layer_norm(x, (c,), sc, bc),
               4 * rows * c + 8 * c, 7 * rows * c)
        del x
    torch.cuda.empty_cache()
    return results


def check_convs(torch, cases, device):
    """The fused GN -> SiLU -> conv3x3 (gn_affine's kernel and the conv
    kernel) against its plain version on the same card tensors: bf16
    activations with statistics of their own per (sample, channel)
    (``grouped_input``) and a bf16 residual, the model's fp32 parameters
    (cast at each call), weights of std (9 C)^-1/2 so that outputs stay
    O(1)."""
    from gligen_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=device).manual_seed(5)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    results = []
    for name, b, h, cin, cout, residual in cases:
        x = grouped_input(randn, (b, h, h, cin))
        s, sb = 1.0 + randn(cin, scale=0.1), randn(cin, scale=0.1)
        w, wb = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), randn(cout, scale=0.1)
        res = randn(b, h, h, cout, dtype=torch.bfloat16) if residual else None
        args = (x, s, sb, w, wb, res)
        got = fc.gn_silu_conv3x3(*args)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, fc.gn_silu_conv3x3_plain(*args))
        ms = time_ms(lambda: fc.gn_silu_conv3x3(*args))
        plain_ms = time_ms(lambda: fc.gn_silu_conv3x3_plain(*args))
        m = b * h * h
        nbytes = 2 * m * cin + 4 * 9 * cin * cout + 4 * cout + 8 * cin + 2 * m * cout * (1 + residual)
        flops = 2 * m * cout * 9 * cin
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"kernel gn_silu_conv3x3 {name:16s} ({b},{h},{h},{cin}) -> {cout}"
              f"{' + residual' if residual else ''}: max_abs_err {err:.3e} (tol {PROJ_ATOL} + "
              f"{PROJ_RTOL} rel) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} "
              f"ms ({bound_by}, {flops / ms / 1e9:.1f} TFLOP/s) {'ok' if ok else 'FAIL'}",
              flush=True)
        results.append(dict(name=name, kind="gn_silu_conv3x3", err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, ok=ok))
        del x, w, res, args, got
    torch.cuda.empty_cache()
    return results


def bwd_cases(batch: int):
    """(name, B, N, M, heads, head dim, dk/dv needed, key mask) of every
    flash backward shape of the 512^2 training step (latent 64, SD-1.4
    widths, no CFG pair): attn1 and the fuser need dq and dk/dv, the
    cross-attention dq only (its k/v come from the frozen text encoder);
    plus one masked case for dbias."""
    cases = []
    for level, (n, d) in {"ds1": (4096, 40), "ds2": (1024, 80), "ds4": (256, 160),
                          "mid": (64, 160)}.items():
        cases += [
            (f"attn1_{level}", batch, n, n, 8, d, True, False),
            (f"fuser_{level}", batch, n, n + 30, 8, d, True, False),
            (f"cross_{level}", batch, n, 77, 8, d, False, False),
        ]
    cases.append(("fuser_ds2_mask", batch, 1024, 1054, 8, 80, True, True))
    return cases


def sdpa_bwd(torch, q, k, v, h, do, need_kv):
    """A function that runs F.scaled_dot_product_attention's backward
    (dq, or dq/dk/dv) at this shape: the library's yardstick, never used by
    the port."""
    leaves = [t.detach().requires_grad_(i == 0 or need_kv) for i, t in enumerate((q, k, v))]
    out = sdpa(torch, *leaves, h, None).transpose(1, 2).flatten(2)
    wrt = leaves if need_kv else leaves[:1]
    return lambda: torch.autograd.grad(out, wrt, do, retain_graph=True)


def check_bwd(torch, cases, device):
    """The dq and dk/dv kernels against ``flash_attention_bwd_plain`` on
    the same card tensors (bf16 q/k/v and a nonzero random dO; the LSE and
    delta from the forward kernel), with device times of each kernel, of
    the plain version (all gradients at once) and of SDPA's backward; each
    launch must take the TMA route."""
    from gligen_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(6)
    results = []
    for name, b, n, m, h, d, need_kv, masked in cases:
        q, k, v = (torch.randn((b, L, h * d), generator=gen, device=device).to(torch.bfloat16)
                   for L in (n, m, m))
        do = torch.randn((b, n, h * d), generator=gen, device=device).to(torch.bfloat16)
        bias = None
        if masked:
            bias = torch.randn((b, m), generator=gen, device=device) * 0.5
            bias[:, n:] = fa.NEG_INF  # the grounding rows masked
        out, lse = fa.flash_fwd(q, k, v, h, bias=bias)
        delta = fa.attention_delta(out, do, h)
        args = (q, k, v, h, do, lse, delta, bias)
        routes = {}
        routes["flash_bwd_dq"], got = routed(fa.flash_bwd_dq,
                                             lambda: {"dq": fa.flash_bwd_dq(*args)})
        if need_kv:
            routes["flash_bwd_dkv"], (got["dk"], got["dv"], db) = routed(
                fa.flash_bwd_dkv, lambda: fa.flash_bwd_dkv(*args, dbias=masked))
            if masked:
                got["dbias"] = db
        torch.cuda.synchronize()
        dq, dk, dv, dbias = fa.flash_attention_bwd_plain(*args)
        want = dict(dq=dq, dk=dk, dv=dv, dbias=dbias)
        errs = {}
        for key, g in got.items():
            scale = want[key].float().abs().max().item()
            errs[key] = ((g.float() - want[key].float()).abs().max().item(), scale)
        ok = all(bool(torch.isfinite(g).all()) and g.shape == want[key].shape
                 and errs[key][0] <= BWD_REL_TOL * errs[key][1] for key, g in got.items())
        ok = ok and all(r == "tma" for r in routes.values())
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(*args), iters=3)
        library_ms = time_ms(sdpa_bwd(torch, q, k, v, h, do, need_kv))
        flops = 2 * b * h * n * m * d
        extra = (0 if bias is None else 4 * b * m) + 8 * b * h * n  # bias; lse and delta
        timings = {"flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args),
                                    2 * (3 * b * n + 2 * b * m) * h * d + extra, 3 * flops)}
        if need_kv:
            timings["flash_bwd_dkv"] = (
                lambda: fa.flash_bwd_dkv(*args, dbias=masked),
                2 * (2 * b * n + 4 * b * m) * h * d + extra + (4 * b * m if masked else 0),
                4 * flops)
        desc = " ".join(f"{key} {e:.3e}/{sc:.3e}" for key, (e, sc) in errs.items())
        for kind, (fn, nbytes, ops) in timings.items():
            ms = time_ms(fn)
            bound_ms, bound_by = bound(nbytes, ops)
            print(f"kernel {kind:13s} {name:14s} q ({b},{n},{h}x{d}) kv {m}: max_abs_err/max|plain| "
                  f"{desc} (tol {BWD_REL_TOL} rel) route {routes[kind]} kernel {ms:.4f} ms "
                  f"{ops / ms / 1e9:.1f} TF/s {100 * bound_ms / ms:.1f}% of bound; plain (all grads) "
                  f"{plain_ms:.4f} ms sdpa bwd {library_ms:.4f} ms bound {bound_ms:.4f} ms "
                  f"({bound_by}) {'ok' if ok else 'FAIL'}", flush=True)
            err = max(e for key, (e, _) in errs.items()
                      if (key == "dq") == (kind == "flash_bwd_dq"))
            results.append(dict(name=name, kind=kind, err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                                route=routes[kind], ok=ok))
        del q, k, v, do, out, lse, delta, args, got, want, dq, dk, dv
    torch.cuda.empty_cache()
    return results


def expected_launches(comps, steps, alpha_stages, latent, config):
    """Launches of each kernel in one generate call of ``config``, from the
    module structure and the sampler tables.  Per transformer block of N
    tokens, a gated UNet call runs attn1, the fuser and attn2 (3 flash
    launches); on the fused path (FUSED_PROJ=1, N >= 64) ln_matmuls for
    q/k/v, the fuser's q, the fuser's k/v and attn2's q (4),
    matmul_residual for the three to_out and the two net_2 (5) and ln_geglu
    for the two feed-forwards (2); on the module path 5 LayerNorms.  A
    fuser-free call runs 2 / 2, 3, 1 / 3.  Every GroupNorm (FUSED_NORM gn
    or both) is one launch, but those of a ResBlock that takes the fused
    conv, which runs gn_affine and the conv twice instead.  The VAE decoder
    (not the encoder, which generation does not run) adds its AttnBlocks'
    flash launches and its GroupNorms."""
    from gligen_tpu_torch.diffusion.samplers import SamplerTables, _gate_zero_from
    from gligen_tpu_torch.models.layers import Normalize
    from gligen_tpu_torch.models.unet import fuses_conv
    from gligen_tpu_torch.models.vae import AttnBlock

    env = CONFIGS[config]
    tables = SamplerTables.create(comps.schedule, steps, alpha_stages=alpha_stages)
    n = len(tables.ts)
    k0 = _gate_zero_from(tables)
    split = max(k0, 1)
    heun = 2  # the peeled step 0 calls the model twice
    gated = (heun if k0 > 0 else 0) + (split - 1)
    free = (heun if k0 == 0 else 0) + (n - split)
    norm = {"1": "both"}.get(env["GLIGEN_TPU_FUSED_NORM"], env["GLIGEN_TPU_FUSED_NORM"])
    gn_on, ln_on = norm in ("gn", "both"), norm in ("ln", "both")
    res, sts = unet_maps(comps.unet, latent)
    counts = dict.fromkeys(kernel_wrappers(), 0)
    for h, _, depth in sts:
        fused = env["GLIGEN_TPU_FUSED_PROJ"] == "1" and h * h >= 64
        counts["flash_fwd"] += depth * (3 * gated + 2 * free)
        if fused:
            for name, (g, f) in {"ln_matmuls": (4, 2), "matmul_residual": (5, 3),
                                 "ln_geglu": (2, 1)}.items():
                counts[name] += depth * (g * gated + f * free)
        elif ln_on:
            counts["layer_norm"] += depth * (5 * gated + 3 * free)
    calls = gated + free
    fused_res = sum(fuses_conv(env["GLIGEN_TPU_FUSED_CONV"], h, h, cout) for h, _, cout in res)
    counts["gn_silu_conv3x3"] = counts["gn_affine"] = 2 * fused_res * calls
    if gn_on:
        unet_norms = sum(isinstance(m, Normalize) for m in comps.unet.modules())
        vae_norms_ = sum(isinstance(m, Normalize) for m in comps.vae.decoder.modules())
        counts["group_norm"] = (unet_norms - 2 * fused_res) * calls + vae_norms_
    counts["flash_fwd"] += sum(isinstance(m, AttnBlock) for m in comps.vae.decoder.modules())
    return counts, gated, free


def expected_train_launches(comps, image_size, config, use_checkpoint):
    """Launches of each kernel in one train step of ``config`` (live VAE
    encode of ``image_size``^2 images), walked from the module structure.
    Per transformer block: 3 flash forwards (attn1, the fuser, attn2), and
    the fused projections (4 ln_matmuls, 5 matmul_residual, 2 ln_geglu) or,
    on the module path, 5 LayerNorms; a block takes the fused path under
    FUSED_PROJ=1 from 64 tokens, or from 1024 under ``use_checkpoint``, which
    also recomputes each block in the backward (every block launch twice,
    remat 'full').  The backward launches dq for attn1, the fuser and attn2
    (whose q derive from the trainable fusers), and dk/dv for attn1 and the
    fuser, but neither for the first block's attn1, whose input derives
    from frozen layers alone.  GroupNorms run once each (none is inside a
    block), as in ``expected_launches``, plus the VAE encoder's; its
    AttnBlocks add flash forwards.  The norm and projection backwards are
    plain PyTorch and launch no kernel."""
    from gligen_tpu_torch.models.layers import Normalize
    from gligen_tpu_torch.models.unet import fuses_conv
    from gligen_tpu_torch.models.vae import AttnBlock

    env = CONFIGS[config]
    norm = {"1": "both"}.get(env["GLIGEN_TPU_FUSED_NORM"], env["GLIGEN_TPU_FUSED_NORM"])
    gn_on, ln_on = norm in ("gn", "both"), norm in ("ln", "both")
    res, sts = unet_maps(comps.unet, image_size // comps.vae.downsample_factor)
    runs = 2 if use_checkpoint else 1
    floor = 1024 if use_checkpoint else 64
    counts = dict.fromkeys(kernel_wrappers(), 0)
    first = 1
    for h, _, depth in sts:
        fused = env["GLIGEN_TPU_FUSED_PROJ"] == "1" and h * h >= floor
        for _ in range(depth):
            counts["flash_fwd"] += 3 * runs
            counts["flash_bwd_dq"] += 3 - first
            counts["flash_bwd_dkv"] += 2 - first
            first = 0
            if fused:
                for name, n in {"ln_matmuls": 4, "matmul_residual": 5, "ln_geglu": 2}.items():
                    counts[name] += n * runs
            elif ln_on:
                counts["layer_norm"] += 5 * runs
    fused_res = sum(fuses_conv(env["GLIGEN_TPU_FUSED_CONV"], h, h, cout) for h, _, cout in res)
    counts["gn_silu_conv3x3"] = counts["gn_affine"] = 2 * fused_res
    encoder = comps.vae.encoder
    if gn_on:
        unet_norms = sum(isinstance(m, Normalize) for m in comps.unet.modules())
        counts["group_norm"] = unet_norms - 2 * fused_res + sum(
            isinstance(m, Normalize) for m in encoder.modules())
    counts["flash_fwd"] += sum(isinstance(m, AttnBlock) for m in encoder.modules())
    return counts


def train_batch(torch, np, rng, batch, size, vocab, ctx_dim, device):
    """A training batch on ``device``: images in [-1, 1], token ids and
    box grounding with 1 to 7 live boxes of 30 (``make_request``)."""
    ids, _, grounding = make_request(rng, batch, vocab, ctx_dim)
    image = rng.uniform(-1.0, 1.0, (batch, size, size, 3)).astype(np.float32)
    return {"image": torch.from_numpy(image).to(device),
            "input_ids": torch.from_numpy(ids).to(device),
            "grounding": {k: torch.from_numpy(v).to(device) for k, v in grounding.items()}}


def run_train(torch, np, seed, device, batch=4, size=512, timed_steps=3):
    """The train step at full SD-1.4 GLIGEN width in configuration (a)
    with remat 'full'.  Returns (failures, per-step launch counts, line)."""
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.training.train_step import create_train_state, make_train_step

    set_config("a")
    os.environ["GLIGEN_TPU_REMAT_POLICY"] = "full"
    failures = []
    comps = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device,
                                    unet_config={"use_checkpoint": True})
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    dezero_(comps.unet, gen)
    state = create_train_state(comps.unet, base_lr=1e-4, warmup_steps=1)
    step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    n_train = sum(p.numel() for p in state.params.values())
    frozen = {f"{tag}.{n}": p.detach().clone()
              for tag, module in (("unet", comps.unet), ("vae", comps.vae),
                                  ("text", comps.text_encoder))
              for n, p in module.named_parameters() if tag != "unet" or n not in state.params}
    print(f"train: SD-1.4 GLIGEN, {n_train / 1e6:.1f} M trainable of "
          f"{sum(p.numel() for p in comps.unet.parameters()) / 1e6:.1f} M UNet parameters, "
          f"{len(state.params)} tensors; {config_desc('a')} remat full; batch {batch} at "
          f"{size}^2, live VAE encode", flush=True)
    expected = expected_train_launches(comps, size, "a", use_checkpoint=True)
    wrappers = kernel_wrappers()
    data = train_batch(torch, np, np.random.default_rng(seed + 6), batch, size, 49408, 768, device)
    losses, counts, times = [], [], []
    bwd = {name: wrappers[name] for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    routes = {name: dict(w.routes) for name, w in bwd.items()}
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in state.params.items()}
    for i in range(1 + timed_steps):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, data, generator=gen)["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append({name: w.launches for name, w in wrappers.items()})
        if i == 0:  # the gradients of the first backward; lr 0 at step 0
            grads_ok = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                           and bool(p.grad.abs().max() > 0) for p in state.params.values())
            unchanged = all(torch.equal(p, before[n]) for n, p in state.params.items())
            print(f"train: after step 0: every trainable gradient finite and nonzero {grads_ok}; "
                  f"no parameter changed (lr 0) {unchanged}", flush=True)
            if not (grads_ok and unchanged):
                failures.append("train gradients after step 0")
            alphas = [p.grad.abs().item() for n, p in state.params.items() if "alpha" in n]
            print(f"train: |d loss / d alpha| over the {len(alphas)} fuser gates: min "
                  f"{min(alphas):.3e} max {max(alphas):.3e}", flush=True)
        if i == 1:
            changed = all(not torch.equal(p, before[n]) for n, p in state.params.items())
            print(f"train: after step 1: every trainable tensor changed {changed}", flush=True)
            if not changed:
                failures.append("train update at step 1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    routes = {name: {r: n - routes[name][r] for r, n in w.routes.items()}
              for name, w in bwd.items()}
    copy = sum(r["copy"] for r in routes.values())
    print(f"train: flash backward launches by route over the {1 + timed_steps} steps {routes} "
          f"(every one must be tma) {'ok' if copy == 0 else 'FAIL'}", flush=True)
    if copy:
        failures.append("flash backward copy route (train)")
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        failures.append("train loss not finite")
    frozen_ok = all(torch.equal(p, frozen[f"{tag}.{n}"])
                    and p.grad is None
                    for tag, module in (("unet", comps.unet), ("vae", comps.vae),
                                        ("text", comps.text_encoder))
                    for n, p in module.named_parameters() if f"{tag}.{n}" in frozen)
    print(f"train: losses {', '.join(f'{x:.5f}' for x in losses)}; frozen parameters "
          f"bit-identical with no gradient {frozen_ok}", flush=True)
    if not frozen_ok:
        failures.append("train frozen parameters")
    for i, c in enumerate(counts):
        got = {name: c[name] for name in expected}
        if got != expected:
            failures.append(f"train launch count step {i}")
            print(f"train: step {i} launches {got}, expected {expected} FAIL", flush=True)
    print(f"train: launches per step {counts[-1]}, expected {expected}", flush=True)
    s_step = sum(times[1:]) / timed_steps
    line = (f"train: {s_step:.4f} s/step = {batch / s_step:.3f} img/s (mean of {timed_steps} "
            f"warm steps: {', '.join(f'{t:.4f}' for t in times[1:])}; warm-up {times[0]:.3f} s), "
            f"batch {batch} at {size}^2, peak memory {peak:.2f} GiB")
    print(line, flush=True)
    del comps, state, step, frozen, before, data
    torch.cuda.empty_cache()
    return failures, counts[-1], line


def train_grads(torch, comps, device, data, draws):
    """One train step's loss and its trainable gradients (fp32, on the CPU)."""
    from gligen_tpu_torch.training.train_step import create_train_state, make_loss_fn

    state = create_train_state(comps.unet)
    loss_fn = make_loss_fn(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    batch = {k: (v.to(device) if k != "grounding" else {g: t.to(device) for g, t in v.items()})
             for k, v in data.items()}
    loss = loss_fn(batch, draws=draws)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in state.params.items()}
    for p in state.params.values():
        p.grad = None
    return loss.item(), grads


def train_reference(torch, np, seed, device, use_checkpoint, size=64, batch=2):
    """One train step's loss and trainable gradients at ``SMALL`` width:
    the card (bf16, kernels) against the CPU (fp32, plain versions), same
    weights, batch and draws, in configuration (a).  64^2 images give a
    32^2 latent, so the ds1 blocks (1024 tokens) take the fused kernels
    under remat too.  Each fuser gate is held on its own; two witnesses,
    held to nothing, show what bf16 alone does to the gates: the card on
    the module path (``PLAIN_SWITCHES``) and the CPU in bf16.  Returns
    (ok, lines)."""
    from gligen_tpu_torch.inference.pipeline import GligenComponents

    set_config("a")
    os.environ["GLIGEN_TPU_REMAT_POLICY"] = "full"
    config = dict(SMALL, unet_config=dict(SMALL["unet_config"], use_checkpoint=use_checkpoint))
    cpu = GligenComponents.create(dtype=torch.float32, seed=seed, device="cpu", **config)
    dezero_(cpu.unet, torch.Generator().manual_seed(seed + 2))
    gpu = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device, **config)
    cpu16 = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device="cpu", **config)
    for other in (gpu, cpu16):
        for a, b in ((cpu.unet, other.unet), (cpu.vae, other.vae),
                     (cpu.text_encoder, other.text_encoder)):
            b.load_state_dict(a.state_dict())
    rng = np.random.default_rng(seed + 7)
    data = train_batch(torch, np, rng, batch, size, 1000, 64, "cpu")
    f = cpu.vae.downsample_factor
    draws = {"posterior": rng.standard_normal((batch, size // f, size // f, 4)),
             "u_t": rng.random(batch), "noise": rng.standard_normal((batch, size // f, size // f, 4)),
             "u_drop": 0.5}
    torch.set_num_threads(4)
    loss_c, grads_c = train_grads(torch, cpu, "cpu", data, draws)
    runs = {"card": train_grads(torch, gpu, device, data, draws)}
    os.environ.update(PLAIN_SWITCHES)
    runs["card module path"] = train_grads(torch, gpu, device, data, draws)
    set_config("a")
    runs["CPU bf16"] = train_grads(torch, cpu16, "cpu", data, draws)

    gates = sorted(n for n in grads_c if "alpha" in n)
    g_max = max(grads_c[n].abs().item() for n in gates)
    limit = {n: GATE_RTOL * grads_c[n].abs().item() + GATE_ATOL * g_max for n in gates}
    err = {run: {n: (g[n] - grads_c[n]).abs().item() for n in gates}
           for run, (_, g) in runs.items()}
    rel = {n: ((runs["card"][1][n] - g).norm() / g.norm()).item()
           for n, g in grads_c.items() if n not in gates}
    worst = max(rel, key=rel.get)
    loss_err = abs(runs["card"][0] - loss_c) / abs(loss_c)
    gates_ok = all(err["card"][n] <= limit[n] for n in gates)
    # a limit at or above its gate's size would let a zero gradient pass
    tight = all(limit[n] < grads_c[n].abs().item() for n in gates)
    ok = (loss_err <= TRAIN_LOSS_RTOL and rel[worst] <= TRAIN_GRAD_RTOL and gates_ok
          and tight)
    head = f"train reference: use_checkpoint={use_checkpoint}:"
    lines = [f"{head} loss card {runs['card'][0]:.6f} CPU {loss_c:.6f} (rel err {loss_err:.2e}, "
             f"tol {TRAIN_LOSS_RTOL}); gradient rel L2 over {len(rel)} tensors: max "
             f"{rel[worst]:.3e} ({worst}, tol {TRAIN_GRAD_RTOL}); each of the {len(gates)} "
             f"fuser gates within {GATE_RTOL} of itself + {GATE_ATOL} x {g_max:.4e} "
             f"{gates_ok}, every limit below its gate's size {tight}; worst error / limit: "
             + ", ".join(f"{run} {max(e[n] / limit[n] for n in gates):.3f}"
                         for run, e in err.items())
             + f" {'ok' if ok else 'FAIL'}"]
    for n in gates:
        lines.append(f"{head} gate {n.replace('.transformer_blocks_0.fuser.', ' ')}: CPU fp32 "
                     f"{grads_c[n].item():+.4e}; abs err "
                     + ", ".join(f"{run} {e[n]:.3e}" for run, e in err.items())
                     + f" (limit {limit[n]:.3e})")
    return ok, lines


def run_tools(torch, device):
    """Phase 9: the port's tools in process at full ds1 width, few calls
    each, in configuration (a).  Returns (failures, the launches of every
    wrapper during the bench_proj run but for its comparisons with the
    plain version, K7's comparisons as results, lines)."""
    from gligen_tpu_torch.tools import bench_block, bench_proj, bench_resblock, bench_sweep_attn

    set_config("a")
    failures, wrappers = [], kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    assert (bench_proj.ATOL, bench_proj.RTOL) == (PROJ_ATOL, PROJ_RTOL)  # K7's rows' "ok"
    rows = bench_proj.run(batch=TOOLS_BATCH, n=LEVELS["ds1"][0], iters=3, device=device)
    counts = {name: w.launches for name, w in wrappers.items()}
    counts["mm_only"] -= sum(r["check_launches"] for r in rows if r["kernel"] == "mm_only")
    lines = [f"tools: bench_proj: {line}" for line in bench_proj.lines(rows)]
    checks = []
    for r in rows:
        k7, k2 = r["launches"]["mm_only"], r["launches"]["K2"]
        if r["kernel"] == "mm_only":
            kind_ok = k7 > 0 and k2 == 0 and r["ok"]
            checks.append(dict(name=f"bench_proj {r['site']}", kind="mm_only",
                               err=r["max_abs_err"], ok=r["ok"]))
        else:
            kind_ok = k7 == 0 and k2 > 0
        if not (kind_ok and r["ms"] > 0):
            failures.append(f"tools bench_proj {r['site']} {r['kernel']}")
    lines.append(f"tools: bench_proj: launches over the run {counts} (K7's comparisons with "
                 f"mm_only_plain left out); every K7 row launched K7 alone and agreed with "
                 f"mm_only_plain (tol {PROJ_ATOL} + {PROJ_RTOL} rel), every K2 row launched no "
                 f"K7: {not failures}")
    # the projection tile sweep: every mode at the table's tiles and the
    # sweep library's, each output held against the plain version
    assert (bench_proj.ATOL, bench_proj.RTOL) == (PROJ_ATOL, PROJ_RTOL)  # its rows' "ok"
    rows = bench_proj.run_sweep(batch=TOOLS_BATCH, n=LEVELS["ds1"][0], iters=3, device=device)
    lines += [f"tools: bench_proj --sweep: {line}" for line in bench_proj.sweep_lines(rows)]
    ok = all(r["ok"] for r in rows)
    lines.append(f"tools: bench_proj --sweep: every configuration agreed with its plain "
                 f"version (tol {PROJ_ATOL} + {PROJ_RTOL} rel): {ok}")
    if not ok:
        failures.append("tools bench_proj --sweep")
    # each sandbox's profiled forward must show the kernels of its configuration
    for tool, needs in (
        (bench_block, ("flash_fwd", "ln_matmuls", "matmul_residual", "ln_geglu",
                       "group_norm normalise (K5)")),
        (bench_resblock, ("group_norm stats (K5)", "group_norm normalise (K5)")),
    ):
        name = tool.__name__.rsplit(".", 1)[1]
        result = tool.run(iters=3, device=device, profile=True)
        missing = [cat for cat in needs if cat not in result["breakdown"]]
        ok = result["out_finite"] and result["ms"] > 0 and not missing
        lines += [f"tools: {name}: {line}" for line in tool.lines(result)]
        lines.append(f"tools: {name}: output finite {result['out_finite']}, kernels missing from "
                     f"the trace {missing} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"tools {name}")
    # the flash forward's tile sweep at the ds1 shapes, a few configurations
    assert (bench_sweep_attn.OUT_TOL, bench_sweep_attn.OUT_REL_TOL, bench_sweep_attn.LSE_TOL) \
        == (OUT_TOL, OUT_REL_TOL, LSE_TOL)  # its rows' "ok"
    rows = bench_sweep_attn.run(batch=TOOLS_BATCH, n=LEVELS["ds1"][0], configs=SWEEP_CONFIGS,
                                iters=3, device=device)
    lines += [f"tools: bench_sweep_attn: {line}" for line in bench_sweep_attn.lines(rows)]
    ok = all(r["ok"] for r in rows)
    lines.append(f"tools: bench_sweep_attn: every configuration agreed with "
                 f"flash_attention_plain: {ok}")
    if not ok:
        failures.append("tools bench_sweep_attn")
    # the flash backward's tile sweep at the ds1 training shapes (B = 4)
    assert bench_sweep_attn.BWD_REL_TOL == BWD_REL_TOL  # its rows' "ok"
    rows = bench_sweep_attn.run_bwd(batch=4, level="ds1", iters=3, device=device)
    lines += [f"tools: bench_sweep_attn --bwd: {line}" for line in bench_sweep_attn.bwd_lines(rows)]
    ok = all(r["ok"] for r in rows)
    lines.append(f"tools: bench_sweep_attn --bwd: every configuration agreed with "
                 f"flash_attention_bwd_plain: {ok}")
    if not ok:
        failures.append("tools bench_sweep_attn --bwd")
    return failures, counts, checks, lines


def make_request(rng, batch, vocab, ctx_dim):
    import numpy as np

    ids = rng.integers(1, vocab - 1, size=(batch, 77)).astype(np.int64)
    uc = np.full((batch, 77), vocab - 1, np.int64)
    n_box = 30
    boxes = np.sort(rng.random((batch, n_box, 4)).astype(np.float32).reshape(-1, 2, 2), axis=1)
    grounding = {
        "boxes": boxes.reshape(batch, n_box, 4),
        "masks": (np.arange(n_box)[None, :] < rng.integers(1, 8, size=(batch, 1))).astype(np.float32),
        "positive_embeddings": rng.standard_normal((batch, n_box, ctx_dim)).astype(np.float32),
    }
    return ids, uc, grounding


def check_image(torch, img, batch, size):
    shape_ok = tuple(img.shape) == (batch, size, size, 3)
    finite = bool(torch.isfinite(img).all())
    lo, hi, std = img.min().item(), img.max().item(), img.float().std().item()
    ok = shape_ok and finite and lo >= 0.0 and hi <= 1.0 and std > 1e-3
    return ok, f"shape {tuple(img.shape)} finite {finite} min {lo:.4f} max {hi:.4f} std {std:.4f}"


# name: (source, the TPU kernel it replaces, the shape its times come from,
# the run that gives its launches: a generate configuration, the train
# step, or phase 9's bench_proj)
KERNEL_META = {
    "flash_fwd": ("gligen_tpu_torch/csrc/flash_fwd.cu",
                  "gligen_tpu/ops/pallas_attention.py:836 (_packed_fwd_impl single-KV) "
                  "and gligen_tpu/ops/pallas_attention.py:466 (_fwd_impl streamed)", "attn1_ds1",
                  "a"),
    "ln_matmuls": ("gligen_tpu_torch/csrc/fused_proj.cu",
                   "gligen_tpu/ops/pallas_matmul.py:132 (_ln_matmuls)", "qkv_ds1", "a"),
    "matmul_residual": ("gligen_tpu_torch/csrc/fused_proj.cu",
                        "gligen_tpu/ops/pallas_matmul.py:212 (_matmul_residual)", "to_out_ds1",
                        "a"),
    "ln_geglu": ("gligen_tpu_torch/csrc/fused_proj.cu",
                 "gligen_tpu/ops/pallas_matmul.py:297 (_ln_geglu)", "geglu_ds1", "a"),
    "group_norm": ("gligen_tpu_torch/csrc/fused_norm.cu",
                   "gligen_tpu/ops/pallas_norm.py:107 (_group_norm_pallas_flat)", "st_64x320",
                   "a"),
    "gn_affine": ("gligen_tpu_torch/csrc/fused_norm.cu",
                  "gligen_tpu/ops/pallas_norm.py:107 (_group_norm_pallas_flat, the statistics of "
                  "_gn_kernel :62, as gligen_tpu/ops/pallas_conv.py:47 gn_affine folds them)",
                  "res_64x320", "c"),
    "layer_norm": ("gligen_tpu_torch/csrc/fused_norm.cu",
                   "gligen_tpu/ops/pallas_norm.py:169 (_layer_norm_pallas_flat)", "ln_ds1", "b"),
    "gn_silu_conv3x3": ("gligen_tpu_torch/csrc/fused_conv.cu",
                        "gligen_tpu/ops/pallas_conv.py:141 (_fused)", "out_64_320", "c"),
    "flash_bwd_dq": ("gligen_tpu_torch/csrc/flash_bwd.cu",
                     "gligen_tpu/ops/pallas_attention.py:627 (_flash_bwd dq) and "
                     "gligen_tpu/ops/pallas_attention.py:1004 (_flash_packed_bwd dq)",
                     "attn1_ds1", "train"),
    "flash_bwd_dkv": ("gligen_tpu_torch/csrc/flash_bwd.cu",
                      "gligen_tpu/ops/pallas_attention.py:684 (_flash_bwd dk/dv/dbias) and "
                      "gligen_tpu/ops/pallas_attention.py:1063 (_flash_packed_bwd dk/dv/dbias)",
                      "attn1_ds1", "train"),
    "mm_only": ("gligen_tpu_torch/csrc/fused_proj.cu", "tools/bench_proj.py:90 (mm_only)",
                "mm_320_320_ds1", "bench_proj"),
}


def kernel_wrappers():
    from gligen_tpu_torch.ops import flash_attention, fused_conv, fused_norm, fused_proj

    return {**flash_attention.KERNELS, **fused_proj.KERNELS, **fused_norm.KERNELS,
            **fused_conv.KERNELS}


def run_requests(torch, pipe, requests, config, gen, **kw):
    """Generate every request in one configuration, with every launch
    count set to 0 just before and read just after.  Returns (seconds per
    request, images, launch counts)."""
    set_config(config)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    times, images = [], []
    for ids, uc, grounding in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images.append(pipe.generate(ids, uc, grounding, generator=gen, **kw))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, images, {name: w.launches for name, w in wrappers.items()}


def small_reference(torch, np, seed, device, alpha, config):
    """The pipeline at a small width: card (bf16, kernels) against CPU
    (fp32, plain versions), same weights and noise, in one configuration.
    Returns (ok, line)."""
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents

    set_config(config)
    cpu = GligenComponents.create(dtype=torch.float32, seed=seed, device="cpu", **SMALL)
    dezero_(cpu.unet, torch.Generator().manual_seed(seed + 2))
    gpu = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device, **SMALL)
    for a, b in ((cpu.unet, gpu.unet), (cpu.vae, gpu.vae), (cpu.text_encoder, gpu.text_encoder)):
        b.load_state_dict(a.state_dict())
    ids, uc, grounding = make_request(np.random.default_rng(seed + 3), 2, 1000, 64)
    noise = np.random.default_rng(seed + 4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    kw = dict(steps=4, guidance_scale=7.5, alpha_stages=alpha, latent_size=16, noise=noise)
    with torch.inference_mode():
        torch.set_num_threads(4)
        ref = GenerationPipeline(cpu).generate(ids, uc, grounding, **kw)
    got = GenerationPipeline(gpu).generate(ids, uc, grounding, **kw).cpu()
    diff = (got - ref).abs()
    ok, desc = check_image(torch, got, 2, 32)
    ok = ok and diff.mean().item() <= REF_MEAN_TOL
    return ok, (f"reference: {config_desc(config)}: small pipeline card bf16 vs CPU fp32: {desc}; "
                f"mean abs diff {diff.mean().item():.4e} (tol {REF_MEAN_TOL}), "
                f"max {diff.max().item():.4e} {'ok' if ok else 'FAIL'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    # ---- 1. card ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not all((REPO / "gligen_tpu_torch" / "csrc" / f"{s}.cu").is_file() for s in SOURCES):
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"TF32 off for matmul and cuDNN)", flush=True)

    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
    from gligen_tpu_torch.ops.cuda_build import library_path, load_library
    from gligen_tpu_torch.ops.flash_attention import flash_fwd

    failures = []

    # ---- 2. build: one nvcc per source, all started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(load_library, SOURCES))
    print(f"build: {', '.join(s + '.cu' for s in SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"-> {library_path(SOURCES[0]).parent.parent.relative_to(REPO)}", flush=True)
    for src in SOURCES:
        report = (library_path(src).parent / "ptxas.txt").read_text()
        if src.startswith("fused_proj"):  # one line per tile configuration
            for name, regs, stores, loads in ptxas_configs(report):
                print(f"build: {src}: {name}: {regs} registers, {stores} bytes spill stores, "
                      f"{loads} bytes spill loads")
            report = "\n".join(l for l in report.splitlines() if "wgmma" in l)
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "wgmma")):
                print(f"build: {src}: {line.strip()}")

    # ---- 3. kernels vs plain ----
    batch = 2
    comps = GligenComponents.create(dtype=torch.bfloat16, seed=args.seed, device=device)
    results = check_kernel(torch, kernel_cases(batch), device)
    results.append(check_kernel_1024(torch, device))
    results += check_proj(torch, proj_cases(batch) + mm_cases(), device)
    results += check_norms(torch, norm_cases(comps.unet, comps.vae, batch), ln_cases(batch), device)
    results += check_convs(torch, conv_cases(comps.unet, batch), device)
    failures += [f"kernel {r['kind']} {r['name']}" for r in results if not r["ok"]]

    # ---- 4. the main path at full width, in each configuration ----
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    dezero_(comps.unet, gen)
    torch.cuda.synchronize()
    print(f"generate: SD-1.4 GLIGEN components on the card in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in comps.unet.parameters()) / 1e6:.1f} M UNet parameters)",
          flush=True)
    pipe = GenerationPipeline(comps)
    alpha, latent = [0.3, 0.0, 0.7], 64
    rng = np.random.default_rng(args.seed)
    kw = dict(steps=args.steps, guidance_scale=7.5, alpha_stages=alpha, latent_size=latent)
    s_per_img, launches = {}, {}
    for config in CONFIGS:
        expected, gated, free = expected_launches(comps, args.steps, alpha, latent, config)
        requests = [make_request(rng, batch, 49408, 768) for _ in range(2)]
        routes = dict(flash_fwd.routes)
        times, images, counts = run_requests(torch, pipe, requests, config, gen, **kw)
        routes = {r: n - routes[r] for r, n in flash_fwd.routes.items()}
        for i, (img, t) in enumerate(zip(images, times)):
            ok, desc = check_image(torch, img, batch, 512)
            print(f"generate: {config_desc(config)} request {i}: {desc} in {t:.3f} s "
                  f"= {t / batch:.3f} s/img {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"image ({config}) {i}")
        want = {name: len(requests) * expected[name] for name in counts}
        print(f"generate: ({config}) per request {gated} gated and {free} fuser-free UNet calls; "
              f"launches {counts}, expected {want} ({len(requests)} requests)", flush=True)
        if counts != want:
            failures.append(f"launch count ({config})")
        print(f"generate: ({config}) flash_fwd launches by route {routes} (every one must be "
              f"tma) {'ok' if routes['copy'] == 0 else 'FAIL'}", flush=True)
        if routes["copy"]:
            failures.append(f"flash_fwd copy route ({config})")
        s_per_img[config] = times[1] / batch
        launches[config] = counts
        del images
    del comps, pipe
    torch.cuda.empty_cache()

    # ---- 5. small-width reference: card (bf16, kernels) vs CPU (fp32, plain) ----
    for config in CONFIGS:
        ok, line = small_reference(torch, np, args.seed, device, alpha, config)
        print(line, flush=True)
        if not ok:
            failures.append(f"reference ({config})")

    # ---- 6. the flash backward kernels vs plain ----
    results += check_bwd(torch, bwd_cases(4), device)
    failures += [f"kernel {r['kind']} {r['name']}" for r in results
                 if r["kind"].startswith("flash_bwd") and not r["ok"]]

    # ---- 7. the train step at full width ----
    train_failures, launches["train"], train_line = run_train(torch, np, args.seed, device)
    failures += train_failures

    # ---- 8. small-width train step: card (bf16, kernels) vs CPU (fp32, plain) ----
    for use_checkpoint in (True, False):
        ok, lines = train_reference(torch, np, args.seed, device, use_checkpoint)
        print("\n".join(lines), flush=True)
        if not ok:
            failures.append(f"train reference (use_checkpoint={use_checkpoint})")

    # ---- 9. the tools at full ds1 width ----
    tool_failures, launches["bench_proj"], tool_checks, tool_report = run_tools(torch, device)
    results += tool_checks
    print("\n".join(tool_report), flush=True)
    failures += tool_failures

    print("summary: s/img " + ", ".join(f"({c}) {s:.3f}" for c, s in s_per_img.items())
          + f" (request 1 of 2, batch {batch}, {args.steps} PLMS steps, 512^2) on {card}")
    print(f"summary: {train_line[len('train: '):]} on {card}")
    by_name = {(r["kind"], r["name"]): r for r in results}
    kernels = []
    for name, (source, replaces, timed_at, config) in KERNEL_META.items():
        own = [r for r in results if r["kind"] == name]
        at = by_name[(name, timed_at)]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[config][name], max_abs_err=max(r["err"] for r in own),
            ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by=at["bound_by"], library_ms=at["library_ms"], timed_at=timed_at,
            launches_config=config,
        ))
    print(json.dumps({"kernels": kernels}))
    if failures:
        print(f"chip_smoke: FAILED: {', '.join(failures)}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
