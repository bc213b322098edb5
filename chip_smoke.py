#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gligen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 10] [--seed 0]

Phases, each of which fails the run with a non-zero exit:

  1. card: require CUDA; print the card's name and power limit.
  2. build: compile csrc/flash_fwd.cu and csrc/fused_proj.cu with nvcc, in
     parallel, into build/kernels/; print ptxas's registers and spills.
  3. kernel: compare each kernel with its plain PyTorch version on bf16
     inputs at every shape the 512^2 path launches, with the times of both:
     flash attention (UNet attn1, the gated fuser's N+30 keys,
     cross-attention over 77 text tokens, at ds1/ds2/ds4 and the 64-token
     middle block; the VAE's single 512-wide head over 4096 tokens; and
     attn1 at ds1 of a 1024^2 image, checked on its first 512 query rows),
     and per level the fused projections: ln_matmuls for q/k/v, for q
     alone and for the fuser's k/v over N+30 rows, matmul_residual for
     to_out (device gate) and net_2 (K = 4C), and ln_geglu (C -> 8C -> 4C).
     Times are device times per call (see ``timed``).
  4. generate: GenerationPipeline.generate at full SD-1.4 GLIGEN width,
     512^2, random de-zeroed weights, two requests of batch 2 (4 UNet rows
     with CFG), PLMS with alpha stages [0.3, 0, 0.7], in the default
     configuration (fused projections), then two more requests with
     GLIGEN_TPU_FUSED_PROJ=0 (plain projections); the images must be
     finite, in [0, 1] and not constant, and each kernel's launch count
     must equal what the sampler tables predict for its configuration.
  5. reference: the same pipeline at a small width on the card (bf16,
     kernels) against its fp32 CPU run (plain versions), same weights and
     noise, in both configurations.

The last three lines are a JSON object with the kernels' measurements,
the card's name and power limit, and {"ok": true, "device": {...}}.  JAX
is not imported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

# kernel vs plain, bf16 output: one bf16 ulp is 2^-7 relative, outputs are
# O(1), and the kernel rounds P to bf16 before the PV product
OUT_TOL = 2e-2
# log-sum-exp, fp32 sums in another order (log2 units)
LSE_TOL = 1e-3
# fused projections vs plain, bf16 output: the same bf16 operands summed in
# fp32 in another order, and a normalised row that may round to the
# neighbouring bf16 value: about one bf16 ulp (2^-7 relative), for outputs
# up to ~5 in magnitude (the residual adds x ~ N(0, 1))
PROJ_ATOL, PROJ_RTOL = 2e-2, 1e-2
# small-width pipeline, bf16 on the card vs fp32 on the CPU: mean absolute
# pixel difference (images in [0, 1])
REF_MEAN_TOL = 2e-2


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


SLEEP_CYCLES = 50_000_000  # ~25 ms of one spinning block at the H100's clock


def timed(fn, iters: int = 10):
    """(device ms, host ms) per call of ``fn``, the mean of ``iters`` calls
    after one warm-up.  The calls are queued behind a spinning kernel and
    timed by CUDA events once the host has queued them all, so the device
    runs them back to back: the device time leaves out the host's time to
    queue each call (the wrapper's checks, allocation and launch), which is
    the host time.  The spin is lengthened until the host gets ahead."""
    import torch

    fn()
    torch.cuda.synchronize()
    for cycles in (SLEEP_CYCLES * 4**i for i in range(4)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        queued_ahead = not start.query()  # the device is still spinning
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters, host_ms
    raise RuntimeError(f"the host took {host_ms:.3f} ms per call: too slow to queue "
                       f"{iters} calls ahead of the device")


def time_ms(fn, iters: int = 10) -> float:
    return timed(fn, iters)[0]


def dezero_(module, generator) -> None:
    """Random values for the zero-initialised weights (UNet out_2,
    out_layers_3, proj_out) and 0.5 for the fuser gates, so the output
    depends on every layer: a fresh model otherwise predicts eps = 0."""
    import torch
    from gligen_tpu_torch.models.layers import Conv2d, Dense, GatedSelfAttentionDense

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Dense, Conv2d)) and m.zero_init:
                std = m.weight[0].numel() ** -0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                           device=m.weight.device) * std)
            elif isinstance(m, GatedSelfAttentionDense):
                m.alpha_attn.fill_(0.5)
                m.alpha_dense.fill_(0.5)


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
        out, lse = flash_fwd(q, k, v, h, bias=bias)
        torch.cuda.synchronize()
        # the plain version on the same (card) tensors: the wrapper takes it
        # only for CPU tensors, so it is called directly here
        want, want_lse = flash_attention_plain(q, k, v, h, bias=bias)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
        ms = time_ms(lambda: flash_fwd(q, k, v, h, bias=bias))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, h, bias=bias))
        ok = finite and err <= OUT_TOL and lse_err <= LSE_TOL
        print(f"kernel {name:18s} q ({b},{n},{h}x{d}) kv {m}: max_abs_err {err:.3e} "
              f"(tol {OUT_TOL}) lse_err {lse_err:.3e} (tol {LSE_TOL}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}",
              flush=True)
        results.append(dict(name=name, err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms, ok=ok))
        del q, k, v, out, lse, want, want_lse
    torch.cuda.empty_cache()
    return results


def check_kernel_1024(torch, device, rows=512):
    """attn1 at ds1 of a 1024^2 image: (4, 16384, 8x40) against 16384 keys.
    The plain version's whole score matrix would take ~34 GB in fp32, so it
    runs on the first ``rows`` query rows; rows are independent, so the
    comparison is exact for them.  plain_ms is the time of those rows."""
    from gligen_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd

    b, n, h, d = 4, 16384, 8, 40
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn((b, n, h * d), generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    out, lse = flash_fwd(q, k, v, h)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_plain(q[:, :rows], k, v, h)
    err = (out[:, :rows].float() - want.float()).abs().max().item()
    lse_err = (lse[:, :, :rows] - want_lse).abs().max().item()
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    ms = time_ms(lambda: flash_fwd(q, k, v, h), iters=3)
    plain_ms = time_ms(lambda: flash_attention_plain(q[:, :rows], k, v, h), iters=3)
    ok = finite and err <= OUT_TOL and lse_err <= LSE_TOL
    name = "attn1_ds1_1024px"
    print(f"kernel {name:18s} q ({b},{n},{h}x{d}) kv {n}: max_abs_err {err:.3e} on the first "
          f"{rows} query rows (tol {OUT_TOL}) lse_err {lse_err:.3e} (tol {LSE_TOL}) "
          f"kernel {ms:.4f} ms (all rows) plain {plain_ms:.4f} ms ({rows} rows) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    del q, k, v, out, lse, want, want_lse
    torch.cuda.empty_cache()
    return dict(name=name, err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms, ok=ok)


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


def check_proj(torch, cases, device):
    """Each fused-projection kernel against its plain version on the same
    card tensors (bf16 activations and weights, fp32 norm parameters,
    biases and gate), with the times of both."""
    from gligen_tpu_torch.ops import fused_proj as fp

    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    bf16 = torch.bfloat16
    results = []
    for name, kind, b, n, c, k in cases:
        x = randn(b, n, c, dtype=bf16)
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        if kind == "ln_matmuls":
            ws = [randn(c, c, scale=c**-0.5, dtype=bf16) for _ in range(k)]
            args = (x, s, sb, ws)
            desc = f"x ({b},{n},{c}) -> {k} x {c}"
        elif kind == "matmul_residual":
            h = randn(b, n, k, dtype=bf16)
            # the fuser's device gate on to_out; net_2 of the block has none
            gate = torch.tensor(0.37, device=device) if k == c else None
            args = (h, randn(c, k, scale=k**-0.5, dtype=bf16), randn(c, scale=0.1), x, gate)
            desc = f"h ({b},{n},{k}) -> {c}{' gated' if gate is not None else ''}"
        else:
            args = (x, s, sb, randn(8 * c, c, scale=c**-0.5, dtype=bf16), randn(8 * c, scale=0.1))
            desc = f"x ({b},{n},{c}) -> {8 * c} -> {4 * c}"
        kernel, plain = fp.KERNELS[kind], getattr(fp, f"{kind}_plain")
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        ok = all(bool(torch.isfinite(g).all()) and g.shape == w.shape
                 and torch.allclose(g.float(), w.float(), atol=PROJ_ATOL, rtol=PROJ_RTOL)
                 for g, w in zip(got, want))
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        print(f"kernel {kind:15s} {name:12s} {desc:28s}: max_abs_err {err:.3e} "
              f"(tol {PROJ_ATOL} + {PROJ_RTOL} rel) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind=kind, err=err, ms=ms, plain_ms=plain_ms, ok=ok))
        del x, args, got, want
    torch.cuda.empty_cache()
    return results


def expected_launches(comps, steps, alpha_stages):
    """Launches of each kernel in one generate call, from the sampler
    tables, for the fused configuration.  Per transformer block, a gated
    UNet call runs attn1, the fuser and attn2 (3 flash launches), the fused
    path's ln_matmuls for q/k/v, the fuser's q, the fuser's k/v and attn2's
    q (4), matmul_residual for the three to_out and the two net_2 (5) and
    ln_geglu for the two feed-forwards (2); a fuser-free call runs 2, 2, 3
    and 1.  The VAE decoder adds its AttnBlocks' flash launches."""
    from gligen_tpu_torch.diffusion.samplers import SamplerTables, _gate_zero_from
    from gligen_tpu_torch.models.layers import BasicTransformerBlock
    from gligen_tpu_torch.models.vae import AttnBlock

    tables = SamplerTables.create(comps.schedule, steps, alpha_stages=alpha_stages)
    n = len(tables.ts)
    k0 = _gate_zero_from(tables)
    split = max(k0, 1)
    heun = 2  # the peeled step 0 calls the model twice
    gated = (heun if k0 > 0 else 0) + (split - 1)
    free = (heun if k0 == 0 else 0) + (n - split)
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in comps.unet.modules())
    vae_attn = sum(isinstance(m, AttnBlock) for m in comps.vae.modules())
    per_block = {"flash_fwd": (3, 2), "ln_matmuls": (4, 2), "matmul_residual": (5, 3),
                 "ln_geglu": (2, 1)}
    counts = {name: blocks * (g * gated + f * free) for name, (g, f) in per_block.items()}
    counts["flash_fwd"] += vae_attn
    return counts, gated, free, blocks


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


KERNEL_META = {
    "flash_fwd": ("gligen_tpu_torch/csrc/flash_fwd.cu",
                  "gligen_tpu/ops/pallas_attention.py:836 (_packed_fwd_impl single-KV) "
                  "and gligen_tpu/ops/pallas_attention.py:466 (_fwd_impl streamed)", "attn1_ds1"),
    "ln_matmuls": ("gligen_tpu_torch/csrc/fused_proj.cu",
                   "gligen_tpu/ops/pallas_matmul.py:132 (_ln_matmuls)", "qkv_ds1"),
    "matmul_residual": ("gligen_tpu_torch/csrc/fused_proj.cu",
                        "gligen_tpu/ops/pallas_matmul.py:212 (_matmul_residual)", "to_out_ds1"),
    "ln_geglu": ("gligen_tpu_torch/csrc/fused_proj.cu",
                 "gligen_tpu/ops/pallas_matmul.py:297 (_ln_geglu)", "geglu_ds1"),
}


def kernel_wrappers():
    from gligen_tpu_torch.ops.flash_attention import flash_fwd
    from gligen_tpu_torch.ops.fused_proj import KERNELS

    return {"flash_fwd": flash_fwd, **KERNELS}


def run_requests(torch, pipe, requests, fused, gen, **kw):
    """Generate every request in one configuration (GLIGEN_TPU_FUSED_PROJ
    = ``fused``), with every launch count set to 0 just before and read
    just after.  Returns (seconds per request, images, launch counts)."""
    os.environ["GLIGEN_TPU_FUSED_PROJ"] = fused
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


def small_reference(torch, np, seed, device, alpha, fused):
    """The pipeline at a small width: card (bf16, kernels) against CPU
    (fp32, plain versions), same weights and noise, in one configuration.
    Returns (ok, line)."""
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents

    os.environ["GLIGEN_TPU_FUSED_PROJ"] = fused
    small = dict(
        unet_config=dict(model_channels=64, num_res_blocks=1, attention_resolutions=(2, 1),
                         channel_mult=(1, 2), num_heads=2, context_dim=64,
                         grounding_tokenizer={"target": "text",
                                              "params": {"in_dim": 64, "out_dim": 64}}),
        vae_config=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=64),
        text_config=dict(vocab_size=1000, hidden_size=64, layers=2, heads=4),
    )
    cpu = GligenComponents.create(dtype=torch.float32, seed=seed, **small)
    dezero_(cpu.unet, torch.Generator().manual_seed(seed + 2))
    gpu = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device, **small)
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
    return ok, (f"reference: GLIGEN_TPU_FUSED_PROJ={fused}: small pipeline card bf16 vs CPU "
                f"fp32: {desc}; mean abs diff {diff.mean().item():.4e} (tol {REF_MEAN_TOL}), "
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
    sources = ("flash_fwd", "fused_proj")
    if not all((REPO / "gligen_tpu_torch" / "csrc" / f"{s}.cu").is_file() for s in sources):
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

    failures = []

    # ---- 2. build: one nvcc per source, all started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(load_library, sources))
    print(f"build: {', '.join(s + '.cu' for s in sources)} in {time.perf_counter() - t0:.1f} s "
          f"-> {library_path(sources[0]).parent.parent.relative_to(REPO)}", flush=True)
    for src in sources:
        for line in (library_path(src).parent / "ptxas.txt").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"build: {src}: {line.strip()}")

    # ---- 3. kernels vs plain ----
    batch = 2
    results = check_kernel(torch, kernel_cases(batch), device)
    results.append(check_kernel_1024(torch, device))
    proj = check_proj(torch, proj_cases(batch), device)
    failures += [f"kernel {r['name']}" for r in results + proj if not r["ok"]]

    # ---- 4. the main path at full width, fused (default) then plain projections ----
    t0 = time.perf_counter()
    comps = GligenComponents.create(dtype=torch.bfloat16, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    dezero_(comps.unet, gen)
    torch.cuda.synchronize()
    print(f"generate: SD-1.4 GLIGEN components on the card in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in comps.unet.parameters()) / 1e6:.1f} M UNet parameters)",
          flush=True)
    pipe = GenerationPipeline(comps)
    alpha = [0.3, 0.0, 0.7]
    expected, gated, free, blocks = expected_launches(comps, args.steps, alpha)
    print(f"generate: per request {gated} gated UNet calls and {free} fuser-free calls over "
          f"{blocks} transformer blocks: expected launches (fused) {expected}", flush=True)
    rng = np.random.default_rng(args.seed)
    kw = dict(steps=args.steps, guidance_scale=7.5, alpha_stages=alpha, latent_size=64)
    s_per_img, launches = {}, None
    for fused in ("1", "0"):
        requests = [make_request(rng, batch, 49408, 768) for _ in range(2)]
        times, images, counts = run_requests(torch, pipe, requests, fused, gen, **kw)
        for i, (img, t) in enumerate(zip(images, times)):
            ok, desc = check_image(torch, img, batch, 512)
            print(f"generate: GLIGEN_TPU_FUSED_PROJ={fused} request {i}: {desc} in {t:.3f} s "
                  f"= {t / batch:.3f} s/img {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"image {fused}/{i}")
        want = {name: len(requests) * (n if fused == "1" or name == "flash_fwd" else 0)
                for name, n in expected.items()}
        print(f"generate: GLIGEN_TPU_FUSED_PROJ={fused} launches {counts}, expected {want} "
              f"({len(requests)} requests)", flush=True)
        if counts != want:
            failures.append(f"launch count GLIGEN_TPU_FUSED_PROJ={fused}")
        s_per_img[fused] = times[1] / batch
        if fused == "1":
            launches = counts
        del images
    del comps, pipe
    torch.cuda.empty_cache()

    # ---- 5. small-width reference: card (bf16, kernels) vs CPU (fp32, plain) ----
    for fused in ("1", "0"):
        ok, line = small_reference(torch, np, args.seed, device, alpha, fused)
        print(line, flush=True)
        if not ok:
            failures.append(f"reference GLIGEN_TPU_FUSED_PROJ={fused}")

    print(f"summary: s/img fused {s_per_img['1']:.3f}, plain projections {s_per_img['0']:.3f} "
          f"(request 1 of 2, batch {batch}, {args.steps} PLMS steps, 512^2) on {card}")
    by_name = {r["name"]: r for r in results + proj}
    kernels = []
    for name, (source, replaces, timed_at) in KERNEL_META.items():
        own = results if name == "flash_fwd" else [r for r in proj if r["kind"] == name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=max(r["err"] for r in own),
            ms=by_name[timed_at]["ms"], plain_ms=by_name[timed_at]["plain_ms"],
            timed_at=timed_at,
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
