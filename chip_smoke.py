#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gligen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 10] [--seed 0]

Phases, each of which fails the run with a non-zero exit:

  1. card: require CUDA; print the card's name and power limit.
  2. build: compile csrc/flash_fwd.cu with nvcc into build/kernels/.
  3. kernel: compare the flash-attention kernel with its plain PyTorch
     version on bf16 inputs at every shape the 512^2 path launches (UNet
     attn1, the gated fuser's N+30 keys, cross-attention over 77 text
     tokens, at ds1/ds2/ds4 and the 64-token middle block; the VAE's
     single 512-wide head over 4096 tokens), with the times of both.
  4. generate: GenerationPipeline.generate at full SD-1.4 GLIGEN width,
     512^2, random de-zeroed weights, two requests of batch 2 (4 UNet rows
     with CFG), PLMS with alpha stages [0.3, 0, 0.7]; the image must be
     finite, in [0, 1] and not constant, and the kernel's launch count
     must equal what the sampler tables predict.
  5. reference: the same pipeline at a small width on the card (bf16,
     kernel) against its fp32 CPU run (plain attention), same weights and
     noise.

The line before the last is a JSON object with the kernel's measurements;
the last line is {"ok": true, "device": {...}}.  JAX is not imported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# kernel vs plain, bf16 output: one bf16 ulp is 2^-7 relative, outputs are
# O(1), and the kernel rounds P to bf16 before the PV product
OUT_TOL = 2e-2
# log-sum-exp, fp32 sums in another order (log2 units)
LSE_TOL = 1e-3
# small-width pipeline, bf16 on the card vs fp32 on the CPU: mean absolute
# pixel difference (images in [0, 1])
REF_MEAN_TOL = 2e-2


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def expected_launches(comps, steps, alpha_stages):
    """Flash launches of one generate call, from the sampler tables: each
    UNet transformer block runs attn1, the fuser and attn2 in a gated call,
    attn1 and attn2 in a fuser-free one; the VAE decoder has its AttnBlocks."""
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
    return gated * 3 * blocks + free * 2 * blocks + vae_attn, gated, free, blocks


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
    if not (REPO / "gligen_tpu_torch" / "csrc" / "flash_fwd.cu").is_file():
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

    # ---- 2. build ----
    t0 = time.perf_counter()
    load_library("flash_fwd")
    print(f"build: flash_fwd.cu in {time.perf_counter() - t0:.1f} s -> "
          f"{library_path('flash_fwd').relative_to(REPO)}", flush=True)
    ptxas = (library_path("flash_fwd").parent / "ptxas.txt").read_text()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")

    # ---- 3. kernel vs plain ----
    batch = 2
    results = check_kernel(torch, kernel_cases(batch), device)
    failures += [f"kernel {r['name']}" for r in results if not r["ok"]]

    # ---- 4. the main path at full width ----
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
    rng = np.random.default_rng(args.seed)
    requests = [make_request(rng, batch, 49408, 768) for _ in range(2)]
    times, images = [], []
    flash_fwd.launches = 0
    for ids, uc, grounding in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pipe.generate(ids, uc, grounding, steps=args.steps, guidance_scale=7.5,
                            alpha_stages=alpha, latent_size=64, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        images.append(img)
    launches = flash_fwd.launches
    for i, (img, t) in enumerate(zip(images, times)):
        ok, desc = check_image(torch, img, batch, 512)
        print(f"generate: request {i}: {desc} in {t:.3f} s = {t / batch:.3f} s/img "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"image {i}")
    want = 2 * expected
    print(f"generate: flash launches {launches}, expected {want} = 2 requests x "
          f"({gated} gated UNet calls x 3 x {blocks} blocks + "
          f"{free} fuser-free calls x 2 x {blocks} + VAE)",
          flush=True)
    if launches != want:
        failures.append("launch count")
    del comps, pipe, images
    torch.cuda.empty_cache()

    # ---- 5. small-width reference: card (bf16, kernel) vs CPU (fp32, plain) ----
    small = dict(
        unet_config=dict(model_channels=64, num_res_blocks=1, attention_resolutions=(2, 1),
                         channel_mult=(1, 2), num_heads=2, context_dim=64,
                         grounding_tokenizer={"target": "text",
                                              "params": {"in_dim": 64, "out_dim": 64}}),
        vae_config=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=64),
        text_config=dict(vocab_size=1000, hidden_size=64, layers=2, heads=4),
    )
    cpu = GligenComponents.create(dtype=torch.float32, seed=args.seed, **small)
    dezero_(cpu.unet, torch.Generator().manual_seed(args.seed + 2))
    gpu = GligenComponents.create(dtype=torch.bfloat16, seed=args.seed, device=device, **small)
    for a, b_ in ((cpu.unet, gpu.unet), (cpu.vae, gpu.vae), (cpu.text_encoder, gpu.text_encoder)):
        b_.load_state_dict(a.state_dict())
    ids, uc, grounding = make_request(np.random.default_rng(args.seed + 3), 2, 1000, 64)
    noise = np.random.default_rng(args.seed + 4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    kw = dict(steps=4, guidance_scale=7.5, alpha_stages=alpha, latent_size=16, noise=noise)
    with torch.inference_mode():
        torch.set_num_threads(4)
        ref = GenerationPipeline(cpu).generate(ids, uc, grounding, **kw)
    got = GenerationPipeline(gpu).generate(ids, uc, grounding, **kw).cpu()
    diff = (got - ref).abs()
    ok, desc = check_image(torch, got, 2, 32)
    ok = ok and diff.mean().item() <= REF_MEAN_TOL
    print(f"reference: small pipeline card bf16 vs CPU fp32: {desc}; mean abs diff "
          f"{diff.mean().item():.4e} (tol {REF_MEAN_TOL}), max {diff.max().item():.4e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("reference")

    worst = max(r["err"] for r in results)
    head = next(r for r in results if r["name"] == "attn1_ds1")
    print(f"summary: s/img {sum(times[1:]) / (batch * len(times[1:])):.3f} "
          f"(request 1 of 2, batch {batch}, {args.steps} PLMS steps, 512^2) on {card}")
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "gligen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "gligen_tpu/ops/pallas_attention.py:836 (_packed_fwd_impl single-KV) "
                    "and gligen_tpu/ops/pallas_attention.py:466 (_fwd_impl streamed)",
        "launches": launches,
        "max_abs_err": worst,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "timed_at": "attn1_ds1",
    }]}))
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
