#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gligen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 10] [--seed 0]

Phases, each of which fails the run with a non-zero exit:

  1. card: require CUDA; print the card's name and power limit.
  2. build: compile csrc/flash_fwd.cu, flash_fwd_sweep.cu (the same
     kernel at the tile sweep's configurations), flash_fwd_f32_sweep.cu
     (its fp32 route's d <= 40 and d <= 80 classes likewise), flash_bwd.cu,
     flash_bwd_sweep.cu (likewise), fused_proj.cu, fused_proj_sweep.cu
     (likewise), fused_norm.cu, fused_conv.cu and fused_conv_sweep.cu
     (likewise) with nvcc, in parallel, into build/kernels/; print the
     seconds it took and ptxas's registers, spills and wgmma notes (for
     fused_proj, fused_conv and the flash forward's fp32 route, one line
     per tile configuration; the fp32 routes' 3xTF32 kernels must not
     spill).
  3. kernel: compare each kernel with its plain PyTorch version on bf16
     inputs at every shape the 512^2 path launches, with the times of both
     and, where one PyTorch call computes the same function, that call's:
     flash attention (UNet attn1, the gated fuser's N+30 keys,
     cross-attention over 77 text tokens, at ds1/ds2/ds4 and the 64-token
     middle block; the gatedSA fuser over N+60 (box+text+image) and N+136
     (keypoint) keys, the gatedCA fuser's N queries over 30, 60 and 136
     keys, the gatedSA2 fuser's 36 queries over N+36 keys; at ds1 and ds2
     the gatedSA fuser over the spatial tokenizers' N+196 and N+64 keys;
     the VAE's single 512-wide head over 4096 tokens; and
     attn1 at ds1 of a 1024^2 image, checked 512 query rows at a time;
     each row with its route, TF/s and share of the bound, and every one
     must take the TMA route; and the fp32 route (3xTF32 wgmma) at the
     inpaint encode's VAE head, held to FP32_REL_TOL of its plain output's
     largest magnitude and repeated bit for bit, beside SDPA in fp32, with
     a TF32 witness (the plain version's error with one-pass TF32, which
     must exceed the limit at one row at least) and its 3xTF32 and fp32
     FMA bounds), each row on the keys-as-rows kernel; and the fp32 routes
     of a model served in fp32 (fault F5, ``check_fp32``): the flash
     forward at every UNet site above (attn1, every gatedSA fuser form,
     the padded-bias fuser, cross-attention, gatedCA, gatedSA2, at every
     level; each on the queries-as-rows kernel, its LSE within
     FP32_LSE_TOL), the fused projections (q/k/v, q,
     the fuser's k/v, to_out, net_2, GEGLU), the LayerNorm at the blocks'
     and the fuser's rows, gn_affine and the fused conv at every ResBlock
     conv, each on fp32 inputs within FP32_REL_TOL of its plain output's
     largest magnitude (TF32 off) and repeated bit for bit, beside SDPA,
     torch.matmul on the products, F.layer_norm or cuDNN's fp32 conv; the
     3xTF32 routes (flash, K2, K6) with their tensor-core bound beside the
     fp32 FMA bound, the flash, K2 and K6 rows with a TF32 witness
     (one-pass TF32 must exceed the limit at one row of each kernel), K6's with its
     whole wrapper call; per level the fused projections (ln_matmuls for q/k/v, for q alone
     and for the fuser's k/v over N+30, N+60 and N+136 rows (and at ds1 over
     N+196 and N+64), matmul_residual for to_out
     and net_2, ln_geglu) and the matmul-only mode of the same kernel
     (mm_only, K7) at the products and rows (16 x 4096) that phase 9's
     projection budget gives it, over the fuser's 16 x 4126 rows and at
     one shape ragged in M, K and F (each projection row with its tile
     configuration, TF/s and share of the bound, and for K2 the time of
     torch.matmul on its products alone); GroupNorm +- SiLU at every UNet and
     VAE map and gn_affine (each row with its route, and a second call
     that must repeat the first bit for bit), the fp32 GroupNorm at every
     map of the inpaint encode and of a request in fp32 (held to
     GN_F32_TOL, repeated bit for bit), LayerNorm at
     every (rows, C) of the module path (the fusers' N+T rows too) and of
     ConvNeXt-tiny at its four widths over 448^2 and 256^2 maps (eps
     1e-6), and the fused GN -> SiLU -> conv3x3
     at every ResBlock conv shape (each row with the conv kernel's own time
     beside the whole call's and cuDNN's bf16 conv alone, its tiles and
     split, TF/s and share of the bound; repeated bit for bit).  Phase 11
     counts each of these calls' CUDA launches.
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
     gradient held to BWD_REL_TOL against the plain backward; and the fp32
     route's tile sweep (``bench_sweep_attn.py --fp32``) at ds1 and ds2,
     B = 4, every configuration of ``F32_CONFIGS`` beside the table, each
     held to FP32_REL_TOL and FP32_LSE_TOL against the plain version.
 10. inpaint from a checkpoint: SD-1.4 GLIGEN's inpainting UNet at full
     width (random de-zeroed weights) written as a reference-format
     checkpoint in memory (``tools/reference_ckpt.py``: model, an ema
     with moved fuser gates, autoencoder, text_encoder under
     ``transformer.``, diffusion, config_dict with a non-default
     linear_start), loaded back with the EMA overlay
     (``inference/cli.py:components_from_checkpoint``): every loaded
     tensor must equal its source bit for bit and the schedule must be the
     config's.  Then two requests of batch 2 at 512^2 with box masks and a
     seeded image, no alpha stages, in configuration (a), with DDIM and
     with PLMS: images sound, launch counts as ``expected_launches``
     predicts for the inpaint UNet, the sampler and the fp32 encode, every
     bf16 flash launch on the TMA route and the encode's attention and
     GroupNorms on the fp32 routes.  Last, the small-width inpaint
     pipeline card vs CPU for both samplers (as phase 5).
 12. grounding modalities (run after 5, in phase 4's host state: a
     profiler session slows the host for the rest of the process): the
     box+text+image model
     (configs/flickr_text_image.yaml) and the keypoint one
     (configs/coco2017K.yaml) at full width, random de-zeroed weights,
     each written as a reference-format checkpoint in memory with its
     tokenizer under the reference's dotted alias and loaded back (every
     tensor bit for bit); a CLIP ViT-L/14 vision tower at full width
     (fp32, random weights through HF's names and convert_clip_vision) and
     a seeded 768 x 768 projection.  Box+text+image grounding from
     ``prepare_batch_box`` and ``FeatureExtractor``: pooled CLIP text
     features of seeded phrase ids and image features of seeded 512^2
     arrays, a box with text, image or both; keypoints from
     ``prepare_batch_kp`` of seeded skeletons with invisible points; each
     through the config's input adapter (reference alias).  Two requests
     of batch 2 at 512^2, PLMS with alpha stages [0.3, 0, 0.7], in
     configuration (a): images sound, launch counts as
     ``expected_launches`` predicts, every flash launch on the TMA route;
     the vision tower's device ms per image.  Then ``SMALL_GROUNDING``'s
     small models (box+text+image, keypoint, gatedCA, gatedSA2) card vs
     CPU (as phase 5).
 13. spatial modalities (run right after 12, in the same host state): the
     hed, canny, depth, normal and sem models (configs/cc3m_hed.yaml,
     cc3m_canny.yaml, cc3m_depth.yaml, diode_normal.yaml, ade_sem.yaml:
     ConvNeXt-tiny tokenizers over 448^2 or 256^2 maps, the grounding
     downsamplers, the widened first conv) at full width, random weights
     de-zeroed down to ConvNeXt's layer scales, each written as a
     reference-format checkpoint in memory (tokenizer and downsampler under
     their dotted names, an in-memory SD first conv) and loaded back (every
     tensor bit for bit).  Two requests of batch 2 at 512^2 each, a seeded
     uint8 map through ``prepare_batch_for`` and the config's input
     adapter, PLMS with the scenario's alpha stages, configuration (a):
     images sound, launch counts as ``expected_launches`` predicts, every
     flash launch on the TMA route; s/img and the tokenizer's ms per
     request (CUDA events, host gaps included).  One hed request in configuration (b), whose count includes
     ConvNeXt's LayerNorms on the LayerNorm kernel.  Then
     ``SMALL_SPATIAL``'s five small models card vs CPU (as phase 5).
 14. fp32 (fault F5; after 13, in the same host state): SD-1.4 GLIGEN
     served in fp32 at full width (random de-zeroed weights), one request
     of batch 2 at 512^2, 10 PLMS steps, alpha stages, in each of
     ``CONFIGS``: the image sound, every kernel launch on its fp32 route,
     as many as ``expected_launches`` predicts, the flash forward's on the
     queries-as-rows kernel but the VAE decoder's d = 512 head; then the small-width
     pipeline in fp32, card vs CPU, held to FP32_REF_MEAN_TOL.
 15. cli (M10; right after 14): ``inference/cli.py`` in this process,
     ``--ckpt random --dezero``, batch 2, 10 steps, configuration (a): the
     reference's scenarios whose inputs are PNGs or none through ``main``,
     the three that read JPEGs through ``run`` with seeded uint8 arrays in
     their place (this machine has no PIL); each PNG written reads back
     (``data/png.py``) equal to ``(img * 255).astype(uint8)`` of the image
     ``generate`` returned, and each scenario launches the path's kernels;
     s/img per scenario.  Then ``tools/bench_matrix.py``'s rows plms50 and
     hed at the users' operating point: batch 8, 50 steps, one repeat.
 11. launches: the CUDA launches of one call of the GroupNorm, gn_affine
     and LayerNorm kernels at every phase-3 shape (the fp32 GroupNorm
     too) and of the conv kernel at every ResBlock conv, read from a
     torch.profiler trace of that call (its launch calls; every device
     record that reaches the trace must answer one of them); each must
     equal what its route or plan predicts (``fused_norm.cuda_launches``,
     ``fused_conv.cuda_launches``).  Last, so that no profiler session
     runs before the timed phases.
 16. trainer (M11b part 1; run after 8, its traced steps after 11):
     ``gligen_tpu_torch.main.main`` in this process on
     ``configs/flickr_text.yaml`` at full width (random weights de-zeroed
     alike in every run), a 16-row TSV written under ``build/`` with PNG
     payloads of 512 x 512, 640 x 512 and 1100 x 800 images and a seeded
     projection matrix, batch 4, EMA, 2 fork workers, the preview on,
     configuration (a), remat full: 6 steps (finite losses, the
     checkpoints the JAX package's rule writes, frozen tensors bit for
     bit, every trainable moved, each step's launches against
     ``expected_train_launches``, every flash launch on the TMA route);
     a resume to 8 restoring the saved state bit for bit; a SIGTERM after
     the first logged step (a checkpoint at that step); the latent cache
     of ``tools/prepare_latents.py``, the loss each way on the same draws;
     the CLI serving the run's EMA shadow (``--train_ckpt --use_ema``),
     one request; s/step with data, the host's decode and collate per
     batch, peak memory, and the device's idle share over two traced
     steps.  Where libjpeg is missing, a JPEG row must raise naming it.
 18. serving (M13; right after 15, in the same host state): phase 4's
     model served by ``serving/server.py``'s ``ServingSession`` (a 25 ms
     batching window) over ``make_server`` on 127.0.0.1 in a thread:
     warmup of buckets 1 and 2 at 512^2 and 1024^2 in the background
     (/ready 503 "warming", then 200); a burst of six batch-1 requests
     (the pipeline calls and their buckets; every image decoded by the
     port's PNG decoder, not constant, within BURST_TOL mean abs pixel of
     its seed sent alone); a 1024^2 request of batch 2 (flash launches
     over 16,384 keys, every one on TMA; peak memory); a malformed body
     (500) and /metrics' counts; one request alone launching what phase
     4's request launches; ``tools/bench_serve_overlap.py`` (pipelined,
     serialized, pipelined again: img/s and the gain); a request's CLIP
     features ready while a batch-8 request is still on the card.  Then
     phase 10's inpaint checkpoint (a drawn sketch and box masks, the
     direct path, the fp32 encode's routes), phase 13's hed checkpoint (a
     map request) and a sem model (a label of 152 answered 500, /health
     still ok), each in a session of its own.  The idle share of a
     pipelined pair, run and then traced, comes after phase 11.
 19. fidelity (M14 part 1): ``tools/fidelity_gate.py`` over the 11
     scenarios at ``--steps`` and batch 1, the fp32 and bf16 arms in
     subprocesses of the CLI; PSNR, proxy-LPIPS and max |dpixel| per
     scenario, each within the budget (LPIPS <= 0.025, PSNR >= 20 dB);
     the JSON under build/chip_smoke_fidelity/.

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
from gligen_tpu_torch.tools.timing import (FP32_FLOP_PER_S, TF32_TENSOR_FLOP_PER_S, bound,
                                           card_line, dezero_, time_ms)

REPO = Path(__file__).resolve().parent
SOURCES = ("flash_fwd", "flash_fwd_sweep", "flash_fwd_f32_sweep", "flash_bwd", "flash_bwd_sweep",
           "fused_proj", "fused_proj_sweep", "fused_norm", "fused_conv", "fused_conv_sweep")

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
# the flash forward's fp32 route vs plain: 3xTF32 products (each ~2^-22 of
# a product dropped) summed in another order, chains of wgmma accumulations
# cut at 12 and 48 steps and summed in fp32, and exp2 to a few fp32 ulps:
# each output within FP32_REL_TOL of the plain output's largest magnitude,
# the LSE (log2 units) within FP32_LSE_TOL.  One-pass TF32 exceeds it
FP32_REL_TOL = 1e-4
FP32_LSE_TOL = 1e-4
# the fp32 GroupNorm vs plain: the same fp32 affine y = x * a + v from sums
# taken in another order, a few fp32 ulps of outputs up to ~5
GN_F32_TOL = 1e-5
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
# Phase 12 (c)'s small models: (SMALL's UNet keywords replaced, the
# tokenizer, its box count): the box+text+image and keypoint tokenizers, and
# the gatedCA and gatedSA2 fusers over box+text (gatedSA2 over a square
# count, 4 x 4 boxes).
SMALL_GROUNDING = {
    "text_image": ({"grounding_tokenizer": {"target": "text_image",
                                            "params": {"in_dim": 64, "out_dim": 64}}},
                   "text_image", 30),
    "keypoint": ({"grounding_tokenizer": {"target": "keypoint",
                                          "params": {"max_persons_per_image": 8,
                                                     "out_dim": 64}}}, "keypoint", 0),
    "gatedCA": ({"fuser_type": "gatedCA"}, "text", 30),
    "gatedSA2": ({"fuser_type": "gatedSA2"}, "text", 16),
}


def ptxas_configs(report: str) -> list:
    """(kernel, registers, spill stores, spill loads) of every tile
    configuration in a ``-Xptxas -v`` report: ``fused_proj_kernel<MODE, BM,
    BN, STAGES>``, ``conv3x3_kernel<BM, BN, STAGES>`` and the fp32 routes'
    ``proj_tf32_kernel<MODE, BM, BN, STAGES, PANEL>`` and
    ``conv3x3_tf32_kernel<BM, BN, STAGES>``, and the flash forward's fp32
    ``flash_fwd_f32_qm_kernel<D, NW, BK, NBUF>`` (its ``f32qm::Cfg``), each
    name read back from the mangled one (a bool argument as 0 or 1)."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            tpl = re.search(r"(fused_proj_kernel|conv3x3_kernel|proj_tf32_kernel|"
                            r"conv3x3_tf32_kernel)I((?:L[ib]\d+E)+)E", entry.group(1)) or \
                re.search(r"(flash_fwd_f32_qm_kernel)I\w*?CfgI((?:L[ib]\d+E)+)E", entry.group(1))
            name = (f"{tpl.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', tpl.group(2)))}>"
                    if tpl else None)
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


# grounding tokens of each tokenizer at its released size: 30 boxes (text);
# 2 x 30 (text_image: a text and an image token per box); 8 persons x 17
# (keypoint); and a 6 x 6 count for gatedSA2, which needs a square one
GROUNDING_TOKENS = {"text": 30, "text_image": 60, "keypoint": 136}
GATED_SA2_TOKENS = 36
# the spatial tokenizers' (resize_input / 32)^2 tokens: hed, canny, depth and
# normal at 448^2, sem at 256^2
SPATIAL_TOKENS = {"spatial": 196, "sem": 64}
# ConvNeXt-tiny's stage widths, each LayerNorm's input a (H/4 / 2^i)^2 map
CONVNEXT_WIDTHS = (96, 192, 384, 768)


def kernel_cases(batch: int):
    """(name, rows, N, M, heads, head dim, padded-key bias) of every
    flash launch shape at 512^2 (latent 64), SD-1.4 widths: attn1, the
    gatedSA fuser over N+30, N+60 and N+136 keys, cross-attention, the
    gatedCA fuser (N queries over 30, 60 or 136 grounding keys), the
    gatedSA2 fuser (36 grounding queries over N+36 keys), and the gatedSA
    fuser over the spatial tokenizers' N+196 and N+64."""
    rows = 2 * batch  # CFG pair in one UNet call
    cases = []
    for level, (n, d) in {"ds1": (4096, 40), "ds2": (1024, 80), "ds4": (256, 160),
                          "mid": (64, 160)}.items():
        cases += [
            (f"attn1_{level}", rows, n, n, 8, d, False),
            (f"fuser_{level}", rows, n, n + 30, 8, d, False),
            (f"cross_{level}", rows, n, 77, 8, d, False),
            (f"fuser_text_image_{level}", rows, n, n + GROUNDING_TOKENS["text_image"], 8, d,
             False),
            (f"fuser_keypoint_{level}", rows, n, n + GROUNDING_TOKENS["keypoint"], 8, d, False),
        ]
        cases += [(f"gated_ca_{t}_{level}", rows, n, t, 8, d, False)
                  for t in GROUNDING_TOKENS.values()]
        cases.append((f"gated_sa2_{level}", rows, GATED_SA2_TOKENS, n + GATED_SA2_TOKENS, 8, d,
                      False))
        cases += [(f"fuser_{name}_{level}", rows, n, n + t, 8, d, False)
                  for name, t in SPATIAL_TOKENS.items()]
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


def check_kernel_f32(torch, device, batch):
    """The flash forward's fp32 route at the inpaint encode's VAE head,
    (batch, 4096, 1x512) fp32, and at a ragged (1, 1000, 1x512) against
    1030 keys: each against the plain version on the same fp32 tensors
    (TF32 off), a second call bit for bit the first, beside SDPA in fp32.

    Each row prints a TF32 witness, held to nothing: the plain version's
    own error with one-pass TF32 products (``allow_tf32``) on the same
    inputs.  At least one row's witness must exceed its limit, or the rows
    could not tell the kernel's fp32 from TF32.  Each row prints two
    bounds: the 3xTF32 tensor-core arithmetic the kernel does (3 x 4 B H N
    M d at TF32_TENSOR_FLOP_PER_S; its share of the bound is taken against
    this one) and the fp32 FMA rate's."""
    from gligen_tpu_torch.ops.flash_attention import flash_attention_plain, flash_fwd

    gen = torch.Generator(device=device).manual_seed(6)
    results = []
    for name, b, n, m in (("vae_mid_fp32", batch, 4096, 4096), ("ragged_fp32", 1, 1000, 1030)):
        h, d = 1, 512
        q, k, v = (torch.randn((b, L, h * d), generator=gen, device=device) for L in (n, m, m))
        km = flash_fwd.fp32_kernels["km"]
        route, (out, lse) = routed(flash_fwd, lambda: flash_fwd(q, k, v, h))
        torch.cuda.synchronize()
        km = flash_fwd.fp32_kernels["km"] - km  # the keys-as-rows kernel, d = 512's
        want, want_lse = flash_attention_plain(q, k, v, h)
        err = (out - want).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        repeats = all(torch.equal(x, y) for x, y in zip((out, lse), flash_fwd(q, k, v, h)))
        finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
        limit = FP32_REL_TOL * want.abs().max().item()
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            witness = (flash_attention_plain(q, k, v, h)[0] - want).abs().max().item()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        ms = time_ms(lambda: flash_fwd(q, k, v, h))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, h))
        library_ms = time_ms(lambda: sdpa(torch, q, k, v, h, None))
        flops = 4 * b * h * n * m * d
        nbytes = 4 * (2 * b * n * h * d + 2 * b * m * h * d) + 4 * b * h * n
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_TENSOR_FLOP_PER_S)
        fma_ms, fma_by = bound(nbytes, flops, FP32_FLOP_PER_S)
        ok = (finite and err <= limit and lse_err <= FP32_LSE_TOL and repeats and route == "fp32"
              and km == 1 and out.dtype == torch.float32)
        print(f"kernel {name:18s} q ({b},{n},{h}x{d}) kv {m} fp32: max_abs_err {err:.3e} (tol "
              f"{limit:.3e}) lse_err {lse_err:.3e} (tol {FP32_LSE_TOL}) repeats {repeats} route "
              f"{route} (keys-as-rows kernel: {km} launch) TF32 witness {witness:.3e} "
              f"({witness / limit:.2f}x the tol) kernel "
              f"{ms:.4f} ms {flops / ms / 1e9:.1f} TF/s {100 * bound_ms / ms:.1f}% of bound; plain "
              f"{plain_ms:.4f} ms sdpa fp32 {library_ms:.4f} ms bound {bound_ms:.4f} ms (3xTF32 "
              f"{bound_by}, the kernel's) fp32 FMA bound {fma_ms:.4f} ms ({fma_by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind="flash_fwd_fp32", err=err, lse_err=lse_err, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, route=route, ok=ok, limit=limit,
                            tf32_witness=witness))
        del q, k, v, out, lse, want, want_lse
    if not any(r["tf32_witness"] > r["limit"] for r in results):
        print("kernel flash_fwd_fp32: one-pass TF32 is within every row's tol, so the rows cannot "
              "tell fp32 from TF32 FAIL", flush=True)
        for r in results:
            r["ok"] = False
    torch.cuda.empty_cache()
    return results


# The fp32 routes of a model served in fp32 (phase 14's path): the flash
# forward at every UNet attention site of kernel_cases (attn1, cross, the
# gatedSA fuser over every tokenizer's keys and padded with a bias row,
# gatedCA, gatedSA2, at every level), the fused projections (K2), the
# LayerNorm, gn_affine and the fused conv (K6), each held to FP32_REL_TOL of
# its plain output's largest magnitude (TF32 off) and repeated bit for bit.
FP32_PROJ = ("qkv", "q", "fuser_kv", "to_out", "net_2", "geglu")


def check_fp32(torch, unet, device, batch):
    """Phase 3's fp32 rows (fault F5): every fp32 route on fp32 card tensors
    at the shapes a 512^2 request in fp32 gives it, against its plain
    version (TF32 off), a second call bit for bit the first; beside the
    library call that computes the same function in fp32 with TF32 off
    (SDPA, ``F.layer_norm``, cuDNN's fp32 conv; the products alone by
    ``torch.matmul`` for K2, which no one call computes), and the bound:
    operations at the fp32 FMA rate, or bytes; the 3xTF32 routes' (flash,
    K2, K6) at their tensor-core arithmetic, 3 x the operations at
    TF32_TENSOR_FLOP_PER_S, with the fp32 FMA bound beside it.

    The flash forward's, K2's and K6's rows print a TF32 witness, held to
    nothing: the plain function with one-pass TF32 products
    (``allow_tf32``) on the same inputs, against the plain version.  For
    each of the five kernels at least one row's witness must exceed its
    limit, or the rows could not tell the kernel's fp32 from TF32.  Every
    flash row must launch the queries-as-rows kernel
    (``flash_fwd.fp32_kernels["qm"]``).  K6's rows add the whole wrapper
    call (``call_ms``: gn_affine and the weight's permute included)."""
    import contextlib

    import torch.nn.functional as F
    from gligen_tpu_torch.ops import flash_attention as fa
    from gligen_tpu_torch.ops import fused_conv as fc
    from gligen_tpu_torch.ops import fused_norm as fn
    from gligen_tpu_torch.ops import fused_proj as fp
    from gligen_tpu_torch.ops.basic import layer_norm_xla

    gen = torch.Generator(device=device).manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    @contextlib.contextmanager
    def tf32_on():
        before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before

    results = []

    def record(kind, name, desc, wrapper, call, plain, library, nbytes, ops, rate=FP32_FLOP_PER_S,
               tc=False, witness=None, whole=None, count=None):
        count = count or (lambda: wrapper.routes["fp32"])  # the launches that must be one
        before = count()
        got = call()
        torch.cuda.synchronize()
        launched = count() - before
        want = plain()
        again = call()
        got, want, again = ((t if isinstance(t, tuple) else (t,)) for t in (got, want, again))
        repeats = all(torch.equal(g, a) for g, a in zip(got, again))
        finite = all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in got)
        extra, lse_err = "", 0.0
        if kind.startswith("flash"):  # (out, lse): the LSE held to FP32_LSE_TOL on its own
            lse_err = (got[1] - want[1]).abs().max().item()
            extra = f" lse_err {lse_err:.3e} (tol {FP32_LSE_TOL})"
            got, want = got[:1], want[:1]
        limit = FP32_REL_TOL * max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok = launched == 1 and repeats and err <= limit and lse_err <= FP32_LSE_TOL and finite
        if witness is not None:
            with tf32_on():
                seen = witness()
            seen = seen if isinstance(seen, tuple) else (seen,)
            seen = max((a - w).abs().max().item() for a, w in zip(seen, want))
            extra += f" TF32 witness {seen:.3e} ({seen / limit:.2f}x the tol)"
        ms, plain_ms = time_ms(call), time_ms(plain)
        library_ms = None if library is None else time_ms(library)
        call_ms = None if whole is None else time_ms(whole)
        if tc:  # 3xTF32: the tensor cores' three products, and the fp32 FMA bound beside
            bound_ms, bound_by = bound(nbytes, 3 * ops, TF32_TENSOR_FLOP_PER_S)
            fma_ms, fma_by = bound(nbytes, ops, FP32_FLOP_PER_S)
            bounds = (f"bound {bound_ms:.4f} ms (3xTF32 {bound_by}, the kernel's) fp32 FMA bound "
                      f"{fma_ms:.4f} ms ({fma_by})")
        else:
            bound_ms, bound_by = bound(nbytes, ops, rate)
            bounds = f"bound {bound_ms:.4f} ms ({bound_by})"
        lib = "" if library is None else f" library {library_ms:.4f} ms"
        lib += "" if whole is None else f" whole call {call_ms:.4f} ms"
        print(f"kernel {kind:20s} {name:18s} {desc:34s}: max_abs_err {err:.3e} (tol {limit:.3e}; "
              f"repeats bit for bit: {repeats}){extra} kernel {ms:.4f} ms "
              f"{(3 * ops if tc else ops) / ms / 1e9:.1f} TF/s {100 * bound_ms / ms:.1f}% of "
              f"bound; plain {plain_ms:.4f} ms{lib} {bounds} {'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind=kind, err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, ok=ok,
                            limit=limit))
        if tc:
            results[-1]["fma_bound_ms"] = fma_ms
        if witness is not None:
            results[-1]["tf32_witness"] = seen
        if whole is not None:
            results[-1]["call_ms"] = call_ms

    # the flash forward's fp32 route (3xTF32, the queries-as-rows kernel) at
    # every UNet site
    for name, b, n, m, h, d, padbias in kernel_cases(batch):
        if d > 160:
            continue
        q, k, v = (randn(b, L, h * d) for L in (n, m, m))
        bias = None
        if padbias:
            bias = torch.zeros((b, m), device=device)
            bias[:, n + 30:] = fa.NEG_INF
        flops = 4 * b * h * n * m * d
        nbytes = 4 * (2 * b * n * h * d + 2 * b * m * h * d) + 4 * b * h * n
        nbytes += 0 if bias is None else 4 * b * m
        record("flash_fwd_fp32_qm", f"{name}_fp32", f"q ({b},{n},{h}x{d}) kv {m}"
               + (" bias" if padbias else ""), fa.flash_fwd,
               lambda: fa.flash_fwd(q, k, v, h, bias=bias),
               lambda: fa.flash_attention_plain(q, k, v, h, bias=bias),
               lambda: sdpa(torch, q, k, v, h, bias), nbytes, flops, tc=True,
               witness=lambda: fa.flash_attention_plain(q, k, v, h, bias=bias),
               count=lambda: fa.flash_fwd.fp32_kernels["qm"])
        del q, k, v, bias
    # K2's fp32 route (3xTF32) at every level
    for name, kind, b, n, c, k in proj_cases(batch):
        if name.rsplit("_", 1)[0] not in FP32_PROJ:
            continue
        x, m = randn(b, n, c, scale=2.0) + 0.3, b * n
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        if kind == "ln_matmuls":
            ws = [randn(c, c, scale=c**-0.5) for _ in range(k)]
            args, products, desc = (x, s, sb, ws), [(x, w) for w in ws], f"x ({b},{n},{c}) -> {k} x {c}"
            nbytes, flops = 4 * (m * c * (1 + k) + 2 * c + k * c * c), 2 * m * c * c * k
            witness = lambda: tuple(layer_norm_xla(x, s, sb) @ w.T for w in ws)
        elif kind == "matmul_residual":
            h = randn(b, n, k)
            gate = torch.tensor(0.37, device=device) if k == c else None
            w, wb = randn(c, k, scale=k**-0.5), randn(c, scale=0.1)
            args, products, desc = (h, w, wb, x, gate), [(h, w)], f"h ({b},{n},{k}) -> {c}"
            nbytes, flops = 4 * (m * (k + 2 * c) + c * k + c + 1), 2 * m * k * c
            witness = lambda: x + (1.0 if gate is None else gate) * (h @ w.T + wb)
        else:
            w, wb = randn(8 * c, c, scale=c**-0.5), randn(8 * c, scale=0.1)
            args, products = (x, s, sb, w, wb), [(x, w)]
            desc = f"x ({b},{n},{c}) -> {8 * c} -> {4 * c}"
            nbytes, flops = 4 * (m * 5 * c + 2 * c + 8 * c * c + 8 * c), 16 * m * c * c

            def witness():
                a, g = (layer_norm_xla(x, s, sb) @ w.T + wb).chunk(2, dim=-1)
                return a * F.gelu(g)
        kernel, plain = fp.KERNELS[kind], getattr(fp, f"{kind}_plain")
        record(f"{kind}_fp32", f"{name}_fp32", desc, kernel, lambda: kernel(*args),
               lambda: plain(*args), lambda: [torch.matmul(a, w.T) for a, w in products],
               nbytes, flops, tc=True, witness=witness)
        del x, args, products, witness
    # the LayerNorm's fp32 route at the module path's rows
    for name, rows, c, eps in ln_cases(batch):
        if name.rsplit("_", 1)[0] not in ("ln", "ln_fuser"):
            continue
        x = randn(rows, c, scale=2.0) + 0.3
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        record("layer_norm_fp32", f"{name}_fp32", f"x ({rows}, {c}) eps {eps:g}",
               fn.layer_norm_fused, lambda: fn.layer_norm_fused(x, s, sb, eps),
               lambda: fn.layer_norm_plain(x, s, sb, eps), lambda: F.layer_norm(x, (c,), s, sb, eps),
               8 * rows * c + 8 * c, 7 * rows * c)
        del x
    # the fused conv's fp32 route (3xTF32), and its statistics (gn_affine's),
    # at every ResBlock conv
    seen = set()
    for name, b, h, cin, cout, residual in conv_cases(unet, batch):
        x = grouped_input(randn, (b, h, h, cin), torch.float32)
        s, sb = 1.0 + randn(cin, scale=0.1), randn(cin, scale=0.1)
        w, wb = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), randn(cout, scale=0.1)
        res = randn(b, h, h, cout) if residual else None
        numel, m = b * h * h * cin, b * h * h
        if (h, cin) not in seen:
            seen.add((h, cin))
            record("gn_affine_fp32", f"res_{h}x{cin}_fp32", f"x ({b},{h},{h},{cin}) -> a, v",
                   fn.gn_affine, lambda: fn.gn_affine(x, s, sb), lambda: fn.gn_affine_plain(x, s, sb),
                   None, 4 * numel + 8 * cin + 8 * b * cin, 3 * numel)
        a, v = fn.gn_affine_plain(x, s, sb)
        wt = w.permute(0, 2, 3, 1).contiguous()
        xn = F.silu(x * a[:, None, None, :] + v[:, None, None, :]).permute(0, 3, 1, 2)
        wcl = w.contiguous(memory_format=torch.channels_last)

        def witness():
            out = F.conv2d(xn, w, wb, padding=1).permute(0, 2, 3, 1)
            return out if res is None else out + res
        record("gn_silu_conv3x3_fp32", f"{name}_fp32",
               f"({b},{h},{h},{cin}) -> {cout}{' + res' if residual else ''}",
               fc.gn_silu_conv3x3, lambda: fc.gn_silu_conv3x3.conv(x, a, v, wt, wb, res),
               lambda: fc._ref_chain(x, a, v, w, wb, res),
               lambda: F.conv2d(xn, wcl, wb, padding=1),
               4 * (m * cin + 2 * b * cin + 9 * cin * cout + cout + m * cout * (1 + residual)),
               2 * m * cout * 9 * cin, tc=True, witness=witness,
               whole=lambda: fc.gn_silu_conv3x3(x, s, sb, w, wb, res))
        del x, w, res, xn, wcl, wt, witness
    for kind in ("flash_fwd_fp32_qm", "ln_matmuls_fp32", "matmul_residual_fp32", "ln_geglu_fp32",
                 "gn_silu_conv3x3_fp32"):
        rows = [r for r in results if r["kind"] == kind]
        if not any(r["tf32_witness"] > r["limit"] for r in rows):
            print(f"kernel {kind}: one-pass TF32 is within every row's tol, so the rows cannot "
                  f"tell fp32 from TF32 FAIL", flush=True)
            for r in rows:
                r["ok"] = False
    torch.cuda.empty_cache()
    return results


# (tokens, channels) of the transformer blocks at 512^2 (latent 64), SD-1.4
LEVELS = {"ds1": (4096, 320), "ds2": (1024, 640), "ds4": (256, 1280), "mid": (64, 1280)}


def proj_cases(batch: int):
    """(name, kernel, rows, N, C, K or weights) of every fused-projection
    launch shape at 512^2: 2*batch UNet rows of N tokens each; the gatedSA
    fuser's k/v over N+30, N+60 and N+136 rows, and over the spatial
    tokenizers' N+196 and N+64."""
    rows = 2 * batch
    cases = []
    for level, (n, c) in LEVELS.items():
        cases += [
            (f"qkv_{level}", "ln_matmuls", rows, n, c, 3),
            (f"q_{level}", "ln_matmuls", rows, n, c, 1),
            (f"fuser_kv_{level}", "ln_matmuls", rows, n + 30, c, 2),
            (f"fuser_kv_text_image_{level}", "ln_matmuls", rows,
             n + GROUNDING_TOKENS["text_image"], c, 2),
            (f"fuser_kv_keypoint_{level}", "ln_matmuls", rows, n + GROUNDING_TOKENS["keypoint"],
             c, 2),
            (f"to_out_{level}", "matmul_residual", rows, n, c, c),
            (f"net_2_{level}", "matmul_residual", rows, n, c, 4 * c),
            (f"geglu_{level}", "ln_geglu", rows, n, c, None),
        ]
        cases += [(f"fuser_kv_{name}_{level}", "ln_matmuls", rows, n + t, c, 2)
                  for name, t in SPATIAL_TOKENS.items()]
    return cases


# The batch of phase 9's tools: the JAX tools' CFG batch, and K7's only
# path (bench_proj.py) runs at it, so phase 3 holds K7 at its rows.
TOOLS_BATCH = 16


# phase 9's flash tile sweep: (BQ, BK, stages) beside the fixed table's
SWEEP_CONFIGS = ((64, 128, 2), (128, 64, 3), (128, 128, 2))
# the profiler categories (perf_probe.category) of each GroupNorm route's kernels
GN_CATEGORIES = {"one": ("group_norm one launch (K5)",),
                 "three": ("group_norm stats (K5)", "group_norm normalise (K5)")}
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


def grouped_input(randn, shape, dtype=None):
    """A bf16 (or ``dtype``) (B, ..., C) GroupNorm input whose every (sample, channel)
    has a mean and a spread of its own: N(mu[b, c], sigma[b, c]^2), with mu
    a per-sample N(0, 1) offset plus a per-channel N(0, 1) and sigma from
    0.37 to 2.7.  So every (sample, group) has statistics of its own, and a
    kernel that reads another group's or sample's fails the comparison."""
    import torch

    b, c = shape[0], shape[-1]
    view = (b,) + (1,) * (len(shape) - 2) + (c,)
    mu, sigma = randn(b, 1) + randn(b, c), (0.5 * randn(b, c)).exp()
    return (randn(*shape) * sigma.view(view) + mu.view(view)).to(dtype or torch.bfloat16)


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


def encoder_norms(vae, size: int):
    """(H, C, SiLU) of every GroupNorm of one VAE encode of ``size``^2
    images, walking the encoder's blocks in order."""
    from gligen_tpu_torch.models.vae import AttnBlock, Downsample, ResnetBlock

    enc, out = vae.encoder, []
    for name in [*enc.down_names, "mid_block_1", "mid_attn_1", "mid_block_2"]:
        m = getattr(enc, name)
        if isinstance(m, ResnetBlock):
            out += [(size, m.norm1.weight.numel(), True), (size, m.norm2.weight.numel(), True)]
        elif isinstance(m, AttnBlock):
            out.append((size, m.norm.weight.numel(), False))
        elif isinstance(m, Downsample):
            size //= 2
    return out + [(size, enc.norm_out.weight.numel(), True)]


def f32_norm_cases(vae, batch: int, size: int = 512):
    """(name, shape, SiLU, eps) of every distinct fp32 GroupNorm input of
    the inpaint encode at ``size``^2 on ``batch`` rows, and the top map
    without SiLU, where F.group_norm computes the same function."""
    norms = encoder_norms(vae, size)
    cases = {f"enc_{h}x{c}{'' if silu else '_attn'}": ((batch, h, h, c), silu, 1e-6)
             for h, c, silu in norms}
    h, c, _ = norms[0]
    cases[f"enc_{h}x{c}_gn"] = ((batch, h, h, c), False, 1e-6)
    return [(name, *case) for name, case in cases.items()]


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
    """(name, rows, C, eps) of the module path's LayerNorms at 512^2: every
    block's N rows (gatedCA's norm1 too), and the gatedSA and gatedSA2
    fusers' N+T (T = 30, 60, 136 grounding tokens; 196 and 64 spatial
    ones), eps 1e-5; and
    ConvNeXt-tiny's (eps 1e-6) in a spatial tokenizer's forward over
    ``batch`` maps at 448^2 and (sem) 256^2: (batch * (S/4 / 2^i)^2, width
    i) for its four widths."""
    cases = []
    for level, (n, c) in LEVELS.items():
        cases += [(f"ln_{level}", 2 * batch * n, c, 1e-5),
                  (f"ln_fuser_{level}", 2 * batch * (n + 30), c, 1e-5)]
        cases += [(f"ln_fuser_{name}_{level}", 2 * batch * (n + t), c, 1e-5)
                  for name, t in {**GROUNDING_TOKENS, **SPATIAL_TOKENS}.items()
                  if name != "text"]
    for size in (448, 256):
        cases += [(f"ln_convnext_{size}_{c}", batch * (size // 4 >> i) ** 2, c, 1e-6)
                  for i, c in enumerate(CONVNEXT_WIDTHS)]
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


def check_norms(torch, gn, ln, device, gn32=()):
    """The GroupNorm kernel (+- SiLU) and gn_affine at every GroupNorm map,
    the fp32 GroupNorm at every map of ``gn32``, and the LayerNorm kernel at
    every LayerNorm shape, against their plain versions on the same card
    tensors, with the library's F.group_norm / F.layer_norm where it
    computes the same function (no SiLU).  The GroupNorm inputs come from
    ``grouped_input``; gn_affine's fp32 (a, v) is held to AFFINE_TOL, the
    fp32 GroupNorm to GN_F32_TOL."""
    import torch.nn.functional as F
    from gligen_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device=device).manual_seed(4)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    results = []

    def record(kind, name, desc, got, want, kernel, plain, library, nbytes, ops,
               tol=(PROJ_ATOL, PROJ_RTOL), route=None, again=None):
        err, ok = compare(torch, got, want, *tol)
        repeats = again is None or all(
            torch.equal(g, a) for g, a in zip(*(t if isinstance(t, tuple) else (t,)
                                                for t in (got, again))))
        ok = ok and repeats
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        library_ms = None if library is None else time_ms(library)
        bound_ms, bound_by = bound(nbytes, ops, FP32_FLOP_PER_S)
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        print(f"kernel {kind:11s} {name:22s} {desc:34s}: max_abs_err {err:.3e} "
              f"(tol {tol[0]} + {tol[1]} rel{'' if again is None else f'; repeats: {repeats}'}) "
              f"{'' if route is None else f'route {route} '}kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms{lib} bound {bound_ms:.4f} ms ({bound_by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind=kind, err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, ok=ok))

    for fp32, name, shape, silu, eps in [(False, *g) for g in gn] + [(True, *g) for g in gn32]:
        c = shape[-1]
        numel = 1
        for d in shape:
            numel *= d
        x = grouped_input(randn, shape, torch.float32 if fp32 else None)
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        args = (x, s, sb, 32, eps)
        library = None
        if not silu:  # the library's GroupNorm on the (B, C, N) view of the same tensor
            xc, sc, bc = x.reshape(shape[0], -1, c).transpose(1, 2), s.to(x.dtype), sb.to(x.dtype)
            library = lambda: F.group_norm(xc, 32, sc, bc, eps)
        rows = numel // (shape[0] * c)
        route = "fp32" if fp32 else fn.gn_plan(shape[0], rows, c)[0]
        record("group_norm_fp32" if fp32 else "group_norm", name,
               f"x {shape} {'fp32 ' if fp32 else ''}{'+ SiLU ' if silu else ''}eps {eps:g}",
               fn.group_norm_fused(*args, silu=silu), fn.group_norm_plain(*args, silu=silu),
               lambda: fn.group_norm_fused(*args, silu=silu),
               lambda: fn.group_norm_plain(*args, silu=silu), library,
               x.element_size() * 2 * numel + 8 * c, (9 if silu else 5) * numel,
               (GN_F32_TOL, 0.0) if fp32 else (PROJ_ATOL, PROJ_RTOL),
               route=route, again=fn.group_norm_fused(*args, silu=silu))
        if name.startswith("res_"):  # the fused conv's inputs take gn_affine
            record("gn_affine", name, f"x {shape} -> a, v ({shape[0]}, {c})",
                   fn.gn_affine(*args), fn.gn_affine_plain(*args),
                   lambda: fn.gn_affine(*args), lambda: fn.gn_affine_plain(*args), None,
                   2 * numel + 8 * c + 8 * shape[0] * c, 3 * numel, (AFFINE_TOL, AFFINE_TOL),
                   route=fn.gn_plan(shape[0], rows, c, normalise=False)[0],
                   again=fn.gn_affine(*args))
        del x, args, library
    for name, rows, c, eps in ln:
        x = randn(rows, c, scale=2.0, dtype=torch.bfloat16) + 0.3
        s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
        sc, bc = s.to(x.dtype), sb.to(x.dtype)
        record("layer_norm", name, f"x ({rows}, {c}) eps {eps:g}",
               fn.layer_norm_fused(x, s, sb, eps), fn.layer_norm_plain(x, s, sb, eps),
               lambda: fn.layer_norm_fused(x, s, sb, eps),
               lambda: fn.layer_norm_plain(x, s, sb, eps),
               lambda: F.layer_norm(x, (c,), sc, bc, eps), 4 * rows * c + 8 * c, 7 * rows * c)
        del x
    torch.cuda.empty_cache()
    return results


def check_convs(torch, cases, device):
    """The fused GN -> SiLU -> conv3x3 (gn_affine's kernel and the conv
    kernel) against its plain version on the same card tensors: bf16
    activations with statistics of their own per (sample, channel)
    (``grouped_input``) and a bf16 residual, the model's fp32 parameters
    (cast at each call), weights of std (9 C)^-1/2 so that outputs stay
    O(1); a second call must give the same bits.  The conv kernel alone
    (the weight already bf16 (F, 3, 3, C), a and v given) against
    ``_ref_chain`` from the same a and v, with its tiles and split, TF/s and
    share of the bound, beside the whole call and cuDNN's bf16 conv alone
    (channels_last, on the activated input) as its library time."""
    import torch.nn.functional as F
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
        repeats = torch.equal(got, fc.gn_silu_conv3x3(*args))
        # the conv kernel alone, on the wrapper's own operands
        a, v = fc.gn_affine(x, s, sb)
        wt, wbf = w.to(x.dtype).permute(0, 2, 3, 1).contiguous(), wb.float()
        conv_args = (x, a, v, wt, wbf, res)
        conv_err, conv_ok = compare(torch, fc.gn_silu_conv3x3.conv(*conv_args),
                                    fc._ref_chain(x, a, v, w, wb, res))
        xn = F.silu(x.float() * a[:, None, None, :] + v[:, None, None, :]).to(x.dtype)
        xn = xn.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        wcl = w.to(x.dtype).contiguous(memory_format=torch.channels_last)
        wbb = wb.to(x.dtype)
        ms = time_ms(lambda: fc.gn_silu_conv3x3.conv(*conv_args))
        call_ms = time_ms(lambda: fc.gn_silu_conv3x3(*args))
        plain_ms = time_ms(lambda: fc._ref_chain(x, a, v, w, wb, res))
        library_ms = time_ms(lambda: F.conv2d(xn, wcl, wbb, padding=1))
        m = b * h * h
        plan = fc.conv_plan(b, h, h, cin, cout)
        # each input read once, the output written once: x, a and v, the
        # bf16 weights, the fp32 bias, the residual
        nbytes = (2 * m * cin + 8 * b * cin + 2 * 9 * cin * cout + 4 * cout
                  + 2 * m * cout * (1 + residual))
        flops = 2 * m * cout * 9 * cin
        bound_ms, bound_by = bound(nbytes, flops)
        ok = ok and conv_ok and repeats
        print(f"kernel gn_silu_conv3x3 {name:16s} ({b},{h},{h},{cin}) -> {cout}"
              f"{' + residual' if residual else ''}: max_abs_err {max(err, conv_err):.3e} (tol "
              f"{PROJ_ATOL} + {PROJ_RTOL} rel; repeats bit for bit: {repeats}) tiles "
              f"{'x'.join(map(str, plan[:3]))} split {plan[3]} kernel {ms:.4f} ms "
              f"{flops / ms / 1e9:.1f} TF/s "
              f"{100 * bound_ms / ms:.1f}% of bound; call with gn_affine {call_ms:.4f} ms; "
              f"plain {plain_ms:.4f} ms cuDNN bf16 conv alone {library_ms:.4f} ms "
              f"(kernel/cuDNN {ms / library_ms:.2f}) bound {bound_ms:.4f} ms ({bound_by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        results.append(dict(name=name, kind="gn_silu_conv3x3", err=max(err, conv_err), ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, ok=ok, call_ms=call_ms, plan=plan))
        del x, w, res, args, got, conv_args, xn, wcl
    torch.cuda.empty_cache()
    return results


def check_launches(torch, gn, ln, convs, device, gn32=()):
    """Phase 11: the CUDA launches (kernels, copies, memsets) of one call of
    the GroupNorm and gn_affine kernels at every GroupNorm map, of the
    LayerNorm kernel at every LayerNorm shape and of the conv kernel at
    every ResBlock conv, read from a torch.profiler trace of that call,
    against what the route (``fused_norm.gn_plan``, ``cuda_launches``) or
    the plan (``fused_conv.conv_plan``, ``cuda_launches``) predicts.  What
    is launched does not depend on the values: zeros.

    The count is the trace's launch calls (``perf_probe.launch_calls``),
    which the host records as it makes them.  CUPTI may drop the device's
    records of the same work (see ``perf_probe.traced``): each record that
    arrives must answer a counted launch call, no two the same one; the
    row says how many arrived and the last line how many in all.  Returns
    (failures, lines)."""
    from gligen_tpu_torch.ops import fused_conv as fc
    from gligen_tpu_torch.ops import fused_norm as fn
    from gligen_tpu_torch.tools.perf_probe import launch_calls, traced

    def zeros(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    failures, lines, arrived = [], [], [0, 0]

    def row(kind, name, desc, call, want, why):
        call()  # warm: the traced call launches only its own work
        torch.cuda.synchronize()
        calls, records = launch_calls(traced(lambda: (call(), torch.cuda.synchronize()))[1])
        got = len(calls)
        corrs = [c for c, _ in records]
        answered = all(c in calls for c in corrs) and len(set(corrs)) == len(corrs)
        arrived[0] += len(records)
        arrived[1] += got
        ok = got == want and answered
        lines.append(f"launches: {kind:15s} {name:22s} {desc:28s}: {got} CUDA "
                     f"launch{'' if got == 1 else 'es'} per call (profiled; {why} predicts "
                     f"{want}; device records {len(records)}, each answering a launch "
                     f"{answered}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"launches {kind} {name}")
            lines.append(f"launches:   launch calls {sorted(calls.items())}, device records "
                         f"(correlation, start) {records}")

    for name, shape, silu, eps in gn:
        b, c = shape[0], shape[-1]
        x, s = zeros(*shape), zeros(c, dtype=torch.float32)
        rows = x.numel() // (b * c)
        route = fn.gn_plan(b, rows, c)[0]
        row("group_norm", name, f"x {shape}", lambda: fn.group_norm_fused(x, s, s, 32, eps, silu),
            fn.cuda_launches(route, True), f"route {route}")
        if name.startswith("res_"):
            route = fn.gn_plan(b, rows, c, normalise=False)[0]
            row("gn_affine", name, f"x {shape}", lambda: fn.gn_affine(x, s, s, 32, eps),
                fn.cuda_launches(route, False), f"route {route}")
    for name, shape, silu, eps in gn32:  # the fp32 route: three launches
        x, s = zeros(*shape, dtype=torch.float32), zeros(shape[-1], dtype=torch.float32)
        row("group_norm_fp32", name, f"x {shape}",
            lambda: fn.group_norm_fused(x, s, s, 32, eps, silu), fn.cuda_launches("three", True),
            "the fp32 route (three)")
    for name, rows, c, eps in ln:
        x, s = zeros(rows, c), zeros(c, dtype=torch.float32)
        row("layer_norm", name, f"x ({rows}, {c})", lambda: fn.layer_norm_fused(x, s, s, eps), 1,
            "one pass")
    for name, b, h, cin, cout, residual in convs:
        x, a = zeros(b, h, h, cin), zeros(b, cin, dtype=torch.float32)
        wt, wb = zeros(cout, 3, 3, cin), zeros(cout, dtype=torch.float32)
        res = zeros(b, h, h, cout) if residual else None
        plan = fc.conv_plan(b, h, h, cin, cout)
        row("gn_silu_conv3x3", name, f"({b},{h},{h},{cin}) -> {cout}",
            lambda: fc.gn_silu_conv3x3.conv(x, a, a, wt, wb, res), fc.cuda_launches(plan),
            f"plan {'x'.join(map(str, plan[:3]))} split {plan[3]}")
    del x, s
    torch.cuda.empty_cache()
    lines.append(f"launches: {arrived[0]} device records reached the traces of "
                 f"{arrived[1]} launch calls")
    return failures, lines


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


def expected_launches(comps, steps, alpha_stages, latent, config, sampler="plms",
                      inpaint=False):
    """Launches of each kernel in one generate call of ``config``, from the
    module structure and the sampler tables: PLMS calls the UNet once a
    step and twice more in its peeled Heun step, DDIM once a step; a
    gatedSA2 UNet has no fuser-free tail (every call runs its fusers).  Per
    transformer block of N tokens, a gated UNet call runs attn1, the fuser
    and attn2 (3 flash launches).  With the gatedSA fuser, on the fused
    path (FUSED_PROJ=1, N >= 64) ln_matmuls for q/k/v, the fuser's q, the
    fuser's k/v and attn2's q (4), matmul_residual for the three to_out and
    the two net_2 (5) and ln_geglu for the two feed-forwards (2); on the
    module path 5 LayerNorms.  The gatedSA2 and gatedCA fusers take the
    module path inside a fused block: 2, 3, 1 and their 2 LayerNorms.  A
    fuser-free call runs 2 / 2, 3, 1 / 3.  Every GroupNorm (FUSED_NORM gn
    or both) is one launch, but those of a ResBlock that takes the fused
    conv, which runs gn_affine and the conv twice instead.  The VAE decoder
    (not the encoder, which generation does not run) adds its AttnBlocks'
    flash launches and its GroupNorms; an ``inpaint`` request's encode adds
    the encoder's (``expected_fp32``: all on the fp32 routes).  Under
    FUSED_NORM ln or both, a spatial tokenizer's LayerNorms (ConvNeXt's 22)
    run twice a request: the conditional and the null forward."""
    from gligen_tpu_torch.diffusion.samplers import SamplerTables, _gate_zero_from
    from gligen_tpu_torch.models.layers import LayerNorm, Normalize
    from gligen_tpu_torch.models.unet import fuses_conv
    from gligen_tpu_torch.models.vae import AttnBlock

    env = CONFIGS[config]
    tables = SamplerTables.create(comps.schedule, steps, alpha_stages=alpha_stages,
                                  first_conv_restorable=comps.unet.first_conv_restorable)
    n = len(tables.ts)
    # the pipeline's fuser-free tail, for the fusers the alpha schedule gates
    k0 = _gate_zero_from(tables) if comps.unet.fuser_type in ("gatedSA", "gatedCA") else n
    if sampler == "plms":
        split = max(k0, 1)
        heun = 2  # the peeled step 0 calls the model twice
        gated = (heun if k0 > 0 else 0) + (split - 1)
        free = (heun if k0 == 0 else 0) + (n - split)
    else:
        gated, free = k0, n - k0
    norm = {"1": "both"}.get(env["GLIGEN_TPU_FUSED_NORM"], env["GLIGEN_TPU_FUSED_NORM"])
    gn_on, ln_on = norm in ("gn", "both"), norm in ("ln", "both")
    res, sts = unet_maps(comps.unet, latent)
    counts = dict.fromkeys(kernel_wrappers(), 0)
    fused_fuser = comps.unet.fuser_type == "gatedSA"
    for h, _, depth in sts:
        fused = env["GLIGEN_TPU_FUSED_PROJ"] == "1" and h * h >= 64
        counts["flash_fwd"] += depth * (3 * gated + 2 * free)
        if fused:
            for name, (g, f) in {"ln_matmuls": (4, 2), "matmul_residual": (5, 3),
                                 "ln_geglu": (2, 1)}.items():
                counts[name] += depth * ((g if fused_fuser else f) * gated + f * free)
        if ln_on and not fused:
            counts["layer_norm"] += depth * (5 * gated + 3 * free)
        elif ln_on and not fused_fuser:
            counts["layer_norm"] += depth * 2 * gated
    if ln_on:
        counts["layer_norm"] += 2 * sum(isinstance(m, LayerNorm)
                                        for m in comps.unet.position_net.modules())
    calls = gated + free
    fused_res = sum(fuses_conv(env["GLIGEN_TPU_FUSED_CONV"], h, h, cout) for h, _, cout in res)
    counts["gn_silu_conv3x3"] = counts["gn_affine"] = 2 * fused_res * calls
    if gn_on:
        unet_norms = sum(isinstance(m, Normalize) for m in comps.unet.modules())
        vae_norms_ = sum(isinstance(m, Normalize) for m in comps.vae.decoder.modules())
        counts["group_norm"] = (unet_norms - 2 * fused_res) * calls + vae_norms_
    counts["flash_fwd"] += sum(isinstance(m, AttnBlock) for m in comps.vae.decoder.modules())
    if inpaint:
        for name, n_enc in expected_fp32(comps, config).items():
            counts[name] += n_enc
    return counts, gated, free


def expected_fp32(comps, config):
    """Launches of the fp32 routes in one inpaint encode (the flash
    forward's, the GroupNorm's) of ``config``: every AttnBlock and, under
    FUSED_NORM gn or both, every GroupNorm of the VAE encoder."""
    from gligen_tpu_torch.models.layers import Normalize
    from gligen_tpu_torch.models.vae import AttnBlock

    norm = {"1": "both"}.get(CONFIGS[config]["GLIGEN_TPU_FUSED_NORM"],
                             CONFIGS[config]["GLIGEN_TPU_FUSED_NORM"])
    enc = list(comps.vae.encoder.modules())
    return {"flash_fwd": sum(isinstance(m, AttnBlock) for m in enc),
            "group_norm": sum(isinstance(m, Normalize) for m in enc) if norm in ("gn", "both")
            else 0}


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
    from frozen layers alone, unless the first conv trains (a model with a
    grounding downsampler, or inpainting: train_step.py's
    ``input_conv_train``), when it gets both.  GroupNorms run once each (none is inside a
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
    first = 0 if comps.unet.downsample_net is not None or comps.unet.inpaint_mode else 1
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
    from gligen_tpu_torch.ops import fused_norm as fn
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
    # each sandbox's profiled forward must show the kernels of its configuration,
    # the GroupNorm's those of the route gn_plan gives the sandbox's map
    for tool, needs in (
        (bench_block, ("flash_fwd", "ln_matmuls", "matmul_residual", "ln_geglu")),
        (bench_resblock, ()),
    ):
        name = tool.__name__.rsplit(".", 1)[1]
        result = tool.run(iters=3, device=device, profile=True)
        b, h, w, c = result["shape"]
        needs += GN_CATEGORIES[fn.gn_plan(b, h * w, c)[0]]
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
    # the fp32 route's tile sweep (the queries-as-rows kernel) at ds1 and ds2 (B = 4)
    assert (bench_sweep_attn.FP32_REL_TOL, bench_sweep_attn.FP32_LSE_TOL) == (
        FP32_REL_TOL, FP32_LSE_TOL)  # its rows' "ok"
    rows = bench_sweep_attn.run_fp32(batch=4, iters=3, device=device)
    lines += [f"tools: bench_sweep_attn --fp32: {line}"
              for line in bench_sweep_attn.fp32_lines(rows)]
    ok = all(r["ok"] for r in rows)
    lines.append(f"tools: bench_sweep_attn --fp32: every configuration agreed with "
                 f"flash_attention_plain: {ok}")
    if not ok:
        failures.append("tools bench_sweep_attn --fp32")
    return failures, counts, checks, lines


def make_request(rng, batch, vocab, ctx_dim, tokenizer="text", n_box=30):
    """Token ids, negative ids and the inputs of ``tokenizer``: 1 to 7 live
    boxes of ``n_box`` (text; text_image with each live box's text and
    image masks drawn), or 8 persons' 17 keypoints, 30% invisible at (0, 0)
    (keypoint)."""
    import numpy as np

    ids = rng.integers(1, vocab - 1, size=(batch, 77)).astype(np.int64)
    uc = np.full((batch, 77), vocab - 1, np.int64)
    if tokenizer == "keypoint":
        masks = (rng.random((batch, 8 * 17)) > 0.3).astype(np.float32)
        points = rng.random((batch, 8 * 17, 2)).astype(np.float32) * masks[..., None]
        return ids, uc, {"points": points, "masks": masks}
    boxes = np.sort(rng.random((batch, n_box, 4)).astype(np.float32).reshape(-1, 2, 2), axis=1)
    masks = (np.arange(n_box)[None, :] < rng.integers(1, 8, size=(batch, 1))).astype(np.float32)
    grounding = {
        "boxes": boxes.reshape(batch, n_box, 4),
        "masks": masks,
        "positive_embeddings": rng.standard_normal((batch, n_box, ctx_dim)).astype(np.float32),
    }
    if tokenizer == "text_image":
        grounding = {"boxes": grounding["boxes"], "masks": masks,
                     "text_masks": masks * (rng.random((batch, n_box)) > 0.3),
                     "image_masks": masks * (rng.random((batch, n_box)) > 0.3),
                     "text_embeddings": grounding["positive_embeddings"],
                     "image_embeddings": rng.standard_normal((batch, n_box, ctx_dim))
                     .astype(np.float32)}
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
    "flash_fwd_fp32": ("gligen_tpu_torch/csrc/flash_fwd.cu",
                       "gligen_tpu/ops/pallas_attention.py:466 (_fwd_impl streamed, q/k/v in "
                       "fp32: the inpaint encode's VAE mid-attention)", "vae_mid_fp32", "inpaint"),
    "flash_fwd_fp32_qm": ("gligen_tpu_torch/csrc/flash_fwd.cu",
                          "gligen_tpu/ops/pallas_attention.py:428 (_fwd_impl single-KV) and "
                          "gligen_tpu/ops/pallas_attention.py:836 (_packed_fwd_impl single-KV), "
                          "q/k/v in fp32: the UNet's attention served in fp32", "attn1_ds1_fp32",
                          "fp32_a"),
    "group_norm_fp32": ("gligen_tpu_torch/csrc/fused_norm.cu",
                        "gligen_tpu/ops/pallas_norm.py:107 (_group_norm_pallas_flat, fp32 x: "
                        "the inpaint encode's VAE encoder norms)", "enc_512x128_gn", "inpaint"),
    # the fp32 routes of a model served in fp32 (fault F5), launches from phase 14
    "ln_matmuls_fp32": ("gligen_tpu_torch/csrc/fused_proj.cu",
                        "gligen_tpu/ops/pallas_matmul.py:132 (_ln_matmuls, fp32 x)",
                        "qkv_ds1_fp32", "fp32_a"),
    "matmul_residual_fp32": ("gligen_tpu_torch/csrc/fused_proj.cu",
                             "gligen_tpu/ops/pallas_matmul.py:212 (_matmul_residual, fp32 x)",
                             "to_out_ds1_fp32", "fp32_a"),
    "ln_geglu_fp32": ("gligen_tpu_torch/csrc/fused_proj.cu",
                      "gligen_tpu/ops/pallas_matmul.py:297 (_ln_geglu, fp32 x)", "geglu_ds1_fp32",
                      "fp32_a"),
    "layer_norm_fp32": ("gligen_tpu_torch/csrc/fused_norm.cu",
                        "gligen_tpu/ops/pallas_norm.py:169 (_layer_norm_pallas_flat, fp32 x)",
                        "ln_ds1_fp32", "fp32_b"),
    "gn_affine_fp32": ("gligen_tpu_torch/csrc/fused_norm.cu",
                       "gligen_tpu/ops/pallas_norm.py:107 (_group_norm_pallas_flat, the "
                       "statistics of fp32 x, as gligen_tpu/ops/pallas_conv.py:47 gn_affine folds "
                       "them)", "res_64x320_fp32", "fp32_c"),
    "gn_silu_conv3x3_fp32": ("gligen_tpu_torch/csrc/fused_conv.cu",
                             "gligen_tpu/ops/pallas_conv.py:141 (_fused, fp32 x)",
                             "out_64_320_fp32", "fp32_c"),
}


def kernel_wrappers():
    from gligen_tpu_torch.ops import flash_attention, fused_conv, fused_norm, fused_proj

    return {**flash_attention.KERNELS, **fused_proj.KERNELS, **fused_norm.KERNELS,
            **fused_conv.KERNELS}


def run_requests(torch, pipe, requests, config, gen, **kw):
    """Generate every request (ids, uc, grounding[, per-request keywords])
    in one configuration, with every launch count set to 0 just before and
    read just after.  Returns (seconds per request, images, launch
    counts)."""
    set_config(config)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    times, images = [], []
    for ids, uc, grounding, *own in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images.append(pipe.generate(ids, uc, grounding, generator=gen, **kw, **dict(*own)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, images, {name: w.launches for name, w in wrappers.items()}


def small_reference(torch, np, seed, device, alpha, config, model=None, dtype=None,
                    tol=REF_MEAN_TOL):
    """The pipeline at a small width: card (bf16, or ``dtype``, kernels)
    against CPU (fp32, plain versions), same weights and noise, in one
    configuration, held to a mean absolute pixel difference of ``tol``;
    ``model`` names one of ``SMALL_GROUNDING`` or ``SMALL_SPATIAL`` in place
    of the box+text gatedSA UNet (a spatial one at latent 64^2, with a
    seeded map).  Returns (ok, line)."""
    dtype = dtype or torch.bfloat16
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents

    set_config(config)
    small, tokenizer, n_box, latent = dict(SMALL), "text", 30, 16
    if model in SMALL_SPATIAL:
        small["unet_config"] = dict(SMALL["unet_config"], **SMALL_SPATIAL[model])
        latent = SPATIAL_LATENT
    elif model is not None:
        unet, tokenizer, n_box = SMALL_GROUNDING[model]
        small["unet_config"] = dict(SMALL["unet_config"], **unet)
    cpu = GligenComponents.create(dtype=torch.float32, seed=seed, device="cpu", **small)
    dezero_(cpu.unet, torch.Generator().manual_seed(seed + 2))
    gpu = GligenComponents.create(dtype=dtype, seed=seed, device=device, **small)
    for a, b in ((cpu.unet, gpu.unet), (cpu.vae, gpu.vae), (cpu.text_encoder, gpu.text_encoder)):
        b.load_state_dict(a.state_dict())
    rng = np.random.default_rng(seed + 3)
    ids, uc, grounding = make_request(rng, 2, 1000, 64, tokenizer, n_box)
    noise = np.random.default_rng(seed + 4).standard_normal((2, latent, latent, 4)).astype(
        np.float32)
    kw = dict(steps=4, guidance_scale=7.5, alpha_stages=alpha, latent_size=latent, noise=noise)
    if model in SMALL_SPATIAL:
        grounding, kw["grounding_extra"] = spatial_request(rng, model, 2)
    with torch.inference_mode():
        torch.set_num_threads(4)
        ref = GenerationPipeline(cpu).generate(ids, uc, grounding, **kw)
    got = GenerationPipeline(gpu).generate(ids, uc, grounding, **kw).cpu()
    diff = (got - ref).abs()
    ok, desc = check_image(torch, got, 2, 2 * latent)
    ok = ok and diff.mean().item() <= tol
    what = "" if model is None else f" ({model})"
    card = "fp32" if dtype == torch.float32 else "bf16"
    return ok, (f"reference: {config_desc(config)}: small pipeline{what} card {card} vs CPU fp32: "
                f"{desc}; mean abs diff {diff.mean().item():.4e} (tol {tol}), "
                f"max {diff.max().item():.4e} {'ok' if ok else 'FAIL'}")


# SD-1.4 GLIGEN's UNet widths (configs/flickr_text.yaml's), gatedSA fuser.
SD14_UNET = dict(
    in_channels=4, out_channels=4, model_channels=320, attention_resolutions=[4, 2, 1],
    num_res_blocks=2, channel_mult=[1, 2, 4, 4], num_heads=8, transformer_depth=1,
    context_dim=768, fuser_type="gatedSA",
)
# The inpaint phase's model as the reference's checkpoint config gives it:
# SD-1.4 GLIGEN with the inpainting UNet's 9-channel first conv, the text
# tokenizer under its reference name, and a schedule that is not the
# default one.
INPAINT_UNET = dict(
    SD14_UNET, inpaint_mode=True,
    grounding_tokenizer={"target": "ldm.modules.diffusionmodules.text_grounding_net.PositionNet",
                         "params": {"in_dim": 768, "out_dim": 768}},
)
INPAINT_SCHEDULE = dict(timesteps=1000, linear_start=0.001, linear_end=0.012)
EMA_GATE = 0.25  # the checkpoint's EMA fuser gates


def inpaint_request(rng, batch, vocab, ctx_dim, size, latent):
    """``make_request`` plus an inpaint image in [-1, 1] (seeded, no
    image file) and keep-masks drawn from the first two boxes, as the
    reference's inpainting scenario has two (cli.py:486-493)."""
    from gligen_tpu_torch.data.inpaint_masks import draw_masks_from_boxes

    ids, uc, grounding = make_request(rng, batch, vocab, ctx_dim)
    image = rng.uniform(-1.0, 1.0, (batch, size, size, 3)).astype("float32")
    mask = draw_masks_from_boxes(grounding["boxes"][:, :2], size=latent)
    return ids, uc, grounding, {"inpaint_image": image, "inpaint_mask": mask}


def loaded_differences(torch, src, comps, ema_gate=None):
    """(the names of the loaded tensors that differ from their source in
    name, dtype or any bit, the number of tensors compared) over the UNet,
    the VAE and the text encoder; with ``ema_gate`` every UNet fuser gate
    must be that (the EMA's)."""
    bad, n = [], 0
    for tag, a, b in (("unet", src.unet, comps.unet), ("vae", src.vae, comps.vae),
                      ("text", src.text_encoder, comps.text_encoder)):
        want, got = a.state_dict(), b.state_dict()
        bad += [f"{tag}: names differ"] if set(want) != set(got) else []
        for name, t in got.items():
            n += 1
            w = want.get(name)
            if ema_gate is not None and tag == "unet" and name.endswith(("alpha_attn",
                                                                          "alpha_dense")):
                w = torch.full_like(t, ema_gate)
            if w is None or t.dtype != w.dtype or not torch.equal(t, w):
                bad.append(f"{tag}.{name}")
    return bad, n


def load_checkpoint(torch, np, seed, device):
    """Build the inpaint components, write them as a reference-format
    checkpoint in memory, load it back (EMA overlay).  Returns (loaded
    components, ok, line)."""
    from gligen_tpu_torch.diffusion.schedule import DiffusionSchedule
    from gligen_tpu_torch.inference.cli import components_from_checkpoint
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.tools.reference_ckpt import reference_checkpoint

    t0 = time.perf_counter()
    src = GligenComponents.create(unet_config=dict(INPAINT_UNET), dtype=torch.bfloat16,
                                  seed=seed + 7, device=device)
    dezero_(src.unet, torch.Generator(device=device).manual_seed(seed + 8))
    ckpt, sd_conv = reference_checkpoint(src, INPAINT_UNET, INPAINT_SCHEDULE, ema_gate=EMA_GATE)
    comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, use_ema=True,
                                       dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    bad, n = loaded_differences(torch, src, comps, ema_gate=EMA_GATE)
    sched = comps.schedule.alphas_cumprod
    sched_ok = (np.array_equal(sched, DiffusionSchedule.create(**INPAINT_SCHEDULE).alphas_cumprod)
                and not np.array_equal(sched, src.schedule.alphas_cumprod))
    ok = (not bad and sched_ok and comps.unet.inpaint_mode and sd_conv is None
          and not hasattr(comps.unet, "first_conv_sd"))
    line = (f"inpaint: reference-format checkpoint ({len(ckpt['model'])} model, "
            f"{len(ckpt['autoencoder'])} autoencoder, {len(ckpt['text_encoder'])} text_encoder "
            f"tensors; ema gates {EMA_GATE}; config linear_start "
            f"{INPAINT_SCHEDULE['linear_start']}) built and loaded on the card in {seconds:.1f} s: "
            f"{n - len(bad)} of {n} loaded tensors equal their source bit for bit "
            f"{bad[:4] if bad else ''}, schedule from the config {sched_ok}, inpaint UNet with no "
            f"SD first conv {comps.unet.inpaint_mode and not hasattr(comps.unet, 'first_conv_sd')} "
            f"{'ok' if ok else 'FAIL'}")
    return comps, ok, line


def run_inpaint(torch, np, seed, device, steps, batch=2, size=512):
    """Phase 10 at full width in configuration (a): the checkpoint, then two
    inpaint requests with each sampler.  Returns (failures, launches of the
    fp32 routes, s/img by sampler)."""
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline
    from gligen_tpu_torch.ops.flash_attention import flash_fwd
    from gligen_tpu_torch.ops.fused_norm import group_norm_fused

    set_config("a")
    comps, ok, line = load_checkpoint(torch, np, seed, device)
    print(line, flush=True)
    failures = [] if ok else ["inpaint checkpoint"]
    torch.cuda.empty_cache()
    pipe = GenerationPipeline(comps)
    latent = size // comps.vae.downsample_factor
    rng = np.random.default_rng(seed + 9)
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    fp32 = {"flash_fwd_fp32": 0, "group_norm_fp32": 0}
    s_per_img = {}
    for sampler in ("ddim", "plms"):
        requests = [inpaint_request(rng, batch, 49408, 768, size, latent) for _ in range(2)]
        expected, gated, free = expected_launches(comps, steps, None, latent, "a",
                                                  sampler=sampler, inpaint=True)
        want32 = {k: len(requests) * n for k, n in expected_fp32(comps, "a").items()}
        before = dict(flash_fwd.routes), dict(group_norm_fused.routes)
        kernels32 = dict(flash_fwd.fp32_kernels)
        times, images, counts = run_requests(torch, pipe, requests, "a", gen, steps=steps,
                                             guidance_scale=7.5, sampler=sampler,
                                             alpha_stages=None, latent_size=latent)
        routes = {r: n - before[0][r] for r, n in flash_fwd.routes.items()}
        kernels32 = {k: n - kernels32[k] for k, n in flash_fwd.fp32_kernels.items()}
        gn32 = group_norm_fused.routes["fp32"] - before[1]["fp32"]
        fp32["flash_fwd_fp32"] += kernels32["km"]
        fp32["group_norm_fp32"] += gn32
        for i, (img, t) in enumerate(zip(images, times)):
            ok, desc = check_image(torch, img, batch, size)
            print(f"inpaint: {sampler} request {i}: {desc} in {t:.3f} s = {t / batch:.3f} s/img "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"inpaint image ({sampler}) {i}")
        want = {name: len(requests) * expected[name] for name in counts}
        ok = counts == want
        print(f"inpaint: {sampler} per request {gated} gated and {free} fuser-free UNet calls; "
              f"launches {counts}, expected {want} {'ok' if ok else 'FAIL'}", flush=True)
        route_ok = (routes["copy"] == 0 and routes["fp32"] == want32["flash_fwd"]
                    and kernels32 == {"qm": 0, "km": want32["flash_fwd"]}
                    and gn32 == want32["group_norm"])
        print(f"inpaint: {sampler} flash_fwd launches by route {routes} (bf16 all tma, fp32 "
              f"{want32['flash_fwd']} expected: the encode's attention, by kernel {kernels32}: "
              f"all on km, the d = 512 kernel); fp32 GroupNorm launches "
              f"{gn32} (expected {want32['group_norm']}: the encode's norms) "
              f"{'ok' if route_ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"inpaint launch count ({sampler})")
        if not route_ok:
            failures.append(f"inpaint routes ({sampler})")
        s_per_img[sampler] = times[1] / batch
        del images
    del comps, pipe
    torch.cuda.empty_cache()
    return failures, fp32, s_per_img


def small_inpaint_reference(torch, np, seed, device, sampler):
    """The inpaint pipeline at a small width, card (bf16, kernels, the
    encode on the fp32 routes) against CPU (fp32, plain versions), same
    weights, image, masks and noise (the encode's and each step's
    injected), in configuration (a).  Returns (ok, line)."""
    from gligen_tpu_torch.diffusion.schedule import make_ddim_timesteps
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents

    set_config("a")
    small = dict(SMALL, unet_config=dict(SMALL["unet_config"], inpaint_mode=True))
    cpu = GligenComponents.create(dtype=torch.float32, seed=seed, device="cpu", **small)
    dezero_(cpu.unet, torch.Generator().manual_seed(seed + 2))
    gpu = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device, **small)
    for a, b in ((cpu.unet, gpu.unet), (cpu.vae, gpu.vae), (cpu.text_encoder, gpu.text_encoder)):
        b.load_state_dict(a.state_dict())
    rng = np.random.default_rng(seed + 11)
    ids, uc, grounding, inpaint = inpaint_request(rng, 2, 1000, 64, 32, 16)
    steps = 4
    n_steps = len(make_ddim_timesteps(steps, 1000))
    shape = (2, 16, 16, 4)
    noise = {k: rng.standard_normal(s).astype(np.float32) for k, s in
             (("noise", shape), ("encode_noise", shape), ("blend_noise", (n_steps,) + shape))}
    kw = dict(steps=steps, guidance_scale=7.5, sampler=sampler, latent_size=16, **inpaint,
              **noise)
    with torch.inference_mode():
        torch.set_num_threads(4)
        ref = GenerationPipeline(cpu).generate(ids, uc, grounding, **kw)
    got = GenerationPipeline(gpu).generate(ids, uc, grounding, **kw).cpu()
    diff = (got - ref).abs()
    ok, desc = check_image(torch, got, 2, 32)
    ok = ok and diff.mean().item() <= REF_MEAN_TOL
    return ok, (f"inpaint reference: {sampler} small inpaint pipeline card bf16 (fp32 encode) vs "
                f"CPU fp32: {desc}; mean abs diff {diff.mean().item():.4e} (tol {REF_MEAN_TOL}), "
                f"max {diff.max().item():.4e} {'ok' if ok else 'FAIL'}")


# Phase 12's models as their configs give them: configs/flickr_text_image.yaml
# (box+text+image) and configs/coco2017K.yaml (keypoint), SD-1.4 GLIGEN's
# widths with the gatedSA fuser, each tokenizer and its input adapter named
# by the reference's dotted alias.  Python literals, since the card's
# machine has no PyYAML; tests/test_torch_launch_counts.py holds them to
# the files.
GROUNDING_MODELS = {
    "text_image": dict(SD14_UNET, grounding_tokenizer={
        "target": "ldm.modules.diffusionmodules.text_image_grounding_net.PositionNet",
        "params": {"in_dim": 768, "out_dim": 768}}),
    "keypoint": dict(SD14_UNET, grounding_tokenizer={
        "target": "ldm.modules.diffusionmodules.keypoint_grounding_net.PositionNet",
        "params": {"max_persons_per_image": 8, "out_dim": 768}}),
}
GROUNDING_INPUTS = {
    "text_image": "grounding_input.text_image_grounding_tokinzer_input.GroundingNetInput",
    "keypoint": "grounding_input.keypoint_grounding_tokinzer_input.GroundingNetInput",
}
GROUNDING_SCHEDULE = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
# the kernels every request of phase 12 must launch in configuration (a)
PATH_KERNELS = ("flash_fwd", "ln_matmuls", "matmul_residual", "ln_geglu", "group_norm")


def _spatial_model(name, tokenizer, downsampler):
    """SD-1.4 GLIGEN with a spatial tokenizer and its downsampler, each
    under the reference's dotted name."""
    prefix = "ldm.modules.diffusionmodules"
    return dict(SD14_UNET,
                grounding_tokenizer={"target": f"{prefix}.{name}_grounding_net.PositionNet",
                                     "params": tokenizer},
                grounding_downsampler={
                    "target": f"{prefix}.{name}_grounding_downsampler.GroundingDownsampler",
                    "params": downsampler})


# Phase 13's models as their configs give them: configs/cc3m_hed.yaml,
# cc3m_canny.yaml, cc3m_depth.yaml, diode_normal.yaml and ade_sem.yaml
# (tests/test_torch_spatial.py holds the literals to the files).
_MAP_TOKENIZER = {"resize_input": 448, "out_dim": 768}
_CONV_DOWNSAMPLER = {"resize_input": 256, "out_dim": 8}
SPATIAL_MODELS = {
    "hed": _spatial_model("hed", _MAP_TOKENIZER, {"out_dim": 1}),
    "canny": _spatial_model("canny", _MAP_TOKENIZER, _CONV_DOWNSAMPLER),
    "depth": _spatial_model("depth", _MAP_TOKENIZER, _CONV_DOWNSAMPLER),
    "normal": _spatial_model("normal", _MAP_TOKENIZER, _CONV_DOWNSAMPLER),
    "sem": _spatial_model("sem", {"resize_input": 256, "in_dim": 152, "out_dim": 768},
                          {"resize_input": 256, "in_dim": 152, "out_dim": 8}),
}
SPATIAL_INPUTS = {name: f"grounding_input.{name}_grounding_tokinzer_input.GroundingNetInput"
                  for name in SPATIAL_MODELS}
# each scenario's alpha stages (gligen_tpu/inference/cli.py:525-560)
SPATIAL_ALPHA = {"hed": [0.9, 0.0, 0.1], "canny": [0.9, 0.0, 0.1], "depth": [0.7, 0.0, 0.3],
                 "normal": [0.7, 0.0, 0.3], "sem": [0.7, 0.0, 0.3]}
SEM_CLASSES = 152
# Phase 13's small models (SMALL's UNet keywords replaced): each spatial
# tokenizer at resize_input 64 (4 tokens) and its downsampler as its config
# has it, attention at the inner level only; the hed downsampler's 64^2
# channels fix the latent at 64^2.
SPATIAL_LATENT = 64
SMALL_SPATIAL = {
    name: {"attention_resolutions": (2,),
           "grounding_tokenizer": {"target": name, "params": dict(
               {"resize_input": 64, "out_dim": 64},
               **({"in_dim": SEM_CLASSES} if name == "sem" else {}))},
           "grounding_downsampler": {"target": name,
                                     "params": cfg["grounding_downsampler"]["params"]}}
    for name, cfg in SPATIAL_MODELS.items()
}


def spatial_request(rng, modality, batch, size=512):
    """(tokenizer inputs, the downsampler's map) of one seeded uint8 map
    (sem: labels in [0, 152); else RGB pixels) at ``size``^2, through the
    CLI's ``prepare_batch_for`` and the config's input adapter."""
    import numpy as np

    from gligen_tpu_torch.inference.adapters import get_adapter
    from gligen_tpu_torch.inference.cli import SPATIAL_KEYS, prepare_batch_for

    shape = (size, size) if modality == "sem" else (size, size, 3)
    top = SEM_CLASSES if modality == "sem" else 256
    image = rng.integers(0, top, size=shape).astype(np.uint8)
    image_key = {m: k for m, _, k in SPATIAL_KEYS}.get(modality, "sem_image")
    meta = {"ckpt": f"checkpoint_generation_{modality}.pth", image_key: image}
    raw = prepare_batch_for(meta, batch)
    adapter = get_adapter(SPATIAL_INPUTS[modality])
    return adapter.prepare(raw), adapter.prepare_extra(raw)


def elapsed_ms(torch, fn, iters=5):
    """ms per call of ``fn`` between CUDA events around ``iters`` calls
    after one warm-up: the device's elapsed time, the host's gaps between
    launches included.  For a module of ~1,000 small launches a call (the
    vision tower), which ``timed`` cannot queue ten calls of ahead of the
    device: the launch queue fills."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tokenizer_device_ms(torch, tokenizers):
    """{model: (the device-busy ms of its tokenizer's conditional and null
    forwards, device records, launch calls)}: one call traced after a warm
    one, busy being the union of its kernel and copy intervals
    (``perf_probe.device_breakdown``).  ``tokenizers`` maps a model to
    (position net, its inputs, their null pair).  A profiler session slows
    the host for the rest of the process, so this runs after every timed
    phase."""
    from gligen_tpu_torch.tools.perf_probe import device_breakdown, launch_calls, traced

    out = {}
    for name, (net, g, null) in tokenizers.items():
        call = lambda: (net(**g), net(**null), torch.cuda.synchronize())
        with torch.no_grad():
            call()
            trace = traced(call)[1]
        calls, records = launch_calls(trace)
        out[name] = (device_breakdown(trace)[1], len(records), len(calls))
    return out


def phrase_tokenizer(rng, phrases, vocab=49408):
    """A seeded stand-in for CLIP's tokenizer (the port's is ROADMAP M10):
    each phrase gets (1, 77) ids, the start token, 2 to 6 random ids, the
    end-of-text token (the largest id, which ``pooled`` reads) and padding."""
    import numpy as np

    table = {}
    for p in phrases:
        body = rng.integers(1, vocab - 2, size=int(rng.integers(2, 7)))
        ids = np.zeros(77, np.int64)
        ids[:len(body) + 2] = [vocab - 2, *body, vocab - 1]
        table[p] = ids
    return lambda batch: np.stack([table[p] for p in batch])


def box_metas(rng, n_requests, n_box=6):
    """Box+text+image metas: each box holds a phrase only, an image only or
    both, in turn from a seeded start; the images are seeded uint8 512^2
    arrays (no image file).  Returns (metas, the phrases)."""
    import numpy as np

    metas, phrases = [], []
    for r in range(n_requests):
        boxes = np.sort(rng.random((n_box, 2, 2)), axis=1).reshape(n_box, 4)
        kinds = [(r + i) % 3 for i in range(n_box)]  # 0 text, 1 image, 2 both
        texts = [f"phrase {r}.{i}" if k != 1 else None for i, k in enumerate(kinds)]
        images = [rng.integers(0, 256, size=(512, 512, 3), dtype=np.uint8) if k else None
                  for k in kinds]
        phrases += [t for t in texts if t]
        metas.append({"locations": boxes.tolist(), "phrases": texts, "images": images})
    return metas, phrases


def keypoint_metas(rng, n_requests):
    """Keypoint metas: 3 to 8 persons' 17 (x, y) points, about a fifth of
    them invisible at (0, 0)."""
    metas = []
    for _ in range(n_requests):
        people = rng.random((int(rng.integers(3, 9)), 17, 2))
        people *= rng.random((people.shape[0], 17, 1)) > 0.2
        metas.append({"locations": people.tolist()})
    return metas


def vision_tower(torch, np, seed, device):
    """CLIP ViT-L/14's vision tower at full width (fp32, as the reference's
    feature extractor runs it) with random weights from ``seed``, written
    with HF's names and loaded back through ``convert_clip_vision``, and a
    seeded 768 x 768 projection.  Returns (tower, projection, tensors equal
    to their source, tensors)."""
    from gligen_tpu_torch.convert.from_reference import convert_clip_vision
    from gligen_tpu_torch.inference.pipeline import random_init_
    from gligen_tpu_torch.models.clip_vision import CLIPVisionModel
    from gligen_tpu_torch.tools.reference_ckpt import clip_vision_to_reference

    with torch.device(device):
        src, vision = CLIPVisionModel().eval(), CLIPVisionModel().eval()
    random_init_(src, torch.Generator(device=device).manual_seed(seed))
    vision.load_state_dict(convert_clip_vision(clip_vision_to_reference(src.state_dict())),
                           strict=True)
    want = src.state_dict()
    same = sum(torch.equal(t, want[n]) for n, t in vision.state_dict().items())
    projection = (np.random.default_rng(seed).standard_normal((768, 768)) / np.sqrt(768))
    return vision, projection.astype(np.float32), same, len(want)


def run_grounding(torch, np, seed, device, steps, batch=2, size=512):
    """Phase 12 (a) and (b): each model of ``GROUNDING_MODELS`` built from ``seed``,
    de-zeroed, written as a reference-format checkpoint in memory and loaded
    back through ``components_from_checkpoint``; its grounding from the
    CLI's batch preparation (box+text+image: CLIP text features of seeded
    phrase ids and image features of seeded arrays through the vision
    tower; keypoint: seeded skeletons) through the config's input adapter;
    two requests of ``batch`` at ``size``^2, PLMS with alpha stages [0.3,
    0, 0.7], configuration (a).  Returns (failures, s/img of request 1 by
    model, the vision tower's device ms per image)."""
    from gligen_tpu_torch.inference.adapters import get_adapter
    from gligen_tpu_torch.inference.cli import (FeatureExtractor, components_from_checkpoint,
                                                prepare_batch_box, prepare_batch_kp)
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
    from gligen_tpu_torch.models.clip_vision import clip_preprocess
    from gligen_tpu_torch.ops.flash_attention import flash_fwd
    from gligen_tpu_torch.tools.reference_ckpt import reference_checkpoint

    set_config("a")
    failures, s_per_img, vision_ms = [], {}, None
    alpha, latent = [0.3, 0.0, 0.7], size // 8
    rng = np.random.default_rng(seed + 12)
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    for name, unet_config in GROUNDING_MODELS.items():
        t0 = time.perf_counter()
        src = GligenComponents.create(unet_config=dict(unet_config), dtype=torch.bfloat16,
                                      seed=seed + 14, device=device)
        dezero_(src.unet, torch.Generator(device=device).manual_seed(seed + 15))
        ckpt, sd_conv = reference_checkpoint(src, unet_config, GROUNDING_SCHEDULE)
        comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, dtype=torch.bfloat16,
                                           device=device)
        bad, n = loaded_differences(torch, src, comps)
        net = type(comps.unet.position_net).__name__
        del src, ckpt, sd_conv
        torch.cuda.empty_cache()
        print(f"grounding: {name}: reference-format checkpoint (tokenizer "
              f"{unet_config['grounding_tokenizer']['target']}) loaded on the card in "
              f"{time.perf_counter() - t0:.1f} s as {net}: {n - len(bad)} of {n} tensors equal "
              f"their source bit for bit {bad[:4] if bad else ''} "
              f"{'ok' if not bad else 'FAIL'}", flush=True)
        if bad:
            failures.append(f"grounding checkpoint ({name})")
        if name == "text_image":
            vision, projection, same, total = vision_tower(torch, np, seed + 16, device)
            print(f"grounding: CLIP ViT-L/14 vision tower (24 x 1024, fp32, random weights) "
                  f"through HF's names and convert_clip_vision: {same} of {total} tensors equal "
                  f"{'ok' if same == total else 'FAIL'}", flush=True)
            if same != total:
                failures.append("grounding vision tower load")
            metas, phrases = box_metas(rng, 2)
            features = FeatureExtractor(comps.text_encoder, phrase_tokenizer(rng, phrases),
                                        vision, projection)
            t1 = time.perf_counter()
            batches = [prepare_batch_box(meta, batch, features) for meta in metas]
            n_images = sum(i is not None for meta in metas for i in meta["images"])
            feature_s = time.perf_counter() - t1
            pixels = clip_preprocess(torch.from_numpy(metas[0]["images"][1]).to(device)[None])
            with torch.no_grad():
                vision_ms = elapsed_ms(torch, lambda: vision(pixels))
            norms = [float(np.linalg.norm(f)) for b in batches
                     for f, m in zip(b["image_embeddings"][0], b["image_masks"][0]) if m]
            feats_ok = (all(np.isfinite(b[k]).all() for b in batches for k in b)
                        and np.allclose(norms, 28.7, rtol=1e-4) and len(norms) == n_images)
            print(f"grounding: {name}: features of {len(phrases)} phrases and {n_images} images "
                  f"in {feature_s:.2f} s (host clock); the vision tower {vision_ms:.3f} ms per "
                  f"image (CUDA events, host gaps included); image features renormed to 28.7 "
                  f"{feats_ok} "
                  f"{'ok' if feats_ok else 'FAIL'}", flush=True)
            if not feats_ok:
                failures.append("grounding features")
            del vision, features, pixels
        else:
            batches = [prepare_batch_kp(meta, batch) for meta in keypoint_metas(rng, 2)]
        adapter = get_adapter(GROUNDING_INPUTS[name])
        requests = []
        for grounding in batches:
            ids, uc, _ = make_request(rng, batch, 49408, 768)
            requests.append((ids, uc, adapter.prepare(grounding)))
        expected, gated, free = expected_launches(comps, steps, alpha, latent, "a")
        routes = dict(flash_fwd.routes)
        pipe = GenerationPipeline(comps)
        times, images, counts = run_requests(torch, pipe, requests, "a", gen, steps=steps,
                                             guidance_scale=7.5, alpha_stages=alpha,
                                             latent_size=latent)
        routes = {r: c - routes[r] for r, c in flash_fwd.routes.items()}
        for i, (img, t) in enumerate(zip(images, times)):
            ok, desc = check_image(torch, img, batch, size)
            print(f"grounding: {name} request {i}: {desc} in {t:.3f} s = {t / batch:.3f} s/img "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"grounding image ({name}) {i}")
        want = {k: len(requests) * expected[k] for k in counts}
        launched = all(counts[k] > 0 for k in PATH_KERNELS)
        ok = counts == want and launched
        print(f"grounding: {name} per request {gated} gated and {free} fuser-free UNet calls; "
              f"launches {counts}, expected {want}; {', '.join(PATH_KERNELS)} each launched "
              f"{launched} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"grounding launch count ({name})")
        print(f"grounding: {name} flash_fwd launches by route {routes} (every one must be tma) "
              f"{'ok' if routes['copy'] == 0 else 'FAIL'}", flush=True)
        if routes["copy"]:
            failures.append(f"grounding flash_fwd copy route ({name})")
        s_per_img[name] = times[1] / batch
        del comps, pipe, images, requests, batches
        torch.cuda.empty_cache()
    return failures, s_per_img, vision_ms


def run_spatial(torch, np, seed, device, steps, batch=2, size=512):
    """Phase 13: each model of ``SPATIAL_MODELS`` built from ``seed``,
    de-zeroed (ConvNeXt's layer scales too), written as a reference-format
    checkpoint in memory (tokenizer and downsampler under their dotted
    names, an in-memory SD first conv) and loaded back through
    ``components_from_checkpoint``; two requests of ``batch`` at ``size``^2,
    each a seeded uint8 map through ``prepare_batch_for`` and the config's
    input adapter, PLMS with the scenario's alpha stages, configuration (a);
    the hed model also serves one request in configuration (b), where
    ConvNeXt's LayerNorms take the LayerNorm kernel.  Returns (failures,
    s/img of request 1 by model, the tokenizer's ms per request (its
    conditional and null forwards, ``elapsed_ms``) by model, the (b)
    request's LayerNorm launches, {model: (its position net, a request's
    tokenizer inputs, their null pair)} for ``tokenizer_device_ms``)."""
    from gligen_tpu_torch.inference.adapters import null_input
    from gligen_tpu_torch.inference.cli import components_from_checkpoint
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
    from gligen_tpu_torch.ops.flash_attention import flash_fwd
    from gligen_tpu_torch.tools.reference_ckpt import reference_checkpoint

    failures, s_per_img, tokenizer_ms, ln_launches, tokenizers = [], {}, {}, None, {}
    latent = size // 8
    rng = np.random.default_rng(seed + 17)
    gen = torch.Generator(device=device).manual_seed(seed + 18)
    for name, unet_config in SPATIAL_MODELS.items():
        set_config("a")
        t0 = time.perf_counter()
        src = GligenComponents.create(unet_config=dict(unet_config), dtype=torch.bfloat16,
                                      seed=seed + 19, device=device)
        dezero_(src.unet, torch.Generator(device=device).manual_seed(seed + 20))
        ckpt, sd_conv = reference_checkpoint(src, unet_config, GROUNDING_SCHEDULE)
        comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, dtype=torch.bfloat16,
                                           device=device)
        bad, n = loaded_differences(torch, src, comps)
        nets = ", ".join(type(m).__name__
                         for m in (comps.unet.position_net, comps.unet.downsample_net))
        width = comps.unet.input_blocks_0_0.weight.shape[1]
        del src, ckpt, sd_conv
        torch.cuda.empty_cache()
        print(f"spatial: {name}: reference-format checkpoint loaded on the card in "
              f"{time.perf_counter() - t0:.1f} s as {nets}, first conv {width} channels: "
              f"{n - len(bad)} of {n} tensors equal their source bit for bit "
              f"{bad[:4] if bad else ''} {'ok' if not bad else 'FAIL'}", flush=True)
        if bad:
            failures.append(f"spatial checkpoint ({name})")
        alpha = SPATIAL_ALPHA[name]
        requests = []
        for _ in range(2):
            ids, uc, _ = make_request(rng, batch, 49408, 768)
            grounding, extra = spatial_request(rng, name, batch, size)
            requests.append((ids, uc, grounding, {"grounding_extra": extra}))
        pipe = GenerationPipeline(comps)
        runs = [("a", requests)] + ([("b", requests[:1])] if name == "hed" else [])
        for config, reqs in runs:
            expected, gated, free = expected_launches(comps, steps, alpha, latent, config)
            routes = dict(flash_fwd.routes)
            times, images, counts = run_requests(torch, pipe, reqs, config, gen, steps=steps,
                                                 guidance_scale=7.5, alpha_stages=alpha,
                                                 latent_size=latent)
            routes = {r: c - routes[r] for r, c in flash_fwd.routes.items()}
            for i, (img, t) in enumerate(zip(images, times)):
                ok, desc = check_image(torch, img, batch, size)
                print(f"spatial: {name} {config_desc(config)} request {i}: {desc} in {t:.3f} s "
                      f"= {t / batch:.3f} s/img {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"spatial image ({name}, {config}) {i}")
            want = {k: len(reqs) * expected[k] for k in counts}
            if config == "a":
                launched = all(counts[k] > 0 for k in PATH_KERNELS)
            else:  # the module path: the tokenizer's LayerNorms beside the blocks'
                launched = counts["layer_norm"] > 0 and counts["ln_matmuls"] == 0
                ln_launches = counts["layer_norm"]
            ok = counts == want and launched
            print(f"spatial: {name} ({config}) per request {gated} gated and {free} fuser-free "
                  f"UNet calls; launches {counts}, expected {want} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"spatial launch count ({name}, {config})")
            print(f"spatial: {name} ({config}) flash_fwd launches by route {routes} (every one "
                  f"must be tma) {'ok' if routes['copy'] == 0 else 'FAIL'}", flush=True)
            if routes["copy"]:
                failures.append(f"spatial flash_fwd copy route ({name}, {config})")
            if config == "a":
                s_per_img[name] = times[1] / batch
            del images
        set_config("a")
        grounding = requests[0][2]
        g = {k: v.to(device) for k, v in grounding.items()}
        null = null_input(g)
        with torch.no_grad():
            tokenizer_ms[name] = elapsed_ms(torch, lambda: (comps.unet.grounding_tokens(g),
                                                            comps.unet.grounding_tokens(null)))
        print(f"spatial: {name}: the tokenizer's conditional and null forwards (batch {batch}, "
              f"{comps.unet.position_net.resize_input}^2 maps) {tokenizer_ms[name]:.3f} ms per "
              f"request (CUDA events, host gaps included)", flush=True)
        tokenizers[name] = (comps.unet.position_net, g, null)
        del comps, pipe, requests
        torch.cuda.empty_cache()
    return failures, s_per_img, tokenizer_ms, ln_launches, tokenizers


# The small-width pipeline in fp32, card (the fp32 routes) vs CPU (plain
# versions, fp32): the same arithmetic summed in other orders, so ten times
# under the bf16 limit (tests/test_torch_fp32_cuda.py holds the same)
FP32_REF_MEAN_TOL = 2e-3


def run_fp32(torch, np, seed, device, steps, batch=2, size=512):
    """Phase 14 (fault F5): the SD-1.4 GLIGEN box+text model served in fp32
    at full width (random de-zeroed weights), one request of ``batch`` at
    ``size``^2 with PLMS and alpha stages [0.3, 0, 0.7] in each of
    ``CONFIGS``: the image sound, and every kernel launch on its fp32 route,
    as many as ``expected_launches`` predicts; the flash forward's on the
    queries-as-rows kernel but for the VAE decoder's d = 512 head (one
    launch a request, the keys-as-rows kernel).  Returns (failures, s/img
    by configuration, {"fp32_<config>": {"<kernel>_fp32": launches}}, the
    flash forward's as "flash_fwd_fp32_qm" and "flash_fwd_fp32")."""
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
    from gligen_tpu_torch.models.vae import AttnBlock
    from gligen_tpu_torch.ops.flash_attention import flash_fwd

    failures, s_per_img, launches = [], {}, {}
    comps = GligenComponents.create(dtype=torch.float32, seed=seed + 21, device=device)
    dezero_(comps.unet, torch.Generator(device=device).manual_seed(seed + 22))
    pipe = GenerationPipeline(comps)
    alpha, latent = [0.3, 0.0, 0.7], size // 8
    rng = np.random.default_rng(seed + 23)
    gen = torch.Generator(device=device).manual_seed(seed + 24)
    wrappers = kernel_wrappers()
    vae_heads = sum(isinstance(m, AttnBlock) for m in comps.vae.decoder.modules())
    for config in CONFIGS:
        expected, gated, free = expected_launches(comps, steps, alpha, latent, config)
        before = {name: dict(w.routes) for name, w in wrappers.items()}
        kernels32 = dict(flash_fwd.fp32_kernels)
        times, images, counts = run_requests(torch, pipe, [make_request(rng, batch, 49408, 768)],
                                             config, gen, steps=steps, guidance_scale=7.5,
                                             alpha_stages=alpha, latent_size=latent)
        kernels32 = {k: n - kernels32[k] for k, n in flash_fwd.fp32_kernels.items()}
        routes = {name: {r: n - before[name][r] for r, n in w.routes.items()}
                  for name, w in wrappers.items()}
        fp32 = {name: r.get("fp32", 0) for name, r in routes.items()}
        other = {name: n - fp32[name] for name, n in counts.items() if n != fp32[name]}
        ok, desc = check_image(torch, images[0], batch, size)
        print(f"fp32: {config_desc(config)} request 0: {desc} in {times[0]:.3f} s = "
              f"{times[0] / batch:.3f} s/img {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"fp32 image ({config})")
        ok = counts == expected and fp32 == expected and not other
        print(f"fp32: ({config}) {gated} gated and {free} fuser-free UNet calls; fp32-route "
              f"launches {fp32}, expected {expected}; launches on another route {other} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"fp32 launch count ({config})")
        ok = kernels32 == {"qm": expected["flash_fwd"] - vae_heads, "km": vae_heads}
        print(f"fp32: ({config}) flash_fwd fp32 launches by kernel {kernels32} (the UNet's on "
              f"qm, the queries-as-rows kernel; the VAE decoder's {vae_heads} d = 512 head on km) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"fp32 flash kernels ({config})")
        s_per_img[config] = times[0] / batch
        launches[f"fp32_{config}"] = {f"{name}_fp32": n for name, n in fp32.items()}
        launches[f"fp32_{config}"].update(flash_fwd_fp32_qm=kernels32["qm"],
                                          flash_fwd_fp32=kernels32["km"])
        del images
    del comps, pipe
    torch.cuda.empty_cache()
    return failures, s_per_img, launches


# Phase 15: the reference's 11 scenarios through the CLI's ``main``, each
# reading its inputs from inference_images/ (PNG, and JPEG through the
# port's decoder).
CLI_MAIN_SCENARIOS = ("generation_box_text", "generation_box_image", "hed", "canny", "normal",
                      "depth", "sem", "keypoint", "inpainting_box_text",
                      "generation_box_text_style", "inpainting_box_image")
CLI_DIR = REPO / "build" / "chip_smoke_cli"
# sha256 of PIL's (libjpeg-turbo's) RGB decode of each inference_images/*.jpg;
# tests/test_torch_jpeg.py holds them to PIL's decode on the CPU
JPEG_DIGESTS = {
    "beach": "6ff1e7dd489f29cf147c4e0b1d086d308e8bc04edb83420ebd62d47fb29bc9d6",
    "bigben": "e9c9dfe66febb2bc84e5ac505243c50bd0445ef82f6682ce45a0d5ae1cd2ac7b",
    "dalle2_museum": "f064ba689dac6b65e35932ad11c99044b2a4331c8b27712ca590e28553bf0c69",
    "style_golden": "734d4acecea05c496d26ebeddd9e6fcd91765ba16c856e02753610000d6ed9cc",
}
# bench_matrix's rows at the users' operating point
MATRIX_ROWS = ("plms50", "hed")
MATRIX_BATCH = 8


def run_cli(torch, np, seed, device, steps, batch=2):
    """Phase 15 (M10): ``inference/cli.py`` in this process, ``--ckpt random
    --dezero`` at full width, ``batch`` images, ``steps`` PLMS steps, in
    configuration (a): each of ``CLI_MAIN_SCENARIOS`` through ``main``, its
    inputs read from their files (the JPEGs by the port's decoder).  Every
    PNG written must read back (``data/png.py``) equal to
    ``(img * 255).astype(uint8)`` of the image ``generate`` returned, and
    each scenario must launch the path's kernels.  Then ``bench_matrix``'s
    ``MATRIX_ROWS`` at batch ``MATRIX_BATCH``, 50 steps, one repeat.
    Returns (failures, s/img by scenario, the bench_matrix rows)."""
    import shutil

    from gligen_tpu_torch.data import png
    from gligen_tpu_torch.inference import cli
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline
    from gligen_tpu_torch.tools.bench_matrix import ROWS, bench_row

    set_config("a")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    flags = ["--ckpt", "random", "--dezero", "--batch_size", str(batch), "--steps", str(steps),
             "--seed", str(seed), "--folder", str(CLI_DIR)]
    metas = {m["save_folder_name"]: m for m in cli.default_meta_list()}
    wrappers = kernel_wrappers()
    failures, s_per_img, recorded = [], {}, []
    real_generate = GenerationPipeline.generate

    def recording(self, *args, **kw):  # generate, timed, its images kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = real_generate(self, *args, **kw)
        torch.cuda.synchronize()
        recorded.append((img.cpu().numpy(), time.perf_counter() - t0))
        return img

    cwd = os.getcwd()
    GenerationPipeline.generate = recording
    os.chdir(REPO)  # the scenarios name their inputs from the repository's root
    try:
        for name in CLI_MAIN_SCENARIOS:
            for w in wrappers.values():
                w.launches = 0
            recorded.clear()
            cli.main(flags + ["--scenarios", name])
            meta = metas[name]
            jpegs = [p for p in [meta.get("input_image"), *meta.get("images", [])]
                     if isinstance(p, str) and p.endswith(".jpg")]
            how = "main()" + (f", reading {', '.join(jpegs)}" if jpegs else "")
            (images, seconds), = recorded
            written = [png.read_png(CLI_DIR / name / f"{i}.png") for i in range(batch)]
            same = all(mode == "RGB" and np.array_equal(pix, (img * 255).astype(np.uint8))
                       for (pix, mode), img in zip(written, images))
            launched = {k: wrappers[k].launches for k in PATH_KERNELS}
            ok = same and len(images) == batch and all(launched.values())
            s_per_img[name] = seconds / batch
            print(f"cli: {name} through {how}: {batch} PNGs read back equal to the images "
                  f"{same}; generate {seconds:.3f} s = {seconds / batch:.3f} s/img; launches "
                  f"{launched} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"cli ({name})")
    finally:
        GenerationPipeline.generate = real_generate
        os.chdir(cwd)
    torch.cuda.empty_cache()
    rows = []
    for name in MATRIX_ROWS:
        modality, sampler, n_steps = ROWS[name]
        rows.append(bench_row(name, modality, sampler, n_steps, MATRIX_BATCH, 1, device))
        torch.cuda.empty_cache()
    return failures, s_per_img, rows


# Phase 16: the Trainer through the training command line, on a TSV written
# here.  Image sizes: 512^2 (at size, a copy), 640 x 512 (the crop alone) and
# 1100 x 800 (bicubic down by 1.5625, center_crop_arr's other branch)
TRAIN_DIR = REPO / "build" / "chip_smoke_train"
TRAIN_ROWS = 16
TRAIN_SHAPES = ((512, 512), (512, 640), (800, 1100))
# a 4 x 4 JPEG (quality 95) and the sum of its decoded RGB pixels, PIL's
# and the port's decoder's (the accurate integer IDCT) alike
JPEG_4X4 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAIBAQEBAQIBAQECAgICAgQDAgICAgUEBAMEBgUGBgYFBgYGBwkIBgcJBwYG"
    "CAsICQoKCgoKBggLDAsKDAkKCgr/2wBDAQICAgICAgUDAwUKBwYHCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoK"
    "CgoKCgoKCgoKCgoKCgoKCgoKCgr/wAARCAAEAAQDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcI"
    "CQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRol"
    "JicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ip"
    "qrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAA"
    "AAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLR"
    "ChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
    "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEA"
    "PwD2j9n/AFW9Hwwsf3vr/IUUUU+Gox/1fwun/LuP5I/IOHsFg/7Dw37uPwR6LsvI/9k=")
JPEG_4X4_SUM = 5825
# the cached-latent loss against the live encode's, same draws: both encode
# the same pixels in bf16, the cache beside the flipped copy at batch 8 and
# the step at batch 4 (cuDNN may pick other algorithms), so a few bf16 ulps
# of the latents, far below a wrong latent (a flip or a row off: O(1))
CACHE_LOSS_REL_TOL = 1e-2


def write_train_data(np, seed):
    """The phase's TSV at ``catalog.py``'s FlickrGrounding path under
    ``TRAIN_DIR / "DATA"`` (``TRAIN_ROWS`` rows in the item format of the
    data tests: a seeded uint8 image of ``TRAIN_SHAPES``, 1 to 6 boxes
    inside the center crop, each with its 768-d embeddings) and a seeded
    768 x 768 projection matrix; PNG payloads.  Returns (TSV path,
    projection path, whether the JPEG decoder decodes here, its line)."""
    import shutil

    from gligen_tpu_torch.data import tsv
    from gligen_tpu_torch.data.catalog import dataset_catalog

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    path = dataset_catalog(str(TRAIN_DIR / "DATA"))["FlickrGrounding"]["train_params"]["tsv_path"]
    os.makedirs(os.path.dirname(path))
    rng = np.random.default_rng(seed + 16)
    proj = str(TRAIN_DIR / "projection_matrix.npy")
    np.save(proj, (rng.standard_normal((768, 768)) / np.sqrt(768)).astype(np.float32))
    writer = tsv.TSVWriter(path)
    for i in range(TRAIN_ROWS):
        h, w = TRAIN_SHAPES[i % len(TRAIN_SHAPES)]
        annos = []
        for k in range(1 + i % 6):
            x0, y0 = rng.uniform(0.2 * w, 0.6 * w), rng.uniform(0.2 * h, 0.6 * h)
            anno = {"bbox": [float(x0), float(y0), float(rng.uniform(0.1, 0.3) * w),
                             float(rng.uniform(0.1, 0.3) * h)]}
            for key in tsv.EMBEDDING_KEYS:
                anno[key] = tsv.encode_base64_fp32(rng.standard_normal(768))
            annos.append(anno)
        item = {"data_id": i, "caption": f"a scene number {i}", "annos": annos,
                "image": tsv.encode_base64_image(rng.integers(0, 256, (h, w, 3), np.uint8))}
        writer.write([i, json.dumps(item)])
    writer.close()
    pixels = tsv.decode_base64_image(JPEG_4X4)
    ok = pixels.shape == (4, 4, 3) and int(pixels.astype(np.int64).sum()) == JPEG_4X4_SUM
    return path, proj, True, (f"the port's JPEG decoder (no libjpeg): a 4 x 4 JPEG's pixels as "
                              f"PIL's {ok}; the rows are PNG (phase 17 trains on JPEG rows)"
                              + ("" if ok else " FAIL"))


def run_trainer(torch, np, seed, device, batch=4):
    """Phase 16 (M11b part 1): ``gligen_tpu_torch.main.main`` in this process
    on ``configs/flickr_text.yaml`` at full SD-1.4 GLIGEN width, the TSV of
    ``write_train_data``, configuration (a), remat full, the preview on:
    (1) 6 steps with EMA and 2 fork workers: a finite loss at every step and
    logged step, the JAX rule's checkpoints, frozen tensors bit for bit,
    every trainable moved, the preview's size, each step's launches against
    ``expected_train_launches``, every flash launch on the TMA route; (2) a
    resume to 8 in the same tag from step 6, its restored state bit for bit
    the saved one; (3) a SIGTERM after the first logged step: a checkpoint
    at that step, the event logged; (4) the latent cache of
    ``tools/prepare_latents.py`` with the run's VAE, the loss each way on
    the same draws; (5) the CLI serving the run's EMA shadow, one request.
    Returns (failures, the Trainer, summary line); the Trainer's two traced
    steps come after phase 11 (``train_idle_share``)."""
    import shutil
    import signal
    import threading

    from gligen_tpu_torch import main as train_main
    from gligen_tpu_torch.data import png
    from gligen_tpu_torch.inference import cli
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline
    from gligen_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from gligen_tpu_torch.tools import prepare_latents
    from gligen_tpu_torch.training import checkpoints as ckpt_io
    from gligen_tpu_torch.training import trainer as trainer_mod
    from gligen_tpu_torch.training.train_step import make_loss_fn

    set_config("a")
    os.environ["GLIGEN_TPU_REMAT_POLICY"] = "full"
    failures = []
    t0 = time.perf_counter()
    tsv_path, proj, _, jpeg_line = write_train_data(np, seed)
    from importlib.util import find_spec

    present = ", ".join(f"{m} {'installed' if find_spec(m) else 'absent'}" for m in ("PIL", "yaml"))
    print(f"trainer: wrote {TRAIN_ROWS} rows of {', '.join(f'{w} x {h}' for h, w in TRAIN_SHAPES)}"
          f" images in {time.perf_counter() - t0:.1f} s; {jpeg_line}; on this machine {present} "
          f"(the port imports neither)", flush=True)
    if "FAIL" in jpeg_line:
        failures.append("trainer jpeg")
    os.environ["GLIGEN_TPU_PROJECTION_MATRIX"] = proj
    out = TRAIN_DIR / "OUT"
    flags = ["--yaml_file", str(REPO / "configs" / "flickr_text.yaml"), "--DATA_ROOT",
             str(TRAIN_DIR / "DATA"), "--OUTPUT_ROOT", str(out), "--name", "smoke",
             "--batch_size", str(batch), "--save_every_iters", "3", "--warmup_steps", "1",
             "--enable_ema", "--workers", "2", "--seed", str(seed), "--device", str(device)]
    wrappers = kernel_wrappers()
    bwd = (flash_bwd_dq, flash_bwd_dkv)
    rec = {"steps": [], "saves": [], "first": None, "unet": None}
    real_components = trainer_mod.GligenComponents

    class Dezeroed(real_components):
        """Random weights de-zeroed from a seeded generator, alike in every
        run: at a fresh init the zero output conv blocks every gradient."""

        @classmethod
        def create(cls, *args, **kwargs):
            comps = real_components.create(*args, **kwargs)
            dezero_(comps.unet, torch.Generator(device=device).manual_seed(seed + 161))
            rec["unet"] = comps.unet
            return comps

    real_make, real_save = trainer_mod.make_train_step, trainer_mod.Trainer._save

    def make_recording(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def recording(state, batch_, generator=None, draws=None):
            if rec["first"] is not None:
                rec["first"](state)
                rec["first"] = None
            for w in wrappers.values():
                w.launches = 0
            routes = [dict(flash_fwd.routes)] + [dict(k.routes) for k in bwd]
            t = time.perf_counter()
            metrics = step(state, batch_, generator, draws)
            loss = metrics["loss"].item()
            rec["steps"].append(dict(
                t=t, step=state.step, loss=loss,
                launches={name: w.launches for name, w in wrappers.items()},
                copy=sum(k.routes["copy"] - r["copy"]
                         for k, r in zip((flash_fwd, *bwd), routes))))
            return metrics

        return recording

    def recording_save(self):
        rec["saves"].append(time.perf_counter())
        return real_save(self)

    def run(total, first=None, extra=()):
        rec["first"] = first
        return train_main.main(flags + ["--total_iters", str(total), *extra])

    trainer_mod.GligenComponents, trainer_mod.make_train_step = Dezeroed, make_recording
    trainer_mod.Trainer._save = recording_save
    try:
        # ---- (1) six steps ----
        torch.cuda.reset_peak_memory_stats()
        start = {}

        def snapshot(state):  # the UNet before its first step
            start.update({n: p.detach().clone() for n, p in rec["unet"].named_parameters()})

        t0 = time.perf_counter()
        tr = run(6, first=snapshot)
        wall1 = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        tag = tr.tag_dir
        steps1, saves1 = list(rec["steps"]), list(rec["saves"])
        losses = [s["loss"] for s in steps1]
        with open(os.path.join(tag, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        finite = bool(np.all(np.isfinite(losses))) and all(
            np.isfinite(r["loss"]) for r in logged if "loss" in r)
        frozen_ok = all(torch.equal(p, start[n]) for n, p in tr.unet.named_parameters()
                        if n not in tr.state.params)
        moved = all(not torch.equal(p, start[n]) for n, p in tr.state.params.items())
        want_ckpts = {f"checkpoint_{it + 1:08d}" for it in range(6)
                      if it == 5 or (it > 0 and it % 3 == 0)}
        names = set(os.listdir(tag))
        ckpt_ok = want_ckpts <= names and "checkpoint_latest" in names
        previews = sorted(n for n in names if n.startswith("preview_"))
        pixels, mode = png.read_png(os.path.join(tag, previews[-1]))
        preview_ok = mode == "RGB" and pixels.shape == (2 * 512, batch * 512, 3)
        expected = expected_train_launches(tr.components, 512, "a", use_checkpoint=True)
        counts_ok = all({k: s["launches"][k] for k in expected} == expected for s in steps1)
        copy = sum(s["copy"] for s in steps1)
        print(f"trainer: (1) main() on configs/flickr_text.yaml, batch {batch}, 6 steps, EMA, "
              f"2 fork workers: losses {', '.join(f'{x:.5f}' for x in losses)} (logged "
              f"{[r['iter'] for r in logged]}) finite {finite}; {sorted(want_ckpts)} and "
              f"checkpoint_latest {ckpt_ok}; frozen UNet tensors bit for bit {frozen_ok}, every "
              f"one of {len(tr.state.params)} trainable tensors moved {moved}; {previews} "
              f"{pixels.shape} {preview_ok}; launches per step as expected_train_launches "
              f"{counts_ok} ({steps1[-1]['launches']}); flash launches on the copy route {copy}",
              flush=True)
        for ok, what in ((finite, "loss"), (ckpt_ok, "checkpoints"), (frozen_ok, "frozen"),
                         (moved, "moved"), (preview_ok, "preview"), (counts_ok, "launches"),
                         (copy == 0, "flash route")):
            if not ok:
                failures.append(f"trainer (1) {what}")
        del start

        # ---- (2) resume to 8 from step 6: the restored state bit for bit
        # run (1)'s final state, which checkpoint_00000006 saved ----
        saved = tr.state
        restored = {}

        def compare(state):
            opt, want = state.optimizer.state_dict(), saved.optimizer.state_dict()
            moments = all(torch.equal(opt["state"][i][k], s[k]) for i, s in want["state"].items()
                          for k in ("step", "exp_avg", "exp_avg_sq"))
            restored["ok"] = (
                state.step == saved.step == 6
                and all(torch.equal(p, saved.params[n]) for n, p in state.params.items())
                and all(torch.equal(e, saved.ema_params[n]) for n, e in state.ema_params.items())
                and moments and opt["param_groups"] == want["param_groups"]
                and state.scheduler.state_dict() == saved.scheduler.state_dict())

        rec["steps"].clear()
        tr2 = run(8, first=compare)
        resume_ok = (tr2.tag_dir == tag and tr2.starting_iter == 6 and tr2.state.step == 8
                     and restored.get("ok", False))
        print(f"trainer: (2) resume to 8 in {os.path.relpath(tag, REPO)} from step "
              f"{tr2.starting_iter}: trainable, EMA, AdamW moments, schedule and step bit for "
              f"bit the saved checkpoint {restored.get('ok')}; now at {tr2.state.step} "
              f"{'ok' if resume_ok else 'FAIL'}", flush=True)
        if not resume_ok:
            failures.append("trainer (2) resume")
        del saved, tr, tr2

        # ---- (3) SIGTERM after the first logged step ----
        metrics_path = os.path.join(tag, "metrics.jsonl")
        with open(metrics_path) as f:
            lines_before = len(f.readlines())

        def send():
            while True:
                with open(metrics_path) as f:
                    if len(f.readlines()) > lines_before:
                        break
                time.sleep(0.02)
            os.kill(os.getpid(), signal.SIGTERM)

        sender = threading.Thread(target=send, daemon=True)
        sender.start()
        rec["steps"].clear()
        rec["saves"].clear()
        tr3 = run(40, extra=["--save_every_iters", "1000"])  # no save before the signal
        sender.join(timeout=60)
        with open(metrics_path) as f:
            last = json.loads(f.readlines()[-1])
        latest = ckpt_io.latest_checkpoint(tag)
        pre_ok = (last.get("event") == "preempted, checkpointed" and not sender.is_alive()
                  and tr3.state.step == last["iter"] + 1 < 40
                  and os.path.basename(latest) == f"checkpoint_{tr3.state.step:08d}")
        print(f"trainer: (3) SIGTERM after the first logged step of a run to 40 from 8: "
              f"{last} and {os.path.basename(latest)} {'ok' if pre_ok else 'FAIL'}", flush=True)
        if not pre_ok:
            failures.append("trainer (3) preemption")
        # the loop's s/step, data included: the intervals between step starts
        # of runs (1) and (3) that hold no checkpoint or preview, each run's
        # first step left out
        gaps = []
        for steps, saves in ((steps1, saves1), (rec["steps"], rec["saves"])):
            starts = [s["t"] for s in steps]
            gaps += [b - a for a, b in list(zip(starts, starts[1:]))[1:]
                     if not any(a < t < b for t in saves)]
    finally:
        trainer_mod.GligenComponents, trainer_mod.make_train_step = real_components, real_make
        trainer_mod.Trainer._save = real_save
    s_step = sum(gaps) / max(len(gaps), 1)

    # ---- the host's decode and collate per batch, serial ----
    dataset = tr3.build_dataset()
    decode, collate = [], []
    for i in range(0, TRAIN_ROWS, batch):
        t = time.perf_counter()
        items = [dataset[j] for j in range(i, i + batch)]
        decode.append(time.perf_counter() - t)
        t = time.perf_counter()
        tr3.collate(items)
        collate.append(time.perf_counter() - t)

    # ---- (4) the latent cache with the run's VAE, one step's loss each way ----
    cache_dir = str(TRAIN_DIR / "latents")
    prepare_latents.main(["--tsv", tsv_path, "--out_dir", cache_dir, "--batch", str(batch)],
                         vae=tr3.vae)
    tr3.run.cached_latents = cache_dir
    cached_ds = tr3.build_dataset()
    tr3.run.cached_latents = None
    live_ds = tr3.build_dataset()
    items_c, items_l = [cached_ds[i] for i in range(batch)], [live_ds[i] for i in range(batch)]
    batch_c, batch_l = tr3.collate(items_c), tr3.collate(items_l)
    batch_c.pop("image")
    rng = np.random.default_rng(seed + 162)
    lat = (batch, 64, 64, 4)
    draws = {"posterior": rng.standard_normal(lat), "u_t": rng.random(batch),
             "noise": rng.standard_normal(lat), "u_drop": rng.random(())}
    loss_fn = make_loss_fn(tr3.unet, tr3.vae, tr3.text_encoder, tr3.schedule)
    with torch.no_grad():
        cached, live = loss_fn(batch_c, draws=draws).item(), loss_fn(batch_l, draws=draws).item()
    diff = abs(cached - live)
    cache_ok = np.isfinite(cached) and diff <= CACHE_LOSS_REL_TOL * abs(live)
    print(f"trainer: (4) tools/prepare_latents.py with the run's VAE: the loss on {batch} cached "
          f"latents {cached:.6f}, on the live encode {live:.6f} (same draws): "
          f"{'equal' if cached == live else f'differ by {diff:.3e} = {diff / abs(live):.2e} of it'}"
          f" (limit {CACHE_LOSS_REL_TOL:g} relative) {'ok' if cache_ok else 'FAIL'}", flush=True)
    if not cache_ok:
        failures.append("trainer (4) latent cache")

    # ---- (5) the CLI serves the run's EMA shadow: its UNet checked as the
    # request's generate starts ----
    serve = ["--ckpt", "random", "--dezero", "--train_ckpt", tag, "--use_ema", "--batch_size",
             "2", "--steps", "10", "--seed", str(seed), "--folder", str(TRAIN_DIR / "served"),
             "--device", str(device)]
    args = cli.parser().parse_args(serve)
    ema = ckpt_io.load_training_params(tag, use_ema=True)
    served = {}
    real_generate = GenerationPipeline.generate

    def checking(self, *a, **kw):
        params = dict(self.c.unet.named_parameters())
        served["ok"] = sorted(ema) == sorted(tr3.state.params) and all(
            torch.equal(params[n].detach().cpu(), t) for n, t in ema.items())
        return real_generate(self, *a, **kw)

    meta = dict(next(m for m in cli.default_meta_list()
                     if m["save_folder_name"] == "generation_box_text"), ckpt="random")
    GenerationPipeline.generate = checking
    try:
        t = time.perf_counter()
        paths = cli.run(meta, args)
        request_s = time.perf_counter() - t
    finally:
        GenerationPipeline.generate = real_generate
    served_ok = served.get("ok", False)
    images = [png.read_png(p) for p in paths]
    served_ok = served_ok and len(images) == 2 and all(
        m == "RGB" and px.shape == (512, 512, 3) for px, m in images)
    print(f"trainer: (5) the CLI with --ckpt random --train_ckpt {os.path.relpath(tag, REPO)} "
          f"--use_ema: its UNet's {len(ema)} trainable tensors bit for bit the checkpoint's EMA "
          f"shadow, one request of 2 images at 512^2 in {request_s:.2f} s (build included) "
          f"{'ok' if served_ok else 'FAIL'}", flush=True)
    if not served_ok:
        failures.append("trainer (5) serving")
    shutil.rmtree(out, ignore_errors=True)  # ~3 GB a checkpoint
    line = (f"trainer: {s_step:.4f} s/step of the loop, data included (mean of {len(gaps)} "
            f"intervals between step starts without a checkpoint or preview: "
            f"{', '.join(f'{g:.4f}' for g in gaps)}), batch {batch} at 512^2, 2 fork workers; "
            f"the host's decode {1e3 * sum(decode) / len(decode):.1f} ms and collate "
            f"{1e3 * sum(collate) / len(collate):.1f} ms per batch (serial, mean of "
            f"{len(decode)}); peak memory {peak:.2f} GiB over run (1) ({wall1:.1f} s wall, "
            f"builds and previews included)")
    print(line, flush=True)
    return failures, tr3, line


def train_idle_share(torch, trainer, batch=4, label="trainer"):
    """The device's idle share over two traced steps of phase 16's Trainer
    (a batch from its loader, profiled with CUDA activity only): 1 - device
    busy / the traced wall.  Run after phase 11, as no profiler run may
    precede a timed phase."""
    from gligen_tpu_torch.tools.perf_probe import device_breakdown, traced

    set_config("a")
    loader = trainer.batches(trainer.build_dataset())
    try:
        batches = [next(loader) for _ in range(2)]
    finally:
        loader.close()
    gen = torch.Generator(device=trainer.device).manual_seed(0)

    def two_steps():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches:
            trainer._train_step(trainer.state, b, generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    two_steps()  # warm
    wall, trace = traced(two_steps)
    _, busy, n, _ = device_breakdown(trace)
    return (f"{label}: two traced steps (batch {batch} at 512^2, host batches ready): wall "
            f"{wall:.1f} ms, device busy {busy:.1f} ms over {n} kernels and copies: idle "
            f"{1 - busy / wall:.1%}")


# Phase 17 (M11b part 2): the keypoint and spatial modalities trained from
# the reference's on-disk formats, written under MODALITY_DIR at the
# catalog's paths from the repository's JPEGs: (modality, config, steps)
MODALITY_DIR = REPO / "build" / "chip_smoke_modalities"
MODALITY_RUNS = (("keypoint", "coco2017K.yaml", 3), ("hed", "cc3m_hed.yaml", 3),
                 ("normal", "diode_normal.yaml", 2), ("sem", "ade_sem.yaml", 2))
# hed's dataset class: one collated batch each on the host
MODALITY_HOST = (("canny", "cc3m_canny.yaml"), ("depth", "cc3m_depth.yaml"))
MODALITY_TRACED = ("keypoint", "hed")
REALDATA_ROWS = 64


def check_jpegs(np, repeats=5):
    """The four inference_images/*.jpg through the port's decoder on this
    host: each decode's sha256 against ``JPEG_DIGESTS`` (PIL's), and its
    ms (median of ``repeats``, the build before).  Returns (ok, line)."""
    import hashlib

    from gligen_tpu_torch.data import jpeg

    t0 = time.perf_counter()
    jpeg.jpeg_library()
    build_s = time.perf_counter() - t0
    ok, parts = True, []
    for name, digest in JPEG_DIGESTS.items():
        raw = (REPO / "inference_images" / f"{name}.jpg").read_bytes()
        times = []
        for _ in range(repeats):
            t = time.perf_counter()
            pixels = jpeg.decode_rgb(raw)
            times.append(time.perf_counter() - t)
        same = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest() == digest
        ok = ok and same
        parts.append(f"{name} {pixels.shape[1]}x{pixels.shape[0]} "
                     f"{1e3 * sorted(times)[repeats // 2]:.2f} ms"
                     + (" = PIL's" if same else " DIFFERS from PIL's"))
    return ok, (f"modalities: JPEG decode on the host (csrc/jpeg_baseline.cpp, no library; built "
                f"in {build_s:.1f} s), sha256 of each image's pixels against PIL's, median of "
                f"{repeats}: {'; '.join(parts)} {'ok' if ok else 'FAIL'}")


def write_modality_data(np, seed):
    """The phase's datasets under ``MODALITY_DIR / "DATA"``
    (``tools/modality_data.py``): a COCO keypoint tree of the four JPEGs
    (1 to 3 seeded persons each) with captions; the CC3M image TSV of their
    bytes with hed, canny and depth TSVs of seeded PNG maps; a DIODE tree
    of their pixels as PNG with seeded .npy normals; an ADE tree of the
    JPEGs with seeded label PNGs in [0, 151].  Returns the data root."""
    import shutil

    from gligen_tpu_torch.data import jpeg, png
    from gligen_tpu_torch.tools import modality_data as md

    shutil.rmtree(MODALITY_DIR, ignore_errors=True)
    data = str(MODALITY_DIR / "DATA")
    rng = np.random.default_rng(seed + 17)
    jpegs = md.images_from_files([REPO / "inference_images" / f"{n}.jpg" for n in JPEG_DIGESTS])
    md.write_keypoint_tree(data, jpegs, rng)
    md.write_paired_tsvs(data, jpegs, rng)
    md.write_normal_tree(data, [(n.replace(".jpg", ".png"), png.encode_png(jpeg.decode_rgb(raw)),
                                 hw) for n, raw, hw in jpegs], rng)
    md.write_sem_tree(data, jpegs, rng)
    return data


def bad_sem_label(np, seed):
    """A label PNG holding 152 must raise ``ValueError`` naming its file and
    the label.  Returns (ok, line)."""
    from gligen_tpu_torch.data import png
    from gligen_tpu_torch.data.spatial_datasets import SemanticDataset
    from gligen_tpu_torch.tools import modality_data as md

    rng = np.random.default_rng(seed + 172)
    jpegs = md.images_from_files([REPO / "inference_images" / "beach.jpg"])
    params = md.write_sem_tree(str(MODALITY_DIR / "BAD"), jpegs, rng)
    path = os.path.join(params["sem_rootdir"], "beach.png")
    labels, _ = png.read_png(path)
    labels[256, 256] = 152
    png.write_png(path, labels)
    try:
        SemanticDataset(image_size=512, **params)[0]
        raised = "nothing raised"
    except ValueError as e:
        raised = str(e)
    ok = "beach.png" in raised and "label 152" in raised
    return ok, (f"modalities: a label of 152 in {os.path.relpath(path, REPO)}: ValueError "
                f"{raised!r} {'ok' if ok else 'FAIL'}")


def run_modalities(torch, np, seed, device, batch=4):
    """Phase 17 (M11b part 2): the JPEG check; the datasets of
    ``write_modality_data``; ``gligen_tpu_torch.main.main`` in this process
    on each of ``MODALITY_RUNS`` at full SD-1.4 GLIGEN width (random weights,
    de-zeroed), configuration (a), remat full, batch ``batch``, 2 fork
    workers, no preview: finite losses, frozen tensors bit for bit, every
    trainable tensor moved unless its gradient was zero at every step
    (Adam's first moment zero: the null features behind masks of 1), each
    step's launches as ``expected_train_launches``, every flash launch on
    the TMA route; s/step, the serial decode of a batch, peak memory.  The
    Trainer's checkpoint writes (~3 GB each) are recorded, not made: phase
    16 writes and resumes them.  Then canny and depth as one collated batch
    each, a bad sem label, and ``tools/bench_train_realdata.py`` (``--make
    --rows REALDATA_ROWS``, ``--input_only`` at 1 and 2 workers).  Returns
    (failures, {modality: Trainer} of ``MODALITY_TRACED`` for the traced
    steps after phase 11, summary line)."""
    from gligen_tpu_torch import main as train_main
    from gligen_tpu_torch.config import load_yaml_config, normalize_model_config
    from gligen_tpu_torch.data.catalog import dataset_catalog
    from gligen_tpu_torch.data.concat import ConCatDataset
    from gligen_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from gligen_tpu_torch.tools import bench_train_realdata as bench
    from gligen_tpu_torch.training import trainer as trainer_mod

    set_config("a")
    os.environ["GLIGEN_TPU_REMAT_POLICY"] = "full"
    failures = []
    ok, line = check_jpegs(np)
    print(line, flush=True)
    if not ok:
        failures.append("modalities jpeg")
    t0 = time.perf_counter()
    data = write_modality_data(np, seed)
    print(f"modalities: wrote the keypoint, CC3M (hed, canny, depth), DIODE and ADE datasets of "
          f"{len(JPEG_DIGESTS)} images under {os.path.relpath(data, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    wrappers = kernel_wrappers()
    bwd = (flash_bwd_dq, flash_bwd_dkv)
    rec = {"steps": [], "unet": None, "start": None, "saves": [], "on": True}
    real_components = trainer_mod.GligenComponents
    real_make, real_save = trainer_mod.make_train_step, trainer_mod.Trainer._save

    class Dezeroed(real_components):
        @classmethod
        def create(cls, *args, **kwargs):
            comps = real_components.create(*args, **kwargs)
            dezero_(comps.unet, torch.Generator(device=device).manual_seed(seed + 171))
            rec["unet"] = comps.unet
            return comps

    def make_recording(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def recording(state, batch_, generator=None, draws=None):
            if not rec["on"]:  # the traced steps after phase 11
                return step(state, batch_, generator, draws)
            if rec["start"] is None:  # the UNet before its first step
                rec["start"] = {n: p.detach().clone() for n, p in rec["unet"].named_parameters()}
            for w in wrappers.values():
                w.launches = 0
            routes = [dict(flash_fwd.routes)] + [dict(k.routes) for k in bwd]
            t = time.perf_counter()
            metrics = step(state, batch_, generator, draws)
            loss = metrics["loss"].item()
            rec["steps"].append(dict(
                t=t, end=time.perf_counter(), loss=loss,
                launches={name: w.launches for name, w in wrappers.items()},
                copy=sum(k.routes["copy"] - r["copy"] for k, r in zip((flash_fwd, *bwd), routes))))
            return metrics

        return recording

    def recorded_save(self):
        rec["saves"].append(self.state.step)

    traced, s_step, summary = {}, {}, []
    trainer_mod.GligenComponents, trainer_mod.make_train_step = Dezeroed, make_recording
    trainer_mod.Trainer._save = recorded_save
    try:
        for modality, yaml_name, steps in MODALITY_RUNS:
            rec["steps"].clear()
            rec["saves"].clear()
            rec["start"] = None
            torch.cuda.reset_peak_memory_stats()
            # the Trainers kept for the traced steps stay allocated: the run's
            # own peak is the peak above them
            resident = torch.cuda.memory_allocated() / 2**30
            flags = ["--yaml_file", str(REPO / "configs" / yaml_name), "--DATA_ROOT", data,
                     "--OUTPUT_ROOT", str(MODALITY_DIR / "OUT"), "--name", modality,
                     "--batch_size", str(batch), "--warmup_steps", "1", "--workers", "2",
                     "--total_iters", str(steps), "--save_every_iters", "1000",
                     "--disable_inference_in_training", "true", "--seed", str(seed),
                     "--device", str(device)]
            t0 = time.perf_counter()
            tr = train_main.main(flags)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30 - resident
            done, start = list(rec["steps"]), rec["start"]
            rec["start"] = None
            losses = [s["loss"] for s in done]
            finite = len(losses) == steps and bool(np.all(np.isfinite(losses)))
            frozen_ok = all(torch.equal(p, start[n]) for n, p in tr.unet.named_parameters()
                            if n not in tr.state.params)
            opt = tr.state.optimizer.state

            def zero_moment(p):
                m = opt.get(p, {}).get("exp_avg")
                return m is None or not bool(m.abs().max() > 0)

            unmoved = [n for n, p in tr.state.params.items() if torch.equal(p, start[n])]
            stuck = [n for n in unmoved if not zero_moment(tr.state.params[n])]
            del start
            expected = expected_train_launches(tr.components, 512, "a", use_checkpoint=True)
            counts_ok = all({k: s["launches"][k] for k in expected} == expected for s in done)
            copy = sum(s["copy"] for s in done)
            s_step[modality] = (done[-1]["end"] - done[1]["t"]) / (steps - 1)
            dataset = tr.build_dataset()
            t = time.perf_counter()
            for j in range(batch):
                dataset[j]
            decode_ms = 1e3 * (time.perf_counter() - t)
            ok = (finite and frozen_ok and not stuck and counts_ok and copy == 0
                  and tr.run.grounding_modality == modality and tr.state.step == steps)
            print(f"modalities: {modality}: main() on configs/{yaml_name}, batch {batch}, "
                  f"{steps} steps, 2 fork workers: losses {', '.join(f'{x:.5f}' for x in losses)}"
                  f" finite {finite}; frozen UNet tensors bit for bit {frozen_ok}; "
                  f"{len(tr.state.params) - len(unmoved)} of {len(tr.state.params)} trainable "
                  f"tensors moved, the rest with zero gradient throughout "
                  f"({', '.join(unmoved) or 'none'}); moved despite a gradient: {stuck or 'none'};"
                  f" launches per step as expected_train_launches {counts_ok} "
                  f"({done[-1]['launches']}); flash launches on the copy route {copy}; "
                  f"{s_step[modality]:.4f} s/step after the first; serial decode "
                  f"{decode_ms:.1f} ms a batch; peak {peak:.2f} GiB above the {resident:.2f} "
                  f"GiB allocated before the run; {wall:.1f} s wall (build "
                  f"included); checkpoint writes recorded, not made, at steps {rec['saves']} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"modalities {modality}")
            summary.append(f"{modality} {s_step[modality]:.4f} s/step, decode {decode_ms:.1f} ms"
                           f" a batch, peak {peak:.2f} GiB")
            if modality in MODALITY_TRACED:
                traced[modality] = tr
            del tr, dataset
            torch.cuda.empty_cache()
    finally:
        trainer_mod.GligenComponents, trainer_mod.make_train_step = real_components, real_make
        trainer_mod.Trainer._save = real_save
        rec["on"] = False

    # ---- canny and depth: one collated batch each, on the host ----
    for modality, yaml_name in MODALITY_HOST:
        config = normalize_model_config(load_yaml_config(str(REPO / "configs" / yaml_name)))
        ds = ConCatDataset.from_catalog(config["train_dataset_names"], dataset_catalog(data))
        shim = bench.input_shim(1, batch, modality)
        t = time.perf_counter()
        b = shim.collate([ds[i] for i in range(batch)])
        host_ms = 1e3 * (time.perf_counter() - t)
        key = {"canny": "canny_edge", "depth": "depth"}[modality]
        g = b["grounding"]
        ok = (tuple(g[key].shape) == (batch, 512, 512, 3) and g[key].dtype == torch.uint8
              and tuple(g["mask"].shape) == (batch,) and torch.equal(b["grounding_extra"], g[key])
              and b["image"].shape == (batch, 512, 512, 3) and bool(np.isfinite(b["image"]).all())
              and -1.0 <= float(b["image"].min()) and float(b["image"].max()) <= 1.0)
        print(f"modalities: {modality}: configs/{yaml_name}'s dataset from the catalog, one batch "
              f"decoded and collated on the host in {host_ms:.1f} ms: image {b['image'].shape}, "
              f"{key} {tuple(g[key].shape)} {g[key].dtype}, grounding_extra the same map "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"modalities {modality}")
    ok, line = bad_sem_label(np, seed)
    print(line, flush=True)
    if not ok:
        failures.append("modalities sem label")

    # ---- the real-data bench: JPEG rows through the Trainer's batches ----
    path = str(MODALITY_DIR / "realdata" / "grounding_512.tsv")
    made, = bench.main(["--tsv", path, "--make", "--rows", str(REALDATA_ROWS)], device=device)
    recs = [bench.main(["--tsv", path, "--input_only", "--workers", str(w)], device=device)[0]
            for w in (1, 2)]
    line = (f"realdata: {made['rows']} JPEG rows ({made['mb']} MB): "
            + "; ".join(f"{r['workers']} worker(s) {r['batches_per_sec']:.3f} batches/s "
                        f"({r['value']:.2f} img/s, batch {r['batch']}, {r['host_cores_busy']:.2f} "
                        f"of {r['host_cores']} host cores busy, serial decode "
                        f"{r['serial_decode_ms_per_batch']:.1f} ms a batch)" for r in recs)
            + "; beside the phase's train step at "
            + ", ".join(f"{m} {1 / s:.3f} steps/s" for m, s in s_step.items()))
    print(line, flush=True)
    ok = all(r["value"] > 0 for r in recs)
    if not ok:
        failures.append("modalities realdata")
    return failures, traced, "modalities: " + "; ".join(summary) + "; " + line


# Phase 18 (M13): the server at full width, over HTTP on 127.0.0.1.  Each
# burst image is held to its seed's image sent alone (another bucket: the
# kernels' tiles differ with the batch) at the small-reference limit.
SERVE_WINDOW_MS = 25
SERVE_BURST = 6
BURST_TOL = 2e-2  # mean abs pixel in [0, 1]
SERVE_PHRASES = ["a teddy bear", "a bird"]
SERVE_BOXES = [[0.0, 0.09, 0.33, 0.76], [0.55, 0.11, 1.0, 0.8]]
# bench_serve_overlap at the users' operating point
OVERLAP = dict(clients=2, reqs=3, steps=50, batch=8)
INPAINT_BOXES = [[0.25, 0.28, 0.42, 0.52], [0.14, 0.58, 0.58, 0.92]]


class Served:
    """A ``ServingSession`` behind ``make_server`` on 127.0.0.1 (a free
    port) in a thread; ``close`` stops the server and the session."""

    def __init__(self, session):
        import threading

        from gligen_tpu_torch.serving.server import make_server

        self.session = session
        self.server = make_server(session, host="127.0.0.1", port=0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def _call(self, req):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(req, timeout=900) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path):
        return self._call(f"{self.url}{path}")

    def post(self, body):
        import urllib.request

        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        return self._call(urllib.request.Request(f"{self.url}/generate", data,
                                                 {"Content-Type": "application/json"}))

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()
        self.session.close()


def serving_session(comps, unet_config, steps, window_ms=SERVE_WINDOW_MS):
    """The session ``serving/server.py:build_session`` makes of random
    weights: the hash tokenizer, CLIP text features and the pseudo image
    features of ``allow_random``; ``steps`` by default."""
    from gligen_tpu_torch.data.tokenizer import HashTokenizer
    from gligen_tpu_torch.inference.cli import FeatureExtractor
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline
    from gligen_tpu_torch.serving.server import ServingSession

    pipe = GenerationPipeline(comps)
    pipe.tokenizer, pipe.unet_config = HashTokenizer(), dict(unet_config)
    features = FeatureExtractor(comps.text_encoder, pipe.tokenizer, allow_random=True)
    return ServingSession(pipe, pipe.tokenizer, features, default_steps=steps,
                          batch_window_ms=window_ms)


def served_images(np, body, size):
    """(the images of a /generate answer in [0, 1], decoded by the port's
    PNG decoder; whether each is size^2 RGB and not constant)."""
    import base64

    from gligen_tpu_torch.data import png

    imgs = [png.decode_png(base64.b64decode(b))[0].astype(np.float32) / 255.0
            for b in body.get("images", [])]
    ok = bool(imgs) and all(i.shape == (size, size, 3) and float(i.std()) > 1e-3 for i in imgs)
    return imgs, ok


def box_request(batch, seed, steps, **kw):
    return dict({"prompt": "a teddy bear sitting next to a bird", "phrases": SERVE_PHRASES,
                 "locations": SERVE_BOXES, "batch_size": batch, "seed": seed, "steps": steps},
                **kw)


def run_serving(torch, np, seed, device, steps, phase4_launches):
    """Phase 18: phase 4's model (configuration (a)) served by a
    ``ServingSession`` with a 25 ms window over ``make_server``: warmup and
    /ready, a burst, 1024^2, /metrics after a malformed body, one request's
    launches, ``bench_serve_overlap`` and features mid-batch; then phase
    10's inpaint checkpoint, phase 13's hed checkpoint and a sem model each
    in a session of its own.  Returns (failures, summary numbers)."""
    import base64
    import collections
    import threading

    from gligen_tpu_torch.data import png
    from gligen_tpu_torch.inference.cli import components_from_checkpoint
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.ops import flash_attention
    from gligen_tpu_torch.ops.flash_attention import flash_fwd
    from gligen_tpu_torch.ops.fused_norm import group_norm_fused
    from gligen_tpu_torch.tools import bench_serve_overlap
    from gligen_tpu_torch.tools.reference_ckpt import reference_checkpoint

    set_config("a")
    failures, out = [], {}

    def check(ok, name, line):
        print(f"serving: {line} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"serving {name}")

    comps = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device)
    dezero_(comps.unet, torch.Generator(device=device).manual_seed(seed + 1))
    served = Served(serving_session(comps, {}, steps))
    session, pipe = served.session, served.session.pipe
    calls, entered = [], threading.Event()  # (rows, latent) of each pipeline call
    real_generate = pipe.generate

    def generate(ids, *a, **kw):
        calls.append((len(ids), kw["latent_size"]))
        entered.set()
        return real_generate(ids, *a, **kw)

    pipe.generate = generate
    sent = collections.Counter()
    try:
        # 1. warmup in the background; /ready 503 "warming", then 200
        t0 = time.perf_counter()
        session.warmup(buckets=(1, 2), resolutions=(512, 1024), background=True)
        first = served.get("/ready")
        while session.warmup_error is None and not session.ready \
                and time.perf_counter() - t0 < 600:
            time.sleep(0.05)
        out["warmup_s"] = time.perf_counter() - t0
        ready = served.get("/ready")
        warmed = sorted(calls)
        sent.update(requests=len(warmed), images=sum(b for b, _ in warmed))
        check(first == (503, {"status": "warming"}) and ready == (200, {"status": "ready"})
              and warmed == [(1, 64), (1, 128), (2, 64), (2, 128)], "warmup",
              f"warmup of buckets 1, 2 at 512^2 and 1024^2 ({steps} steps) in the background: "
              f"/ready {first} then {ready} after {out['warmup_s']:.1f} s; pipeline calls (rows, "
              f"latent) {warmed}")

        # 2. a burst of single-image requests, then each seed alone
        calls.clear()
        barrier, burst = threading.Barrier(SERVE_BURST), {}

        def client(s):
            barrier.wait()
            burst[s] = served.post(box_request(1, s, steps))

        threads = [threading.Thread(target=client, args=(s,)) for s in range(SERVE_BURST)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["burst_s_per_img"] = (time.perf_counter() - t0) / SERVE_BURST
        burst_calls = list(calls)
        diffs, ok = [], len(burst) == SERVE_BURST
        for s in range(SERVE_BURST):
            code, body = burst.get(s, (0, {}))
            imgs, sound = served_images(np, body, 512)
            code_alone, alone = served.post(box_request(1, s, steps))
            imgs_alone, sound_alone = served_images(np, alone, 512)
            ok &= code == code_alone == 200 and sound and sound_alone
            if imgs and imgs_alone:
                diffs.append(float(np.abs(imgs[0] - imgs_alone[0]).mean()))
        sent.update(requests=2 * SERVE_BURST, images=2 * SERVE_BURST)
        check(ok and len(diffs) == SERVE_BURST and max(diffs) <= BURST_TOL
              and len(burst_calls) < SERVE_BURST, "burst",
              f"burst of {SERVE_BURST} requests of batch 1 ({steps} steps, seeds 0-"
              f"{SERVE_BURST - 1}): {len(burst_calls)} pipeline calls at buckets "
              f"{[b for b, _ in burst_calls]}, {out['burst_s_per_img']:.4f} s/img over the burst; "
              f"each image against its seed alone: mean abs pixel "
              f"{', '.join(f'{d:.5f}' for d in diffs)} (limit {BURST_TOL})")

        # 3. 1024^2 at batch 2: attention over 16,384 keys on the TMA route
        seen, real_launch = [], flash_attention.launch_fwd

        def observe(library, q, k, v, heads, bias, tiles):
            res = real_launch(library, q, k, v, heads, bias, tiles)
            seen.append((k.shape[1], q.shape[2] // heads, res[2]))
            return res

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launch_fwd = observe
        t0 = time.perf_counter()
        try:
            code, body = served.post(box_request(2, 11, steps, resolution=1024))
        finally:
            flash_attention.launch_fwd = real_launch
        out["s_per_img_1024"] = (time.perf_counter() - t0) / 2
        out["peak_gib_1024"] = torch.cuda.max_memory_allocated() / 2**30
        sent.update(requests=1, images=2)
        _, sound = served_images(np, body, 1024)
        at16k = collections.Counter(f"d {d} {route}" for m, d, route in seen if m == 16384)
        check(code == 200 and sound and at16k.get("d 40 tma", 0) > 0
              and all(route == "tma" for _, _, route in seen), "1024",
              f"1024^2, batch 2 ({steps} steps): {out['s_per_img_1024']:.4f} s/img, peak "
              f"allocated {out['peak_gib_1024']:.2f} GiB ({resident:.2f} GiB resident before); "
              f"flash launches over 16,384 keys {dict(at16k)} (attn1 at ds1 is d 40, the VAE's "
              f"mid-attention d 512), every launch on TMA")

        # 6. a malformed body, then /metrics
        code, body = served.post(b"{not json")
        sent.update(requests=1, errors=1)
        mcode, m = served.get("/metrics")
        check(code == 500 and body["error"].startswith("JSONDecodeError") and mcode == 200
              and all(m[k] == sent[k] for k in ("requests", "images", "errors"))
              and 0 <= m["latency_p50_sec"] <= m["latency_p95_sec"], "metrics",
              f"malformed body -> {code} {body}; /metrics {m} (sent {dict(sent)})")

        # 7. one request alone launches what phase 4's request launches
        wrappers = kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        code, body = served.post(box_request(2, 3, steps))
        counts = {name: w.launches for name, w in wrappers.items()}
        expected, _, _ = expected_launches(comps, steps, [0.3, 0.0, 0.7], 64, "a")
        phase4 = {k: v // 2 for k, v in phase4_launches.items()}
        check(code == 200 and counts == expected == phase4, "launches",
              f"one request alone (batch 2, {steps} steps, the default alpha stages): launches "
              f"{counts}, phase 4's per request {phase4}")

        # 8. pipelined against serialized completion
        rates = bench_serve_overlap.run(session, **OVERLAP)
        out["overlap"] = rates
        print(f"serving: bench_serve_overlap ({OVERLAP['clients']} clients x {OVERLAP['reqs']} "
              f"back-to-back requests of batch {OVERLAP['batch']}, {OVERLAP['steps']} steps): "
              + ", ".join(f"{arm} {rates[arm]:.4f} img/s" for arm in bench_serve_overlap.ARMS)
              + f"; pipelined vs serialized {rates['gain_pct']:+.2f}%", flush=True)

        # 9. a request's features while a batch-8 request is on the card
        done, real_run = [], session.streams.run

        def run(fn):
            res = real_run(fn)
            done.append(res[1])
            return res

        session.streams.run = run
        entered.clear()
        batch_answer = {}
        t = threading.Thread(target=lambda: batch_answer.update(
            r=served.post(box_request(8, 21, OVERLAP["steps"]))))
        t0 = time.perf_counter()
        t.start()
        entered.wait(600)
        time.sleep(0.3)
        n_done = len(done)
        t1 = time.perf_counter()
        with session.streams.for_features():
            grounding, _ = session._grounding_for_modality(
                {"phrases": ["a red car", "a tree", "a dog"],
                 "locations": SERVE_BOXES + [[0.2, 0.2, 0.4, 0.4]]}, 1)
        feat_ms = (time.perf_counter() - t1) * 1e3
        in_flight = len(done) == n_done or not done[-1].query()
        t.join()
        batch_s = time.perf_counter() - t0
        session.streams.run = real_run
        feats_ok = bool(np.abs(grounding["positive_embeddings"][0, :3]).sum(-1).all())
        check(in_flight and feats_ok and batch_answer["r"][0] == 200, "features mid-batch",
              f"three phrases' CLIP features {feat_ms:.1f} ms, ready while the batch-8 request "
              f"({OVERLAP['steps']} steps, {batch_s:.2f} s in all) was still on the card "
              f"{in_flight}")
        out["features_ms"], out["features_batch_s"] = feat_ms, batch_s
    finally:
        served.close()
    del comps, session, pipe, served
    torch.cuda.empty_cache()

    # 4. inpainting on phase 10's checkpoint, the direct path
    comps, ok, line = load_checkpoint(torch, np, seed, device)
    print(line, flush=True)
    if not ok:
        failures.append("serving inpaint checkpoint")
    served = Served(serving_session(comps, INPAINT_UNET, steps))
    try:
        beach = base64.b64encode((REPO / "inference_images" / "beach.jpg").read_bytes()).decode()
        sketch = np.zeros((512, 512), np.uint8)
        sketch[128:320, 160:400] = 255  # the region to repaint
        sketch = base64.b64encode(png.encode_png(sketch)).decode()
        want32 = expected_fp32(comps, "a")
        for name, extra in (("actual_mask", {"actual_mask": sketch}), ("boxes", {})):
            before = flash_fwd.routes["fp32"], group_norm_fused.routes["fp32"], \
                flash_fwd.routes["copy"]
            t0 = time.perf_counter()
            code, body = served.post(dict(
                {"prompt": "a corgi and a cake", "phrases": ["corgi", "cake"],
                 "locations": INPAINT_BOXES, "task": "inpainting", "input_image": beach,
                 "batch_size": 2, "seed": 5, "steps": steps}, **extra))
            sec = time.perf_counter() - t0
            got32 = {"flash_fwd": flash_fwd.routes["fp32"] - before[0],
                     "group_norm": group_norm_fused.routes["fp32"] - before[1]}
            _, sound = served_images(np, body, 512)
            check(code == 200 and sound and got32 == want32
                  and flash_fwd.routes["copy"] == before[2], f"inpaint ({name})",
                  f"inpainting with {name} (beach.jpg, batch 2, {steps} steps, the direct "
                  f"path): {sec / 2:.4f} s/img; the fp32 encode's launches {got32} (expected "
                  f"{want32})")
    finally:
        served.close()
    del comps, served
    torch.cuda.empty_cache()

    # 5. hed from phase 13's checkpoint; sem's label check
    rng = np.random.default_rng(seed + 23)
    src = GligenComponents.create(unet_config=dict(SPATIAL_MODELS["hed"]), dtype=torch.bfloat16,
                                  seed=seed + 19, device=device)
    dezero_(src.unet, torch.Generator(device=device).manual_seed(seed + 20))
    ckpt, sd_conv = reference_checkpoint(src, SPATIAL_MODELS["hed"], GROUNDING_SCHEDULE)
    comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, dtype=torch.bfloat16,
                                       device=device)
    del src, ckpt, sd_conv
    served = Served(serving_session(comps, SPATIAL_MODELS["hed"], steps))
    try:
        edges = base64.b64encode(png.encode_png(
            rng.integers(0, 256, (512, 512, 3)).astype(np.uint8))).decode()
        t0 = time.perf_counter()
        code, body = served.post({"prompt": "a man is eating breakfast", "map_image": edges,
                                  "batch_size": 2, "seed": 6, "steps": steps,
                                  "alpha_type": SPATIAL_ALPHA["hed"]})
        _, sound = served_images(np, body, 512)
        check(code == 200 and sound, "hed",
              f"hed map request (batch 2, {steps} steps): "
              f"{(time.perf_counter() - t0) / 2:.4f} s/img")
    finally:
        served.close()
    del comps, served
    torch.cuda.empty_cache()
    comps = GligenComponents.create(unet_config=dict(SPATIAL_MODELS["sem"]),
                                    dtype=torch.bfloat16, seed=seed + 21, device=device)
    served = Served(serving_session(comps, SPATIAL_MODELS["sem"], steps))
    try:
        labels = rng.integers(0, SEM_CLASSES, (512, 512)).astype(np.uint8)
        labels[100, 200] = SEM_CLASSES
        code, body = served.post({"prompt": "a living room", "batch_size": 1, "steps": steps,
                                  "map_image": base64.b64encode(png.encode_png(labels)).decode()})
        health = served.get("/health")
        check(code == 500 and str(SEM_CLASSES) in body.get("error", "")
              and health == (200, {"status": "ok"}), "sem label",
              f"sem map with a label of {SEM_CLASSES} -> {code} {body}; then /health {health}")
    finally:
        served.close()
    del comps, served
    torch.cuda.empty_cache()
    return failures, out


def serving_idle_share(torch, seed, device, steps):
    """The card's idle share over a pipelined pair of phase 18's
    ``bench_serve_overlap`` requests, run as it is and traced (after phase
    11: no profiler run may precede a timed phase)."""
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.tools import bench_serve_overlap

    set_config("a")
    comps = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device)
    dezero_(comps.unet, torch.Generator(device=device).manual_seed(seed + 1))
    session = serving_session(comps, {}, steps)
    try:
        bench_serve_overlap.drive(session, 1, 1, OVERLAP["steps"], OVERLAP["batch"])  # warm
        plain, wall, busy = bench_serve_overlap.idle_share(session, OVERLAP["steps"],
                                                           OVERLAP["batch"])
    finally:
        session.close()
    del comps, session
    torch.cuda.empty_cache()
    return (f"serving: a pipelined pair (2 clients, one request of batch {OVERLAP['batch']} "
            f"each, {OVERLAP['steps']} steps): wall {plain:.1f} ms, traced {wall:.1f} ms with the "
            f"device busy {busy:.1f} ms: idle {1 - busy / plain:.1%} of the unprofiled wall, "
            f"{1 - busy / wall:.1%} of the traced one")


# Phase 19 (M14 part 1): the fidelity gate of the served configuration
FIDELITY_DIR = REPO / "build" / "chip_smoke_fidelity"


def run_fidelity(torch, steps):
    """``tools/fidelity_gate.py`` over the 11 scenarios at ``steps`` steps
    and batch 1, both arms in subprocesses of the CLI; each scenario within
    the budget.  Returns (failures, results)."""
    from gligen_tpu_torch.tools import fidelity_gate

    torch.cuda.empty_cache()
    results = fidelity_gate.main(["--out", str(FIDELITY_DIR), "--steps", str(steps),
                                  "--batch", "1"])
    bad = fidelity_gate.over_budget(results)
    for sc in fidelity_gate.SCENARIOS:
        r = results[sc]
        print(f"fidelity: {sc}: " + (f"PSNR {r['psnr']:.4f} dB, proxy-LPIPS {r['lpips']:.6f}, "
                                     f"max |dpixel| {r['max_abs_pixel_delta']:.4f} over "
                                     f"{r['images']} images" if "lpips" in r else "missing")
              + f" {'FAIL' if sc in bad else 'ok'} (budget LPIPS <= {fidelity_gate.LPIPS_MAX}, "
              f"PSNR >= {fidelity_gate.PSNR_MIN})", flush=True)
    return [f"fidelity {sc}" for sc in bad], results


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
        if src.startswith(("fused_proj", "fused_conv")) or src in ("flash_fwd",
                                                                   "flash_fwd_f32_sweep"):
            # one line per tile configuration
            configs = ptxas_configs(report)
            tc = lambda name: "tf32" in name or "f32_qm" in name
            if src in ("fused_proj", "fused_conv", "flash_fwd", "flash_fwd_f32_sweep") and not any(
                    tc(c[0]) for c in configs):
                print(f"build: {src}: no 3xTF32 kernel read from the ptxas report FAIL")
                failures.append(f"build {src} no 3xTF32 kernel")
            for name, regs, stores, loads in configs:
                # the fp32 routes' 3xTF32 kernels must not spill
                ok = not tc(name) or stores + loads == 0
                print(f"build: {src}: {name}: {regs} registers, {stores} bytes spill stores, "
                      f"{loads} bytes spill loads{'' if ok else ' FAIL'}")
                if not ok:
                    failures.append(f"build {src} {name} spills")
            if not src.startswith("flash"):
                report = "\n".join(l for l in report.splitlines() if "wgmma" in l)
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "wgmma")):
                print(f"build: {src}: {line.strip()}")

    # ---- 3. kernels vs plain ----
    t0 = time.perf_counter()
    batch = 2
    comps = GligenComponents.create(dtype=torch.bfloat16, seed=args.seed, device=device)
    results = check_kernel(torch, kernel_cases(batch), device)
    results.append(check_kernel_1024(torch, device))
    results += check_kernel_f32(torch, device, batch)
    results += check_proj(torch, proj_cases(batch) + mm_cases(), device)
    gn, ln, convs = (norm_cases(comps.unet, comps.vae, batch), ln_cases(batch),
                     conv_cases(comps.unet, batch))
    # the fp32 GroupNorm at the inpaint encode's maps and, for a model served
    # in fp32 (phase 14), at the UNet's and the decoder's
    gn32 = f32_norm_cases(comps.vae, batch) + gn
    results += check_norms(torch, gn, ln, device, gn32)
    results += check_convs(torch, convs, device)
    results += check_fp32(torch, comps.unet, device, batch)
    failures += [f"kernel {r['kind']} {r['name']}" for r in results if not r["ok"]]
    print(f"kernel: phase 3 took {time.perf_counter() - t0:.1f} s", flush=True)

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
    print(f"generate: phase 4 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 5. small-width reference: card (bf16, kernels) vs CPU (fp32, plain) ----
    t0 = time.perf_counter()
    for config in CONFIGS:
        ok, line = small_reference(torch, np, args.seed, device, alpha, config)
        print(line, flush=True)
        if not ok:
            failures.append(f"reference ({config})")
    print(f"reference: phase 5 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 12. the other grounding modalities and fusers, in phase 4's host state:
    # before the train phases and any profiler session (phases 9, 11) ----
    t0 = time.perf_counter()
    grounding_failures, grounding_s, vision_ms = run_grounding(torch, np, args.seed, device,
                                                               args.steps)
    failures += grounding_failures
    for model in SMALL_GROUNDING:
        ok, line = small_reference(torch, np, args.seed, device, alpha, "a", model=model)
        print(line, flush=True)
        if not ok:
            failures.append(f"grounding reference ({model})")
    print(f"grounding: phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 13. the spatial modalities, right after 12 in the same host state ----
    t0 = time.perf_counter()
    spatial_failures, spatial_s, tokenizer_ms, spatial_ln, tokenizers = run_spatial(
        torch, np, args.seed, device, args.steps)
    failures += spatial_failures
    for model in SMALL_SPATIAL:
        ok, line = small_reference(torch, np, args.seed, device, SPATIAL_ALPHA[model], "a",
                                   model=model)
        print(line, flush=True)
        if not ok:
            failures.append(f"spatial reference ({model})")
    print(f"spatial: phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 14. a model served in fp32 (fault F5), in the same host state ----
    t0 = time.perf_counter()
    fp32_failures, fp32_s, fp32_launches = run_fp32(torch, np, args.seed, device, args.steps)
    failures += fp32_failures
    launches.update(fp32_launches)
    for config in CONFIGS:
        ok, line = small_reference(torch, np, args.seed, device, alpha, config,
                                   dtype=torch.float32, tol=FP32_REF_MEAN_TOL)
        print(line, flush=True)
        if not ok:
            failures.append(f"fp32 reference ({config})")
    print(f"fp32: phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 15. the CLI's scenarios and bench_matrix, in the same host state ----
    t0 = time.perf_counter()
    cli_failures, cli_s, matrix_rows = run_cli(torch, np, args.seed, device, args.steps)
    failures += cli_failures
    print(f"cli: phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 18. the server at full width, in the same host state ----
    t0 = time.perf_counter()
    serving_failures, serving = run_serving(torch, np, args.seed, device, args.steps,
                                            launches["a"])
    failures += serving_failures
    print(f"serving: phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 19. the fidelity gate: 11 scenarios, fp32 arm against bf16 ----
    t0 = time.perf_counter()
    fidelity_failures, fidelity = run_fidelity(torch, args.steps)
    failures += fidelity_failures
    print(f"fidelity: phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 6. the flash backward kernels vs plain ----
    t0 = time.perf_counter()
    results += check_bwd(torch, bwd_cases(4), device)
    failures += [f"kernel {r['kind']} {r['name']}" for r in results
                 if r["kind"].startswith("flash_bwd") and not r["ok"]]
    print(f"backward: phase 6 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 7. the train step at full width ----
    t0 = time.perf_counter()
    train_failures, launches["train"], train_line = run_train(torch, np, args.seed, device)
    failures += train_failures
    print(f"train: phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 8. small-width train step: card (bf16, kernels) vs CPU (fp32, plain) ----
    t0 = time.perf_counter()
    for use_checkpoint in (True, False):
        ok, lines = train_reference(torch, np, args.seed, device, use_checkpoint)
        print("\n".join(lines), flush=True)
        if not ok:
            failures.append(f"train reference (use_checkpoint={use_checkpoint})")
    print(f"train: phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 16. the Trainer through the training command line ----
    t0 = time.perf_counter()
    trainer_failures, trainer, trainer_line = run_trainer(torch, np, args.seed, device)
    failures += trainer_failures
    print(f"trainer: phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 17. the keypoint and spatial modalities trained from the reference's formats ----
    t0 = time.perf_counter()
    modality_failures, modality_trainers, modality_line = run_modalities(torch, np, args.seed,
                                                                         device)
    failures += modality_failures
    print(f"modalities: phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 9. the tools at full ds1 width ----
    t0 = time.perf_counter()
    tool_failures, launches["bench_proj"], tool_checks, tool_report = run_tools(torch, device)
    results += tool_checks
    print("\n".join(tool_report), flush=True)
    failures += tool_failures
    print(f"tools: phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 10. inpaint from a reference-format checkpoint, DDIM and PLMS ----
    t0 = time.perf_counter()
    inpaint_failures, launches["inpaint"], inpaint_s = run_inpaint(torch, np, args.seed, device,
                                                                   args.steps)
    failures += inpaint_failures
    for sampler in ("ddim", "plms"):
        ok, line = small_inpaint_reference(torch, np, args.seed, device, sampler)
        print(line, flush=True)
        if not ok:
            failures.append(f"inpaint reference ({sampler})")
    print(f"inpaint: phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 11. CUDA launches per call, from profiled calls ----
    t0 = time.perf_counter()
    launch_failures, launch_lines = check_launches(torch, gn, ln, convs, device, gn32)
    print("\n".join(launch_lines), flush=True)
    failures += launch_failures
    print(f"launches: phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    # the spatial tokenizers' device time, under the profiler: after every timed phase
    set_config("a")
    tokenizer_device = tokenizer_device_ms(torch, tokenizers)
    for name, (busy, records, calls) in tokenizer_device.items():
        print(f"spatial: {name}: the tokenizer's conditional and null forwards (batch {batch}) "
              f"{busy:.3f} ms device busy per request (profiled; {records} device records of "
              f"{calls} launch calls)", flush=True)
    del tokenizers
    # phase 18's traced pipelined pair, likewise
    serving_idle = serving_idle_share(torch, args.seed, device, args.steps)
    print(serving_idle, flush=True)
    # phase 16's two traced steps, under the profiler: after every timed phase
    idle_line = train_idle_share(torch, trainer)
    print(idle_line, flush=True)
    del trainer
    # phase 17's traced steps, likewise
    modality_idle = []
    for modality in list(modality_trainers):
        modality_idle.append(train_idle_share(torch, modality_trainers.pop(modality),
                                              label=f"modalities: {modality}"))
        print(modality_idle[-1], flush=True)

    print("summary: s/img " + ", ".join(f"({c}) {s:.3f}" for c, s in s_per_img.items())
          + f" (request 1 of 2, batch {batch}, {args.steps} PLMS steps, 512^2) on {card}")
    print(f"summary: {train_line[len('train: '):]} on {card}")
    print(f"summary: {trainer_line[len('trainer: '):]}; {idle_line[len('trainer: '):]} on {card}")
    print(f"summary: {modality_line}; " + "; ".join(l[len('modalities: '):] for l in modality_idle)
          + f" on {card}")
    print("summary: inpaint from a checkpoint, s/img " + ", ".join(
        f"{sampler} {s:.3f}" for sampler, s in inpaint_s.items())
          + f" (request 1 of 2, batch {batch}, {args.steps} steps, fp32 encode, 512^2) on {card}")
    print("summary: grounding s/img " + ", ".join(f"{m} {t:.3f}" for m, t in grounding_s.items())
          + f" (request 1 of 2, batch {batch}, {args.steps} PLMS steps, alpha stages, 512^2, "
          f"loaded from a checkpoint); CLIP ViT-L/14 vision {vision_ms:.3f} ms per image (fp32) "
          f"on {card}")
    print("summary: spatial s/img " + ", ".join(f"{m} {t:.3f}" for m, t in spatial_s.items())
          + f" (request 1 of 2, batch {batch}, {args.steps} PLMS steps, each scenario's alpha "
          f"stages, 512^2, loaded from a checkpoint); the tokenizer's ms per request (conditional "
          f"and null forwards), device busy " + ", ".join(
              f"{m} {t[0]:.3f}" for m, t in tokenizer_device.items())
          + ", CUDA events with host gaps " + ", ".join(
              f"{m} {t:.3f}" for m, t in tokenizer_ms.items())
          + f"; hed (b) LayerNorm launches {spatial_ln} on {card}")
    print("summary: fp32 s/img " + ", ".join(f"({c}) {t:.3f}" for c, t in fp32_s.items())
          + f" (one request, batch {batch}, {args.steps} PLMS steps, alpha stages, 512^2, a "
          f"model served in fp32) on {card}")
    print("summary: cli s/img " + ", ".join(f"{m} {t:.3f}" for m, t in cli_s.items())
          + f" (--ckpt random --dezero, batch {batch}, {args.steps} steps, 512^2) on {card}")
    rates = serving["overlap"]
    print(f"summary: serving (phase 18, a 25 ms window): warmup {serving['warmup_s']:.1f} s; burst "
          f"{serving['burst_s_per_img']:.4f} s/img (batch 1 x {SERVE_BURST}, {args.steps} steps, "
          f"512^2); 1024^2 batch 2 {serving['s_per_img_1024']:.4f} s/img, peak allocated "
          f"{serving['peak_gib_1024']:.2f} GiB; bench_serve_overlap pipelined "
          f"{rates['pipelined']:.4f} / {rates['pipelined2']:.4f}, serialized "
          f"{rates['serialized']:.4f} img/s ({rates['gain_pct']:+.2f}%); features mid-batch "
          f"{serving['features_ms']:.1f} ms; {serving_idle[len('serving: '):]} on {card}")
    print(f"summary: fidelity (phase 19, {args.steps} steps, batch 1, bf16 vs fp32): " + ", ".join(
        f"{sc} {r['psnr']:.2f} dB / {r['lpips']:.5f}" for sc, r in fidelity.items()
        if "lpips" in r) + f" on {card}")
    for row in matrix_rows:
        print(f"summary: bench_matrix {row['row']} ({row['modality']}, {row['sampler']} "
              f"{row['steps']} steps, batch {row['batch']}): {row['img_per_sec']:.4f} img/s, "
              f"{row['sec_per_img']:.4f} s/img, first call {row['first_call_s']:.2f} s on {card}")
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
        # K6: the whole wrapper call (gn_affine and the weight cast included);
        # the 3xTF32 routes: the fp32 FMA bound beside bound_ms (theirs, at
        # the tensor cores' TF32 rate); K2/K6 fp32: the one-pass TF32 witness
        for key in ("call_ms", "fma_bound_ms", "tf32_witness"):
            if key in at:
                kernels[-1][key] = at[key]
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
