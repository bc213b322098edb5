"""A model served in fp32 on the card (``GligenComponents.create(dtype=
torch.float32)``, the CLI's ``--dtype float32``): the fp32 routes of the
fused projections (K2: ``ln_matmuls``, ``matmul_residual``, ``ln_geglu``),
the LayerNorm, ``gn_affine`` and the fused conv (K6) against their plain
versions, and a small-width ``generate`` in fp32 on the card against the
same model on the CPU, in each of the smoke's configurations: (a) the
default (fused projections), (b) the module path with both norm kernels,
(c) the fused conv on every ResBlock.  The JAX package runs its Pallas
kernels in ``x.dtype`` under the same switches.

The kernels have no CPU mode, so these tests skip without a GPU.  This
file imports neither jax nor gligen_tpu, so it also runs where JAX is not
installed (the GPU machine):

    python -m pytest tests/test_torch_fp32_cuda.py -m gpu --noconftest -q

Tolerances.  Each fp32 route against its plain version (TF32 off): the
same fp32 operands; K2's and K6's products as 3xTF32 (each ~2^-22 of a
product dropped, chains of 12 accumulations summed in fp32), the rest as
fp32 FMAs, summed in another order, so within FP32_REL_TOL = 1e-4 of the
plain output's largest magnitude (the limit of the flash kernel's fp32
route, ``chip_smoke.FP32_REL_TOL``; one-pass TF32, ~2^-11 relative per
product, misses it), and a second call repeats the first bit for bit.  The pipeline, fp32 on the card (kernels,
TF32 off) against fp32 on the CPU (plain versions): a mean absolute pixel
difference of at most 2e-3 (images in [0, 1]), ten times under the bf16
smoke's 2e-2.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.ops import fused_conv as fc
from gligen_tpu_torch.ops import fused_norm as fn
from gligen_tpu_torch.ops import fused_proj as fp
from gligen_tpu_torch.ops.basic import tf32_off

FP32_REL_TOL = 1e-4
PIPELINE_MEAN_TOL = 2e-3

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels' fp32 routes have no CPU mode")
    with tf32_off():
        yield torch.device("cuda")


def randn(cuda, seed, *shape, scale=1.0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=cuda) * scale


def held(kernel, call, plain):
    """One fp32-route launch of ``kernel`` (after a warm call) against
    ``plain``, within FP32_REL_TOL of the plain output's largest magnitude;
    a third call bit for bit the second."""
    call()
    before = dict(kernel.routes)
    got = call()
    torch.cuda.synchronize()
    assert kernel.routes == dict(before, fp32=before["fp32"] + 1), (before, kernel.routes)
    want = plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        limit = FP32_REL_TOL * w.abs().max().item()
        assert (g - w).abs().max().item() <= limit
    again = call()
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


# The K2 and K6 shapes below reach every fp32 tile class, split 1 and
# split > 1 of each kernel, and a ragged M and F
# (tests/test_torch_fp32_tc.py::test_card_tests_cover_every_fp32_class_and_split).
# No ln_geglu shape of the UNet splits (its 40-column tiles fill the card),
# so its third case forces a split of 3 through the plan.  The cases of
# 2 * 16384 rows (1024^2 at ds1, batch 1 with guidance) have more row
# blocks than the card has SMs, so a block walks a second row block: with
# the panel resident (K = 320) and with A streamed (K = 1280).
LN_CASES = [(4 * 1024, 640, 640, 3), (2 * 1030, 320, 320, 2), (333, 104, 200, 1),
            (256, 1280, 1280, 1), (2 * 16384, 320, 320, 3)]
RESIDUAL_CASES = [(4 * 1024, 2560, 640, False), (4 * 256, 1280, 1280, True), (333, 200, 104, True),
                  (256, 5120, 1280, False), (2 * 16384, 1280, 320, True),
                  (2 * 16384, 320, 320, False)]
GEGLU_CASES = [(4 * 1024, 640, None), (333, 104, None), (333, 104, 3), (2 * 16384, 320, None)]
CONV_CASES = [(4, 64, 64, 320, 320, True), (4, 16, 16, 1280, 640, False), (2, 12, 12, 64, 32, True),
              (1, 5, 7, 32, 16, False), (4, 8, 8, 2560, 1280, False), (1, 128, 128, 320, 320, True),
              (2, 8, 8, 1280, 1280, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,f,n_w", LN_CASES)
def test_ln_matmuls_f32(cuda, m, c, f, n_w):
    x = randn(cuda, 1, m, c, scale=2.0) + 0.3
    s, b = 1.0 + randn(cuda, 2, c, scale=0.1), randn(cuda, 3, c, scale=0.1)
    ws = [randn(cuda, 4 + i, f, c, scale=c**-0.5) for i in range(n_w)]
    held(fp.ln_matmuls, lambda: fp.ln_matmuls(x, s, b, ws),
         lambda: fp.ln_matmuls_plain(x, s, b, ws))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,c,gated", RESIDUAL_CASES)
def test_matmul_residual_f32(cuda, m, k, c, gated):
    h, x = randn(cuda, 1, m, k), randn(cuda, 2, m, c)
    w, wb = randn(cuda, 3, c, k, scale=k**-0.5), randn(cuda, 4, c, scale=0.1)
    gate = torch.tensor(0.37, device=cuda) if gated else None
    held(fp.matmul_residual, lambda: fp.matmul_residual(h, w, wb, x, gate),
         lambda: fp.matmul_residual_plain(h, w, wb, x, gate))


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,split", GEGLU_CASES)
def test_ln_geglu_f32(cuda, monkeypatch, m, c, split):
    if split is not None:
        plan = fp.proj_plan_f32
        monkeypatch.setattr(fp, "proj_plan_f32", lambda *a: (*plan(*a)[:3], split))
    x = randn(cuda, 1, m, c) * 2.0 + 0.3
    s, b = 1.0 + randn(cuda, 2, c, scale=0.1), randn(cuda, 3, c, scale=0.1)
    w, wb = randn(cuda, 4, 8 * c, c, scale=c**-0.5), randn(cuda, 5, 8 * c, scale=0.1)
    held(fp.ln_geglu, lambda: fp.ln_geglu(x, s, b, w, wb),
         lambda: fp.ln_geglu_plain(x, s, b, w, wb))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c,eps", [(4 * 4126, 320, 1e-5), (25088, 96, 1e-6), (7, 1280, 1e-5)])
def test_layer_norm_f32(cuda, rows, c, eps):
    x = randn(cuda, 1, rows, c, scale=2.0) + 0.3
    s, b = 1.0 + randn(cuda, 2, c, scale=0.1), randn(cuda, 3, c, scale=0.1)
    held(fn.layer_norm_fused, lambda: fn.layer_norm_fused(x, s, b, eps),
         lambda: fn.layer_norm_plain(x, s, b, eps))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64, 64, 320), (4, 8, 8, 2560), (3, 12, 12, 64)])
def test_gn_affine_f32(cuda, shape):
    c = shape[-1]
    x = randn(cuda, 1, *shape) * (0.5 * randn(cuda, 2, shape[0], 1, 1, c)).exp() \
        + randn(cuda, 3, shape[0], 1, 1, c)
    s, b = 1.0 + randn(cuda, 4, c, scale=0.1), randn(cuda, 5, c, scale=0.1)
    held(fn.gn_affine, lambda: fn.gn_affine(x, s, b), lambda: fn.gn_affine_plain(x, s, b))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,cin,cout,residual", CONV_CASES)
def test_gn_silu_conv3x3_f32(cuda, b, h, w, cin, cout, residual):
    x = randn(cuda, 1, b, h, w, cin) * (0.5 * randn(cuda, 2, b, 1, 1, cin)).exp() \
        + randn(cuda, 3, b, 1, 1, cin)
    s, sb = 1.0 + randn(cuda, 4, cin, scale=0.1), randn(cuda, 5, cin, scale=0.1)
    wt, wb = randn(cuda, 6, cout, cin, 3, 3, scale=(9 * cin) ** -0.5), randn(cuda, 7, cout)
    res = randn(cuda, 8, b, h, w, cout) if residual else None
    before = fn.gn_affine.launches
    held(fc.gn_silu_conv3x3, lambda: fc.gn_silu_conv3x3(x, s, sb, wt, wb, res),
         lambda: fc.gn_silu_conv3x3_plain(x, s, sb, wt, wb, res))
    # the statistics took gn_affine's kernel (its fp32 route: x is fp32),
    # once in each of the 3 calls
    assert fn.gn_affine.launches == before + 3


@pytest.mark.gpu
def test_other_dtypes_raise_on_the_card(cuda):
    x = randn(cuda, 1, 64, 64).half()
    s = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        fp.ln_matmuls(x, s, s, [torch.ones(64, 64, device=cuda).half()])
    with pytest.raises(TypeError):
        fn.layer_norm_fused(x, s, s)
    with pytest.raises(TypeError):
        fc.gn_silu_conv3x3(x.reshape(1, 8, 8, 64), s, s, torch.ones(8, 64, 3, 3, device=cuda),
                           torch.zeros(8, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["a", "b", "c"])
def test_generate_fp32_card_matches_cpu(cuda, monkeypatch, config):
    """The small-width pipeline in fp32, card (kernels' fp32 routes) vs CPU
    (plain versions), same weights and noise, PLMS with alpha stages."""
    for name, value in chip_smoke.CONFIGS[config].items():
        monkeypatch.setenv(name, value)
    cpu = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu", **chip_smoke.SMALL)
    chip_smoke.dezero_(cpu.unet, torch.Generator().manual_seed(2))
    gpu = GligenComponents.create(dtype=torch.float32, seed=0, device=cuda, **chip_smoke.SMALL)
    for a, b in ((cpu.unet, gpu.unet), (cpu.vae, gpu.vae), (cpu.text_encoder, gpu.text_encoder)):
        b.load_state_dict(a.state_dict())
    ids, uc, grounding = chip_smoke.make_request(np.random.default_rng(3), 2, 1000, 64)
    noise = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    kw = dict(steps=4, guidance_scale=7.5, alpha_stages=[0.3, 0.0, 0.7], latent_size=16,
              noise=noise)
    ref = GenerationPipeline(cpu).generate(ids, uc, grounding, **kw)
    # each configuration reaches its own kernel, every launch of which is an
    # fp32 one here: the fused projections, the LayerNorm, the fused conv
    kernel = {"a": fp.ln_matmuls, "b": fn.layer_norm_fused, "c": fc.gn_silu_conv3x3}[config]
    before = kernel.launches
    got = GenerationPipeline(gpu).generate(ids, uc, grounding, **kw).cpu()
    assert kernel.launches > before
    assert torch.isfinite(got).all() and got.shape == ref.shape
    assert (got - ref).abs().mean().item() <= PIPELINE_MEAN_TOL
