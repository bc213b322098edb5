"""The fused norm path of gligen_tpu_torch against gligen_tpu's.

Kernels: the plain versions of ops/fused_norm.py against the Pallas kernels
they port (ops/pallas_norm.py in interpret mode on the CPU) and against the
JAX package's own plain forms (``group_norm_rowsum``, ``group_norm_xla``,
``layer_norm_xla``).  Routing: GLIGEN_TPU_FUSED_NORM is parsed as the JAX
package parses it, the dispatchers send card tensors (and only those) to
the kernels, and on the CPU no launch is counted.  Also the device default
of ``GligenComponents.create``.

Tolerance, fp32 on both sides: normalised values of O(1) from fp32 sums
over at most 2,560 elements taken in another order agree to a few fp32
ulps: atol 2e-5, as tests/test_pallas_norm.py.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.ops import basic as jb
from gligen_tpu.ops import pallas_conv as jpc
from gligen_tpu.ops import pallas_norm as jpn

from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.models import clip_text as tclip
from gligen_tpu_torch.models import layers as tl
from gligen_tpu_torch.ops import basic as tb
from gligen_tpu_torch.ops import fused_norm as fn
from gligen_tpu_torch.ops import fused_proj as fp

from test_torch_modules import close, rand, t

torch.set_num_threads(1)

ATOL = 2e-5


def norm_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rand(rng, *shape) * 3.0 + 0.7
    return x, 1.0 + rand(rng, c, scale=0.2), rand(rng, c, scale=0.1)


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 64, 64), (2, 8, 8, 320), (2, 64, 320)],
                         ids=["nhwc64", "bnc64", "nhwc320", "bnc320"])
@pytest.mark.parametrize("silu,eps", [(False, 1e-6), (True, 1e-5), (True, 1e-6)])
def test_group_norm_plain_matches_pallas(shape, silu, eps):
    """NHWC and (B, N, C) layouts, +- SiLU, eps 1e-5 (GroupNorm32) and
    1e-6 (Normalize), C in {64, 320}."""
    x, s, b = norm_inputs(len(shape) + shape[-1], shape)
    j = [jnp.asarray(a) for a in (x, s, b)]
    got = fn.group_norm_plain(t(x), t(s), t(b), 32, eps, silu)
    want = jpn.group_norm_fused(*j, 32, eps, silu, interpret=True)
    assert want is not None and tuple(got.shape) == shape
    close(got, want, atol=ATOL)
    act = "silu" if silu else None
    close(got, jb.group_norm_rowsum(*j, 32, eps, act), atol=ATOL)
    ref = jb.group_norm_xla(*j, num_groups=32, eps=eps)
    close(got, jax.nn.silu(ref) if silu else ref, atol=ATOL)
    close(tb.group_norm_xla(t(x), t(s), t(b), 32, eps), ref, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (3, 4, 6, 320)])
def test_gn_affine_plain_matches_jax(shape):
    x, s, b = norm_inputs(5, shape)
    a, v = fn.gn_affine_plain(t(x), t(s), t(b))
    ja, jv = jpc.gn_affine(*(jnp.asarray(arr) for arr in (x, s, b)))
    close(a, ja, atol=1e-6)
    close(v, jv, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 64, 320), (8, 16, 640), (2, 8, 1280)])
def test_layer_norm_plain_matches_pallas(shape):
    x, s, b = norm_inputs(shape[1], shape)
    j = [jnp.asarray(a) for a in (x, s, b)]
    want = jpn.layer_norm_fused(*j, 1e-5, interpret=True)
    assert want is not None
    got = fn.layer_norm_plain(t(x), t(s), t(b))
    close(got, want, atol=ATOL)
    close(got, jb.layer_norm_xla(*j), atol=ATOL)


def test_layer_norm_plain_ragged_rows():
    """The fuser's N + 30 rows: no row block divides 2 * 94, so the Pallas
    wrapper declines (None) and ``layer_norm_f`` takes its reference; the
    port's kernel takes any row count."""
    x, s, b = norm_inputs(94, (2, 94, 96))
    j = [jnp.asarray(a) for a in (x, s, b)]
    assert jpn.layer_norm_fused(*j, 1e-5, interpret=True) is None
    close(fn.layer_norm_plain(t(x), t(s), t(b)), jpn.layer_norm_f(*j, 1e-5, True), atol=ATOL)


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    x, s, b = (t(a) for a in norm_inputs(1, (2, 4, 4, 64)))
    before = {name: k.launches for name, k in fn.KERNELS.items()}
    assert torch.equal(fn.group_norm_fused(x, s, b, 32, 1e-6, True),
                       fn.group_norm_plain(x, s, b, 32, 1e-6, True))
    for got, want in zip(fn.gn_affine(x, s, b), fn.gn_affine_plain(x, s, b)):
        assert torch.equal(got, want)
    assert torch.equal(fn.layer_norm_fused(x, s, b), fn.layer_norm_plain(x, s, b))
    assert {name: k.launches for name, k in fn.KERNELS.items()} == before


def test_other_devices_raise():
    x = torch.empty((2, 8, 64), device="meta")
    s = torch.empty((64,), device="meta")
    for kernel in fn.KERNELS.values():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            kernel(x, s, s)


# ------------------------------------------------ the GroupNorm route plan

def _norm_maps():
    """(name, (B, N, C)) of every GroupNorm input of a 512^2 request, from
    chip_smoke.norm_cases on storage-free models."""
    import math

    import chip_smoke
    from gligen_tpu_torch.models.unet import UNetModel
    from gligen_tpu_torch.models.vae import AutoencoderKL

    with torch.device("meta"):
        unet, vae = UNetModel(), AutoencoderKL()
    return [(name, (shape[0], math.prod(shape[1:-1]), shape[-1]))
            for name, shape, _, _ in chip_smoke.norm_cases(unet, vae, 2)]


@pytest.mark.parametrize("name,shape", _norm_maps())
def test_every_unet_map_takes_one_launch(name, shape):
    """Every UNet GroupNorm map takes the one-launch route: a cluster of at
    most 16 blocks per sample, each block's shared memory (the ring and its
    floats) within the H100's 227 KB; so do their statistics alone
    (gn_affine) but at the narrow maps over 2 MB a sample; the VAE's top
    levels, which read HBM twice on either route, keep three launches."""
    b, n, c = shape
    route, chunks = fn.gn_plan(b, n, c)
    assert 1 <= chunks <= n
    if name.startswith(("res_", "st_")):
        assert route == "one" and fn.cuda_launches(route, True) == 1
    # the statistics alone: one launch but for the narrow maps over 2 MB a sample
    affine = fn.gn_plan(b, n, c, normalise=False)[0]
    if name.startswith("res_"):
        assert affine == ("three" if c < 1280 and 2 * n * c > 2 * 2**20 else "one")
    if name in ("vae_512x128", "vae_256x512", "vae_256x256"):
        assert route == "three" and fn.cuda_launches(route, True) == 3
        assert fn.cuda_launches(route, False) == 2
    if route == "one":
        assert chunks <= fn.MAX_CLUSTER == 16 and fn.fused_smem(c, 32) <= 232448
    assert fn.fused_smem(4096, 4096) <= 232448  # the widest map the kernels take fits a block


@pytest.mark.parametrize("c,groups,smem", [
    # the 128 KB ring (4 slots of 32 KB), then floats: RB = 1024 / (C / 8)
    # rows of (2, C) partials (or the (2, groups) statistics, if larger),
    # and the (2, groups) group sums
    (320, 32, 131072 + 4 * (25 * 2 * 320 + 64)),       # RB 25: 195,328
    (1280, 32, 131072 + 4 * (6 * 2 * 1280 + 64)),      # RB 6: 192,768
    (32, 32, 131072 + 4 * (256 * 2 * 32 + 64)),        # RB 256: 196,864
    (4096, 4096, 131072 + 4 * (2 * 2 * 4096 + 8192)),  # RB 2: 229,376
])
def test_fused_smem_worked_by_hand(c, groups, smem):
    """The one-launch block's shared memory, worked out by hand from
    csrc/fused_norm.cu's layout (kRingBytes, gn_fused_floats)."""
    assert fn.fused_smem(c, groups) == smem


def gn_partition_model(x, scale, bias, groups, eps, route, chunks):
    """fused_norm.cu's partition of the statistics in torch: each of
    ``chunks`` row chunks of a sample sums its channels; on the one-launch
    route each chunk (a block of the sample's cluster) folds its channels
    into group sums and the chunks are then added in rank order; on the
    three-launch route a group's per-channel partials are added over chunks
    and channels.  Returns (a, v), both (B, C)."""
    b, n, c = x.shape
    cpg, rows = c // groups, -(-n // chunks)
    parts = []
    for k in range(chunks):
        xs = x[:, min(n, k * rows):min(n, k * rows + rows)]
        parts.append(torch.stack([xs.sum(1), (xs * xs).sum(1)], 1))  # (B, 2, C)
    if route == "one":
        total = parts[0].reshape(b, 2, groups, cpg).sum(-1)
        for p in parts[1:]:
            total = total + p.reshape(b, 2, groups, cpg).sum(-1)
    else:
        total = torch.stack(parts, 1).reshape(b, chunks, 2, groups, cpg).sum((1, 4))
    count = n * cpg
    mean = total[:, 0] / count
    rstd = torch.rsqrt(torch.clamp(total[:, 1] / count - mean * mean, min=0.0) + eps)
    a = rstd.repeat_interleave(cpg, 1) * scale
    return a, bias - mean.repeat_interleave(cpg, 1) * a


@pytest.mark.parametrize("shape,route,chunks",
                         [((2, 64, 320), "one", None), ((2, 64, 320), "one", 7),
                          ((3, 24, 64), "one", None), ((2, 64, 320), "three", 5),
                          ((2, 48, 32), "three", None)])
@pytest.mark.parametrize("silu", [False, True])
def test_gn_partition_matches_jax(shape, route, chunks, silu):
    """Both routes' partitions (the plan's chunks, or a ragged count)
    against the Pallas kernel in interpret mode and JAX's gn_affine: the
    output, and (a, v) to gn_affine's tolerance."""
    b, n, c = shape
    if chunks is None:  # the plan's: gn_plan's on the one-launch route, else the partials'
        chunks = (fn.gn_plan(b, n, c)[1] if route == "one"
                  else max(1, min(n, -(-fn.CHUNK_BLOCKS // b))))
    x, s, sh = norm_inputs(n + c, shape)
    j = [jnp.asarray(arr) for arr in (x, s, sh)]
    a, v = gn_partition_model(t(x), t(s), t(sh), 32, 1e-5, route, chunks)
    ja, jv = jpc.gn_affine(*j)
    close(a, ja, atol=1e-6)
    close(v, jv, atol=ATOL)
    y = t(x) * a[:, None] + v[:, None]
    want = jpn.group_norm_fused(*j, 32, 1e-5, silu, interpret=True)
    close(torch.nn.functional.silu(y) if silu else y, want, atol=ATOL)


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("value", [None, "0", "gn", "ln", "both", "1", "rowsum"])
def test_norm_mode_parses_as_jax(monkeypatch, value):
    """The same mode as gligen_tpu/ops/basic.py:_fused_norm_mode on a TPU
    (its backend test stands in for the port's per-tensor device test)."""
    if value is None:
        monkeypatch.delenv("GLIGEN_TPU_FUSED_NORM", raising=False)
    else:
        monkeypatch.setenv("GLIGEN_TPU_FUSED_NORM", value)
    monkeypatch.setattr(jb.jax, "default_backend", lambda: "tpu")
    assert tb._fused_norm_mode() == jb._fused_norm_mode()


@pytest.mark.parametrize("mode,gn_kernel,ln_kernel",
                         [("0", False, False), ("gn", True, False), ("ln", False, True),
                          ("both", True, True)])
def test_dispatch_sends_card_tensors_to_the_kernels(monkeypatch, mode, gn_kernel, ln_kernel):
    """With the device test answering "on the card", each mode reaches
    exactly its kernels; with a CPU tensor as it is, none."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_NORM", mode)
    calls = []
    monkeypatch.setattr(fn, "group_norm_fused", lambda *a, **k: calls.append("gn"))
    monkeypatch.setattr(fn, "layer_norm_fused", lambda *a, **k: calls.append("ln"))
    x, s, b = (t(a) for a in norm_inputs(2, (2, 4, 4, 64)))
    tb.group_norm(x, s, b, act="silu")
    tb.layer_norm(x, s, b)
    assert calls == []
    monkeypatch.setattr(tb, "_on_card", lambda x: True)
    tb.group_norm(x, s, b, act="silu")
    tb.layer_norm(x, s, b)
    assert calls == ["gn"] * gn_kernel + ["ln"] * ln_kernel


def test_plain_versions_and_clip_never_dispatch(monkeypatch):
    """The fused projections' plain versions and CLIP's LayerNorm call the
    plain LayerNorm: with the device test answering "on the card" and the
    LayerNorm kernel refusing every call, they still run; the transformer
    blocks' LayerNorm module does dispatch."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_NORM", "both")
    monkeypatch.setattr(tb, "_on_card", lambda x: True)

    def refuse(*a, **k):
        raise AssertionError("the LayerNorm kernel was reached")

    monkeypatch.setattr(fn, "layer_norm_fused", refuse)
    rng = np.random.default_rng(4)
    x = t(rand(rng, 2, 10, 16))
    s, b = torch.ones(16), torch.zeros(16)
    fp.ln_matmuls_plain(x, s, b, (t(rand(rng, 8, 16)),))
    fp.ln_geglu_plain(x, s, b, t(rand(rng, 16, 16)), torch.zeros(16))
    tclip.LayerNorm(16)(x)
    with pytest.raises(AssertionError, match="kernel was reached"):
        tl.LayerNorm(16)(x)


# ----------------------------------------------------- the device default

def test_components_default_to_the_card(monkeypatch):
    """``GligenComponents.create`` targets CUDA unless asked for the CPU,
    and without a card it says so instead of building on the CPU."""
    assert inspect.signature(GligenComponents.create).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GligenComponents.create()
