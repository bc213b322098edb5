"""``cast_params_bf16`` of gligen_tpu_torch (inference/pipeline.py) against
gligen_tpu's (gligen_tpu/inference/pipeline.py:98-108), on the CPU at a
tiny size:

  * it casts exactly the tensors the JAX function casts (every fp32
    parameter of two or more dimensions), name for name through the
    weight bridge, to the same bf16 values, and leaves the rest as they
    were, for the box+text and the keypoint UNets (the keypoint net's
    identity embeddings are 2-D parameters read without a module), and
    the grounding tokens over the cast weights in fp32 are the jitted JAX
    model's within 1e-5;
  * a cast weight reaches the fused kernels' wrappers and the modules'
    products with no copy: the K2 wrappers pass the parameter itself on,
    the conv kernel's (F, 3, 3, C) weight is a view of it, and a UNet
    forward in bf16 on the module path copies no cast weight;
  * ``generate`` with cast parameters against the JAX pipeline with
    ``cast_params_bf16(params)`` on the same weights and noise: in bf16
    within the port's bf16 limit (2e-2 mean abs pixel, the smoke's card
    against the CPU: the two packages round their bf16 products apart by
    ~1e-2 with or without the cast), and with the modules computing in
    fp32 over the same bf16 weights within the fp32 pipeline's 1e-4,
    which holds every site that reads a weight to the JAX rounding.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from flax import traverse_util

from gligen_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from gligen_tpu.inference.pipeline import GenerationPipeline as JaxPipeline
from gligen_tpu.inference.pipeline import GligenComponents as JaxComponents
from gligen_tpu.inference.pipeline import cast_params_bf16 as jax_cast_params_bf16
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE

from gligen_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from gligen_tpu_torch.inference.pipeline import (GenerationPipeline, GligenComponents,
                                                 cast_params_bf16)
from gligen_tpu_torch.ops import fused_conv, fused_proj

from test_torch_modules import CLIP, CTX, LATENT, UNET, VAE, grounding_inputs, random_params
from test_torch_pipeline import TOKENIZERS, tokenizer_inputs
from test_torch_train_step import port_name

torch.set_num_threads(1)

BF16_MEAN_TOL = 2e-2  # chip_smoke.REF_MEAN_TOL: bf16 images, mean abs pixel in [0, 1]
FP32_ATOL = 1e-4  # test_torch_pipeline.py's fp32 pipeline tolerance
COMPONENTS = {"model": "unet", "autoencoder": "vae", "text_encoder": "text_encoder"}


@pytest.fixture(scope="module")
def jax_params():
    """(tokenizer, grounding) -> random fp32 JAX parameters of the small
    models (seeds as test_torch_pipeline.py's), drawn once per tokenizer:
    they do not depend on the modules' dtype."""
    cache = {}

    def get(tokenizer, grounding):
        if tokenizer not in cache:
            unet, vae, clip = jax_modules(tokenizer, jnp.float32)
            g1 = {k: jnp.asarray(v[:1]) for k, v in grounding.items()}
            cache[tokenizer] = {
                "model": random_params(unet, jnp.zeros((1, LATENT, LATENT, 4)),
                                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, CTX)), g1,
                                       seed=1),
                "autoencoder": random_params(vae, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
                                             jax.random.PRNGKey(0), seed=2),
                "text_encoder": random_params(clip, jnp.zeros((1, 77), jnp.int32), seed=3),
            }
        return cache[tokenizer]

    return get


def jax_modules(tokenizer, dtype):
    """The JAX UNet (with ``tokenizer``), VAE and CLIP text model in ``dtype``."""
    return (JaxUNet(**unet_config_of(tokenizer), use_checkpoint=False, dtype=dtype),
            JaxVAE(**VAE, dtype=dtype), JaxCLIP(**CLIP, dtype=dtype))


def unet_config_of(tokenizer):
    return UNET if tokenizer == "text" else dict(UNET, grounding_tokenizer=TOKENIZERS[tokenizer])


def port_components(unet_config, params, dtype=torch.float32):
    comps = GligenComponents.create(unet_config=unet_config, dtype=dtype, vae_config=VAE,
                                    text_config=CLIP, device="cpu")
    load_jax_params(comps, params)
    return comps


@pytest.mark.parametrize("tokenizer", ["text", "keypoint"])
def test_casts_the_tensors_jax_casts(jax_params, tokenizer):
    grounding = (grounding_inputs(np.random.default_rng(10), 2) if tokenizer == "text"
                 else tokenizer_inputs(np.random.default_rng(11), tokenizer, 2))
    params = jax_params(tokenizer, grounding)
    unet = jax_modules(tokenizer, jnp.float32)[0]
    comps = port_components(unet_config_of(tokenizer), params)
    before = {key: {n: p.detach().clone() for n, p in getattr(comps, attr).named_parameters()}
              for key, attr in COMPONENTS.items()}
    assert cast_params_bf16(comps) is comps
    cast = jax_cast_params_bf16(params)
    # the grounding tokens in fp32 over the cast weights, as the JAX
    # pipeline computes them (jitted)
    tokens = jax.jit(lambda p, g: unet.apply(
        {"params": p}, jnp.zeros((2, LATENT, LATENT, 4)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 77, CTX)), g, tokens_only=True)[0])
    want_objs = tokens(cast["model"], {k: jnp.asarray(v) for k, v in grounding.items()})
    with torch.no_grad():
        objs = comps.unet.grounding_tokens({k: torch.from_numpy(v) for k, v in grounding.items()})
    np.testing.assert_allclose(objs.numpy(), np.asarray(want_objs), atol=1e-5, rtol=0)
    for key, attr in COMPONENTS.items():
        want = state_dict_from_jax(cast[key])  # the bridge's names and layouts, in fp32
        casts = {port_name(path) for path, leaf in traverse_util.flatten_dict(cast[key]).items()
                 if leaf.dtype == jnp.bfloat16}
        got = dict(getattr(comps, attr).named_parameters())
        assert set(got) == set(want), key
        assert {n for n, p in got.items() if p.dtype == torch.bfloat16} == casts, key
        assert casts and all(p.dtype == torch.float32 for n, p in got.items() if n not in casts)
        for name, p in got.items():
            if name in casts:
                assert torch.equal(p.float(), want[name])
                assert p.dim() != 4 or p.is_contiguous(memory_format=torch.channels_last)
            else:
                assert torch.equal(p, before[key][name]), name
    if tokenizer == "keypoint":
        net = comps.unet.position_net
        assert net.person_embeddings.dtype == net.keypoint_embeddings.dtype == torch.bfloat16
    module = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3))
    assert cast_params_bf16(module) is module
    assert [p.dtype for p in module.parameters()] == [torch.bfloat16] + [torch.float32] * 3


def test_cast_weights_reach_the_kernels_without_a_copy(monkeypatch):
    """Each K2 wrapper hands its kernel (here the plain version: CPU
    tensors) the cast parameter itself; the conv wrapper's (F, 3, 3, C)
    weight is a contiguous view of the cast OIHW parameter, while an fp32
    parameter is cast and permuted into a copy at each call."""
    gen = torch.Generator().manual_seed(0)
    lin = [torch.nn.Linear(64, 32) for _ in range(3)]
    conv = torch.nn.Conv2d(64, 32, 3)
    for m in (*lin, conv):
        cast_params_bf16(m)
    seen = {}
    for name in ("ln_matmuls", "matmul_residual", "ln_geglu"):
        kernel = fused_proj.KERNELS[name]

        def record(*args, _run=kernel._forward, _name=name, **kw):
            seen[_name] = [a.data_ptr() for a in args if isinstance(a, torch.Tensor)]
            return _run(*args, **kw)

        monkeypatch.setattr(kernel, "_forward", record)
    x = torch.randn(2, 16, 64, generator=gen).bfloat16()
    scale, bias = torch.ones(64), torch.zeros(64)
    ws = [m.weight for m in lin]
    fused_proj.ln_matmuls(x, scale, bias, ws)
    h = torch.randn(2, 16, 64, generator=gen).bfloat16()
    res = torch.randn(2, 16, 32, generator=gen).bfloat16()
    fused_proj.matmul_residual(h, lin[0].weight, lin[0].bias, res)
    fused_proj.ln_geglu(x, scale, bias, lin[1].weight, lin[1].bias)
    assert all(w.data_ptr() in seen["ln_matmuls"] for w in ws)
    assert lin[0].weight.data_ptr() in seen["matmul_residual"]
    assert lin[1].weight.data_ptr() in seen["ln_geglu"]
    wt = fused_conv.weight_fhwc(conv.weight, torch.bfloat16)
    assert wt.data_ptr() == conv.weight.data_ptr() and wt.is_contiguous()
    assert torch.equal(wt, conv.weight.permute(0, 2, 3, 1))
    fp32 = torch.nn.Conv2d(64, 32, 3).weight
    assert fused_conv.weight_fhwc(fp32, torch.bfloat16).data_ptr() != fp32.data_ptr()


class CopiesOf(TorchDispatchMode):
    """Counts the copies (``_to_copy``, ``clone``, ``copy_``'s source)
    made of the storages in ``ptrs`` while open."""

    def __init__(self, ptrs):
        super().__init__()
        self.ptrs = ptrs
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        src = {"_to_copy": 0, "clone": 0, "copy_": 1}.get(name)
        if (src is not None and isinstance(args[src], torch.Tensor)
                and args[src].untyped_storage().data_ptr() in self.ptrs):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_a_bf16_forward_copies_no_cast_weight(monkeypatch):
    """A bf16 UNet call on the module path (every Dense and Conv2d) makes
    no copy of a cast weight; over fp32 parameters every call casts them."""
    for k, v in {"GLIGEN_TPU_FUSED_PROJ": "0", "GLIGEN_TPU_FUSED_NORM": "0",
                 "GLIGEN_TPU_FUSED_CONV": "0"}.items():
        monkeypatch.setenv(k, v)
    comps = GligenComponents.create(unet_config=UNET, dtype=torch.bfloat16, vae_config=VAE,
                                    text_config=CLIP, device="cpu")
    rng = np.random.default_rng(12)
    g = {k: torch.from_numpy(v) for k, v in grounding_inputs(rng, 2).items()}
    x = torch.from_numpy(rng.standard_normal((2, LATENT, LATENT, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, CTX)).astype(np.float32))
    steps = torch.tensor([10, 500])
    copies = {}
    for cast in (False, True):
        if cast:
            cast_params_bf16(comps)
        ptrs = {p.untyped_storage().data_ptr() for p in comps.unet.parameters() if p.dim() >= 2}
        with torch.no_grad(), CopiesOf(ptrs) as mode:
            comps.unet(x, steps, ctx, g)
        copies[cast] = mode.n
    assert copies[True] == 0 < copies[False]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_generate_with_cast_params_matches_jax(jax_params, dtype):
    """The same weights, prompts, grounding and noise through both
    pipelines with their parameters cast, the modules computing in
    ``dtype``: 2 PLMS steps with CFG 7.5 and VAE decode."""
    b = 2
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(b, 77)).astype(np.int32)
    uc_ids = np.full((b, 77), CLIP["vocab_size"] - 1, np.int32)
    noise = rng.standard_normal((b, LATENT, LATENT, 4)).astype(np.float32)
    grounding = grounding_inputs(np.random.default_rng(10), b)
    unet, vae, clip = jax_modules("text", getattr(jnp, dtype))
    params = jax_params("text", grounding)
    kwargs = dict(steps=2, guidance_scale=7.5, sampler="plms", latent_size=LATENT, noise=noise)
    schedule = JaxSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    jax_comps = JaxComponents(unet, vae, clip, schedule, jax_cast_params_bf16(params))
    want = np.asarray(JaxPipeline(jax_comps).generate(ids, uc_ids, grounding, **kwargs))
    comps = cast_params_bf16(port_components(UNET, params, getattr(torch, dtype)))
    got = GenerationPipeline(comps).generate(ids, uc_ids, grounding, **kwargs)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(got.std()) > 1e-2  # not a constant image
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    else:
        assert float(np.abs(got.numpy() - want).mean()) <= BF16_MEAN_TOL
