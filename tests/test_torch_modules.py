"""Module parity: each gligen_tpu_torch module against its gligen_tpu
counterpart on the CPU in fp32, the same weights carried by the bridge
(convert/from_jax.py), the same numpy inputs.

Off the TPU, gligen_tpu runs its plain XLA path (no fused projections, no
Pallas attention), which is the path the port implements.  The weights are
random with no zero leaf (the JAX init zeroes out_2, proj_out and the
fuser gates, which would make the comparisons vacuous).

Tolerance: both sides compute in fp32 (JAX with "highest" matmul
precision, set in conftest.py); the sums run in another order, so outputs
of O(1) agree to ~1e-5.  ATOL = 1e-4 leaves room for the deeper stacks.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from gligen_tpu.models import layers as jl
from gligen_tpu.models import unet as ju
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.grounding.text import TextPositionNet as JaxPositionNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE
from gligen_tpu.ops import basic as jb

from gligen_tpu_torch.convert.from_jax import state_dict_from_jax
from gligen_tpu_torch.models import layers as tl
from gligen_tpu_torch.models import unet as tu
from gligen_tpu_torch.models.clip_text import CLIPTextModel
from gligen_tpu_torch.models.grounding.text import TextPositionNet
from gligen_tpu_torch.models.vae import AutoencoderKL
from gligen_tpu_torch.ops import basic as tb

torch.set_num_threads(1)

ATOL = 1e-4
CTX = 32
LATENT = 8
UNET = dict(
    in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
    attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=2, context_dim=CTX,
    grounding_tokenizer={"target": "text", "params": {"in_dim": CTX, "out_dim": CTX}},
)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=2 * LATENT)
CLIP = dict(vocab_size=64, hidden_size=CTX, layers=2, heads=2)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def random_params(module, *args, seed=0, **kwargs):
    """A random parameter tree for ``module`` (shapes from ``eval_shape``
    of its init, so nothing is initialised twice).  No leaf is zero, so
    every weight, gate and null feature takes part in the comparison:
    kernels ~ N(0, 1/fan_in), norm scales ~ 1, biases and null features
    ~ N(0, 0.1^2), fuser gates in [0.3, 0.8]."""
    rng = np.random.default_rng(seed)
    init = functools.partial(module.init, **kwargs)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    flat = traverse_util.flatten_dict(shapes)
    for path, sd in flat.items():
        shape, name = sd.shape, path[-1]
        if name == "kernel":
            flat[path] = rand(rng, *shape, scale=float(np.prod(shape[:-1])) ** -0.5)
        elif name == "embedding":
            flat[path] = rand(rng, *shape, scale=shape[-1] ** -0.5)
        elif name == "scale":
            flat[path] = 1.0 + rand(rng, *shape, scale=0.1)
        elif name in ("alpha_attn", "alpha_dense"):
            flat[path] = rng.uniform(0.3, 0.8, size=shape).astype(np.float32)
        else:
            flat[path] = rand(rng, *shape, scale=0.1)
    return traverse_util.unflatten_dict(flat)


def jax_apply(module, params, *args, **static):
    """``module.apply`` under ``jax.jit`` (one compile beats op-by-op
    dispatch on the CPU); keyword arguments are static."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **static))(params, *args)


def port(module, params, skip=()):
    module.load_state_dict(state_dict_from_jax(params, skip), strict=True)
    return module.eval()


def grounding_inputs(rng, b, n=30, dim=CTX):
    return {
        "boxes": rng.random((b, n, 4)).astype(np.float32),
        "masks": (rng.random((b, n)) > 0.5).astype(np.float32),
        "positive_embeddings": rand(rng, b, n, dim),
    }


def jax_unet(seed=0):
    """The small JAX UNet and a random parameter tree for it."""
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    model = ju.UNetModel(**UNET, use_checkpoint=False)
    params = random_params(
        model, jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, CTX)), g, seed=seed,
    )
    return model, params


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("op", ["fourier", "timestep", "group_norm", "group_norm_silu",
                                "layer_norm", "upsample"])
def test_basic_ops(op):
    rng = np.random.default_rng(9)
    x = rand(rng, 2, 4, 4, 64) * 3.0 + 0.5
    w, b = 1.0 + rand(rng, 64, scale=0.1), rand(rng, 64, scale=0.1)
    j, p = (jnp.asarray(a) for a in (x, w, b)), (t(a) for a in (x, w, b))
    if op == "fourier":
        boxes = rng.random((2, 5, 4)).astype(np.float32)
        want, got = jb.fourier_embed(jnp.asarray(boxes)), tb.fourier_embed(t(boxes))
    elif op == "timestep":
        ts = np.array([0, 1, 500, 999], np.int32)
        want, got = jb.timestep_embedding(jnp.asarray(ts), 321), tb.timestep_embedding(t(ts), 321)
    elif op.startswith("group_norm"):
        act = "silu" if op.endswith("silu") else None
        want, got = jb.group_norm(*j, act=act), tb.group_norm(*p, act=act)
    elif op == "layer_norm":
        want, got = jb.layer_norm(*j), tb.layer_norm(*p)
    else:
        want, got = jb.nearest_upsample_2x(jnp.asarray(x)), tb.nearest_upsample_2x(t(x))
    assert tuple(got.shape) == want.shape
    # fp32 elementwise ops agree to a few ulps of O(1) values, except the
    # timestep embedding: sin/cos of arguments up to 999 rad, where one fp32
    # ulp of the argument (from exp's rounding of the frequency) is 6.1e-5
    close(got, want, atol=2e-4 if op == "timestep" else 2e-5)


@pytest.fixture(scope="module")
def unet_pair():
    model, params = jax_unet()
    return model, params, port(tu.UNetModel(**UNET), params)


def test_clip_text_encode():
    rng = np.random.default_rng(1)
    jm = JaxCLIP(**CLIP)
    params = random_params(jm, jnp.zeros((1, 77), jnp.int32))
    ids = rng.integers(1, 63, size=(2, 77)).astype(np.int32)
    want = jax_apply(jm, params, jnp.asarray(ids), method=jm.encode)
    with torch.no_grad():
        got = port(CLIPTextModel(**CLIP), params).encode(t(ids).long())
    close(got, want)


def test_text_position_net():
    rng = np.random.default_rng(2)
    g = grounding_inputs(rng, 2, n=6, dim=CTX)
    args = [jnp.asarray(g[k]) for k in ("boxes", "masks", "positive_embeddings")]
    jm = JaxPositionNet(in_dim=CTX, out_dim=24)
    params = random_params(jm, *args)
    want = jax_apply(jm, params, *args)
    with torch.no_grad():
        got = port(TextPositionNet(in_dim=CTX, out_dim=24), params)(**{k: t(v) for k, v in g.items()})
    close(got, want)


@pytest.mark.parametrize("skip_fuser", [False, True])
def test_basic_transformer_block(skip_fuser):
    rng = np.random.default_rng(3)
    x, ctx, objs = rand(rng, 2, 16, 32), rand(rng, 2, 7, 24), rand(rng, 2, 5, 20)
    args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(objs))
    params = random_params(jl.BasicTransformerBlock(2, 16, "gatedSA"), *args, 1.0)
    jm = jl.BasicTransformerBlock(2, 16, "gatedSA", skip_fuser=skip_fuser)
    want = jax_apply(jm, params, *args, 0.7)
    block = port(tl.BasicTransformerBlock(32, 24, 20, 2, 16), params)
    with torch.no_grad():
        got = block(t(x), t(ctx), t(objs), 0.7, skip_fuser=skip_fuser)
    close(got, want)
    if not skip_fuser:  # the fuser really acts
        with torch.no_grad():
            skipped = block(t(x), t(ctx), t(objs), 0.7, skip_fuser=True)
        assert float((skipped - got).abs().max()) > 1e-3


def test_spatial_transformer():
    rng = np.random.default_rng(4)
    x, ctx, objs = rand(rng, 2, 4, 4, 32), rand(rng, 2, 7, 24), rand(rng, 2, 5, 20)
    args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(objs), 0.4)
    jm = jl.SpatialTransformer(2, 16, depth=1, use_checkpoint=False)
    params = random_params(jm, *args)
    want = jax_apply(jm, params, *args)
    with torch.no_grad():
        got = port(tl.SpatialTransformer(32, 24, 20, 2, 16), params)(t(x), t(ctx), t(objs), 0.4)
    close(got, want)


def test_resblock():
    rng = np.random.default_rng(5)
    x, emb = rand(rng, 2, 8, 8, 32), rand(rng, 2, 128)
    jm = ju.ResBlock(64)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(emb))
    want = jax_apply(jm, params, jnp.asarray(x), jnp.asarray(emb))
    with torch.no_grad():
        got = port(tu.ResBlock(32, 64, 128), params)(t(x), t(emb))
    close(got, want)


def test_vae_decode():
    rng = np.random.default_rng(6)
    jm = JaxVAE(**VAE)
    z = rand(rng, 2, LATENT, LATENT, 4)
    # the whole VAE's tree (encoder too), which the port's strict load needs
    params = random_params(jm, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)), jax.random.PRNGKey(1))
    want = jax_apply(jm, params, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        got = port(AutoencoderKL(**VAE), params).decode(t(z))
    assert got.shape == (2, 2 * LATENT, 2 * LATENT, 3)
    close(got, want)


@pytest.mark.parametrize("use_sd_conv", [False, True])
def test_unet_eps(unet_pair, use_sd_conv):
    model, params, unet = unet_pair
    rng = np.random.default_rng(7)
    x, ctx = rand(rng, 2, LATENT, LATENT, 4), rand(rng, 2, 77, CTX)
    ts = np.array([981, 401], np.int32)
    g = grounding_inputs(rng, 2)
    want = jax_apply(
        model, params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        {k: jnp.asarray(v) for k, v in g.items()}, gate_scale=0.6, use_sd_conv=use_sd_conv,
    )
    with torch.no_grad():
        got = unet(t(x), t(ts), t(ctx), {k: t(v) for k, v in g.items()},
                   gate_scale=0.6, use_sd_conv=use_sd_conv)
    close(got, want)


def test_unet_hoisted_tokens_and_skip_fusers(unet_pair):
    """tokens_only/objs hoisting and the fuser-free call match the JAX UNet."""
    model, params, unet = unet_pair
    rng = np.random.default_rng(8)
    x, ctx = rand(rng, 2, LATENT, LATENT, 4), rand(rng, 2, 77, CTX)
    ts = np.array([761, 21], np.int32)
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(rng, 2).items()}
    args = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    objs_j, _ = jax_apply(model, params, *args, g, tokens_only=True)
    with torch.no_grad():
        objs = unet.grounding_tokens({k: t(v) for k, v in g.items()})
    close(objs, objs_j)
    for skip in (False, True):
        want = jax_apply(model, params, *args, objs=None if skip else objs_j,
                         skip_fusers=skip, gate_scale=0.0, use_sd_conv=skip)
        with torch.no_grad():
            got = unet(t(x), t(ts), t(ctx), objs=None if skip else objs, skip_fusers=skip,
                       gate_scale=0.0, use_sd_conv=skip)
        close(got, want)
