"""What the training step adds below the UNet, against gligen_tpu.

  * the VAE encoder: ``encode_moments`` (the logvar clamp included),
    ``encode`` with the JAX draw passed in as the posterior noise, and
    ``encode_mode``, against ``AutoencoderKL.encode_*``;
  * the gradients of the fused kernels' wrappers (K2: ``ln_matmuls``,
    ``matmul_residual`` with its tensor gate, ``ln_geglu``; K5: GroupNorm
    +- SiLU, LayerNorm; K6: the fused GN -> SiLU -> conv3x3) through their
    autograd Functions, which run the plain versions for CPU tensors and
    differentiate the reference chain, against ``jax.grad`` of the JAX
    fused ops in Pallas interpret mode (their custom VJPs).

Tolerances, fp32 on both sides (JAX with "highest" matmul precision): the
encoder chains ~20 convs, norms and one attention, ATOL 1e-4 as in
tests/test_torch_modules.py; a gradient is a sum over at most a few
hundred rows of O(1) products taken in another order, relative to the
gradient's largest entry: 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.models.vae import AutoencoderKL as JaxVAE
from gligen_tpu.ops import pallas_conv as jpc
from gligen_tpu.ops import pallas_matmul as jpm
from gligen_tpu.ops import pallas_norm as jpn

from gligen_tpu_torch.models.vae import AutoencoderKL
from gligen_tpu_torch.ops import fused_conv as fc
from gligen_tpu_torch.ops import fused_norm as fn
from gligen_tpu_torch.ops import fused_proj as fp

from test_torch_modules import LATENT, VAE, close, jax_apply, port, rand, random_params, t

torch.set_num_threads(1)

GRAD_RTOL = 2e-5


# ---------------------------------------------------------------- VAE encoder

@pytest.fixture(scope="module")
def vae_pair():
    jm = JaxVAE(**VAE)
    params = random_params(jm, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)), jax.random.PRNGKey(1))
    return jm, params


@pytest.mark.parametrize("clamped", [False, True])
def test_vae_encode_matches_jax(vae_pair, clamped):
    """``clamped`` pushes half the logvar channels above 20 and half below
    -30 through quant_conv's bias, so the clamp decides them."""
    jm, params = vae_pair
    if clamped:
        bias = np.asarray(params["quant_conv"]["bias"]).copy()
        bias[4:6], bias[6:] = 60.0, -60.0
        params = {**params, "quant_conv": {**params["quant_conv"], "bias": bias}}
    rng = np.random.default_rng(8 + clamped)
    x = np.clip(rand(rng, 2, 2 * LATENT, 2 * LATENT, 3), -1.0, 1.0)
    jx, key = jnp.asarray(x), jax.random.PRNGKey(4)
    mean_j, logvar_j = jax_apply(jm, params, jx, method=jm.encode_moments)
    z_j = jax_apply(jm, params, jx, key, method=jm.encode)
    noise = jax.random.normal(key, mean_j.shape, mean_j.dtype)  # encode's own draw
    mode_j = jax_apply(jm, params, jx, method=jm.encode_mode)
    vae = port(AutoencoderKL(**VAE), params)
    with torch.no_grad():
        mean, logvar = vae.encode_moments(t(x))
        z, mode = vae.encode(t(x), t(noise)), vae.encode_mode(t(x))
    assert mean.shape == (2, LATENT, LATENT, 4)
    if clamped:
        assert float(logvar[..., :2].max()) == 20.0 and float(logvar[..., 2:].min()) == -30.0
    # with logvar at 20 a sample reaches exp(10) ~ 2e4: fp32 ulps there, rtol 1e-5
    for got, want in ((mean, mean_j), (logvar, logvar_j), (z, z_j), (mode, mode_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


def test_vae_downsample_pads_asymmetrically():
    """The encoder's Downsample pads (0, 1), not 1 on both sides: the
    first output pixel sees input rows/cols 0..2, the UNet form's -1..1."""
    from gligen_tpu_torch.models.unet import Downsample as UNetDownsample
    from gligen_tpu_torch.models.vae import Downsample

    torch.manual_seed(0)
    vae_ds, unet_ds = Downsample(32), UNetDownsample(32)
    unet_ds.op.load_state_dict(vae_ds.conv.state_dict())
    x = torch.randn(1, 8, 8, 32)
    with torch.no_grad():
        got, other = vae_ds(x), unet_ds(x)
        want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), vae_ds.conv.weight,
                                          vae_ds.conv.bias, stride=2)  # no pad reaches 0..2
    assert got.shape == other.shape == (1, 4, 4, 32)
    close(got[:, :3, :3], want.permute(0, 2, 3, 1)[:, :3, :3].numpy(), atol=1e-5)
    assert float((got - other).abs().max()) > 1e-2


# ------------------------------------------------------ kernel gradients

def leaves(*arrays):
    return [t(a).requires_grad_(True) for a in arrays]


def assert_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0
        np.testing.assert_allclose(g.detach().numpy(), w, atol=GRAD_RTOL * scale, rtol=0)


def norm_params(rng, c):
    return 1.0 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)


@pytest.mark.parametrize("n_w", [1, 3])
def test_ln_matmuls_gradients_match_jax(n_w):
    rng = np.random.default_rng(20 + n_w)
    x = rand(rng, 2, 72, 64) * 2.0 + 0.3
    s, b = norm_params(rng, 64)
    ws = [rand(rng, 64, 96, scale=64**-0.5) for _ in range(n_w)]  # JAX (K, F)
    gs = [rand(rng, 2, 72, 96) for _ in range(n_w)]

    def jloss(x_, s_, b_, *ws_):
        outs = jpm.ln_matmuls(x_, s_, b_, ws_, block_n=32, interpret=True)
        return sum(jnp.sum(o * jnp.asarray(g)) for o, g in zip(outs, gs))

    want = jax.grad(jloss, argnums=tuple(range(3 + n_w)))(
        *(jnp.asarray(a) for a in (x, s, b, *ws)))
    tx, ts, tb, *tw = leaves(x, s, b, *(w.T.copy() for w in ws))
    outs = fp.ln_matmuls(tx, ts, tb, tw)
    sum((o * t(g)).sum() for o, g in zip(outs, gs)).backward()
    assert_grads([tx.grad, ts.grad, tb.grad, *(w.grad.T for w in tw)], want)


@pytest.mark.parametrize("gate", ["tensor", 0.6, None])
def test_matmul_residual_gradients_match_jax(gate):
    """A tensor gate (the fuser's gate_scale * tanh(alpha)) gets its
    gradient, sum(dout * (h @ W + b)): the only path by which the fusers'
    alpha_attn and alpha_dense train."""
    rng = np.random.default_rng(30)
    h, x = rand(rng, 2, 40, 128), rand(rng, 2, 40, 64)
    w, b = rand(rng, 128, 64, scale=128**-0.5), rand(rng, 64, scale=0.1)
    g = rand(rng, 2, 40, 64)
    gval = 0.43 if gate == "tensor" else gate

    def jloss(h_, w_, b_, x_, g_):
        out = jpm.matmul_residual(h_, w_, b_, x_, gate=g_, block_n=32, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    jg = None if gval is None else jnp.float32(gval)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3) + ((4,) if gate == "tensor" else ()))(
        *(jnp.asarray(a) for a in (h, w, b, x)), jg)
    th, tw, tb, tx = leaves(h, w.T.copy(), b, x)
    tg = torch.tensor(gval, requires_grad=True) if gate == "tensor" else gate
    (fp.matmul_residual(th, tw, tb, tx, gate=tg) * t(g)).sum().backward()
    got = [th.grad, tw.grad.T, tb.grad, tx.grad] + ([tg.grad] if gate == "tensor" else [])
    assert_grads(got, want)


def test_ln_geglu_gradients_match_jax():
    rng = np.random.default_rng(40)
    x = rand(rng, 2, 48, 64)
    s, b = norm_params(rng, 64)
    w, wb = rand(rng, 64, 256, scale=64**-0.5), rand(rng, 256, scale=0.1)
    g = rand(rng, 2, 48, 128)

    def jloss(*a):
        return jnp.sum(jpm.ln_geglu(*a, block_n=16, interpret=True) * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, s, b, w, wb)))
    tx, ts, tb, tw, twb = leaves(x, s, b, w.T.copy(), wb)
    (fp.ln_geglu(tx, ts, tb, tw, twb) * t(g)).sum().backward()
    assert_grads([tx.grad, ts.grad, tb.grad, tw.grad.T, twb.grad], want)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_gradients_match_jax(silu):
    rng = np.random.default_rng(50 + silu)
    x = rand(rng, 2, 8, 8, 64) * 2.0 + rand(rng, 1, 1, 1, 64)
    s, b = norm_params(rng, 64)
    g = rand(rng, 2, 8, 8, 64)

    def jloss(*a):
        return jnp.sum(jpn.group_norm_silu(*a, 32, 1e-5, silu, True) * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, s, b)))
    tx, ts, tb = leaves(x, s, b)
    (fn.group_norm_fused(tx, ts, tb, 32, 1e-5, silu=silu) * t(g)).sum().backward()
    assert_grads([tx.grad, ts.grad, tb.grad], want)


def test_layer_norm_gradients_match_jax():
    rng = np.random.default_rng(60)
    x = rand(rng, 3, 40, 64) * 2.0 + 0.5
    s, b = norm_params(rng, 64)
    g = rand(rng, 3, 40, 64)

    def jloss(*a):
        return jnp.sum(jpn.layer_norm_f(*a, 1e-5, True) * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, s, b)))
    tx, ts, tb = leaves(x, s, b)
    (fn.layer_norm_fused(tx, ts, tb) * t(g)).sum().backward()
    assert_grads([tx.grad, ts.grad, tb.grad], want)


@pytest.mark.parametrize("residual", [False, True])
def test_fused_conv_gradients_match_jax(residual):
    """Through the statistics (``gn_affine``) and the conv's reference
    chain, as pallas_conv.py differentiates them."""
    rng = np.random.default_rng(70 + residual)
    x = rand(rng, 2, 8, 8, 64) + rand(rng, 1, 1, 1, 64)
    s, b = norm_params(rng, 64)
    wk, wb = rand(rng, 3, 3, 64, 32, scale=(9 * 64) ** -0.5), rand(rng, 32, scale=0.1)  # HWIO
    res = rand(rng, 2, 8, 8, 32)
    g = rand(rng, 2, 8, 8, 32)
    n_args = 6 if residual else 5

    def jloss(*a):
        out = jpc.gn_silu_conv3x3(*a[:5], residual=a[5] if residual else None, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=tuple(range(n_args)))(
        *(jnp.asarray(a) for a in (x, s, b, wk, wb, res)[:n_args]))
    tx, ts, tb, tw, twb, tr = leaves(x, s, b, wk.transpose(3, 2, 0, 1).copy(), wb, res)
    out = fc.gn_silu_conv3x3(tx, ts, tb, tw, twb, residual=tr if residual else None)
    (out * t(g)).sum().backward()
    got = [tx.grad, ts.grad, tb.grad, tw.grad.permute(2, 3, 1, 0), twb.grad]
    assert_grads(got + ([tr.grad] if residual else []), want)
