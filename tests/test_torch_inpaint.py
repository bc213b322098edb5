"""Inpainting and DDIM in gligen_tpu_torch against gligen_tpu, on the CPU
in fp32 at a small width: the sampler tables without a restorable first
conv (F2), ``ddim_sample`` (eta 0 and 0.5, the blend, the gate-0 split)
and ``plms_sample`` with the blend, each with the JAX package's
``fold_in`` noise passed in; the inpaint UNet's forward; the fp32 encode;
``GenerationPipeline.generate`` inpainting with PLMS and with DDIM; the
box and stroke masks; and the inpaint train step's loss.

Tolerances: the sampler cases as ``test_torch_samplers.py`` (fp32 through
10 steps of coefficients up to ~15: rtol 2e-6, atol 1e-5); the UNet and
the encode as ``test_torch_modules.py`` (1e-4); ``generate`` as
``test_torch_pipeline.py`` (atol 1e-4 on images in [0, 1], measured a few
1e-6); the loss as ``test_torch_train_step.py`` (rtol 1e-5); masks exactly
(the same numpy code on the same Generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gligen_tpu.data import inpaint_masks as jmasks
from gligen_tpu.diffusion import samplers as js
from gligen_tpu.diffusion import schedule as jsch
from gligen_tpu.inference.pipeline import GenerationPipeline as JaxPipeline
from gligen_tpu.inference.pipeline import GligenComponents as JaxComponents
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE
from gligen_tpu.training import train_step as jts

from gligen_tpu_torch.convert.from_jax import load_jax_params
from gligen_tpu_torch.data import inpaint_masks as tmasks
from gligen_tpu_torch.diffusion import samplers as ts
from gligen_tpu_torch.diffusion import schedule as tsch
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.models.unet import UNetModel
from gligen_tpu_torch.models.vae import AutoencoderKL
from gligen_tpu_torch.training import train_step as tts

from test_torch_modules import (CLIP, CTX, LATENT, UNET, VAE, close, grounding_inputs,
                                jax_apply, port, rand, random_params, t)
from test_torch_samplers import SCHED, _jax_eps, _torch_eps

torch.set_num_threads(1)

ALPHA = [0.3, 0.0, 0.7]


def test_tables_without_a_restorable_first_conv():
    """F2: an inpaint UNet has no SD first conv, so no step switches to it:
    use_sd is all false under alpha [0.3, 0, 0.7], as in the JAX package;
    every table (sigma_t at eta 0.5 included) equals JAX's."""
    for restorable, eta in ((False, 0.0), (True, 0.5)):
        want = js.SamplerTables.create(jsch.DiffusionSchedule.create(**SCHED), 10, eta=eta,
                                       alpha_stages=ALPHA, first_conv_restorable=restorable)
        got = ts.SamplerTables.create(tsch.DiffusionSchedule.create(**SCHED), 10, eta=eta,
                                      alpha_stages=ALPHA, first_conv_restorable=restorable)
        for field in ("ts", "ts_next", "a_t", "a_prev", "sqrt_one_minus_at", "sigma_t", "gate",
                      "use_sd"):
            np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)),
                                          field)
        assert got.use_sd.any() == restorable
        assert (got.sigma_t > 0).any() == (eta > 0)


def blend_inputs(shape=(2, 8, 8, 4)):
    rng = np.random.default_rng(3)
    x0 = rand(rng, *shape)
    mask = (rng.random(shape[:3] + (1,)) > 0.4).astype(np.float32)
    return x0, mask


def fold_in_noise(key, steps, shape):
    """(S, *shape): the JAX samplers' normal(fold_in(key, i)) for each step."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                                  jnp.float32)) for i in range(steps)])


@pytest.mark.parametrize("eta,inpaint,with_gate0", [(0.0, False, False), (0.0, True, True),
                                                    (0.5, True, False), (0.5, False, True)])
def test_ddim_sample_matches_jax(eta, inpaint, with_gate0):
    noise = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    x0, mask = blend_inputs()
    rng = jax.random.PRNGKey(11)
    want = js.ddim_sample(
        _jax_eps(0.0), jsch.DiffusionSchedule.create(**SCHED), jnp.asarray(noise), steps=10,
        eta=eta, alpha_stages=ALPHA, mask=jnp.asarray(mask) if inpaint else None,
        x0=jnp.asarray(x0) if inpaint else None, rng=rng,
        eps_fn_gate0=_jax_eps(0.05) if with_gate0 else None,
    )
    calls = []
    got = ts.ddim_sample(
        _torch_eps(0.0, calls), tsch.DiffusionSchedule.create(**SCHED), torch.from_numpy(noise),
        steps=10, eta=eta, alpha_stages=ALPHA, mask=t(mask) if inpaint else None,
        x0=t(x0) if inpaint else None,
        blend_noise=fold_in_noise(jax.random.fold_in(rng, 1), 10, x0.shape) if inpaint else None,
        sigma_noise=fold_in_noise(jax.random.fold_in(rng, 2), 10, noise.shape) if eta else None,
        eps_fn_gate0=_torch_eps(0.05, calls) if with_gate0 else None,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=2e-6)
    # one call a step; the gate-0 steps (3..9) go to the fuser-free twin
    assert [c[3] for c in calls] == [0.0] * 3 + [0.05 if with_gate0 else 0.0] * 7
    assert [c[2] for c in calls] == [False] * 3 + [True] * 7  # restorable by default


def test_ddim_draws_from_the_generator():
    """Without injected noise the blend and the sigma noise come from the
    generator: the same seed repeats, another seed differs."""
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(
        np.float32))
    x0, mask = blend_inputs()

    def run(seed):
        return ts.ddim_sample(_torch_eps(0.0, []), tsch.DiffusionSchedule.create(**SCHED), noise,
                              steps=5, eta=0.5, mask=t(mask), x0=t(x0),
                              generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


@pytest.mark.parametrize("with_gate0", [False, True])
def test_plms_blend_matches_jax(with_gate0):
    """The inpaint blend at every step top (the peeled step's included),
    with the JAX fold_in(blend_rng, i) noise; the gate-0 tail of an inpaint
    UNet keeps the GLIGEN conv (restorable False)."""
    noise = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    x0, mask = blend_inputs()
    blend_rng = jax.random.PRNGKey(5)
    want = js.plms_sample(
        _jax_eps(0.0), jsch.DiffusionSchedule.create(**SCHED), jnp.asarray(noise), steps=10,
        alpha_stages=ALPHA, first_conv_restorable=False, mask=jnp.asarray(mask),
        x0=jnp.asarray(x0), blend_rng=blend_rng,
        eps_fn_gate0=_jax_eps(0.05) if with_gate0 else None,
    )
    calls = []
    got = ts.plms_sample(
        _torch_eps(0.0, calls), tsch.DiffusionSchedule.create(**SCHED), torch.from_numpy(noise),
        steps=10, alpha_stages=ALPHA, first_conv_restorable=False, mask=t(mask), x0=t(x0),
        blend_noise=fold_in_noise(blend_rng, 10, x0.shape),
        eps_fn_gate0=_torch_eps(0.05, calls) if with_gate0 else None,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=2e-6)
    assert len(calls) == 11 and not any(c[2] for c in calls)


def jax_inpaint_unet():
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    model = JaxUNet(**UNET, inpaint_mode=True, use_checkpoint=False)
    params = random_params(model, jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 77, CTX)), g,
                           inpainting_extra=jnp.zeros((1, LATENT, LATENT, 5)), seed=4)
    return model, params


def test_inpaint_unet_forward():
    """x, then z0 * mask and the mask, through the 9-channel GLIGEN conv."""
    model, params = jax_inpaint_unet()
    unet = port(UNetModel(**UNET, inpaint_mode=True), params)
    rng = np.random.default_rng(7)
    x, ctx = rand(rng, 2, LATENT, LATENT, 4), rand(rng, 2, 77, CTX)
    extra = rand(rng, 2, LATENT, LATENT, 5)
    ts_ = np.array([981, 401], np.int32)
    g = grounding_inputs(rng, 2)
    want = jax_apply(model, params, jnp.asarray(x), jnp.asarray(ts_), jnp.asarray(ctx),
                     {k: jnp.asarray(v) for k, v in g.items()}, inpainting_extra=jnp.asarray(extra),
                     gate_scale=0.6)
    with torch.no_grad():
        got = unet(t(x), t(ts_), t(ctx), {k: t(v) for k, v in g.items()},
                   inpainting_extra=t(extra), gate_scale=0.6)
        close(got, want)
        with pytest.raises(ValueError, match="inpainting_extra"):
            unet(t(x), t(ts_), t(ctx), {k: t(v) for k, v in g.items()})
        with pytest.raises(ValueError, match="no SD first conv"):
            unet(t(x), t(ts_), t(ctx), {k: t(v) for k, v in g.items()},
                 inpainting_extra=t(extra), use_sd_conv=True)


def test_fp32_encode_of_a_bf16_vae():
    """encode_fp32 on a bf16 VAE is JAX's vae.clone(dtype=float32) encode
    over the same fp32 parameters, and leaves the module in bf16."""
    jm = JaxVAE(**VAE, dtype=jnp.bfloat16)
    params = random_params(jm, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)), jax.random.PRNGKey(0),
                           seed=6)
    vae = port(AutoencoderKL(**VAE, dtype=torch.bfloat16), params)
    rng = np.random.default_rng(8)
    x = np.clip(rand(rng, 2, 2 * LATENT, 2 * LATENT, 3), -1, 1)
    key = jax.random.PRNGKey(9)
    f32 = jm.clone(dtype=jnp.float32)
    want = jax.jit(lambda p, a: f32.apply({"params": p}, a, key, method=f32.encode))(
        params, jnp.asarray(x))
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    with torch.no_grad():
        got = vae.encode_fp32(t(x), t(noise))
    assert got.dtype == torch.float32
    close(got, want)
    assert vae.dtype == torch.bfloat16 and vae.encoder.conv_in.compute_dtype == torch.bfloat16


def box_masks(b, seed=0):
    boxes = np.sort(np.random.default_rng(seed).random((b, 2, 4)).reshape(b, 2, 2, 2),
                    axis=2).reshape(b, 2, 4)
    return boxes, tmasks.draw_masks_from_boxes(boxes, size=LATENT)


@pytest.mark.parametrize("sampler,steps,alpha", [("plms", 3, None), ("ddim", 4, ALPHA)])
def test_generate_inpaints_as_jax(sampler, steps, alpha):
    """GenerationPipeline.generate with an inpaint image and box masks, CFG
    7.5, against the JAX pipeline with the same weights; the starting noise
    is passed to both, and the encode and blend noise are the JAX
    pipeline's own draws from split(rng, 3)."""
    rng = np.random.default_rng(0)
    b = 2
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(b, 77)).astype(np.int32)
    uc_ids = np.full((b, 77), CLIP["vocab_size"] - 1, np.int32)
    grounding = grounding_inputs(rng, b)
    noise = rng.standard_normal((b, LATENT, LATENT, 4)).astype(np.float32)
    image = np.clip(rng.standard_normal((b, 2 * LATENT, 2 * LATENT, 3)), -1, 1).astype(np.float32)
    _, mask = box_masks(b)
    assert 0.0 < mask.mean() < 1.0

    unet, params_u = jax_inpaint_unet()
    vae, clip = JaxVAE(**VAE), JaxCLIP(**CLIP)
    params = {
        "model": params_u,
        "autoencoder": random_params(vae, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
                                     jax.random.PRNGKey(0), seed=2),
        "text_encoder": random_params(clip, jnp.zeros((1, 77), jnp.int32), seed=3),
    }
    sched = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    key = jax.random.PRNGKey(21)
    kwargs = dict(steps=steps, guidance_scale=7.5, sampler=sampler, alpha_stages=alpha,
                  latent_size=LATENT, noise=noise, inpaint_image=image, inpaint_mask=mask)
    jax_comps = JaxComponents(unet, vae, clip, jsch.DiffusionSchedule.create(**sched), params)
    want = np.asarray(JaxPipeline(jax_comps).generate(ids, uc_ids, grounding, rng=key, **kwargs))

    _, k_enc, k_blend = jax.random.split(key, 3)
    shape = (b, LATENT, LATENT, 4)
    encode_noise = np.array(jax.random.normal(k_enc, shape, jnp.float32))
    n_steps = len(tsch.make_ddim_timesteps(steps, 1000))
    blend_key = k_blend if sampler == "plms" else jax.random.fold_in(k_blend, 1)
    comps = GligenComponents.create(unet_config=dict(UNET, inpaint_mode=True), vae_config=VAE,
                                    text_config=CLIP, dtype=torch.float32, device="cpu")
    load_jax_params(comps, params)
    got = GenerationPipeline(comps).generate(
        ids, uc_ids, grounding, encode_noise=encode_noise,
        blend_noise=fold_in_noise(blend_key, n_steps, shape), **kwargs)

    assert got.shape == (b, 2 * LATENT, 2 * LATENT, 3) and got.dtype == torch.float32
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0 and float(got.std()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_masks_match_jax():
    """draw_masks_from_boxes (plain and randomised) and the stroke masks:
    the same numpy code on the same Generator, exactly."""
    boxes, mask = box_masks(3, seed=1)
    np.testing.assert_array_equal(mask, jmasks.draw_masks_from_boxes(boxes, size=LATENT))
    for size in (64, 32):
        got = tmasks.draw_masks_from_boxes(boxes, size=size, randomize_fg_mask=True,
                                           random_add_bg_mask=True,
                                           rng=np.random.default_rng(7))
        want = jmasks.draw_masks_from_boxes(boxes, size=size, randomize_fg_mask=True,
                                            random_add_bg_mask=True,
                                            rng=np.random.default_rng(7))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (3, size, size, 1) and got.dtype == np.float32
    for fn, args in ((tmasks.generate_stroke_mask, ()), (tmasks.get_a_fg_mask, (40, 24)),
                     (tmasks.get_a_bg_mask, (32,))):
        got = fn(np.random.default_rng(2), *args)
        want = getattr(jmasks, fn.__name__)(np.random.default_rng(2), *args)
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {0.0, 1.0}
    with pytest.raises(ValueError):
        tmasks.get_a_fg_mask(np.random.default_rng(0), 3, 8)


def test_inpaint_train_step_loss_matches_jax():
    """The inpaint branch (z * m, m into the 9-channel conv) of the loss,
    with the JAX draws passed in, and a gradient reaching the fusers."""
    from test_torch_train_step import B, IMAGE, TINY_CLIP, TINY_UNET, TINY_VAE

    latent = IMAGE // 2
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    unet = JaxUNet(**TINY_UNET, inpaint_mode=True, use_checkpoint=False)
    vae, text = JaxVAE(**TINY_VAE), JaxCLIP(**TINY_CLIP)
    params = {
        "model": random_params(unet, jnp.zeros((1, latent, latent, 4)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, CTX)), g,
                               inpainting_extra=jnp.zeros((1, latent, latent, 5)), seed=1),
        "autoencoder": random_params(vae, jnp.zeros((1, IMAGE, IMAGE, 3)),
                                     jax.random.PRNGKey(0), seed=2),
        "text_encoder": random_params(text, jnp.zeros((1, 8), jnp.int32), seed=3),
    }
    rng = np.random.default_rng(4)
    boxes = np.sort(rng.random((B, 2, 4)).reshape(B, 2, 2, 2), axis=2).reshape(B, 2, 4)
    batch = {"image": np.clip(rand(rng, B, IMAGE, IMAGE, 3), -1.0, 1.0),
             "input_ids": rng.integers(1, 63, size=(B, 8)).astype(np.int32),
             "grounding": grounding_inputs(rng, B, n=6, dim=CTX),
             "inpainting_mask": tmasks.draw_masks_from_boxes(boxes, size=latent)}
    schedule = jsch.DiffusionSchedule.create(timesteps=1000, linear_start=0.00085,
                                             linear_end=0.012)
    train, frozen = jts.partition(params["model"], jts.trainable_mask(params["model"]))
    aux = {"autoencoder": params["autoencoder"], "text_encoder": params["text_encoder"]}
    loss_fn = jts.make_loss_fn(unet, vae, text, schedule, grounding_drop_prob=0.1)
    key = jax.random.PRNGKey(7)
    want = jax.jit(loss_fn)(train, frozen, aux, jax.tree.map(jnp.asarray, batch), key)
    k_vae, k_t, k_noise, k_drop = jax.random.split(key, 4)
    shape = (B, latent, latent, 4)
    draws = {"posterior": jax.random.normal(k_vae, shape, jnp.float32),
             "u_t": jax.random.uniform(k_t, (B,)),
             "noise": jax.random.normal(k_noise, shape, jnp.float32),
             "u_drop": jax.random.uniform(k_drop, ())}

    comps = GligenComponents.create(unet_config=dict(TINY_UNET, inpaint_mode=True),
                                    dtype=torch.float32, vae_config=TINY_VAE,
                                    text_config=TINY_CLIP, device="cpu")
    load_jax_params(comps, params)
    state = tts.create_train_state(comps.unet)
    port_loss = tts.make_loss_fn(comps.unet, comps.vae, comps.text_encoder, comps.schedule,
                                 grounding_drop_prob=0.1)
    port_batch = {k: ({g: t(v) for g, v in batch[k].items()} if k == "grounding" else t(batch[k]))
                  for k in batch}
    loss = port_loss(port_batch, draws={k: np.array(v) for k, v in draws.items()})
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    loss.backward()
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in state.params.items() if "fuser" in n)
