"""The training step of gligen_tpu_torch against gligen_tpu's
(gligen_tpu/training/train_step.py), on the CPU at a tiny size (the
dry-run configuration of train_step.py:276-285).

  * the loss and every trainable gradient of ``make_loss_fn``, in both
    latent branches (live VAE encode, cached posterior moments), with the
    JAX package's ``k_vae, k_t, k_noise, k_drop`` draws passed in, with and
    without per-block remat;
  * AdamW + the warmup schedule against optax on the same gradients (not
    whole steps: at Adam's first step the update is about lr * sign(g), so
    gradients that agree to 1e-6 but sit near 0 would flip whole-lr
    updates);
  * ``trainable_mask`` against the JAX rule on the same tree;
  * the EMA update, ``q_sample`` and the remat policies.

Tolerances, fp32 on both sides (JAX with "highest" matmul precision): the
loss is a mean over 2048 squared errors of a UNet whose stages agree to
~1e-6 relative: rtol 1e-5.  A gradient runs back through every stage
after its parameter: each agrees to 2e-4 of its tensor's largest entry.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from gligen_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE
from gligen_tpu.training import train_step as jts

from gligen_tpu_torch.convert.from_jax import load_jax_params
from gligen_tpu_torch.diffusion.schedule import DiffusionSchedule
from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.training import train_step as tts

from test_torch_modules import UNET, grounding_inputs, rand, random_params, t

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
CTX, B, IMAGE = 32, 2, 32
TINY_UNET = dict(
    in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1, attention_resolutions=(1,),
    channel_mult=(1, 2), num_heads=2, context_dim=CTX,
    grounding_tokenizer={"target": "text", "params": {"in_dim": CTX, "out_dim": CTX}},
)
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=IMAGE)
TINY_CLIP = dict(vocab_size=64, hidden_size=CTX, layers=1, heads=2, max_positions=8)
LATENT = IMAGE // 2


def port_name(path):
    """A JAX parameter path -> the port's parameter name."""
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(path[-1], path[-1])
    return ".".join(path[:-1] + (leaf,))


@pytest.fixture(scope="module")
def jax_setup():
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    unet = JaxUNet(**TINY_UNET, use_checkpoint=True)
    vae, text = JaxVAE(**TINY_VAE), JaxCLIP(**TINY_CLIP)
    params = {
        "model": random_params(unet, jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 8, CTX)), g, seed=1),
        "autoencoder": random_params(vae, jnp.zeros((1, IMAGE, IMAGE, 3)), jax.random.PRNGKey(1),
                                     seed=2),
        "text_encoder": random_params(text, jnp.zeros((1, 8), jnp.int32), seed=3),
    }
    schedule = JaxSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    rng = np.random.default_rng(4)
    image = np.clip(rand(rng, B, IMAGE, IMAGE, 3), -1.0, 1.0)
    batch = {"image": image, "input_ids": rng.integers(1, 63, size=(B, 8)).astype(np.int32),
             "grounding": grounding_inputs(rng, B, n=6, dim=CTX)}
    mean, logvar = jax.jit(lambda p, x: vae.apply({"params": p}, x, method=vae.encode_moments))(
        params["autoencoder"], jnp.asarray(image))
    batch["latent_moments"] = np.concatenate([np.asarray(mean), np.asarray(logvar)], axis=-1)
    return unet, vae, text, params, schedule, batch


def _jax_loss_and_grads(setup, branch, drop_prob):
    """The JAX loss, its trainable gradients by port name, and its draws."""
    unet, vae, text, params, schedule, batch = setup
    train, frozen = jts.partition(params["model"], jts.trainable_mask(params["model"]))
    aux = {"autoencoder": params["autoencoder"], "text_encoder": params["text_encoder"]}
    keys = ("image" if branch == "image" else "latent_moments", "input_ids", "grounding")
    jbatch = jax.tree.map(jnp.asarray, {k: batch[k] for k in keys})
    loss_fn = jts.make_loss_fn(unet, vae, text, schedule, grounding_drop_prob=drop_prob)
    rng = jax.random.PRNGKey(7)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(train, frozen, aux, jbatch, rng)
    k_vae, k_t, k_noise, k_drop = jax.random.split(rng, 4)
    shape = (B, LATENT, LATENT, 4)
    draws = {"posterior": jax.random.normal(k_vae, shape, jnp.float32),
             "u_t": jax.random.uniform(k_t, (B,)),
             "noise": jax.random.normal(k_noise, shape, jnp.float32),
             "u_drop": jax.random.uniform(k_drop, ())}
    return float(loss), {port_name(p): np.asarray(g) for p, g in grads.items()}, \
        {k: np.array(v) for k, v in draws.items()}


@pytest.fixture(scope="module")
def jax_reference(jax_setup):
    """(branch, drop_prob) -> the JAX loss, gradients and draws, each
    computed once for the module."""
    cache = {}

    def get(branch, drop_prob):
        if (branch, drop_prob) not in cache:
            cache[branch, drop_prob] = _jax_loss_and_grads(jax_setup, branch, drop_prob)
        return cache[branch, drop_prob]

    return get


def port_components(jax_params, use_checkpoint):
    comps = GligenComponents.create(unet_config=dict(TINY_UNET, use_checkpoint=use_checkpoint),
                                    dtype=torch.float32, vae_config=TINY_VAE,
                                    text_config=TINY_CLIP, device="cpu")
    load_jax_params(comps, jax_params)
    return comps


def port_batch(batch, branch):
    keys = ("image" if branch == "image" else "latent_moments", "input_ids", "grounding")
    return {k: ({g: t(v) for g, v in batch[k].items()} if k == "grounding" else t(batch[k]))
            for k in keys}


@pytest.mark.parametrize(
    "branch,drop_prob,use_checkpoint",
    [("image", 0.1, True), ("image", 0.1, False), ("latent_moments", 1.0, True)],
)
def test_loss_and_gradients_match_jax(jax_setup, jax_reference, branch, drop_prob,
                                     use_checkpoint):
    """drop_prob 1.0 drops the grounding of the whole batch."""
    want_loss, want_grads, draws = jax_reference(branch, drop_prob)
    _, _, _, params, _, batch = jax_setup
    comps = port_components(params, use_checkpoint)
    state = tts.create_train_state(comps.unet)
    loss_fn = tts.make_loss_fn(comps.unet, comps.vae, comps.text_encoder, comps.schedule,
                               grounding_drop_prob=drop_prob)
    loss = loss_fn(port_batch(batch, branch), draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    assert set(state.params) == set(want_grads)
    for name, p in state.params.items():
        want = want_grads[name]
        if p.grad.dim() == 2:
            want = want.T  # Dense kernels are (I, O) in JAX
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)


def test_both_latent_branches_give_one_loss():
    """Live encode and the cached moments of the same image give the same
    loss, bit for bit, for the same draws (the JAX package's contract)."""
    comps = GligenComponents.create(unet_config=TINY_UNET, dtype=torch.float32,
                                    vae_config=TINY_VAE, text_config=TINY_CLIP, device="cpu")
    rng = np.random.default_rng(9)
    image = t(np.clip(rand(rng, B, IMAGE, IMAGE, 3), -1.0, 1.0))
    with torch.no_grad():
        moments = torch.cat(comps.vae.encode_moments(image), dim=-1)
    common = {"input_ids": t(rng.integers(1, 63, size=(B, 8))),
              "grounding": {k: t(v) for k, v in grounding_inputs(rng, B, n=6, dim=CTX).items()}}
    shape = (B, LATENT, LATENT, 4)
    draws = {"posterior": rand(rng, *shape), "u_t": rng.random(B), "noise": rand(rng, *shape),
             "u_drop": 0.5}
    loss_fn = tts.make_loss_fn(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    with torch.no_grad():
        live = loss_fn({"image": image, **common}, draws=draws)
        cached = loss_fn({"latent_moments": moments, **common}, draws=draws)
    assert torch.equal(live, cached)


@pytest.mark.parametrize("scheduler_type", ["constant", "cosine"])
def test_optimizer_matches_optax(scheduler_type):
    """The same gradients through torch's AdamW + LambdaLR and optax's
    adamw + join_schedules over 3 steps with a 2-step warmup: step 0 has
    learning rate 0 and changes nothing.  fp32 updates of O(1) parameters
    by at most lr = 1e-2: atol 1e-6."""
    rng = np.random.default_rng(11)
    params = {"w": rand(rng, 5, 3), "b": rand(rng, 7)}
    grads = [{k: rand(rng, *v.shape) for k, v in params.items()} for _ in range(3)]
    kw = dict(base_lr=1e-2, weight_decay=0.05, warmup_steps=2, total_steps=5,
              scheduler_type=scheduler_type)
    tx = jts.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: nn.Parameter(t(v)) for k, v in params.items()}
    opt, sched = tts.make_optimizer(list(tp.values()), **kw)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = t(g[k])
        opt.step()
        sched.step()
        for k, p in tp.items():
            if i == 0:
                assert torch.equal(p.detach(), t(params[k]))
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
    schedule = (jts.warmup_constant(1e-2, 2) if scheduler_type == "constant"
                else jts.warmup_cosine(1e-2, 2, 5))
    mult = tts.lr_multiplier(2, 5, scheduler_type)
    for c in range(8):
        np.testing.assert_allclose(1e-2 * mult(c), float(schedule(c)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("input_conv_train", [False, True])
def test_trainable_mask_matches_jax(input_conv_train):
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    model = JaxUNet(**UNET, use_checkpoint=False)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, CTX)), g)["params"]
    want = traverse_util.flatten_dict(jts.trainable_mask(shapes, input_conv_train))
    want = {port_name(p): v for p, v in want.items()}
    comps = GligenComponents.create(unet_config=UNET, dtype=torch.float32, device="cpu")
    got = tts.trainable_mask(comps.unet, input_conv_train)
    assert got == want
    assert any(got.values()) and not all(got.values())
    assert got["input_blocks_0_0.weight"] == input_conv_train
    assert not got["input_blocks_0_0.bias"]


def test_train_step_freezes_and_keeps_ema_copies():
    """create_train_state freezes every non-trainable UNet parameter (no
    gradient after a step); the EMA copies are copies, and one step gives
    e * rate + p * (1 - rate) (train_step.py:239-242) to fp32 rounding."""
    comps = GligenComponents.create(unet_config=TINY_UNET, dtype=torch.float32,
                                    vae_config=TINY_VAE, text_config=TINY_CLIP, device="cpu")
    with torch.no_grad():  # nonzero fuser gates, so every fuser weight gets a gradient
        for name, p in comps.unet.named_parameters():
            if "alpha" in name:
                p.fill_(0.5)
    state = tts.create_train_state(comps.unet, enable_ema=True, base_lr=1e-3, warmup_steps=0)
    assert all(e.data_ptr() != state.params[n].data_ptr() and torch.equal(e, state.params[n])
               for n, e in state.ema_params.items())
    ema0 = {n: e.clone() for n, e in state.ema_params.items()}
    rate = 0.99
    step = tts.make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule,
                               ema_rate=rate)
    rng = np.random.default_rng(12)
    batch = {"image": t(np.clip(rand(rng, B, IMAGE, IMAGE, 3), -1.0, 1.0)),
             "input_ids": t(rng.integers(1, 63, size=(B, 8))),
             "grounding": {k: t(v) for k, v in grounding_inputs(rng, B, n=6, dim=CTX).items()}}
    out = step(state, batch, generator=torch.Generator().manual_seed(0))
    assert state.step == 1 and out["loss"].dim() == 0 and torch.isfinite(out["loss"])
    for name, p in comps.unet.named_parameters():
        assert p.requires_grad == (name in state.params)
        assert (p.grad is not None) == (name in state.params), name
    for n, e in state.ema_params.items():
        p = state.params[n].detach().numpy()
        want = ema0[n].numpy() * np.float32(rate) + p * np.float32(1.0 - rate)
        np.testing.assert_allclose(e.numpy(), want, rtol=1e-6, atol=1e-7)
    assert any(not torch.equal(e, ema0[n]) for n, e in state.ema_params.items())


def test_q_sample_matches_jax():
    js = JaxSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    ts = DiffusionSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, name), np.asarray(getattr(js, name)))
    rng = np.random.default_rng(13)
    x, noise = rand(rng, 3, 4, 4, 4), rand(rng, 3, 4, 4, 4)
    steps = np.array([0, 517, 999], np.int32)
    want = js.q_sample(jnp.asarray(x), jnp.asarray(steps), jnp.asarray(noise))
    got = ts.q_sample(t(x), t(steps).long(), t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_remat_policies(monkeypatch):
    """'none' stores what 'full' recomputes: the same gradients; 'dots' is
    not ported and says so."""
    comps = GligenComponents.create(unet_config=dict(TINY_UNET, use_checkpoint=True),
                                    dtype=torch.float32, vae_config=TINY_VAE,
                                    text_config=TINY_CLIP, device="cpu")
    state = tts.create_train_state(comps.unet)
    rng = np.random.default_rng(14)
    batch = {"latent_moments": t(rand(rng, B, LATENT, LATENT, 8)),
             "input_ids": t(rng.integers(1, 63, size=(B, 8))),
             "grounding": {k: t(v) for k, v in grounding_inputs(rng, B, n=6, dim=CTX).items()}}
    shape = (B, LATENT, LATENT, 4)
    draws = {"posterior": rand(rng, *shape), "u_t": rng.random(B), "noise": rand(rng, *shape),
             "u_drop": 0.5}
    loss_fn = tts.make_loss_fn(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    grads = {}
    for policy in ("full", "none"):
        monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", policy)
        state.optimizer.zero_grad(set_to_none=True)
        loss_fn(batch, draws=draws).backward()
        grads[policy] = {n: p.grad.clone() for n, p in state.params.items()}
    for n, g in grads["full"].items():
        torch.testing.assert_close(g, grads["none"][n], atol=1e-6, rtol=1e-6)
    monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", "dots")
    with pytest.raises(NotImplementedError, match="dots"):
        loss_fn(batch, draws=draws)


# A tiny hed UNet: the hed downsampler's 64^2 channels fix the latent at
# 64^2, where the UNet attends at its inner level only (32^2 tokens).
HED_UNET = dict(TINY_UNET, attention_resolutions=(2,),
                grounding_tokenizer={"target": "hed",
                                     "params": {"resize_input": 64, "out_dim": CTX}},
                grounding_downsampler={"target": "hed", "params": {}})
HED_LATENT = 64


@pytest.fixture(scope="module")
def jax_hed_setup(jax_setup):
    """The hed UNet's random parameters (the VAE's and the text encoder's
    from ``jax_setup``) and a cached-latent batch whose grounding is a
    uint8 hed map with its mask, and whose ``grounding_extra`` is the same
    map, as the spatial datasets give it."""
    _, vae, text, params, schedule, _ = jax_setup
    rng = np.random.default_rng(15)
    edge = rng.integers(0, 256, size=(B, 128, 128, 3)).astype(np.uint8)
    grounding = {"hed_edge": edge, "mask": np.ones(B, np.float32)}
    unet = JaxUNet(**HED_UNET, use_checkpoint=True)
    model = random_params(unet, jnp.zeros((1, HED_LATENT, HED_LATENT, 4)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, CTX)),
                          {k: jnp.asarray(v[:1]) for k, v in grounding.items()},
                          grounding_extra=jnp.asarray(edge[:1]), seed=16)
    moments = np.concatenate([rand(rng, B, HED_LATENT, HED_LATENT, 4),
                              rand(rng, B, HED_LATENT, HED_LATENT, 4, scale=0.5) - 2.0], axis=-1)
    batch = {"latent_moments": moments, "input_ids": rng.integers(1, 63, size=(B, 8)).astype(
        np.int32), "grounding": grounding, "grounding_extra": edge}
    return unet, vae, text, dict(params, model=model), schedule, batch


@pytest.mark.parametrize("drop_prob", [0.0, 1.0])
def test_spatial_loss_and_gradients_match_jax(jax_hed_setup, drop_prob):
    """The hed UNet's loss and trainable gradients (ConvNeXt's, the position
    net's and the fusers') with ``grounding_extra`` in the batch, against
    the JAX loss with the same draws.  With drop_prob 1.0 the grounding is
    dropped (mask 0: ConvNeXt gets zero gradients on both sides) and the
    map still reaches the first conv, as in the JAX step."""
    unet, vae, text, params, schedule, batch = jax_hed_setup
    train, frozen = jts.partition(params["model"], jts.trainable_mask(params["model"]))
    aux = {"autoencoder": params["autoencoder"], "text_encoder": params["text_encoder"]}
    loss_fn = jts.make_loss_fn(unet, vae, text, schedule, grounding_drop_prob=drop_prob)
    rng = jax.random.PRNGKey(17)
    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        train, frozen, aux, jax.tree.map(jnp.asarray, batch), rng)
    k_vae, k_t, k_noise, k_drop = jax.random.split(rng, 4)
    shape = (B, HED_LATENT, HED_LATENT, 4)
    draws = {"posterior": np.array(jax.random.normal(k_vae, shape, jnp.float32)),
             "u_t": np.array(jax.random.uniform(k_t, (B,))),
             "noise": np.array(jax.random.normal(k_noise, shape, jnp.float32)),
             "u_drop": np.array(jax.random.uniform(k_drop, ()))}
    want_grads = {port_name(p): np.asarray(g) for p, g in grads.items()}

    comps = GligenComponents.create(unet_config=dict(HED_UNET, use_checkpoint=True),
                                    dtype=torch.float32, vae_config=TINY_VAE,
                                    text_config=TINY_CLIP, device="cpu")
    load_jax_params(comps, params)
    state = tts.create_train_state(comps.unet)
    port_loss = tts.make_loss_fn(comps.unet, comps.vae, comps.text_encoder, comps.schedule,
                                 grounding_drop_prob=drop_prob)
    tb = {"latent_moments": t(batch["latent_moments"]), "input_ids": t(batch["input_ids"]),
          "grounding": {k: t(v) for k, v in batch["grounding"].items()},
          "grounding_extra": t(batch["grounding_extra"])}
    loss = port_loss(tb, draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    assert set(state.params) == set(want_grads)
    assert any("convnext_tiny_backbone" in n for n in state.params)
    # every mask is 1 (no null feature read) unless the grounding is dropped
    # (no ConvNeXt output read)
    zero = {n for n, g in want_grads.items() if not np.abs(g).max()}
    if drop_prob == 0.0:
        assert zero == {"position_net.null_feature"}
    else:
        assert zero and all("convnext_tiny_backbone" in n for n in zero)
    for name, p in state.params.items():
        want = want_grads[name]
        if p.grad.dim() == 2:
            want = want.T  # Dense kernels are (I, O) in JAX
        elif p.grad.dim() == 4:
            want = want.transpose(3, 2, 0, 1)  # conv kernels HWIO -> OIHW
        if name in zero:
            assert not p.grad.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, atol=GRAD_RTOL * np.abs(want).max(),
                                   rtol=0, err_msg=name)
