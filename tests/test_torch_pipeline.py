"""End to end: gligen_tpu_torch's GenerationPipeline.generate against
gligen_tpu's, same random weights (carried by the bridge), same prompts,
boxes and starting noise, on the CPU in fp32.

The run covers CLIP text encode, the grounding tokens with their CFG null
pair, the peeled Heun step and the gated phase, the fuser-free tail with
the SD first conv (alpha stages [0.3, 0, 0.7] at 4 steps: one gated step,
three gate-0 steps), CFG 7.5 as one 2B-row UNet call, and VAE decode.
A second case runs without CFG (guidance 1.0) and with the gate at 1 for
every step.  Tolerance: fp32 on both sides through ~5 UNet calls and the
decoder, then a clip to [0, 1]; measured ~3e-6, atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from gligen_tpu.inference.pipeline import GenerationPipeline as JaxPipeline
from gligen_tpu.inference.pipeline import GligenComponents as JaxComponents
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE

from gligen_tpu_torch.convert.from_jax import load_jax_params
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents

from test_torch_modules import CLIP, CTX, LATENT, UNET, VAE, grounding_inputs, random_params

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "guidance,steps,alpha", [(7.5, 4, [0.3, 0.0, 0.7]), (1.0, 2, None)]
)
def test_generate_matches_jax_pipeline(guidance, steps, alpha):
    rng = np.random.default_rng(0)
    b = 2
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(b, 77)).astype(np.int32)
    uc_ids = np.full((b, 77), CLIP["vocab_size"] - 1, np.int32)
    grounding = grounding_inputs(rng, b)
    noise = rng.standard_normal((b, LATENT, LATENT, 4)).astype(np.float32)

    unet, vae, clip = JaxUNet(**UNET, use_checkpoint=False), JaxVAE(**VAE), JaxCLIP(**CLIP)
    g1 = {k: jnp.asarray(v[:1]) for k, v in grounding.items()}
    params = {
        "model": random_params(unet, jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 77, CTX)), g1, seed=1),
        "autoencoder": random_params(vae, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
                                     jax.random.PRNGKey(0), seed=2),
        "text_encoder": random_params(clip, jnp.zeros((1, 77), jnp.int32), seed=3),
    }
    sched = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    kwargs = dict(steps=steps, guidance_scale=guidance, alpha_stages=alpha,
                  latent_size=LATENT, noise=noise)

    jax_comps = JaxComponents(unet, vae, clip, JaxSchedule.create(**sched), params)
    want = np.asarray(JaxPipeline(jax_comps).generate(ids, uc_ids, grounding, **kwargs))

    comps = GligenComponents.create(unet_config=UNET, dtype=torch.float32, vae_config=VAE,
                                    text_config=CLIP, device="cpu")
    load_jax_params(comps, params)
    got = GenerationPipeline(comps).generate(ids, uc_ids, grounding, **kwargs)

    assert got.shape == (b, 2 * LATENT, 2 * LATENT, 3) and got.dtype == torch.float32
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert float(got.std()) > 1e-2  # not a constant image
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
