"""End to end: gligen_tpu_torch's GenerationPipeline.generate against
gligen_tpu's, same random weights (carried by the bridge), same prompts,
grounding and starting noise, on the CPU in fp32: the box+text UNet, and
the box+text+image and keypoint ones.

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

from test_torch_modules import (CLIP, CTX, LATENT, UNET, VAE, grounding_inputs, rand,
                                random_params)

torch.set_num_threads(1)


def compare_pipelines(unet_config, grounding, guidance=7.5, steps=4, alpha=(0.3, 0.0, 0.7),
                      sampler="plms", grounding_extra=None, latent=LATENT):
    """The port's generate against the JAX pipeline's for a small UNet of
    ``unet_config``, the same random weights (carried by the bridge),
    prompts, ``grounding`` (the tokenizer's inputs, batch 2), the
    downsampler's map ``grounding_extra`` where the UNet has one, and
    starting noise at ``latent``^2."""
    b = 2
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(b, 77)).astype(np.int32)
    uc_ids = np.full((b, 77), CLIP["vocab_size"] - 1, np.int32)
    noise = rng.standard_normal((b, latent, latent, 4)).astype(np.float32)
    alpha = None if alpha is None else list(alpha)

    unet = JaxUNet(**unet_config, use_checkpoint=False)
    vae, clip = JaxVAE(**VAE), JaxCLIP(**CLIP)
    g1 = {k: jnp.asarray(v[:1]) for k, v in grounding.items()}
    extra1 = None if grounding_extra is None else jnp.asarray(grounding_extra[:1])
    params = {
        "model": random_params(unet, jnp.zeros((1, latent, latent, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 77, CTX)), g1, grounding_extra=extra1, seed=1),
        "autoencoder": random_params(vae, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
                                     jax.random.PRNGKey(0), seed=2),
        "text_encoder": random_params(clip, jnp.zeros((1, 77), jnp.int32), seed=3),
    }
    sched = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    kwargs = dict(steps=steps, guidance_scale=guidance, alpha_stages=alpha, sampler=sampler,
                  latent_size=latent, noise=noise, grounding_extra=grounding_extra)

    jax_comps = JaxComponents(unet, vae, clip, JaxSchedule.create(**sched), params)
    want = np.asarray(JaxPipeline(jax_comps).generate(ids, uc_ids, grounding, **kwargs))

    comps = GligenComponents.create(unet_config=unet_config, dtype=torch.float32,
                                    vae_config=VAE, text_config=CLIP, device="cpu")
    load_jax_params(comps, params)
    got = GenerationPipeline(comps).generate(ids, uc_ids, grounding, **kwargs)

    assert got.shape == (b, 2 * latent, 2 * latent, 3) and got.dtype == torch.float32
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert float(got.std()) > 1e-2  # not a constant image
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "guidance,steps,alpha", [(7.5, 4, [0.3, 0.0, 0.7]), (1.0, 2, None)]
)
def test_generate_matches_jax_pipeline(guidance, steps, alpha):
    grounding = grounding_inputs(np.random.default_rng(10), 2)
    compare_pipelines(UNET, grounding, guidance=guidance, steps=steps, alpha=alpha)


# the small UNet with each other tokenizer (the text one is UNET's)
TOKENIZERS = {
    "text_image": {"target": "text_image", "params": {"in_dim": CTX, "out_dim": CTX}},
    "keypoint": {"target": "keypoint", "params": {"max_persons_per_image": 8, "out_dim": CTX}},
}


def tokenizer_inputs(rng, name, b, n=30, dim=CTX, persons=8):
    """The inputs of the ``text_image`` or ``keypoint`` tokenizer: mixed
    box, text and image masks; keypoints with some invisible (0, 0)."""
    if name == "keypoint":
        points = rng.random((b, persons * 17, 2)).astype(np.float32)
        masks = (rng.random((b, persons * 17)) > 0.3).astype(np.float32)
        return {"points": points * masks[..., None], "masks": masks}
    masks = (rng.random((b, n)) > 0.3).astype(np.float32)
    return {
        "boxes": rng.random((b, n, 4)).astype(np.float32),
        "masks": masks,
        "text_masks": masks * (rng.random((b, n)) > 0.4),
        "image_masks": masks * (rng.random((b, n)) > 0.4),
        "text_embeddings": rand(rng, b, n, dim),
        "image_embeddings": rand(rng, b, n, dim),
    }


@pytest.mark.parametrize("tokenizer", sorted(TOKENIZERS))
def test_generate_matches_jax_pipeline_for_each_tokenizer(tokenizer):
    """The box+text+image and keypoint UNets through generate, with the
    alpha stages, against the JAX pipeline."""
    grounding = tokenizer_inputs(np.random.default_rng(11), tokenizer, 2)
    compare_pipelines(dict(UNET, grounding_tokenizer=TOKENIZERS[tokenizer]), grounding)
