"""The weight bridge (gligen_tpu_torch/convert/from_jax.py): every leaf of
each gligen_tpu parameter tree lands in the port's state dict, in the
torch layout, under a strict load; a subtree the port does not have would
be skipped by name, never silently, and none is now."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE

from gligen_tpu_torch.convert.from_jax import SKIPPED, load_jax_params, state_dict_from_jax
from gligen_tpu_torch.inference.pipeline import GligenComponents

from test_torch_modules import CLIP, CTX, LATENT, UNET, VAE, grounding_inputs, random_params


@pytest.fixture(scope="module")
def trees():
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    return {
        "model": random_params(
            JaxUNet(**UNET, use_checkpoint=False), jnp.zeros((1, LATENT, LATENT, 4)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, CTX)), g,
        ),
        "autoencoder": random_params(
            JaxVAE(**VAE), jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)), jax.random.PRNGKey(1)
        ),
        "text_encoder": random_params(JaxCLIP(**CLIP), jnp.zeros((1, 77), jnp.int32)),
    }


@pytest.fixture(scope="module")
def comps():
    return GligenComponents.create(unet_config=UNET, dtype=torch.float32, vae_config=VAE,
                                   text_config=CLIP, device="cpu")


def _modules(c):
    return {"model": c.unet, "autoencoder": c.vae, "text_encoder": c.text_encoder}


@pytest.mark.parametrize("component", ["model", "autoencoder", "text_encoder"])
def test_bridge_covers_every_leaf(trees, comps, component):
    flat = traverse_util.flatten_dict(trees[component], sep=".")
    kept = [k for k in flat if k.split(".")[0] not in SKIPPED[component]]
    sd = state_dict_from_jax(trees[component], SKIPPED[component])
    assert len(sd) == len(kept)
    module = _modules(comps)[component]
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd, strict=True)
    if component == "model":
        assert "first_conv_sd.weight" in sd
    if component == "autoencoder":  # the encoder side is carried too: nothing is skipped
        assert kept == list(flat)
        assert {k.split(".")[0] for k in flat} == {"encoder", "quant_conv", "decoder",
                                                   "post_quant_conv"}


def test_bridge_layouts(trees):
    unet = trees["model"]
    sd = state_dict_from_jax(unet)
    dense = np.asarray(unet["time_embed_0"]["kernel"])  # (I, O)
    np.testing.assert_array_equal(sd["time_embed_0.weight"].numpy(), dense.T)
    conv = np.asarray(unet["first_conv_sd"]["kernel"])  # HWIO
    np.testing.assert_array_equal(sd["first_conv_sd.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    norm = np.asarray(unet["out_0"]["scale"])
    np.testing.assert_array_equal(sd["out_0.weight"].numpy(), norm)
    alpha = sd["input_blocks_1_1.transformer_blocks_0.fuser.alpha_attn"]
    assert alpha.shape == ()
    emb = np.asarray(trees["text_encoder"]["token_embedding"]["embedding"])
    np.testing.assert_array_equal(state_dict_from_jax(trees["text_encoder"])
                                  ["token_embedding.weight"].numpy(), emb)


def test_strict_load_refuses_unmapped_or_missing_leaves(trees, comps):
    sd = state_dict_from_jax(trees["autoencoder"])
    sd["encoder.unmapped.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        comps.vae.load_state_dict(sd, strict=True)
    sd = state_dict_from_jax(trees["model"])
    del sd["first_conv_sd.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        comps.unet.load_state_dict(sd, strict=True)


def test_load_jax_params_into_components(trees, comps):
    load_jax_params(comps, trees)
    got = comps.unet.input_blocks_1_0.in_layers_2.weight.detach().numpy()
    want = np.asarray(trees["model"]["input_blocks_1_0"]["in_layers_2"]["kernel"])
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))
