"""Reference checkpoints into the port (convert/from_reference.py,
training/checkpoints.py, inference/cli.py) against the JAX package's
converter and loader, on the CPU at a small width, with no download.

The JAX converter is the oracle for the key map: the port's inverse map
(tools/reference_ckpt.py) writes reference-keyed state dicts from a JAX
parameter tree (carried by the bridge), and JAX's ``convert_unet``,
``convert_vae`` and ``convert_clip_text`` must give that tree back exactly;
the port's loader must then give what ``from_jax`` gives for the JAX
conversion, bit for bit (an inpaint UNet has no ``first_conv_sd`` in the
port, where the JAX converter adds one its model ignores).  Also: the
``ema`` overlay, ``config_dict["_content"]``, the SD first-conv fill both
ways, the official SD split, a ``torch.save`` round trip, the schedule
from the config (F3), the registry's reference aliases and the widened
first conv.  Every comparison is exact: the maps move and reshape
tensors, they compute nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from gligen_tpu.convert import torch_to_jax as jconv
from gligen_tpu.convert.widen import add_additional_channels as jax_widen
from gligen_tpu.diffusion import schedule as jsch
from gligen_tpu.inference.pipeline import GligenComponents as JaxComponents
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE

from gligen_tpu_torch.convert import from_reference as conv
from gligen_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from gligen_tpu_torch.convert.widen import add_additional_channels
from gligen_tpu_torch.diffusion import schedule as tsch
from gligen_tpu_torch.inference.cli import components_from_checkpoint
from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.models.unet import UNetModel
from gligen_tpu_torch.tools import reference_ckpt as ref
from gligen_tpu_torch.training import checkpoints as ckpts

from test_torch_modules import CLIP, CTX, LATENT, UNET, VAE, grounding_inputs, random_params
from test_torch_pipeline import tokenizer_inputs

torch.set_num_threads(1)

SCHED = dict(timesteps=1000, linear_start=0.001, linear_end=0.015)  # not the default


def jax_trees(inpaint, unet_config=UNET, grounding=None, latent=LATENT, grounding_extra=None):
    """Random JAX parameter trees of a small UNet (generation or inpaint;
    ``unet_config`` with the tokenizer whose inputs are ``grounding`` and
    the downsampler whose map is ``grounding_extra``, at ``latent``^2), VAE
    and text encoder."""
    grounding = grounding or grounding_inputs(np.random.default_rng(0), 1)
    g = {k: jnp.asarray(v[:1]) for k, v in grounding.items()}
    unet = JaxUNet(**unet_config, inpaint_mode=inpaint, use_checkpoint=False)
    extra = jnp.zeros((1, latent, latent, 5)) if inpaint else None
    ds_map = None if grounding_extra is None else jnp.asarray(grounding_extra[:1])
    return {
        "model": random_params(unet, jnp.zeros((1, latent, latent, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 77, CTX)), g, inpainting_extra=extra,
                               grounding_extra=ds_map, seed=1),
        "autoencoder": random_params(JaxVAE(**VAE), jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
                                     jax.random.PRNGKey(0), seed=2),
        "text_encoder": random_params(JaxCLIP(**CLIP), jnp.zeros((1, 77), jnp.int32), seed=3),
    }


def flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in traverse_util.flatten_dict(tree).items()}


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), (sorted(set(want) - set(got))[:5],
                                   sorted(set(got) - set(want))[:5])
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_state_equal(got, want):
    assert set(got) == set(want), (sorted(set(want) - set(got))[:5],
                                   sorted(set(got) - set(want))[:5])
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


def reference_dicts(trees):
    """The reference-keyed state dicts of JAX trees, through the port: the
    bridge, then the inverse map."""
    model, sd_conv = ref.unet_to_reference(state_dict_from_jax(trees["model"]))
    return dict(model=model, sd_conv=sd_conv,
                autoencoder=ref.vae_to_reference(state_dict_from_jax(trees["autoencoder"])),
                text_encoder=ref.clip_to_reference(state_dict_from_jax(trees["text_encoder"])))


@pytest.fixture(scope="module", params=[False, True], ids=["generation", "inpaint"])
def case(request):
    trees = jax_trees(request.param)
    return request.param, trees, reference_dicts(trees)


def test_inverse_map_feeds_the_jax_converters(case):
    """The JAX converters take the inverse map's reference dicts back to
    the JAX trees exactly; for the generation UNet the SD conv file fills
    ``first_conv_sd``, and for the inpaint UNet (which has none) the JAX
    converter's own fill is its only extra leaf."""
    inpaint, trees, refs = case
    assert (refs["sd_conv"] is None) == inpaint
    got = jconv.convert_unet(refs["model"], sd_first_conv=refs["sd_conv"])
    if inpaint:
        assert set(got.pop("first_conv_sd")) == {"kernel", "bias"}
    assert_trees_equal(got, trees["model"])
    assert_trees_equal(jconv.convert_vae(refs["autoencoder"]), trees["autoencoder"])
    assert_trees_equal(jconv.convert_clip_text(refs["text_encoder"]), trees["text_encoder"])
    # the reference's layouts: 1x1 convs (O, I, 1, 1), to_out.0, VAE levels, CLIP prefixes
    assert refs["model"]["input_blocks.1.1.proj_in.weight"].dim() == 4
    assert "input_blocks.1.1.transformer_blocks.0.attn1.to_out.0.weight" in refs["model"]
    assert refs["autoencoder"]["encoder.mid.attn_1.q.weight"].dim() == 4
    assert "decoder.up.1.block.0.conv1.weight" in refs["autoencoder"]
    assert "text_model.encoder.layers.0.mlp.fc1.weight" in refs["text_encoder"]


def test_loader_matches_from_jax_of_the_jax_conversion(case):
    """The port's converters give, bit for bit, the bridge's state dicts of
    the JAX conversion; an inpaint UNet's has no first_conv_sd on either
    side of the strict load."""
    inpaint, _, refs = case
    sd = None if inpaint else refs["sd_conv"]
    jax_unet = jconv.convert_unet(refs["model"], sd_first_conv=sd)
    if inpaint:
        del jax_unet["first_conv_sd"]  # the JAX inpaint model ignores it
    got = conv.convert_unet(refs["model"], sd_first_conv=sd, restorable=not inpaint)
    assert_state_equal(got, state_dict_from_jax(jax_unet))
    assert_state_equal(conv.convert_vae(refs["autoencoder"]),
                       state_dict_from_jax(jconv.convert_vae(refs["autoencoder"])))
    assert_state_equal(conv.convert_clip_text(refs["text_encoder"]),
                       state_dict_from_jax(jconv.convert_clip_text(refs["text_encoder"])))
    UNetModel(**UNET, inpaint_mode=inpaint).load_state_dict(got, strict=True)


def test_inpaint_unet_loads_from_jax_strictly():
    """from_jax: an inpaint UNet's tree has no first_conv_sd, nor has the
    port's inpaint UNet; the 9-channel GLIGEN conv loads as it is."""
    trees = jax_trees(True)
    assert "first_conv_sd" not in trees["model"]
    comps = GligenComponents.create(unet_config=dict(UNET, inpaint_mode=True), vae_config=VAE,
                                    text_config=CLIP, dtype=torch.float32, device="cpu")
    load_jax_params(comps, trees)
    assert not hasattr(comps.unet, "first_conv_sd") and not comps.unet.first_conv_restorable
    assert tuple(comps.unet.input_blocks_0_0.weight.shape[:2]) == (UNET["model_channels"], 9)
    wide = trees["model"]["input_blocks_0_0"]["kernel"]
    np.testing.assert_array_equal(comps.unet.input_blocks_0_0.weight.detach().numpy(),
                                  np.asarray(wide).transpose(3, 2, 0, 1))


def reference_checkpoint(inpaint, ema_gate=0.25, unet_config=UNET):
    """A reference-format checkpoint dict of small port components."""
    unet_config = dict(unet_config, inpaint_mode=inpaint)
    comps = GligenComponents.create(unet_config=unet_config, vae_config=VAE, text_config=CLIP,
                                    dtype=torch.float32, seed=5, device="cpu",
                                    schedule_config=SCHED)
    ckpt, sd_conv = ref.reference_checkpoint(comps, unet_config, SCHED, ema_gate=ema_gate)
    return comps, ckpt, sd_conv


@pytest.mark.parametrize("inpaint", [False, True])
@pytest.mark.parametrize("use_ema", [False, True])
def test_components_from_checkpoint(inpaint, use_ema):
    """Every loaded tensor equals its source, the fuser gates the EMA's
    when ``use_ema``; the architecture and schedule are the config's."""
    src, ckpt, sd_conv = reference_checkpoint(inpaint)
    comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, use_ema=use_ema,
                                       dtype=torch.float32, device="cpu", text_config=CLIP)
    assert comps.unet.inpaint_mode == inpaint
    np.testing.assert_array_equal(comps.schedule.alphas_cumprod, src.schedule.alphas_cumprod)
    want = src.unet.state_dict()
    gates = 0
    for name, got in comps.unet.state_dict().items():
        if use_ema and name.endswith(("alpha_attn", "alpha_dense")):
            gates += 1
            assert torch.equal(got, torch.full_like(got, 0.25)), name
        else:
            assert torch.equal(got, want[name]), name
    assert gates == (14 if use_ema else 0)  # 7 fusers' alpha_attn and alpha_dense
    for a, b in ((src.vae, comps.vae), (src.text_encoder, comps.text_encoder)):
        assert_state_equal(b.state_dict(), a.state_dict())


def test_ema_overlay_needs_an_ema_entry():
    _, ckpt, _ = reference_checkpoint(False)
    del ckpt["ema"]
    with pytest.raises(ValueError, match="no 'ema' entry"):
        ckpts.gligen_state_dicts(ckpt, use_ema=True)
    ckpts.gligen_state_dicts(ckpt, use_ema=False)


def test_config_content_extraction():
    _, ckpt, _ = reference_checkpoint(True)
    content = ckpt["config_dict"]["_content"]
    assert ckpts.gligen_state_dicts(ckpt)[1] == content
    ckpt["config_dict"] = content  # a plain dict is taken as it is
    assert ckpts.checkpoint_config(ckpt) == content
    assert ckpts.checkpoint_config({}) == {}


def test_sd_first_conv_fill_both_ways():
    """From the SD conv file when given, else the GLIGEN conv's first 4
    input channels, as the JAX converter fills it."""
    g = torch.Generator().manual_seed(0)
    state = {"input_blocks.0.0.weight": torch.randn((8, 9, 3, 3), generator=g),
             "input_blocks.0.0.bias": torch.randn((8,), generator=g)}
    sd = {"weight": torch.randn((8, 4, 3, 3), generator=g), "bias": torch.randn((8,), generator=g)}
    for sd_conv in (sd, None):
        got = conv.convert_unet(state, sd_first_conv=sd_conv)
        want = state_dict_from_jax(jconv.convert_unet(state, sd_first_conv=sd_conv))
        assert_state_equal(got, want)
    assert torch.equal(conv.convert_unet(state, sd)["first_conv_sd.weight"], sd["weight"])
    assert torch.equal(conv.convert_unet(state)["first_conv_sd.weight"],
                       state["input_blocks.0.0.weight"][:, :4])
    assert "first_conv_sd.weight" not in conv.convert_unet(state, sd, restorable=False)


def test_official_sd_split():
    state = {"model.diffusion_model.out.2.bias": torch.ones(4),
             "first_stage_model.quant_conv.bias": torch.ones(8),
             "cond_stage_model.transformer.text_model.final_layer_norm.bias": torch.ones(3),
             "model_ema.decay": torch.ones(())}
    got = conv.split_official_sd_ckpt(state)
    want = jconv.split_official_sd_ckpt(state)
    assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in want.items()}
    sds = ckpts.official_sd_state_dicts({"state_dict": state})
    assert set(sds["model"]) == {"out_2.bias"}
    assert set(sds["autoencoder"]) == {"quant_conv.bias"}
    assert set(sds["text_encoder"]) == {"final_layer_norm.bias"}


def test_torch_save_round_trip(tmp_path):
    """A ``torch.save``d checkpoint and SD conv file load as the in-memory
    dicts do."""
    _, ckpt, sd_conv = reference_checkpoint(False)
    path, conv_path = tmp_path / "checkpoint_generation_text.pth", tmp_path / "sd_conv.pth"
    torch.save(ckpt, path)
    torch.save(sd_conv, conv_path)
    got, config = ckpts.load_gligen_torch_checkpoint(str(path), str(conv_path), use_ema=True)
    want, want_config = ckpts.gligen_state_dicts(ckpt, sd_first_conv=sd_conv, use_ema=True)
    assert config == want_config
    for key in want:
        assert_state_equal(got[key], want[key])
    # a missing SD conv file falls back to the GLIGEN conv's first channels
    got, _ = ckpts.load_gligen_torch_checkpoint(str(path), str(tmp_path / "absent.pth"))
    assert torch.equal(got["model"]["first_conv_sd.weight"],
                       got["model"]["input_blocks_0_0.weight"][:, :4])
    torch.save({"state_dict": {"first_stage_model.quant_conv.bias": torch.ones(8)}},
               tmp_path / "sd.ckpt")
    sds = ckpts.load_official_sd_checkpoint(str(tmp_path / "sd.ckpt"))
    assert torch.equal(sds["autoencoder"]["quant_conv.bias"], torch.ones(8))


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_match_jax(kind):
    """F3: every beta schedule's tables equal the JAX package's."""
    kw = dict(beta_schedule=kind, timesteps=500, linear_start=2e-4, linear_end=3e-2,
              cosine_s=1e-2)
    np.testing.assert_array_equal(tsch.make_beta_schedule(kind, 500, 2e-4, 3e-2, 1e-2),
                                  jsch.make_beta_schedule(kind, 500, 2e-4, 3e-2, 1e-2))
    got, want = tsch.DiffusionSchedule.create(**kw), jsch.DiffusionSchedule.create(**kw)
    for field in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                  "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)), field)
    with pytest.raises(ValueError, match="unknown"):
        tsch.make_beta_schedule("quad")


def test_schedule_from_the_checkpoint_config():
    """F3: a checkpoint whose config says linear_start 0.001, linear_end
    0.015 gives the alphas_cumprod of the JAX components built from it."""
    _, ckpt, sd_conv = reference_checkpoint(False)
    comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, dtype=torch.float32,
                                       device="cpu", text_config=CLIP)
    diffusion = ckpt["config_dict"]["_content"]["diffusion"]["params"]
    want = JaxComponents.create(
        unet_config=dict(UNET), schedule_config={k: v for k, v in diffusion.items()
                                                 if k in ("timesteps", "linear_start",
                                                          "linear_end")}).schedule
    np.testing.assert_array_equal(comps.schedule.alphas_cumprod, np.asarray(want.alphas_cumprod))
    default = GligenComponents.create(unet_config=UNET, vae_config=VAE, text_config=CLIP,
                                      dtype=torch.float32, device="cpu").schedule
    assert not np.array_equal(comps.schedule.alphas_cumprod, default.alphas_cumprod)


def test_registry_takes_the_reference_aliases():
    """The released configs name the tokenizer and the downsampler by the
    reference's dotted path: every tokenizer (text, text_image, keypoint
    and the five spatial ones) and every downsampler builds under its short
    name and under its dotted one, the same class."""
    prefix = "ldm.modules.diffusionmodules"
    tokenizers = {
        "text": ("TextPositionNet", {"in_dim": CTX, "out_dim": CTX}),
        "text_image": ("TextImagePositionNet", {"in_dim": CTX, "out_dim": CTX}),
        "keypoint": ("KeypointPositionNet", {"out_dim": CTX}),
        "hed": ("HedPositionNet", {"resize_input": 64, "out_dim": CTX}),
        "canny": ("CannyPositionNet", {"resize_input": 64, "out_dim": CTX}),
        "depth": ("DepthPositionNet", {"resize_input": 64, "out_dim": CTX}),
        "normal": ("NormalPositionNet", {"resize_input": 64, "out_dim": CTX}),
        "sem": ("SemPositionNet", {"resize_input": 64, "in_dim": 152, "out_dim": CTX}),
    }
    for name, (net, params) in tokenizers.items():
        for target in (name, f"{prefix}.{name}_grounding_net.PositionNet"):
            unet = UNetModel(**dict(UNET, grounding_tokenizer={"target": target,
                                                               "params": params}))
            assert type(unet.position_net).__name__ == net, target
            assert unet.downsample_net is None
    downsamplers = {"hed": ("HedDownsampler", {"out_dim": 1}, 1),
                    "canny": ("CannyDownsampler", {"resize_input": 256, "out_dim": 8}, 8),
                    "depth": ("DepthDownsampler", {"resize_input": 256, "out_dim": 8}, 8),
                    "normal": ("NormalDownsampler", {"resize_input": 256, "out_dim": 8}, 8),
                    "sem": ("SemDownsampler", {"resize_input": 256, "in_dim": 152,
                                               "out_dim": 8}, 8)}
    for name, (net, params, width) in downsamplers.items():
        for target in (name, f"{prefix}.{name}_grounding_downsampler.GroundingDownsampler"):
            unet = UNetModel(**UNET, grounding_downsampler={"target": target, "params": params})
            assert type(unet.downsample_net).__name__ == net, target
            assert unet.input_blocks_0_0.weight.shape[1] == 4 + width
            assert unet.first_conv_sd.weight.shape[1] == 4
    with pytest.raises(KeyError, match="unknown target"):
        UNetModel(**UNET, grounding_downsampler={"target": "seg", "params": {}})


def test_widen_matches_jax():
    """add_additional_channels widens axis 1 of OIHW as JAX widens axis 2
    of HWIO, zeros for the new channels."""
    trees = jax_trees(False)
    want = jax_widen(trees["model"], 5)["input_blocks_0_0"]["kernel"]
    state = state_dict_from_jax(trees["model"])
    got = add_additional_channels(state, 5)
    np.testing.assert_array_equal(got["input_blocks_0_0.weight"].numpy(),
                                  np.asarray(want).transpose(3, 2, 0, 1))
    assert got["out_2.weight"] is state["out_2.weight"]
    assert add_additional_channels(state, 0) is state


# the small UNet with each other tokenizer, under its reference name
DOTTED_TOKENIZERS = {
    "text_image": {"target": "ldm.modules.diffusionmodules.text_image_grounding_net.PositionNet",
                   "params": {"in_dim": CTX, "out_dim": CTX}},
    "keypoint": {"target": "ldm.modules.diffusionmodules.keypoint_grounding_net.PositionNet",
                 "params": {"max_persons_per_image": 8, "out_dim": CTX}},
}


@pytest.mark.parametrize("tokenizer", sorted(DOTTED_TOKENIZERS))
def test_tokenizer_checkpoints_load_strictly(tokenizer):
    """A text_image or keypoint UNet: the inverse map's reference dict
    (``linears_text.0``, ``person_embeddings``...) goes back to the JAX
    tree through the JAX converter exactly, the port's converter gives the
    bridge's state dict of that conversion bit for bit and loads strictly;
    a reference-format checkpoint whose config names the tokenizer by its
    reference alias loads into components equal to their source."""
    config = dict(UNET, grounding_tokenizer=DOTTED_TOKENIZERS[tokenizer])
    trees = jax_trees(False, config, tokenizer_inputs(np.random.default_rng(0), tokenizer, 1))
    refs = reference_dicts(trees)
    keys = {"text_image": ("position_net.linears_text.0.weight",
                           "position_net.linears_image.4.bias",
                           "position_net.null_image_feature"),
            "keypoint": ("position_net.linears.2.weight", "position_net.person_embeddings",
                         "position_net.null_xy_feature")}[tokenizer]
    assert set(keys) <= set(refs["model"])
    assert_trees_equal(jconv.convert_unet(refs["model"], sd_first_conv=refs["sd_conv"]),
                       trees["model"])
    got = conv.convert_unet(refs["model"], sd_first_conv=refs["sd_conv"])
    assert_state_equal(got, state_dict_from_jax(
        jconv.convert_unet(refs["model"], sd_first_conv=refs["sd_conv"])))
    UNetModel(**config).load_state_dict(got, strict=True)

    src, ckpt, sd_conv = reference_checkpoint(False, unet_config=config)
    assert ckpt["config_dict"]["_content"]["model"]["params"]["grounding_tokenizer"][
        "target"] == DOTTED_TOKENIZERS[tokenizer]["target"]
    comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, dtype=torch.float32,
                                       device="cpu", text_config=CLIP)
    assert type(comps.unet.position_net) is type(src.unet.position_net)
    for a, b in ((src.unet, comps.unet), (src.vae, comps.vae),
                 (src.text_encoder, comps.text_encoder)):
        assert_state_equal(b.state_dict(), a.state_dict())
