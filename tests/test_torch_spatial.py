"""The spatial grounding modalities (hed, canny, depth, normal, sem) of the
port against the JAX package, on the CPU in fp32: ConvNeXt-tiny,
``prepare_spatial_map``, the five position nets and downsamplers, the
widened UNet (the raw map, precomputed features, the SD first conv),
``generate`` with PLMS and alpha stages and with DDIM, a strict
reference-format checkpoint load of each config (the JAX converter as the
oracle), the input adapters and their null batch, the CLI's batch
preparation on ``inference_images/``, the registries' names and
``chip_smoke.py``'s literal configs against ``configs/*.yaml``.

The weights are ``random_params``': no zero leaf, ConvNeXt's layer scales
in [0.3, 0.8] (1e-6 at init, where a wrong block would not show).  The
tiny UNet's latent is 64^2, since the hed downsampler always gives 64^2
channels; it attends only at its inner level (32^2 tokens).

Tolerances: every module's output within 1e-4 of its largest JAX
magnitude (fp32 on both sides, sums in another order); the pipelines at
``compare_pipelines``' atol 1e-4; label maps, batches, null inputs,
checkpoint tensors and names exactly.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gligen_tpu.convert import torch_to_jax as jconv
from gligen_tpu.inference import adapters as jad
from gligen_tpu.inference import cli as jcli
from gligen_tpu.models.grounding import downsamplers as jds
from gligen_tpu.models.grounding import spatial as jsp
from gligen_tpu.models.grounding.convnext import convnext_tiny as jax_convnext_tiny
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.utils.registry import DOWNSAMPLERS as JAX_DOWNSAMPLERS
from gligen_tpu.utils.registry import GROUNDING_NETS as JAX_NETS
from gligen_tpu.utils.registry import INPUT_ADAPTERS as JAX_ADAPTERS

from gligen_tpu_torch.convert import from_reference as conv
from gligen_tpu_torch.convert.from_jax import state_dict_from_jax
from gligen_tpu_torch.inference import adapters, cli
from gligen_tpu_torch.inference.cli import components_from_checkpoint
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.models.grounding import spatial as tsp
from gligen_tpu_torch.models.grounding.convnext import convnext_tiny
from gligen_tpu_torch.models.unet import UNetModel
from gligen_tpu_torch.utils.registry import DOWNSAMPLERS, GROUNDING_NETS, INPUT_ADAPTERS

from test_torch_checkpoints import (assert_state_equal, assert_trees_equal, jax_trees,
                                    reference_checkpoint, reference_dicts)
from test_torch_modules import CLIP, CTX, jax_apply, port, rand, random_params, t
from test_torch_pipeline import compare_pipelines

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

REL = 1e-4
MODALITIES = ("hed", "canny", "depth", "normal", "sem")
MAP_KEY = {"hed": "hed_edge", "canny": "canny_edge", "depth": "depth", "normal": "normal",
           "sem": "sem"}
CONFIG_FILE = {"hed": "cc3m_hed.yaml", "canny": "cc3m_canny.yaml", "depth": "cc3m_depth.yaml",
               "normal": "diode_normal.yaml", "sem": "ade_sem.yaml"}
CLASSES = 152
LATENT = 64  # the hed downsampler's fixed 64^2
MAP = 128  # the maps' side: each net resizes it (up and down)
TOKENIZER = {m: {"target": m, "params": dict({"resize_input": 64, "out_dim": CTX},
                                             **({"in_dim": CLASSES} if m == "sem" else {}))}
             for m in MODALITIES}
DOWNSAMPLER = {m: {"target": m, "params": {} if m == "hed" else dict(
    {"resize_input": 256, "out_dim": 8}, **({"in_dim": CLASSES} if m == "sem" else {}))}
    for m in MODALITIES}


def spatial_unet(modality):
    """The tiny UNet of ``modality``: the test UNet's widths, attention at
    its inner level only."""
    return dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
                attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, context_dim=CTX,
                grounding_tokenizer=TOKENIZER[modality],
                grounding_downsampler=DOWNSAMPLER[modality])


def spatial_map(rng, modality, b=2, size=MAP):
    """A seeded uint8 map: sem's labels (B, H, W) in [0, 152); the others'
    RGB pixels (B, H, W, 3), each channel its own (a net that reads the
    wrong channel shows)."""
    if modality == "sem":
        return rng.integers(0, CLASSES, size=(b, size, size)).astype(np.uint8)
    return rng.integers(0, 256, size=(b, size, size, 3)).astype(np.uint8)


def spatial_inputs(rng, modality, mask=(1.0, 0.0)):
    """(tokenizer inputs, the downsampler's map): the same map for both."""
    m = spatial_map(rng, modality, b=len(mask))
    return {MAP_KEY[modality]: m, "mask": np.asarray(mask, np.float32)}, m


def close_rel(got, want, rel=REL):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * scale, rtol=0)


def test_convnext_tiny_matches_jax():
    x = rand(np.random.default_rng(0), 2, 64, 64, 3)
    jm = jax_convnext_tiny()
    params = random_params(jm, jnp.asarray(x))
    want = jax_apply(jm, params, jnp.asarray(x))
    with torch.no_grad():
        got = port(convnext_tiny(), params)(t(x))
    assert tuple(got.shape) == (2, 2, 2, 768)
    close_rel(got, want)


@pytest.mark.parametrize("kind, size, mode", [
    ("pixels", 448, "nearest"), ("pixels", 256, "bicubic"), ("pixels", 64, "bicubic"),
    ("pixels", 64, "nearest"), ("labels", 256, "nearest"), ("labels", 64, "nearest"),
    ("labels_nhw1", 64, "nearest"), ("float", 64, "bicubic"), ("float", 448, "nearest"),
])
def test_prepare_spatial_map_matches_jax(kind, size, mode):
    """uint8 pixels up and down in both modes; uint8 labels (one of them 152
    and one 255, out of range: a zero row, as jax.nn.one_hot gives) by
    nearest taps, also as (B, H, W, 1); floats passed through the resize."""
    rng = np.random.default_rng(1)
    classes = 0
    if kind.startswith("labels"):
        x = rng.integers(0, CLASSES, size=(2, 40, 56)).astype(np.uint8)
        x[0, 0, 0], x[1, 39, 55] = CLASSES, 255
        x = x[..., None] if kind == "labels_nhw1" else x
        classes = CLASSES
    elif kind == "pixels":
        x = rng.integers(0, 256, size=(2, 40, 56, 3)).astype(np.uint8)
    else:
        x = rand(rng, 2, 40, 56, 3)
    want = np.asarray(jsp.prepare_spatial_map(jnp.asarray(x), size, mode, num_classes=classes))
    got = tsp.prepare_spatial_map(t(x), size, mode, num_classes=classes)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if classes:
        np.testing.assert_array_equal(got.numpy(), want)
        # out of range: zero rows, at every tap of the two pixels (nearest
        # taps src = floor(i * n_in / n_out) repeat a pixel when upsampling)
        zero = got.sum(-1) == 0
        taps = lambda n_in, src: int((np.arange(size) * n_in // size == src).sum())
        assert zero[0, 0, 0] and zero[1, -1, -1]
        assert int(zero.sum()) == taps(40, 0) * taps(56, 0) + taps(40, 39) * taps(56, 55)
        assert bool((got.sum(-1) <= 1).all())
    else:
        close_rel(got, want)


JAX_NET = {"hed": jsp.HedPositionNet, "canny": jsp.CannyPositionNet,
           "depth": jsp.DepthPositionNet, "normal": jsp.NormalPositionNet,
           "sem": jsp.SemPositionNet}


@pytest.mark.parametrize("modality", MODALITIES)
def test_position_net_matches_jax(modality):
    """resize_input 64 (4 tokens) from a 128^2 map; the second sample's
    mask is 0, so its tokens are the null feature's."""
    g, _ = spatial_inputs(np.random.default_rng(2), modality)
    params_kw = TOKENIZER[modality]["params"]
    jm = JAX_NET[modality](**params_kw)
    args = [jnp.asarray(g[MAP_KEY[modality]]), jnp.asarray(g["mask"])]
    params = random_params(jm, *args)
    want = jax_apply(jm, params, *args)
    net = port(GROUNDING_NETS.get(modality)(**params_kw), params)
    with torch.no_grad():
        got = net(**{k: t(v) for k, v in g.items()})
        null = net(**{k: t(v) for k, v in adapters.null_input(g).items()})
    assert tuple(got.shape) == (2, 4, CTX)
    close_rel(got, want)
    # behind mask 0 the map is not read: the zeroed map gives the same tokens
    assert torch.equal(null[1], got[1]) and not torch.allclose(null[0], got[0])


JAX_DS = {"hed": jds.HedDownsampler, "canny": jds.CannyDownsampler,
          "depth": jds.DepthDownsampler, "normal": jds.NormalDownsampler,
          "sem": jds.SemDownsampler}


@pytest.mark.parametrize("modality", MODALITIES)
def test_downsampler_matches_jax(modality):
    _, m = spatial_inputs(np.random.default_rng(3), modality)
    params_kw = DOWNSAMPLER[modality]["params"]
    jm = JAX_DS[modality](**params_kw)
    net = DOWNSAMPLERS.get(modality)(**params_kw).eval()
    if modality == "hed":  # no parameters
        want = jm.apply({}, jnp.asarray(m))
    else:
        params = random_params(jm, jnp.asarray(m))
        want = jax_apply(jm, params, jnp.asarray(m))
        port(net, params)
    with torch.no_grad():
        got = net(t(m))
    assert tuple(got.shape) == (2, 64, 64, net.out_dim)
    close_rel(got, want)


@pytest.fixture(scope="module")
def unets():
    """modality -> (the JAX UNet, its random parameters, the port's UNet
    with them), built once each."""
    built = {}

    def get(modality):
        if modality not in built:
            g, m = spatial_inputs(np.random.default_rng(4), modality, mask=(1.0,))
            model = JaxUNet(**spatial_unet(modality), use_checkpoint=False)
            params = random_params(
                model, jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, 77, CTX)), {k: jnp.asarray(v) for k, v in g.items()},
                grounding_extra=jnp.asarray(m), seed=5)
            built[modality] = model, params, port(UNetModel(**spatial_unet(modality)), params)
        return built[modality]

    return get


@pytest.mark.parametrize("how", ["map", "features", "sd_conv"])
@pytest.mark.parametrize("modality", ["hed", "sem"])
def test_spatial_unet_matches_jax(unets, modality, how):
    """The widened first conv fed by the port's ``downsampler_features`` of
    the map (against the JAX UNet given the raw map), by the JAX
    ``tokens_only`` features themselves (the UNet body alone), and the SD
    first conv, which reads no downsampler channel (the JAX UNet computes
    both convs and selects)."""
    model, params, unet = unets(modality)
    rng = np.random.default_rng(6)
    g, m = spatial_inputs(rng, modality, mask=(1.0, 0.0))
    x, ctx = rand(rng, 2, LATENT, LATENT, 4), rand(rng, 2, 77, CTX)
    ts = np.array([981, 401], np.int32)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jargs = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jg)
    want = jax_apply(model, params, *jargs, grounding_extra=jnp.asarray(m), gate_scale=0.6,
                     use_sd_conv=how == "sd_conv")
    tg = {k: t(v) for k, v in g.items()}
    with torch.no_grad():
        if how == "features":
            _, ds_j = jax_apply(model, params, *jargs, grounding_extra=jnp.asarray(m),
                                tokens_only=True)
            close_rel(unet.downsampler_features(t(m)), ds_j)
            got = unet(t(x), t(ts), t(ctx), tg, gate_scale=0.6,
                       grounding_extra_features=t(ds_j))
        elif how == "sd_conv":  # no map: the SD conv does not read one
            got = unet(t(x), t(ts), t(ctx), tg, gate_scale=0.6, use_sd_conv=True)
        else:
            got = unet(t(x), t(ts), t(ctx), tg, gate_scale=0.6,
                       grounding_extra_features=unet.downsampler_features(t(m)))
    close_rel(got, want)
    if how == "map":
        with pytest.raises(ValueError, match="grounding_extra_features"):
            unet(t(x), t(ts), t(ctx), tg)


@pytest.mark.parametrize("sampler", ["plms", "ddim"])
@pytest.mark.parametrize("modality", MODALITIES)
def test_generate_matches_jax_pipeline(modality, sampler):
    """The spatial UNet through generate: tokens and their null pair once,
    the downsampler's channels once from the conditional map, PLMS with
    the scenario's alpha stages (a fuser-free SD-conv tail) or DDIM with
    the gate at 1, CFG 7.5, VAE decode."""
    g, m = spatial_inputs(np.random.default_rng(7), modality, mask=(1.0, 1.0))
    alpha = chip_smoke.SPATIAL_ALPHA[modality] if sampler == "plms" else None
    compare_pipelines(spatial_unet(modality), g, alpha=alpha, sampler=sampler,
                      grounding_extra=m, latent=LATENT)


def test_generate_reads_the_map_once_and_never_nulls_it(monkeypatch):
    """The downsampler reads the conditional map once per request, and its
    channels serve both halves of the CFG pair; the tokenizer's null batch
    is the zeroed map with mask 0."""
    comps = GligenComponents.create(unet_config=spatial_unet("canny"), dtype=torch.float32,
                                    vae_config=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                                    resolution=2 * LATENT),
                                    text_config=CLIP, device="cpu")
    maps, tokens, features = [], [], comps.unet.downsampler_features
    monkeypatch.setattr(comps.unet, "downsampler_features",
                        lambda x: maps.append(x) or features(x))
    seen, grounding_tokens = [], comps.unet.grounding_tokens
    monkeypatch.setattr(comps.unet, "grounding_tokens",
                        lambda g: seen.append(g) or grounding_tokens(g))
    g, m = spatial_inputs(np.random.default_rng(8), "canny", mask=(1.0, 1.0))
    ids = np.ones((2, 77), np.int64)
    GenerationPipeline(comps).generate(ids, ids, g, steps=2, latent_size=LATENT,
                                       grounding_extra=m, alpha_stages=[0.5, 0.0, 0.5])
    assert len(maps) == 1 and np.array_equal(maps[0].numpy(), m)
    assert len(seen) == 2 and np.array_equal(seen[0]["canny_edge"].numpy(), m)
    assert not seen[1]["canny_edge"].any() and not seen[1]["mask"].any()
    assert seen[1]["canny_edge"].dtype == torch.uint8


@pytest.mark.parametrize("modality", MODALITIES)
def test_checkpoint_loads_strictly(modality):
    """The config's UNet with the tokenizer and the downsampler under their
    reference names: the inverse map's reference dict goes back to the JAX
    tree through the JAX converter exactly; the port's converter gives the
    bridge's state dict of that conversion bit for bit and loads strictly;
    a reference-format checkpoint loads into components equal to their
    source."""
    dotted = chip_smoke.SPATIAL_MODELS[modality]
    config = dict(spatial_unet(modality),
                  grounding_tokenizer=dict(TOKENIZER[modality],
                                           target=dotted["grounding_tokenizer"]["target"]),
                  grounding_downsampler=dict(DOWNSAMPLER[modality],
                                             target=dotted["grounding_downsampler"]["target"]))
    g, m = spatial_inputs(np.random.default_rng(9), modality, mask=(1.0,))
    trees = jax_trees(False, config, g, latent=LATENT, grounding_extra=m)
    refs = reference_dicts(trees)
    keys = ["position_net.convnext_tiny_backbone.stages.2.8.dwconv.weight",
            "position_net.convnext_tiny_backbone.stages.3.2.gamma",
            "position_net.convnext_tiny_backbone.downsample_layers.0.1.weight",
            "position_net.pos_embedding", "position_net.linears.4.bias"]
    keys += [] if modality == "hed" else ["downsample_net.layers.2.weight"]
    keys += ["position_net.in_conv.weight"] if modality == "sem" else []
    assert set(keys) <= set(refs["model"])
    assert refs["model"]["input_blocks.0.0.weight"].shape[1] == 4 + (1 if modality == "hed" else 8)
    assert_trees_equal(jconv.convert_unet(refs["model"], sd_first_conv=refs["sd_conv"]),
                       trees["model"])
    got = conv.convert_unet(refs["model"], sd_first_conv=refs["sd_conv"])
    assert_state_equal(got, state_dict_from_jax(
        jconv.convert_unet(refs["model"], sd_first_conv=refs["sd_conv"])))
    UNetModel(**config).load_state_dict(got, strict=True)

    src, ckpt, sd_conv = reference_checkpoint(False, unet_config=config)
    comps = components_from_checkpoint(ckpt, sd_first_conv=sd_conv, dtype=torch.float32,
                                       device="cpu", text_config=CLIP)
    assert type(comps.unet.position_net) is type(src.unet.position_net)
    assert type(comps.unet.downsample_net) is DOWNSAMPLERS.get(modality)
    for a, b in ((src.unet, comps.unet), (src.vae, comps.vae),
                 (src.text_encoder, comps.text_encoder)):
        assert_state_equal(b.state_dict(), a.state_dict())


@pytest.mark.parametrize("modality", MODALITIES)
def test_adapters_and_null_input_match_jax(modality):
    """Each adapter gives the JAX adapter's tokenizer inputs and
    downsampler map under both reference names; the null batch is the
    JAX pipeline's (a zeroed uint8 map, mask 0)."""
    batch, m = spatial_inputs(np.random.default_rng(10), modality, mask=(1.0, 1.0))
    names = [modality, f"grounding_input.{modality}_grounding_tokinzer_input.GroundingNetInput",
             f"grounding_input.{modality}_grounding_downsampler_input.GroundingDSInput"]
    for name in names:
        got, want = adapters.get_adapter(name), jad.get_adapter(name)
        assert got is adapters.get_adapter(modality)
        prepared, want_prepared = got.prepare(batch), want.prepare(batch)
        assert sorted(prepared) == sorted(want_prepared)
        for k in want_prepared:
            np.testing.assert_array_equal(prepared[k].numpy(), np.asarray(want_prepared[k]))
        np.testing.assert_array_equal(got.prepare_extra(batch).numpy(),
                                      np.asarray(want.prepare_extra(batch)))
        assert got.prepare_extra(batch).dtype == torch.uint8
    null = adapters.null_input(prepared)
    for k, v in prepared.items():
        assert null[k].dtype == v.dtype and null[k].shape == v.shape and not null[k].any(), k
    assert adapters.get_adapter("text").prepare_extra({}) is None


META_KEY = {"hed": "hed_image", "canny": "canny_image", "depth": "depth", "normal": "normal",
            "sem": "sem"}


@pytest.mark.parametrize("modality", MODALITIES)
def test_prepare_batch_matches_jax(modality):
    """``prepare_batch_for`` on the reference's scenario image (a path,
    read with PIL) against the JAX CLI's; the same map given as an array."""
    path = str(REPO / "inference_images" / f"{modality}.png")
    meta = {"ckpt": f"checkpoint_generation_{modality}.pth", META_KEY[modality]: path}
    want, got = jcli.prepare_batch_for(meta, 2, None), cli.prepare_batch_for(meta, 2)
    assert sorted(got) == sorted(want) == sorted([MAP_KEY[modality], "mask"])
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    arr = got[MAP_KEY[modality]][0]
    again = cli.prepare_batch_for(dict(meta, **{META_KEY[modality]: arr}), 2)
    np.testing.assert_array_equal(again[MAP_KEY[modality]], got[MAP_KEY[modality]])


def test_prepare_batch_refusals():
    """A sem label of num_classes or more is a ValueError (the JAX CLI has
    a bare assert); a map array must be uint8 at 512^2."""
    sem = np.zeros((512, 512), np.uint8)
    sem[3, 4] = CLASSES
    with pytest.raises(ValueError, match="num_classes"):
        cli.prepare_batch_sem({"sem": sem}, 1)
    sem[3, 4] = CLASSES - 1
    assert cli.prepare_batch_sem({"sem": sem}, 1)["sem"].max() == CLASSES - 1
    with pytest.raises(ValueError, match="uint8"):
        cli.prepare_batch_spatial({"hed_image": np.zeros((256, 256, 3), np.uint8)}, 1,
                                  "hed_edge", "hed_image")
    with pytest.raises(ValueError, match="uint8"):
        cli.prepare_batch_sem({"sem": sem.astype(np.int32)}, 1)
    with pytest.raises(ValueError, match="FeatureExtractor"):
        cli.prepare_batch_for({"ckpt": "checkpoint_generation_text.pth", "locations": []}, 1)


def test_registry_names_match_jax():
    """Every name and reference alias the JAX registries hold for the five
    spatial tokenizers and downsamplers resolves in the port to the
    class of the same name; the port's downsampler registry holds no other
    name."""
    nets = {k for k, v in JAX_NETS._entries.items() if issubclass(v, jsp.SpatialPositionNet)}
    assert len(nets) == 10
    for key in nets:
        assert GROUNDING_NETS.get(key).__name__ == JAX_NETS.get(key).__name__, key
    assert set(DOWNSAMPLERS._entries) == set(JAX_DOWNSAMPLERS._entries)
    for key in JAX_DOWNSAMPLERS._entries:
        assert DOWNSAMPLERS.get(key).__name__ == JAX_DOWNSAMPLERS.get(key).__name__, key
    for m in MODALITIES:
        assert INPUT_ADAPTERS.get(m)().extra_key == JAX_ADAPTERS.get(m)().extra_key


@pytest.mark.parametrize("modality", MODALITIES)
def test_smoke_models_are_the_configs(modality):
    """``chip_smoke.py``'s phase-13 literals are the config file's model,
    schedule and input adapters, the tokenizer and the downsampler under a
    reference alias of the config's own name."""
    cfg = yaml.safe_load((REPO / "configs" / CONFIG_FILE[modality]).read_text())
    want = dict(cfg["model"]["params"])
    want.pop("image_size")
    got = dict(chip_smoke.SPATIAL_MODELS[modality])
    for key, registry in (("grounding_tokenizer", GROUNDING_NETS),
                          ("grounding_downsampler", DOWNSAMPLERS)):
        mine, theirs = got.pop(key), want.pop(key)
        assert mine["params"] == theirs["params"] and mine["target"] != theirs["target"]
        assert registry.get(mine["target"]) is registry.get(theirs["target"])
    assert got == want
    assert chip_smoke.GROUNDING_SCHEDULE == cfg["diffusion"]["params"]
    for key in ("grounding_tokenizer_input", "grounding_downsampler_input"):
        assert adapters.get_adapter(cfg[key]["target"]) is adapters.get_adapter(modality)
    assert chip_smoke.SPATIAL_INPUTS[modality] == cfg["grounding_tokenizer_input"]["target"]
