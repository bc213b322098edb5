"""The grounding inputs of box+text+image and keypoint grounding in the port
against the JAX package, on the CPU in fp32: the two position nets, the
input adapters and the null batch, the registry's reference aliases, the
CLI's batch preparation and the CLIP feature extractor.

Tolerances: the position nets are three fp32 layers over O(1) inputs
(2e-5); the features go through small towers and a renorm to 28.7 (1e-4);
batches, null inputs and aliases are held exactly.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gligen_tpu.inference import adapters as jad
from gligen_tpu.inference import cli as jcli
from gligen_tpu.inference.pipeline import _zero_grounding
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.clip_vision import CLIPVisionModel as JaxVision
from gligen_tpu.models.grounding.keypoint import KeypointPositionNet as JaxKeypointNet
from gligen_tpu.models.grounding.text_image import TextImagePositionNet as JaxTextImageNet
from gligen_tpu.utils.registry import GROUNDING_NETS as JAX_NETS
from gligen_tpu.utils.registry import INPUT_ADAPTERS as JAX_ADAPTERS

from gligen_tpu_torch.convert.from_jax import load_clip_vision_params
from gligen_tpu_torch.inference import adapters, cli
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents, random_init_
from gligen_tpu_torch.models.clip_text import CLIPTextModel
from gligen_tpu_torch.models.clip_vision import CLIPVisionModel
from gligen_tpu_torch.models.grounding.keypoint import KeypointPositionNet
from gligen_tpu_torch.models.grounding.text_image import TextImagePositionNet
from gligen_tpu_torch.tools.timing import dezero_
from gligen_tpu_torch.utils.registry import GROUNDING_NETS, INPUT_ADAPTERS

from test_torch_clip_vision import VISION
from test_torch_modules import (CLIP, CTX, LATENT, UNET, VAE, close, grounding_inputs, jax_apply,
                                port, random_params, t)
from test_torch_pipeline import TOKENIZERS, tokenizer_inputs

torch.set_num_threads(1)

ATOL = 2e-5
TEXT_IMAGE_KEYS = ("boxes", "masks", "text_masks", "image_masks", "text_embeddings",
                   "image_embeddings")


def test_text_image_position_net_matches_jax():
    """Mixed box, text and image masks: a box with text only, image only,
    both, and padded slots, each taking its null features."""
    g = tokenizer_inputs(np.random.default_rng(0), "text_image", 2, n=6)
    args = [jnp.asarray(g[k]) for k in TEXT_IMAGE_KEYS]
    jm = JaxTextImageNet(in_dim=CTX, out_dim=24)
    params = random_params(jm, *args)
    want = jax_apply(jm, params, *args)
    net = port(TextImagePositionNet(in_dim=CTX, out_dim=24), params)
    with torch.no_grad():
        got = net(**{k: t(v) for k, v in g.items()})
    assert tuple(got.shape) == (2, 12, 24)  # B x 2N
    close(got, want, atol=ATOL)


def test_keypoint_position_net_matches_jax():
    """3 persons x 17 keypoints, some invisible at (0, 0)."""
    g = tokenizer_inputs(np.random.default_rng(1), "keypoint", 2, persons=3)
    assert 0 < g["masks"].mean() < 1
    args = [jnp.asarray(g["points"]), jnp.asarray(g["masks"])]
    jm = JaxKeypointNet(max_persons_per_image=3, out_dim=24)
    params = random_params(jm, *args)
    want = jax_apply(jm, params, *args)
    net = port(KeypointPositionNet(max_persons_per_image=3, out_dim=24), params)
    with torch.no_grad():
        got = net(**{k: t(v) for k, v in g.items()})
    assert tuple(got.shape) == (2, 51, 24)
    close(got, want, atol=ATOL)


def test_dezero_gives_each_keypoint_token_its_identity():
    """A fresh keypoint net's identities and null features are zeros, so
    every token of one point is the same; after ``dezero_`` each person's
    keypoints differ, and an invisible point takes the null features."""
    net = KeypointPositionNet(max_persons_per_image=2, out_dim=16)
    random_init_(net, torch.Generator().manual_seed(0))
    points, masks = torch.full((1, 34, 2), 0.5), torch.ones(1, 34)
    with torch.no_grad():
        fresh = net(points, masks)
        dezero_(net, torch.Generator().manual_seed(1))
        got = net(points, masks)
        masks[0, 3] = 0
        hidden = net(points * masks[..., None], masks)
    assert torch.equal(fresh, fresh[:, :1].expand_as(fresh))
    assert len({tuple(row.tolist()) for row in got[0]}) == 34
    for name in ("person_embeddings", "keypoint_embeddings", "null_person_feature",
                 "null_xy_feature"):
        assert bool(getattr(net, name).abs().min() > 0), name
    assert not torch.allclose(hidden[0, 3], got[0, 3])


def box_meta():
    """Five boxes: text only, image only, both, text only, image only."""
    return {"locations": [[0.1, 0.1, 0.4, 0.5], [0.5, 0.2, 0.9, 0.6], [0.0, 0.5, 0.5, 1.0],
                          [0.3, 0.3, 0.6, 0.6], [0.6, 0.6, 1.0, 1.0]],
            "phrases": ["a dog", None, "a cat", "a hat", None],
            "images": [None, "img0", "img1", None, "img2"],
            "text_mask": [1, 1, 0, 1, 1], "image_mask": 1}


class FakeFeatures:
    """Deterministic 768-wide features of a phrase or an image name."""

    @staticmethod
    def _feature(key):
        seed = sum(map(ord, key))
        return np.random.default_rng(seed).standard_normal(768).astype(np.float32)

    text_feature = image_feature = _feature


@pytest.mark.parametrize("batch", [1, 3])
def test_prepare_batch_box_matches_jax(batch):
    want, got = (fn(box_meta(), batch, FakeFeatures())
                 for fn in (jcli.prepare_batch_box, cli.prepare_batch_box))
    assert sorted(got) == sorted(want) == sorted(TEXT_IMAGE_KEYS)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["masks"][0].sum() == 5 and got["text_masks"][0].sum() == 2
    assert got["image_masks"][0].sum() == 3


def test_prepare_batch_kp_matches_jax():
    rng = np.random.default_rng(2)
    people = rng.random((3, 17, 2)).astype(np.float32)
    people[1, 4:9] = 0.0  # invisible keypoints
    meta = {"locations": people.tolist()}
    want, got = jcli.prepare_batch_kp(meta, 2), cli.prepare_batch_kp(meta, 2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["points"].shape == (2, 136, 2) and got["masks"][0].sum() == 3 * 17 - 5


@pytest.mark.parametrize("name", ["text", "text_image", "keypoint"])
def test_adapters_and_null_input_match_jax(name):
    """Each adapter gives the JAX adapter's tokenizer inputs, and their
    null batch is the JAX pipeline's ``_zero_grounding``."""
    rng = np.random.default_rng(3)
    if name == "keypoint":
        batch, n = cli.prepare_batch_kp({"locations": rng.random((8, 17, 2)).tolist()}, 2), 136
    else:
        batch, n = cli.prepare_batch_box(box_meta(), 2, FakeFeatures()), 30
    got = adapters.get_adapter(name).prepare(batch)
    want = jad.get_adapter(name).prepare(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    zeros = _zero_grounding({"target": name, "params": {"in_dim": 768}}, 2, n)
    null = adapters.null_input(got)
    assert sorted(null) == sorted(zeros)
    for k in zeros:
        assert tuple(null[k].shape) == zeros[k].shape and null[k].dtype == torch.float32, k
        assert not bool(null[k].any()), k


@pytest.mark.parametrize("name", ["text", "text_image", "keypoint"])
def test_generate_builds_the_null_batch(monkeypatch, name):
    """``generate`` computes the CFG null tokens from ``null_input`` of the
    request's grounding: the JAX pipeline's ``_zero_grounding``."""
    tok = TOKENIZERS.get(name, UNET["grounding_tokenizer"])
    comps = GligenComponents.create(unet_config=dict(UNET, grounding_tokenizer=tok),
                                    dtype=torch.float32, vae_config=VAE, text_config=CLIP,
                                    device="cpu")
    seen, tokens = [], comps.unet.grounding_tokens
    monkeypatch.setattr(comps.unet, "grounding_tokens", lambda g: seen.append(g) or tokens(g))
    rng = np.random.default_rng(4)
    if name == "text":
        grounding, n = grounding_inputs(rng, 2), 30
    else:
        grounding = tokenizer_inputs(rng, name, 2)
        n = 136 if name == "keypoint" else 30
    ids = np.ones((2, 77), np.int64)
    GenerationPipeline(comps).generate(ids, ids, grounding, steps=1, latent_size=LATENT)
    zeros = _zero_grounding({"target": name, "params": {"in_dim": CTX}}, 2, n)
    assert len(seen) == 2 and sorted(seen[1]) == sorted(zeros)
    for k in zeros:
        assert tuple(seen[1][k].shape) == zeros[k].shape and not bool(seen[1][k].any()), k
        np.testing.assert_array_equal(seen[0][k].numpy(), grounding[k], err_msg=k)


def test_registry_aliases_match_jax():
    """Every name and reference alias the JAX registries hold for the
    tokenizers (box+text, box+text+image, keypoint and the five spatial
    ones) and their input adapters resolves in the port, to the same kind
    of object; the port's registries hold no other name."""
    nets = {"text": "TextPositionNet", "text_image": "TextImagePositionNet",
            "keypoint": "KeypointPositionNet", "hed": "HedPositionNet",
            "canny": "CannyPositionNet", "depth": "DepthPositionNet",
            "normal": "NormalPositionNet", "sem": "SemPositionNet"}
    jax_nets = {k for k, v in JAX_NETS._entries.items() if v.__name__ in nets.values()}
    assert set(GROUNDING_NETS._entries) == jax_nets
    for key in jax_nets:
        assert GROUNDING_NETS.get(key).__name__ == JAX_NETS.get(key).__name__, key
    jax_adapters = {k for k, v in JAX_ADAPTERS._entries.items()
                    if v() in {jad.get_adapter(n) for n in nets}}
    assert set(INPUT_ADAPTERS._entries) == jax_adapters
    for key in jax_adapters:
        assert INPUT_ADAPTERS.get(key)().key_map == JAX_ADAPTERS.get(key)().key_map, key
    assert "grounding_input.text_image_grounding_tokinzer_input.GroundingNetInput" in jax_adapters
    assert "grounding_input.keypoint_grounding_downsampler_input.GroundingDSInput" in jax_adapters


# the small tower at CLIP's 224^2 input, which the extractors resize to
EXTRACTOR_VISION = dict(VISION, image_size=224)


@pytest.fixture(scope="module")
def extractors():
    """The port's and the JAX package's feature extractors over the same
    small CLIP text and vision towers and a seeded projection."""
    rng = np.random.default_rng(5)
    vocab = CLIP["vocab_size"]
    ids_of = {p: np.concatenate([[vocab - 2], rng.integers(1, vocab - 2, 6), [vocab - 1],
                                 np.zeros(69, int)])[None].astype(np.int32)
              for p in ("a dog", "a red cat")}
    tokenizer = lambda phrases: np.concatenate([ids_of[p] for p in phrases])
    jtext, jvision = JaxCLIP(**CLIP), JaxVision(**EXTRACTOR_VISION)
    text_params = random_params(jtext, jnp.zeros((1, 77), jnp.int32), seed=6)
    vision_params = random_params(jvision, jnp.zeros((1, 224, 224, 3)), seed=7)
    projection = rng.standard_normal((VISION["projection_dim"], 24)).astype(np.float32)
    pipe = types.SimpleNamespace(tokenizer=tokenizer, c=types.SimpleNamespace(text_encoder=jtext),
                                 params={"text_encoder": text_params})
    jfx = jcli.FeatureExtractor(pipe, vision_params, projection)
    jfx._vision = jvision  # the small tower in place of ViT-L/14
    vision = CLIPVisionModel(**EXTRACTOR_VISION).eval()
    load_clip_vision_params(vision, vision_params)
    fx = cli.FeatureExtractor(port(CLIPTextModel(**CLIP), text_params), tokenizer, vision,
                              projection)
    return jfx, fx


@pytest.mark.parametrize("phrase", ["a dog", "a red cat"])
def test_text_feature_matches_jax(extractors, phrase):
    jfx, fx = extractors
    got = fx.text_feature(phrase)
    assert got.shape == (CTX,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jfx.text_feature(phrase), atol=1e-4, rtol=0)


@pytest.mark.parametrize("size", [(48, 64), (512, 512)])
def test_image_feature_matches_jax(extractors, size):
    """A uint8 image through clip_preprocess, the tower, the projection and
    the renorm to 28.7."""
    jfx, fx = extractors
    image = np.random.default_rng(8).integers(0, 256, size=(*size, 3)).astype(np.uint8)
    got = fx.image_feature_from_array(image)
    assert got.shape == (24,)
    np.testing.assert_allclose(np.linalg.norm(got), 28.7, rtol=1e-5)
    np.testing.assert_allclose(got, jfx.image_feature_from_pil(image), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(fx.image_feature(image), got)


def test_feature_extractor_refusals_and_pseudo_feature():
    """No tokenizer: text features refused; no tower or projection: image
    features refused, or with ``allow_random`` the JAX extractor's
    deterministic pseudo-feature."""
    image = np.random.default_rng(9).integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    fx = cli.FeatureExtractor(CLIPTextModel(**CLIP))
    with pytest.raises(ValueError, match="tokenizer"):
        fx.text_feature("a dog")
    with pytest.raises(ValueError, match="vision"):
        fx.image_feature_from_array(image)
    got = cli.FeatureExtractor(None, allow_random=True).image_feature_from_array(image)
    want = jcli.FeatureExtractor(None, allow_random=True).image_feature_from_pil(image)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("value", [None, 0.5, [1, 0, 1]])
def test_complete_mask_matches_jax(value):
    np.testing.assert_array_equal(cli.complete_mask(value, 5), jcli.complete_mask(value, 5))
