"""The image side of box+text+image grounding in the port against the JAX
package, on the CPU in fp32: ``ops/interpolate.py:resize_2d``,
``models/clip_vision.py`` (``clip_preprocess`` and a 2-layer, 64-wide
vision tower), ``convert_clip_vision`` against the JAX converter, and CLIP
text's penultimate and pooled outputs.

Tolerances: the resize is two fp32 products of the same matrices, a few
fp32 ulps of O(1) pixels (1e-5; the 255-scale inputs are compared after
the division); the towers' outputs O(1) through a few fp32 layers (1e-4,
as test_torch_modules.py).  The key maps are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gligen_tpu.convert import torch_to_jax as jconv
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.clip_vision import CLIPVisionModel as JaxVision
from gligen_tpu.models.clip_vision import clip_preprocess as jax_preprocess
from gligen_tpu.ops.interpolate import resize_2d as jax_resize

from gligen_tpu_torch.convert import from_reference as conv
from gligen_tpu_torch.convert.from_jax import load_clip_vision_params, state_dict_from_jax
from gligen_tpu_torch.models.clip_text import CLIPTextModel
from gligen_tpu_torch.models.clip_vision import CLIPVisionModel, clip_preprocess
from gligen_tpu_torch.ops import interpolate
from gligen_tpu_torch.tools import reference_ckpt as ref

from test_torch_checkpoints import assert_state_equal, assert_trees_equal
from test_torch_modules import CLIP, close, jax_apply, port, rand, random_params, t

torch.set_num_threads(1)

# the small tower: 56^2 pixels in 14^2 patches (a 4 x 4 grid), 2 layers
VISION = dict(image_size=56, patch_size=14, hidden_size=64, layers=2, heads=4,
              projection_dim=32)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("shape,out", [((2, 6, 6, 5), (13, 9)), ((1, 17, 11, 3), (8, 4))],
                         ids=["up", "down"])
def test_resize_2d_matches_jax(mode, shape, out):
    x = rand(np.random.default_rng(0), *shape)
    want = jax_resize(jnp.asarray(x), out, mode=mode)
    got = interpolate.resize_2d(t(x), out, mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    close(got, want, atol=1e-5)


def test_resize_2d_keeps_dtype_and_computes_in_fp32(monkeypatch):
    """A bf16 input comes back bf16, resized in fp32 with TF32 off inside
    (the JAX op runs at HIGHEST precision) whatever the caller's switch,
    which is restored afterwards."""
    x = rand(np.random.default_rng(1), 1, 4, 4, 2)
    seen = []
    einsum = torch.einsum

    def spy(eq, *ops):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     *(o.dtype for o in ops)))
        return einsum(eq, *ops)

    monkeypatch.setattr(interpolate.torch, "einsum", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    got = interpolate.resize_2d(t(x).to(torch.bfloat16), (6, 6))
    assert seen == [(False, False, torch.float32, torch.float32)] * 2
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    monkeypatch.undo()
    want = interpolate.resize_2d(t(x).to(torch.bfloat16).float(), (6, 6)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("kind", ["uint8", "unit_float", "byte_float"])
def test_clip_preprocess_matches_jax(kind):
    rng = np.random.default_rng(2)
    pixels = rng.integers(0, 256, size=(2, 40, 30, 3))
    x = {"uint8": pixels.astype(np.uint8), "unit_float": (pixels / 255.0).astype(np.float32),
         "byte_float": pixels.astype(np.float32)}[kind]
    want = jax_preprocess(jnp.asarray(x))
    got = clip_preprocess(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 224, 224, 3) and got.dtype == torch.float32
    close(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def vision_pair():
    jm = JaxVision(**VISION)
    params = random_params(jm, jnp.zeros((1, 56, 56, 3)), seed=4)
    model = CLIPVisionModel(**VISION).eval()
    load_clip_vision_params(model, params)
    return jm, params, model


def test_clip_vision_matches_jax(vision_pair):
    """Image embeds, the pooled CLS token and every layer's patch grid."""
    jm, params, model = vision_pair
    pixels = rand(np.random.default_rng(5), 2, 56, 56, 3)
    embeds, pooled, hidden = jax_apply(jm, params, jnp.asarray(pixels), output_hidden_states=True)
    with torch.no_grad():
        got_embeds, got_pooled, got_hidden = model(t(pixels), output_hidden_states=True)
        plain = model(t(pixels))
    assert tuple(got_embeds.shape) == (2, 32) and len(got_hidden) == 2
    close(got_embeds, embeds)
    close(got_pooled, pooled)
    for g, w in zip(got_hidden, hidden):
        assert tuple(g.shape) == (2, 4, 4, 64)
        close(g, w)
    assert torch.equal(plain[0], got_embeds) and len(plain) == 2


def test_convert_clip_vision_matches_jax(vision_pair):
    """The inverse map writes HF names the JAX converter takes back to the
    JAX tree exactly, and the port's converter gives the bridge's state
    dict of that conversion bit for bit; the port's tower loads it
    strictly."""
    _, params, model = vision_pair
    hf = ref.clip_vision_to_reference(state_dict_from_jax(params))
    assert {"vision_model.embeddings.class_embedding",
            "vision_model.embeddings.patch_embedding.weight",
            "vision_model.embeddings.position_ids", "vision_model.pre_layrnorm.weight",
            "vision_model.encoder.layers.1.mlp.fc2.bias", "vision_model.post_layernorm.bias",
            "visual_projection.weight"} <= set(hf)
    assert hf["vision_model.embeddings.patch_embedding.weight"].shape == (64, 3, 14, 14)
    assert_trees_equal(jconv.convert_clip_vision(hf), params)
    got = conv.convert_clip_vision(hf)
    assert_state_equal(got, state_dict_from_jax(jconv.convert_clip_vision(hf)))
    CLIPVisionModel(**VISION).load_state_dict(got, strict=True)
    assert_state_equal(got, model.state_dict())


def test_clip_text_penultimate_and_pooled():
    """``forward`` gives last, penultimate (the last layer's input) and
    pooled (last at each row's argmax id) as the JAX model does; ``encode``
    is ``last``."""
    rng = np.random.default_rng(6)
    jm = JaxCLIP(**CLIP)
    params = random_params(jm, jnp.zeros((1, 77), jnp.int32), seed=7)
    ids = rng.integers(1, CLIP["vocab_size"] - 2, size=(3, 77)).astype(np.int32)
    ids[np.arange(3), [5, 40, 76]] = CLIP["vocab_size"] - 1  # the end-of-text token
    last, penultimate, pooled = jax_apply(jm, params, jnp.asarray(ids))
    model = port(CLIPTextModel(**CLIP), params)
    with torch.no_grad():
        got = model(t(ids).long())
        encoded = model.encode(t(ids).long())
    for g, w in zip(got, (last, penultimate, pooled)):
        assert tuple(g.shape) == w.shape
        close(g, w)
    assert torch.equal(got[2], got[0][torch.arange(3), [5, 40, 76]])
    assert torch.equal(encoded, got[0])
