"""The port's inference CLI (``gligen_tpu_torch/inference/cli.py``) and
``tools/bench_matrix.py`` against the JAX package's, on the CPU.

  * For each of the reference's 11 scenarios under ``--ckpt random`` (the
    meta tagged by ``_tag_random``), both CLIs' ``run`` hand ``generate``
    the same inputs: token ids, every grounding array, the downsampler's
    map, the inpaint image and mask bit for bit; steps, sampler, alpha
    stages and guidance equal; CLIP text features (a 1-layer, 768-wide CLIP
    text model, the JAX one's weights loaded into the port's with
    ``from_jax``) within 1e-5.  ``generate`` is stubbed on both sides to
    record its arguments; the components are stand-ins with the real text
    encoders (the JAX side through a patched ``GligenComponents.create``
    and ``GenerationPipeline``, as ``tests/test_cli.py`` patches the
    checkpoint loader).
  * ``save_images``' PNGs equal the JAX CLI's pixel for pixel.
  * ``dezero_`` touches exactly the tensors ``dezero_params`` touches
    (through ``from_jax``'s names), sets the gates to 0.5, and its values
    repeat in a second process.
  * ``main`` on the CPU at a small width, 2 steps, one scenario per
    modality family: PNGs written, finite; the guards raise.
  * ``bench_matrix._grounding`` equals the JAX tool's for every modality,
    bit for bit, and a small ``bench_row`` runs.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gligen_tpu.inference.cli as jcli
import gligen_tpu.inference.pipeline as jpipe
import gligen_tpu.utils.cache as jcache
from gligen_tpu.models import unet as ju
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP

from gligen_tpu_torch.convert.from_jax import state_dict_from_jax
from gligen_tpu_torch.data import png
from gligen_tpu_torch.inference import cli
from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.models.clip_text import CLIPTextModel
from gligen_tpu_torch.models.unet import UNetModel
from gligen_tpu_torch.tools import bench_matrix

from test_torch_modules import grounding_inputs, random_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CLIP's width (the CLI's features are 768 wide), one layer, the full vocab
# (the hash tokenizer's ids reach 49407)
CLIP = dict(vocab_size=49408, hidden_size=768, layers=1, heads=12)
TEXT_TOL = 1e-5
FEATURE_KEYS = ("positive_embeddings", "text_embeddings")
SCENARIOS = [m["save_folder_name"] for m in jcli.default_meta_list()]


@pytest.fixture(scope="module")
def text_encoders():
    jm = JaxCLIP(**CLIP)
    params = random_params(jm, jnp.zeros((1, 77), jnp.int32), seed=3)
    pt = CLIPTextModel(**CLIP)
    pt.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, pt.eval()


def args_for(tmp_path, *extra):
    return cli.parser().parse_args(["--folder", str(tmp_path), "--batch_size", "2",
                                    "--device", "cpu", "--dtype", "float32", *extra])


def jax_generate_inputs(monkeypatch, text_encoders, meta, args):
    """What the JAX CLI's ``run`` hands ``generate`` for ``meta``."""
    jm, params, _ = text_encoders
    seen = {}

    def create(unet_config=None, dtype=None, rng=None):
        unet_config = unet_config or {}
        seen["unet_config"] = unet_config
        unet = types.SimpleNamespace(grounding_tokenizer=unet_config.get("grounding_tokenizer"),
                                     grounding_downsampler=unet_config.get("grounding_downsampler"))
        return types.SimpleNamespace(unet=unet, text_encoder=jm,
                                     params={"model": {}, "text_encoder": params})

    class Pipeline:
        def __init__(self, comps, mesh=None):
            self.c, self.params = comps, comps.params

        def generate(self, *args, **kw):
            seen["args"], seen["kw"] = args, kw
            return np.zeros((args[0].shape[0], 8, 8, 3), np.float32)

    monkeypatch.setattr(jpipe.GligenComponents, "create", staticmethod(create))
    monkeypatch.setattr(jpipe, "GenerationPipeline", Pipeline)
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    jargs = types.SimpleNamespace(**{k: v for k, v in vars(args).items() if k != "device"})
    jcli.run(meta, jargs)
    return seen


def port_generate_inputs(monkeypatch, text_encoders, meta, args):
    """What the port's ``run`` hands ``generate`` for ``meta``."""
    seen = {}

    def create(unet_config=None, dtype=None, seed=None, device=None):
        seen["unet_config"] = unet_config
        return types.SimpleNamespace(unet=torch.nn.Linear(1, 1), text_encoder=text_encoders[2])

    def generate(self, *args, **kw):
        seen["args"], seen["kw"] = args, kw
        return torch.zeros((args[0].shape[0], 8, 8, 3))

    monkeypatch.setattr(cli.GenerationPipeline, "generate", generate)
    cli.run(meta, args, create)
    return seen


def as_np(x):
    return None if x is None else np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_run_hands_generate_what_the_jax_cli_does(monkeypatch, tmp_path, text_encoders,
                                                  scenario):
    monkeypatch.chdir(REPO)
    monkeypatch.delenv("GLIGEN_TPU_ASSETS", raising=False)
    jmeta = next(m for m in jcli.default_meta_list() if m["save_folder_name"] == scenario)
    pmeta = next(m for m in cli.default_meta_list() if m["save_folder_name"] == scenario)
    assert pmeta == jmeta
    pmeta["ckpt"] = cli._tag_random(pmeta, "random")
    jmeta["ckpt"] = jcli._tag_random(jmeta, "random")
    assert pmeta["ckpt"] == jmeta["ckpt"]
    args = args_for(tmp_path)
    want = jax_generate_inputs(monkeypatch, text_encoders, jmeta, args)
    got = port_generate_inputs(monkeypatch, text_encoders, pmeta, args)
    assert got["unet_config"] == want["unet_config"]
    (ids, uc, grounding), (jids, juc, jgrounding) = got["args"], want["args"]
    assert np.array_equal(as_np(ids), as_np(jids)) and np.array_equal(as_np(uc), as_np(juc))
    assert sorted(grounding) == sorted(jgrounding)
    for key, value in grounding.items():
        g, w = as_np(value), as_np(jgrounding[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key in FEATURE_KEYS:
            np.testing.assert_allclose(g, w, rtol=0, atol=TEXT_TOL, err_msg=key)
        else:
            assert np.array_equal(g, w), key
    kw, jkw = got["kw"], want["kw"]
    for key in ("steps", "sampler", "guidance_scale", "alpha_stages"):
        assert kw[key] == jkw[key], key
    assert (kw["steps"], kw["sampler"]) == (50, "plms")
    for key in ("grounding_extra", "inpaint_image", "inpaint_mask"):
        g, w = as_np(kw[key]), as_np(jkw[key])
        assert (g is None) == (w is None), key
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), key
    assert kw["generator"].initial_seed() == args.seed
    assert np.array_equal(np.asarray(jkw["rng"]), np.asarray(jax.random.PRNGKey(args.seed)))
    assert os.path.exists(tmp_path / scenario / "0.png")


def test_no_plms_runs_ddim_250(monkeypatch, tmp_path, text_encoders):
    meta = dict(cli.default_meta_list()[0], ckpt="random")
    got = port_generate_inputs(monkeypatch, text_encoders, meta, args_for(tmp_path, "--no_plms"))
    assert (got["kw"]["steps"], got["kw"]["sampler"]) == (250, "ddim")
    got = port_generate_inputs(monkeypatch, text_encoders, meta,
                               args_for(tmp_path, "--no_plms", "--steps", "7"))
    assert got["kw"]["steps"] == 7


def test_save_images_equal_the_jax_clis(tmp_path):
    images = np.random.default_rng(0).random((3, 16, 24, 3)).astype(np.float32)
    images[0, 0, 0] = [0.0, 1.0, 0.999]
    got = cli.save_images(images, str(tmp_path / "port"))
    want = jcli.save_images(images, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == ["0.png", "1.png", "2.png"]
    for g, w in zip(got, want):
        assert np.array_equal(png.read_png(g)[0], np.asarray(Image.open(w)))
    again = cli.save_images(images[:1], str(tmp_path / "port"))
    assert os.path.basename(again[0]) == "3.png"


def test_load_image_pm1_equals_the_jax_clis():
    for name in ("hed.png", "sem.png", "beach.jpg", "placeholder.png"):
        path = os.path.join(REPO, "inference_images", name)
        for mode in ("RGB", "L"):
            got = cli.load_image_pm1(path, 512, mode)
            assert np.array_equal(got, jcli.load_image_pm1(path, 512, mode)), (name, mode)
    pixels = np.random.default_rng(1).integers(0, 256, (300, 400, 3)).astype(np.uint8)
    want = np.asarray(jcli.crop_and_resize(Image.fromarray(pixels), 128))
    assert np.array_equal(cli.crop_and_resize(pixels, 128), want)
    assert np.array_equal(cli.load_image_pm1(pixels, 128),
                          want.astype(np.float32) / 255.0 * 2.0 - 1.0)


def small_unet_pair():
    """The small UNet of both packages, fresh from the JAX initialisers
    (zero-init tensors and gates included), the same weights in each."""
    cfg = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
               attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=2, context_dim=32,
               grounding_tokenizer={"target": "text", "params": {"in_dim": 32, "out_dim": 32}})
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    model = ju.UNetModel(**cfg, use_checkpoint=False)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)), g)["params"]
    unet = UNetModel(**cfg)
    unet.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, unet


def test_dezero_touches_what_the_jax_cli_touches():
    params, unet = small_unet_pair()
    before_jax = state_dict_from_jax(params)
    after_jax = state_dict_from_jax(jcli.dezero_params(params))
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    cli.dezero_(unet)
    after = unet.state_dict()
    touched_jax = {k for k in before_jax if not torch.equal(before_jax[k], after_jax[k])}
    touched = {k for k in before if not torch.equal(before[k], after[k])}
    assert touched == touched_jax and len(touched) > 10
    gates = [k for k in after if k.rsplit(".", 1)[-1] in cli.GATES]
    assert gates and all(float(after[k]) == 0.5 for k in gates)
    for k in touched - set(gates):  # N(0, 1) / sqrt(fan_in), fan_in in torch's layout
        v = after[k]
        fan_in = v[0].numel() if v.dim() >= 2 else v.numel()
        assert v.abs().max() < 6 / fan_in**0.5 and bool(v.any()), k


def test_dezero_repeats_in_another_process():
    code = """
import json, sys, torch
from gligen_tpu_torch.inference import cli
from gligen_tpu_torch.inference.pipeline import GligenComponents
torch.manual_seed(int(sys.argv[1]))
unet = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Conv2d(4, 4, 3))
with torch.no_grad():
    for p in unet.parameters():
        p.zero_()
cli.dezero_(unet)
print(json.dumps([p.flatten().tolist() for p in unet.parameters()]))
"""
    runs = [subprocess.run([sys.executable, "-c", code, str(seed)], capture_output=True,
                           text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                           timeout=120) for seed in (1, 2)]
    assert all(r.returncode == 0 for r in runs), runs[0].stderr
    values = [json.loads(r.stdout) for r in runs]
    assert values[0] == values[1] and all(any(v) for v in values[0])


def small_create(unet_config=None, **kw):
    """A small-width model for ``main`` on the CPU: SD-1.4's 768-wide
    context (the CLI's features), a 1-layer CLIP text model, an 8x VAE
    (the CLI's 64^2 latent and 512^2 inpaint image), spatial tokenizers at
    64^2."""
    unet = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                channel_mult=(1, 2), num_heads=2, context_dim=768, **(unet_config or {}))
    tok = dict(unet.get("grounding_tokenizer") or {"target": "text", "params": {}})
    if tok["target"] in ("hed", "canny", "depth", "normal", "sem"):
        tok["params"] = dict(tok["params"], resize_input=64)
    unet["grounding_tokenizer"] = tok
    return GligenComponents.create(
        unet_config=unet, vae_config=dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1,
                                          resolution=64),
        text_config=dict(hidden_size=768, layers=1, heads=12), **kw)


@pytest.mark.parametrize("scenario", ["generation_box_text", "keypoint", "hed",
                                      "inpainting_box_text"])
def test_main_on_the_cpu(monkeypatch, tmp_path, scenario):
    """One scenario per modality family (box grounding, keypoints, a spatial
    map, inpainting) through ``main``: PNGs written, of finite images."""
    monkeypatch.chdir(REPO)
    images = []
    real = cli.GenerationPipeline.generate

    def generate(self, *args, **kw):
        images.append(real(self, *args, **kw))
        return images[-1]

    monkeypatch.setattr(cli.GenerationPipeline, "generate", generate)
    cli.main(["--ckpt", "random", "--dezero", "--device", "cpu", "--batch_size", "1",
              "--steps", "2", "--folder", str(tmp_path), "--scenarios", scenario],
             create=small_create)
    (img,) = images
    assert img.shape == (1, 512, 512, 3) and bool(torch.isfinite(img).all())
    pixels, mode = png.read_png(tmp_path / scenario / "0.png")
    assert mode == "RGB" and np.array_equal(pixels, (img[0].numpy() * 255).astype(np.uint8))


def test_real_checkpoint_without_a_vocab_exits(monkeypatch, tmp_path):
    monkeypatch.delenv("GLIGEN_TPU_ASSETS", raising=False)
    with pytest.raises(SystemExit, match="allow_hash_tokenizer"):
        cli.build_pipeline(str(tmp_path / "real.pth"), args_for(tmp_path))


@pytest.mark.parametrize("flag,item", [(["--data_parallel"], "M12")])
def test_unported_flags_raise(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.build_pipeline("random", args_for(tmp_path, *flag))


def test_default_meta_list_equals_the_jax_clis():
    assert cli.default_meta_list("x") == jcli.default_meta_list("x")
    assert cli.KEYPOINT_DEMO_SKELETONS == jcli.KEYPOINT_DEMO_SKELETONS
    for meta in cli.default_meta_list():
        assert cli._tag_random(meta, "random") == jcli._tag_random(meta, "random")


@pytest.mark.parametrize("modality", list(bench_matrix.MODALITIES))
def test_bench_matrix_grounding_equals_the_jax_tools(modality):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import bench_matrix as jbench
    finally:
        sys.path.pop(0)
    assert bench_matrix.MODALITIES[modality] == jbench.MODALITIES[modality]
    got, got_extra = bench_matrix._grounding(modality, 3)
    want, want_extra = jbench._grounding(modality, 3)
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert (got_extra is None) == (want_extra is None)
    if got_extra is not None:
        assert np.array_equal(got_extra, want_extra)


def test_bench_row_runs_small_on_the_cpu():
    row = bench_matrix.bench_row(
        "plms50", "box_text", "plms", 2, 1, 1, device="cpu", latent_size=8,
        unet_config=dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                         channel_mult=(1, 2), num_heads=2),
        vae_config=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16),
        text_config=dict(layers=1))
    assert row["device"] == "cpu" and row["batch"] == 1 and row["img_per_sec"] > 0
