"""The port's evaluator, eval datasets and meta writer
(``gligen_tpu_torch/eval/{evaluator,datasets,create_meta}.py``) against
``gligen_tpu.eval``'s, on the CPU, over the seeded data of
``gligen_tpu_torch/tools/eval_data.py`` (the repository's PNGs and JPEGs
under COCO, grounding and layout annotations):

  * each dataset's items equal the JAX dataset's: images bit for bit
    (the port's decoders and PIL-exact resizes against PIL), boxes, masks,
    embeddings and captions equal, with random flips and caption drops on;
  * ``metas_from_dataset`` and the meta writer's command line equal JAX's;
  * ``Evaluator.start_evaluating`` with small-width weights carried by
    ``convert/from_jax.py`` and the same noise injected into both
    pipelines (a wrapper here): the fakes within
    ``tests/test_torch_pipeline.py``'s atol 1e-4 before the PNG write, the
    written fakes within one level of 255 (a truncation may cross a level),
    the real PNGs equal;
  * the evaluator's command line: ``--psnr`` within 1e-5 of JAX's on the
    same folders; ``--lpips`` / ``--fid`` refuse without
    ``--allow_random_features``, as JAX's do, and give finite numbers with
    it.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from gligen_tpu.eval import create_meta as jmeta
from gligen_tpu.eval import datasets as jds
from gligen_tpu.eval import evaluator as jev
from gligen_tpu.inference.pipeline import GenerationPipeline as JaxPipeline
from gligen_tpu.inference.pipeline import GligenComponents as JaxComponents
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE

from gligen_tpu_torch.convert.from_jax import load_jax_params
from gligen_tpu_torch.data import png
from gligen_tpu_torch.data.tokenizer import HashTokenizer
from gligen_tpu_torch.eval import create_meta, datasets, evaluator
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.tools.eval_data import write_eval_data

from test_torch_modules import CLIP, CTX, LATENT, UNET, VAE, random_params

torch.set_num_threads(1)

EVAL_UNET = dict(UNET, grounding_tokenizer={"target": "text",
                                            "params": {"in_dim": 768, "out_dim": CTX}})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_eval_data(str(tmp_path_factory.mktemp("eval_data")), seed=3)


def _feature_fn(names):
    """A seeded text feature per category name (a stand-in for CLIP's)."""
    return np.stack([np.random.default_rng(sum(map(ord, n))).standard_normal(768)
                     for n in names]).astype(np.float32)


def _pair(name, data):
    """(port dataset, JAX dataset) over the same files and seed."""
    if name == "coco":
        kw = dict(image_size=200, text_feature_fn=_feature_fn, seed=4)
        args = (data["image_root"], data["instances"], data["captions"])
        return datasets.COCOEvalDataset(*args, **kw), jds.COCOEvalDataset(*args, **kw)
    if name == "grounding":
        kw = dict(prob_real_caption=0.5, random_flip=True, image_size=256, seed=5)
        args = (data["image_root"], data["grounding"], data["embeddings"])
        return datasets.GroundingEvalDataset(*args, **kw), jds.GroundingEvalDataset(*args, **kw)
    kw = dict(fake_caption_type="made", image_size=96, seed=6, min_boxes_per_image=1)
    args = (data["image_root"], data["instances"], data["stuff"], data["category_embeddings"])
    return datasets.LayoutEvalDataset(*args, **kw), jds.LayoutEvalDataset(*args, **kw)


@pytest.mark.parametrize("name", ["coco", "grounding", "layout"])
def test_datasets_equal_the_jax_items(data, name):
    port, ref = _pair(name, data)
    assert len(port) == len(ref) >= 5
    flips = 0
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        assert got["id"] == want["id"] and got["caption"] == want["caption"]
        for key in ("image", "boxes", "masks", "text_embeddings"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {i} {key}")
        flips += bool(np.any(want["masks"]))
    assert flips  # some item carries boxes


def test_load_embedding_reads_npy_and_torch_files(data):
    names = sorted(os.listdir(data["embeddings"]))
    torch_saved = [n for n in names if not n.endswith(".npy")]
    assert torch_saved and len(torch_saved) < len(names)
    for n in names[:6]:
        path = os.path.join(data["embeddings"], n.removesuffix(".npy"))
        np.testing.assert_array_equal(datasets._load_embedding(path), jds._load_embedding(path))


def test_metas_and_the_meta_writer_equal_jax(data, tmp_path):
    port, ref = _pair("coco", data)
    got = create_meta.metas_from_dataset(port, "ckpt.pth", max_items=5, alpha_type=[0.3, 0, 0.7])
    want = jmeta.metas_from_dataset(ref, "ckpt.pth", max_items=5, alpha_type=[0.3, 0, 0.7])
    assert got == want and len(got) == 5
    argv = ["--image_root", data["image_root"], "--instances_json", data["instances"],
            "--captions_json", data["captions"], "--ckpt", "c.pth", "--max_items", "4"]
    create_meta.main(argv + ["--out", str(tmp_path / "port.json")])
    jmeta.main(argv + ["--out", str(tmp_path / "jax.json")])
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)


def test_ckpt_to_folder_name_equals_jax():
    for name in ("checkpoint_00450001.pth", "tag_7.ckpt", "x.pth"):
        assert evaluator.ckpt_to_folder_name(name) == jev.ckpt_to_folder_name(name)


class _Injected:
    """A pipeline whose draws are injected: each ``generate`` takes the
    next of ``noises`` as its starting noise (dropping the evaluator's
    generator or key) at ``LATENT``, and keeps its images."""

    def __init__(self, pipe, noises, drop):
        self.pipe, self.noises, self.drop = pipe, list(noises), drop
        self.tokenizer = lambda captions: HashTokenizer()(captions) % CLIP["vocab_size"]
        self.device = torch.device("cpu")
        self.images = []

    def generate(self, ids, uc_ids, grounding, **kw):
        kw.pop(self.drop)
        out = self.pipe.generate(ids, uc_ids, grounding, noise=self.noises.pop(0),
                                 latent_size=LATENT, **kw)
        self.images.append(np.asarray(out))
        return out


@pytest.fixture(scope="module")
def evaluated(data, tmp_path_factory):
    """Both evaluators over 4 COCO items, batch 2, 3 steps: (port root,
    JAX root, port wrapper, JAX wrapper)."""
    unet, vae, clip = JaxUNet(**EVAL_UNET, use_checkpoint=False), JaxVAE(**VAE), JaxCLIP(**CLIP)
    rng = np.random.default_rng(7)
    g1 = {"boxes": jnp.zeros((1, 30, 4)), "masks": jnp.zeros((1, 30)),
          "positive_embeddings": jnp.zeros((1, 30, 768))}
    params = {
        "model": random_params(unet, jnp.zeros((1, LATENT, LATENT, 4)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, CTX)), g1, seed=1),
        "autoencoder": random_params(vae, jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
                                     jax.random.PRNGKey(0), seed=2),
        "text_encoder": random_params(clip, jnp.zeros((1, 77), jnp.int32), seed=3),
    }
    sched = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    jax_pipe = JaxPipeline(JaxComponents(unet, vae, clip, JaxSchedule.create(**sched), params))
    comps = GligenComponents.create(unet_config=EVAL_UNET, dtype=torch.float32, vae_config=VAE,
                                    text_config=CLIP, device="cpu")
    load_jax_params(comps, params)
    noises = [rng.standard_normal((2, LATENT, LATENT, 4)).astype(np.float32) for _ in range(2)]
    port_w = _Injected(GenerationPipeline(comps), noises, "generator")
    jax_w = _Injected(jax_pipe, noises, "rng")
    roots = []
    for wrapper, ds_mod, ev_mod, name in ((port_w, datasets, evaluator, "port"),
                                          (jax_w, jds, jev, "jax")):
        ds = ds_mod.COCOEvalDataset(data["image_root"], data["instances"], data["captions"],
                                    image_size=2 * LATENT, text_feature_fn=_feature_fn, seed=4)
        root = str(tmp_path_factory.mktemp(name))
        ev = ev_mod.Evaluator(wrapper, ds, root, batch_size=2, steps=3)
        assert ev.start_evaluating(max_items=4) == {"real": os.path.join(root, "real"),
                                                    "fake": os.path.join(root, "fake")}
        roots.append(root)
    return roots[0], roots[1], port_w, jax_w


def test_evaluator_writes_the_jax_evaluators_images(evaluated):
    port_root, jax_root, port_w, jax_w = evaluated
    assert len(port_w.images) == len(jax_w.images) == 2
    for got, want in zip(port_w.images, jax_w.images):
        assert got.shape == (2, 2 * LATENT, 2 * LATENT, 3) and float(want.std()) > 1e-2
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for sub in ("real", "fake"):
        names = sorted(os.listdir(os.path.join(jax_root, sub)))
        assert sorted(os.listdir(os.path.join(port_root, sub))) == names == \
            [f"{i}.png" for i in range(4)]
        for n in names:
            got, mode = png.read_png(os.path.join(port_root, sub, n))
            want, _ = png.read_png(os.path.join(jax_root, sub, n))
            assert mode == "RGB" and got.shape == want.shape
            diff = np.abs(got.astype(int) - want.astype(int)).max()
            assert diff == 0 if sub == "real" else diff <= 1, (sub, n, diff)


def test_main_psnr_matches_jax(evaluated, capsys):
    port_root, jax_root, _, _ = evaluated
    argv = ["--a", os.path.join(port_root, "real"), "--b", os.path.join(jax_root, "fake"),
            "--psnr"]
    got = evaluator.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jev.main(argv)
    assert printed == got and set(got) == {"psnr"}
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)


@pytest.mark.parametrize("flag", [["--lpips"], ["--fid"]])
def test_random_features_need_the_flag(evaluated, flag, capsys):
    port_root, jax_root, _, _ = evaluated
    argv = ["--a", os.path.join(port_root, "real"), "--b", os.path.join(port_root, "fake"), *flag]
    for main in (lambda a: evaluator.main(a + ["--device", "cpu"]), jev.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2 and "--allow_random_features" in capsys.readouterr().err


def test_main_with_random_features_gives_finite_numbers(evaluated):
    port_root, _, _, _ = evaluated
    got = evaluator.main(["--a", os.path.join(port_root, "real"), "--b",
                          os.path.join(port_root, "fake"), "--psnr", "--lpips", "--fid",
                          "--allow_random_features", "--device", "cpu"])
    assert got["lpips_features"] == got["fid_features"] == "random"
    assert all(np.isfinite(got[k]) for k in ("psnr", "lpips", "fid"))
