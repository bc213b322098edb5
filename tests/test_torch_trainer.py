"""The port's Trainer, its checkpoints and its command line on the CPU at a
small width, held to the JAX package's Trainer where the two compute the
same thing: ``TrainerConfig``, ``collate`` (inpaint masks included),
``_merge_loaded``'s first-conv widening, ``config.json``.  Then what only
the port runs end to end here: train and resume in ``tagNN`` through
``python -m gligen_tpu_torch.main``, the restored state bit for bit, the
fork and thread decode pools, the pool's release, the SIGTERM checkpoint,
the latent cache's loss, and a trained checkpoint's EMA shadow served
through the CLI's ``--train_ckpt`` and generated from, against the JAX
pipeline with the same weights.

Tolerances: exact for the config, collate, merges and restored state; the
cached-latent loss within 1e-5 relative of the live encode's (the cache's
encode batches other images beside the same one); the served generate
within the pipeline tests' atol 1e-4 of the JAX pipeline's.
"""

import base64
import dataclasses
import json
import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from gligen_tpu.data import tokenizer as jtokenizer
from gligen_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from gligen_tpu.inference import adapters as jadapters
from gligen_tpu.inference.pipeline import GenerationPipeline as JaxPipeline
from gligen_tpu.inference.pipeline import GligenComponents as JaxComponents
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE
from gligen_tpu.training import trainer as jtrainer

from gligen_tpu_torch import main as tmain
from gligen_tpu_torch.config import load_yaml_config, normalize_model_config
from gligen_tpu_torch.convert.from_jax import state_dict_from_jax
from gligen_tpu_torch.data import png, tsv
from gligen_tpu_torch.data.tokenizer import load_tokenizer
from gligen_tpu_torch.inference import adapters, cli
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.tools import prepare_latents
from gligen_tpu_torch.training import checkpoints as ckpt_io
from gligen_tpu_torch.training import trainer
from gligen_tpu_torch.training.train_step import make_loss_fn

from test_torch_data import write_box_tsv

torch.set_num_threads(1)

CTX = 32
LATENT = 8
UNET = dict(in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[1],
            num_res_blocks=1, channel_mult=[1, 2], num_heads=2, context_dim=CTX,
            grounding_tokenizer={"target": "text", "params": {"in_dim": 768, "out_dim": CTX}})
VAE = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, resolution=2 * LATENT)
CLIP = dict(vocab_size=64, hidden_size=CTX, layers=1, heads=2)
SHAPES = [(40, 50), (100, 80), (300, 260), (16, 16), (70, 130), (24, 30)]


def _flow(obj):
    return json.dumps(obj).replace('"', "")


def write_setup(root, flip=True, caption=0.5):
    """A small config (``configs/flickr_text.yaml``'s layout, narrow
    widths, one line a flow map), its FlickrGrounding TSV under
    ``root/DATA`` and a projection matrix; returns the config's path."""
    tsv = os.path.join(root, "DATA/GROUNDING/flickr30k/tsv/train-00.tsv")
    os.makedirs(os.path.dirname(tsv), exist_ok=True)
    rng = np.random.default_rng(0)
    write_box_tsv(tsv, rng, SHAPES, image_format="PNG")
    proj = os.path.join(root, "proj.npy")
    np.save(proj, rng.standard_normal((768, 768)).astype(np.float32))
    params = dict(UNET, image_size=LATENT)
    lines = ["model:", "  target: unet", "  params:"]
    lines += [f"    {k}: {_flow(v)}" for k, v in params.items()]
    lines += [f"diffusion: {_flow({'params': dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)})}",
              f"autoencoder: {_flow({'params': VAE})}",
              f"text_encoder: {_flow({'params': CLIP})}",
              "train_dataset_names:",
              f"  FlickrGrounding: {{image_size: {2 * LATENT}, max_boxes_per_data: 5, "
              f"prob_use_caption: {caption}, random_flip: {str(flip).lower()}, "
              f"projection_matrix_path: {proj}}}",
              "grounding_tokenizer_input:",
              "  target: grounding_input.text_grounding_tokinzer_input.GroundingNetInput"]
    path = os.path.join(root, "small.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def main_argv(root, *extra):
    return ["--yaml_file", os.path.join(root, "small.yaml"), "--DATA_ROOT",
            os.path.join(root, "DATA"), "--OUTPUT_ROOT", os.path.join(root, "OUT"),
            "--device", "cpu", "--dtype", "float32", "--batch_size", "2",
            "--warmup_steps", "1", *extra]


class DezeroedComponents(GligenComponents):
    """Components whose zero-initialised tensors are de-zeroed (``cli.dezero_``,
    a function of the parameter names): at a fresh init the zero output
    conv blocks every gradient, where real training starts from SD."""

    @classmethod
    def create(cls, *args, **kwargs):
        comps = GligenComponents.create(*args, **kwargs)
        with torch.no_grad():
            cli.dezero_(comps.unet)
        return comps


@pytest.fixture(autouse=True)
def _dezeroed(monkeypatch):
    monkeypatch.setattr(trainer, "GligenComponents", DezeroedComponents)


def small_trainer(root, **run_kw):
    config = normalize_model_config(load_yaml_config(os.path.join(root, "small.yaml")))
    run = trainer.TrainerConfig(output_root=os.path.join(root, "OUT"),
                                data_root=os.path.join(root, "DATA"), dtype="float32",
                                batch_size=2, warmup_steps=1, **run_kw)
    return trainer.Trainer(config, run, device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Four steps through the command line with EMA, saving every 2, then
    a resume to six: (root, first run's Trainer, resumed Trainer)."""
    root = str(tmp_path_factory.mktemp("trained"))
    write_setup(root)
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(trainer, "GligenComponents", DezeroedComponents)
        return _train(root)


def _train(root):
    first = tmain.main(main_argv(root, "--total_iters", "4", "--save_every_iters", "2",
                                 "--enable_ema", "--workers", "2"))
    second = tmain.main(main_argv(root, "--total_iters", "6", "--save_every_iters", "2",
                                  "--enable_ema"))
    return root, first, second


def test_trainer_config_fields_and_defaults_equal_the_jax_packages():
    assert dataclasses.asdict(trainer.TrainerConfig()) == \
        dataclasses.asdict(jtrainer.TrainerConfig())


def test_run_writes_checkpoints_previews_and_config(trained):
    root, first, second = trained
    tag = os.path.join(root, "OUT", "test", "tag00")
    assert first.tag_dir == tag and first.state.step == 4
    names = sorted(os.listdir(tag))
    # the JAX rule: a save after iteration it when it % save_every == 0
    # (step it + 1) and after the last
    for want in ("checkpoint_00000003", "checkpoint_00000004", "checkpoint_00000006",
                 "checkpoint_latest", "config.json", "metrics.jsonl", "captions.txt",
                 "preview_00000002.png", "preview_00000003.png", "preview_00000005.png"):
        assert want in names, names
    assert not any(n.startswith("tag01") for n in os.listdir(os.path.dirname(tag)))
    pixels, mode = png.read_png(os.path.join(tag, "preview_00000003.png"))
    assert mode == "RGB" and pixels.shape == (2 * 2 * LATENT, 2 * 2 * LATENT, 3)  # batch 2
    with open(os.path.join(tag, "config.json")) as f:
        saved = json.load(f)
    # the resumed run wrote it last
    want_run = dataclasses.asdict(jtrainer.TrainerConfig(**dataclasses.asdict(second.run)))
    assert saved["run"] == json.loads(json.dumps(want_run))
    assert saved["model"] == normalize_model_config(
        load_yaml_config(os.path.join(root, "small.yaml")))
    with open(os.path.join(tag, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["iter"] for r in logged] == [0]
    assert all(np.isfinite(r["loss"]) for r in logged)


def test_resume_continues_in_the_same_tag_bit_for_bit(trained):
    root, first, second = trained
    tag = os.path.join(root, "OUT", "test", "tag00")
    assert second.tag_dir == tag and second.starting_iter == 4 and second.state.step == 6
    # a third Trainer restores what the second saved, bit for bit
    saved = ckpt_io.restore_training_checkpoint(os.path.join(tag, "checkpoint_00000006"))
    third = small_trainer(root, name="test", enable_ema=True, total_iters=6)
    state = third.state
    assert third.starting_iter == state.step == saved["step"] == 6
    for name, p in state.params.items():
        assert torch.equal(p.detach(), saved["train_params"][name]), name
        assert torch.equal(state.ema_params[name], saved["ema_params"][name]), name
        assert torch.equal(p.detach(), second.state.params[name].detach()), name
    opt, want = state.optimizer.state_dict(), second.state.optimizer.state_dict()
    assert opt["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt["state"][i][key], s[key]), (i, key)
    assert state.scheduler.state_dict() == second.state.scheduler.state_dict()
    assert state.optimizer.param_groups[0]["lr"] == second.state.optimizer.param_groups[0]["lr"]


def test_main_under_remat_dots_trains_as_full(tmp_path, monkeypatch):
    """``GLIGEN_TPU_REMAT_POLICY=dots`` reaches the Trainer through ``main``
    as in the JAX package: two steps give 'full''s parameters bit for bit."""
    root = str(tmp_path)
    write_setup(root)
    monkeypatch.setattr(trainer, "GligenComponents", DezeroedComponents)
    params = {}
    for policy in ("full", "dots"):
        monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", policy)
        run = tmain.main(main_argv(root, "--total_iters", "2", "--save_every_iters", "100",
                                   "--name", policy))
        assert run.state.step == 2
        params[policy] = {n: p.detach() for n, p in run.state.params.items()}
    assert params["dots"].keys() == params["full"].keys()
    for name, p in params["full"].items():
        assert torch.equal(params["dots"][name], p), name


def test_frozen_parameters_stay_and_trainables_move(trained):
    root, first, _ = trained
    fresh = DezeroedComponents.create(unet_config=dict(UNET, use_checkpoint=True),
                                    dtype=torch.float32, seed=123, device="cpu",
                                    vae_config=VAE, text_config=CLIP)
    trainable = first.state.params
    start = dict(fresh.unet.named_parameters())
    for name, p in first.unet.named_parameters():
        assert torch.equal(p, start[name]) != (name in trainable), name
    for a, b in ((first.vae, fresh.vae), (first.text_encoder, fresh.text_encoder)):
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(p, q) and p.grad is None, n


def _collate_stubs(modality, inpaint):
    """The port's and the JAX package's ``Trainer.collate`` on stand-ins
    holding what it reads: the hash tokenizers (no vocab here), the
    adapters, the run flags, the latent size and the mask RNG."""
    run_kw = dict(inpaint_mode=inpaint, randomize_fg_mask=inpaint, random_add_bg_mask=inpaint)

    class Port:
        tokenizer = load_tokenizer(None)
        text_encoder = nn.Module()
        text_encoder.token_embedding = nn.Embedding(CLIP["vocab_size"], 2)
        adapter = adapters.get_adapter(modality)
        run = trainer.TrainerConfig(**run_kw)
        latent_size = 64  # the stroke masks' smallest size
        _mask_rng = np.random.default_rng(123 + 0x5EED)

    class Jax:
        tokenizer = jtokenizer.load_tokenizer(None)
        text_encoder = JaxCLIP(**CLIP)
        adapter = jadapters.get_adapter(modality)
        run = jtrainer.TrainerConfig(**run_kw)
        latent_size = 64
        _mask_rng = np.random.default_rng(123 + 0x5EED)

    return (lambda items: trainer.Trainer.collate(Port, items),
            lambda items: jtrainer.Trainer.collate(Jax, items))


@pytest.mark.parametrize("modality,inpaint", [("text", False), ("text", True),
                                              ("text_image", True)])
def test_collate_equals_the_jax_packages(tmp_path, monkeypatch, modality, inpaint):
    monkeypatch.delenv("GLIGEN_TPU_ASSETS", raising=False)
    from gligen_tpu_torch.data.box_dataset import TSVBoxDataset

    path = str(tmp_path / "g.tsv")
    write_box_tsv(path, np.random.default_rng(1), SHAPES, image_format="PNG")
    ds = TSVBoxDataset(path, image_size=16, which_layer_image="after_renorm", seed=3,
                       prob_use_caption=0.5, random_drop_embedding="both",
                       max_boxes_per_data=5)
    items = [ds[i] for i in range(len(ds))]
    port, want_fn = _collate_stubs(modality, inpaint)
    for start in (0, 2, 4, 0):  # the mask RNG carries on across batches
        got, want = port(items[start:start + 2]), want_fn(items[start:start + 2])
        assert sorted(got) == sorted(want)
        for key in ("image", "input_ids") + (("inpainting_mask",) if inpaint else ()):
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])
        assert sorted(got["grounding"]) == sorted(want["grounding"])
        for key, value in want["grounding"].items():
            assert np.array_equal(got["grounding"][key].numpy(), np.asarray(value)), key


def test_merge_loaded_widens_the_first_conv_as_the_jax_package():
    rng = np.random.default_rng(2)

    def tree(cin, with_extra):
        t = {"input_blocks_0_0": {"kernel": rng.standard_normal((3, 3, cin, 8)).astype("f"),
                                  "bias": rng.standard_normal(8).astype("f")},
             "out": {"kernel": rng.standard_normal((8, 4)).astype("f"),
                     "bias": rng.standard_normal(4).astype("f")}}
        if with_extra:
            t["fuser"] = {"kernel": rng.standard_normal((4, 4)).astype("f")}
        else:
            t["only_in_ckpt"] = {"bias": rng.standard_normal(3).astype("f")}
        return t

    current, loaded = tree(9, True), tree(4, False)
    want = jtrainer._merge_loaded({"model": current}, {"model": loaded})["model"]
    module = nn.ModuleDict({"input_blocks_0_0": nn.Conv2d(9, 8, 3), "out": nn.Linear(8, 4),
                            "fuser": nn.Linear(4, 4, bias=False)})
    module.load_state_dict(state_dict_from_jax(current))
    trainer.merge_loaded(module, state_dict_from_jax(loaded))
    want = state_dict_from_jax(want)
    assert sorted(module.state_dict()) == sorted(want)
    for name, value in module.state_dict().items():
        assert torch.equal(value, want[name]), name
    bad = {"out.weight": torch.zeros(5, 8)}
    with pytest.raises(ValueError, match="out.weight"):
        trainer.merge_loaded(module, bad)


def _deterministic_items(root, workers, pool, monkeypatch, n_batches=4):
    monkeypatch.setenv("GLIGEN_TPU_DECODE_POOL", pool)
    tr = small_trainer(root, name=f"pool_{pool}_{workers}", workers=workers)
    loader = tr.batches(tr.build_dataset())
    try:
        return [next(loader) for _ in range(n_batches)]
    finally:
        loader.close()


def test_fork_and_thread_pools_give_the_serial_items(tmp_path, monkeypatch):
    root = str(tmp_path)
    write_setup(root, flip=False, caption=1.0)  # no draw changes an item
    serial = _deterministic_items(root, 1, "fork", monkeypatch)
    for workers, pool in ((2, "fork"), (3, "thread")):
        got = _deterministic_items(root, workers, pool, monkeypatch)
        for a, b in zip(got, serial):
            assert np.array_equal(a["image"], b["image"]) and \
                np.array_equal(a["input_ids"], b["input_ids"])
            for key in b["grounding"]:
                assert torch.equal(a["grounding"][key], b["grounding"][key]), (pool, key)


def test_worker_init_reseeds_each_workers_rng():
    class Items:
        rng = None

    ds = Items()
    trainer._decode_worker_init(ds, 7)
    assert trainer._WORKER_DATASET is ds
    assert ds.rng.bit_generator.state == np.random.default_rng(7).bit_generator.state


def test_closing_the_generator_releases_the_pool(tmp_path, monkeypatch):
    root = str(tmp_path)
    write_setup(root)
    monkeypatch.setenv("GLIGEN_TPU_DECODE_POOL", "fork")
    tr = small_trainer(root, name="release", workers=2)
    children, threads = set(mp.active_children()), set(threading.enumerate())
    loader = tr.batches(tr.build_dataset())
    next(loader)
    workers = set(mp.active_children()) - children
    producers = set(threading.enumerate()) - threads
    assert len(workers) == 2 and producers
    loader.close()
    assert not any(w.is_alive() for w in workers)
    assert not any(t.is_alive() for t in producers)


def test_sigterm_checkpoints_at_the_step_boundary(tmp_path):
    assert threading.current_thread() is threading.main_thread()
    root = str(tmp_path)
    write_setup(root)
    tr = small_trainer(root, name="preempt", total_iters=1000, log_every_iters=1,
                       save_every_iters=1000)
    metrics = os.path.join(tr.tag_dir, "metrics.jsonl")

    def send():
        while not os.path.exists(metrics):
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)

    sender = threading.Thread(target=send)
    sender.start()
    state = tr.start_training()
    sender.join(timeout=60)
    assert not sender.is_alive()
    with open(metrics) as f:
        logged = [json.loads(line) for line in f]
    assert logged[-1]["event"] == "preempted, checkpointed"
    it = logged[-1]["iter"]
    assert state.step == it + 1 < 1000
    assert ckpt_io.latest_checkpoint(tr.tag_dir).endswith(f"checkpoint_{it + 1:08d}")
    assert signal.getsignal(signal.SIGTERM) is not None


def test_cached_latents_give_the_live_encode_loss(tmp_path):
    root = str(tmp_path)
    write_setup(root, flip=True)
    tr = small_trainer(root, name="cache", cached_latents=os.path.join(root, "latents"))
    tsv = os.path.join(root, "DATA/GROUNDING/flickr30k/tsv/train-00.tsv")
    prepare_latents.main(["--tsv", tsv, "--out_dir", os.path.join(root, "latents"),
                          "--image_size", str(2 * LATENT), "--batch", "2"], vae=tr.vae)
    cached_ds = tr.build_dataset()
    live_tr = small_trainer(root, name="live")
    live_ds = live_tr.build_dataset()
    items_c = [cached_ds[i] for i in range(3)]
    items_l = [live_ds[i] for i in range(3)]
    assert all("latent_moments" in it for it in items_c)
    batch_c, batch_l = tr.collate(items_c), live_tr.collate(items_l)
    assert np.array_equal(batch_c["image"], batch_l["image"])  # the same flips
    loss_fn = make_loss_fn(tr.unet, tr.vae, tr.text_encoder, tr.schedule)
    rng = np.random.default_rng(4)
    draws = {"posterior": rng.standard_normal((3, LATENT, LATENT, 4)),
             "u_t": rng.random(3), "noise": rng.standard_normal((3, LATENT, LATENT, 4)),
             "u_drop": rng.random(())}
    with torch.no_grad():
        cached = loss_fn({k: v for k, v in batch_c.items() if k != "image"}, draws=draws)
        live = loss_fn(batch_l, draws=draws)
    np.testing.assert_allclose(cached.item(), live.item(), rtol=1e-5)
    with torch.no_grad():
        tr.vae.encoder.conv_in.bias += 1.0  # other weights: the digest refuses the cache
    with pytest.raises(ValueError, match="different VAE weights"):
        tr.build_dataset()


def _jax_tree(template, state):
    """The port's state dict in the JAX package's tree of ``template``
    (``convert/from_jax.py`` inverted)."""
    out = {}
    for key, sub in template.items():
        if isinstance(sub, dict):
            out[key] = _jax_tree(sub, {k[len(key) + 1:]: v for k, v in state.items()
                                       if k.startswith(key + ".")})
            continue
        name = "weight" if key in ("kernel", "scale", "embedding") else key
        arr = state[name].numpy()
        if key == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        out[key] = jnp.asarray(arr)
    return out


def test_train_ckpt_overlay_serves_the_ema_shadow(trained, tmp_path):
    root, first, second = trained
    tag = os.path.join(root, "OUT", "test", "tag00")
    ema = ckpt_io.load_training_params(tag, use_ema=True)
    live = ckpt_io.load_training_params(os.path.join(tag, "checkpoint_00000006"))
    assert sorted(ema) == sorted(second.state.params)
    assert any(not torch.equal(ema[n], live[n]) for n in ema)
    want = second.model_params(use_ema=True)

    def create(unet_config, dtype, seed, device):
        assert unet_config == {}  # "random" names no modality
        return DezeroedComponents.create(unet_config=dict(UNET), dtype=dtype, seed=123,
                                       device=device, vae_config=VAE, text_config=CLIP)

    args = cli.parser().parse_args(["--ckpt", "random", "--device", "cpu", "--dtype", "float32",
                                    "--train_ckpt", tag, "--use_ema"])
    pipe = cli.build_pipeline("random", args, create)
    for name, p in pipe.c.unet.named_parameters():
        assert torch.equal(p, want[name]), name

    # a generate from the served weights against the JAX pipeline's
    rng = np.random.default_rng(5)
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(2, 77)).astype(np.int32)
    uc = np.full((2, 77), CLIP["vocab_size"] - 1, np.int32)
    grounding = {"boxes": rng.random((2, 5, 4)).astype("f"),
                 "masks": np.array([[1, 1, 0, 0, 0], [1, 0, 0, 0, 0]], "f"),
                 "positive_embeddings": rng.standard_normal((2, 5, 768)).astype("f")}
    noise = rng.standard_normal((2, LATENT, LATENT, 4)).astype("f")
    kw = dict(steps=2, guidance_scale=5.0, latent_size=LATENT, noise=noise)
    got = pipe.generate(ids, uc, grounding, **kw).numpy()
    junet, jvae, jclip = JaxUNet(**UNET, use_checkpoint=False), JaxVAE(**VAE), JaxCLIP(**CLIP)
    g1 = {k: jnp.asarray(v[:1]) for k, v in grounding.items()}
    templates = {
        "model": jax.eval_shape(junet.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 77, CTX)), g1)["params"],
        "autoencoder": jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 2 * LATENT, 2 * LATENT, 3)),
                                      jax.random.PRNGKey(1))["params"],
        "text_encoder": jax.eval_shape(jclip.init, jax.random.PRNGKey(0),
                                       jnp.zeros((1, 77), jnp.int32))["params"],
    }
    modules = {"model": pipe.c.unet, "autoencoder": pipe.c.vae, "text_encoder": pipe.c.text_encoder}
    params = {k: _jax_tree(templates[k], {n: t.detach() for n, t in modules[k].state_dict().items()})
              for k in modules}
    sched = JaxSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    jcomps = JaxComponents(junet, jvae, jclip, sched, params)
    want_img = np.asarray(JaxPipeline(jcomps).generate(ids, uc, grounding, **kw))
    assert float(np.std(got)) > 1e-2
    np.testing.assert_allclose(got, want_img, atol=1e-4, rtol=0)

    with pytest.raises(ValueError, match="not in the UNet"):
        cli.overlay_training_params(pipe.c.unet, {"no.such.weight": torch.zeros(1)})


def test_load_training_params_without_ema_raises(tmp_path):
    tag = str(tmp_path / "tag00")
    ckpt_io.save_training_checkpoint(tag, 3, {"step": 3, "train_params": {"a": torch.ones(2)}})
    assert torch.equal(ckpt_io.load_training_params(tag)["a"], torch.ones(2))
    with pytest.raises(ValueError, match="enable_ema"):
        ckpt_io.load_training_params(tag, use_ema=True)
    with pytest.raises(FileNotFoundError):
        ckpt_io.load_training_params(str(tmp_path / "empty"))


def test_find_resume_dir_scans_tags_newest_first(tmp_path):
    root = str(tmp_path)
    tag, path = ckpt_io.find_resume_dir(root, "run")
    assert tag.endswith("tag00") and path is None
    tag, path = ckpt_io.find_resume_dir(root, "run")  # tag00 has no checkpoint yet
    assert tag.endswith("tag01") and path is None
    ckpt_io.save_training_checkpoint(os.path.join(root, "run", "tag00"), 5, {"step": 5})
    tag, path = ckpt_io.find_resume_dir(root, "run")
    assert tag.endswith("tag00") and path.endswith("checkpoint_00000005")
    os.remove(os.path.join(root, "run", "tag00", "checkpoint_latest"))
    ckpt_io.save_training_checkpoint(os.path.join(root, "run", "tag00"), 7, {"step": 7})
    assert ckpt_io.latest_checkpoint(os.path.join(root, "run", "tag00")).endswith("07")


def test_profile_dir_traces_steps_10_to_12(tmp_path):
    root = str(tmp_path)
    write_setup(root)
    trace_dir = os.path.join(root, "trace")
    tr = small_trainer(root, name="profile", total_iters=13, save_every_iters=1000,
                       profile_dir=trace_dir)
    tr.start_training()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = json.load(f)
    ranges = [ev for ev in trace["traceEvents"] if ev.get("name") == "train_step.loss"]
    assert len(ranges) == 3  # the forwards of steps 10, 11 and 12


def test_preview_from_the_ema_shadow_restores_the_live_weights(tmp_path):
    root = str(tmp_path)
    write_setup(root)
    tr = small_trainer(root, name="ema_preview", enable_ema=True, preview_use_ema=True,
                       preview_steps=2)
    with torch.no_grad():
        for e in tr.state.ema_params.values():
            e.add_(1.0)
    live = {n: p.detach().clone() for n, p in tr.state.params.items()}
    ds = tr.build_dataset()
    out = tr.save_preview(tr.collate([ds[0], ds[1]]), 7)
    assert png.read_png(out)[0].shape == (2 * 2 * LATENT, 2 * 2 * LATENT, 3)
    for n, p in tr.state.params.items():
        assert torch.equal(p, live[n]), n
    with pytest.raises(ValueError, match="enable_ema"):
        small_trainer(root, name="no_ema", preview_use_ema=True).save_preview(
            tr.collate([ds[0], ds[1]]), 7)


# ---- the inpaint preview (fault F8) -----------------------------------------
def test_inpaint_preview_samples_plain_plms_with_the_batchs_inpainting_extra(tmp_path,
                                                                               monkeypatch):
    """As the JAX preview (trainer.py:455-535): ``plms_sample`` gets no mask
    and no x0 (no blend of a known region); the UNet gets concat(z * m, m)
    with z the batch's encode by the VAE at its own dtype (not
    ``encode_fp32``), its noise the preview generator's first draw."""
    from gligen_tpu_torch.inference import pipeline

    root = str(tmp_path)
    write_setup(root)
    tr = small_trainer(root, name="inpaint_preview", inpaint_mode=True, preview_steps=2)
    ds = tr.build_dataset()
    batch = tr.collate([ds[0], ds[1]])
    calls, seen = [], []

    def sampler(eps_fn, schedule, x_init, **kw):
        calls.append(kw)
        hook = tr.unet.register_forward_pre_hook(
            lambda module, args, kwargs: seen.append(kwargs["inpainting_extra"]),
            with_kwargs=True)
        try:
            eps_fn(x_init, torch.full((x_init.shape[0],), 500, dtype=torch.int32), 1.0, False)
        finally:
            hook.remove()
        return x_init

    def no_fp32_encode(*args, **kw):
        raise AssertionError("the preview encodes at the VAE's own dtype")

    monkeypatch.setattr(pipeline, "plms_sample", sampler)
    monkeypatch.setattr(tr.vae, "encode_fp32", no_fp32_encode)
    out = tr.save_preview(batch, 3)
    assert png.read_png(out)[0].shape == (2 * 2 * LATENT, 2 * 2 * LATENT, 3)
    assert len(calls) == 1 and calls[0]["mask"] is None and calls[0]["x0"] is None
    generator = torch.Generator().manual_seed(1000 + 3)
    noise = torch.randn((2, LATENT, LATENT, 4), generator=generator)
    with torch.no_grad():
        z = tr.vae.encode(torch.as_tensor(batch["image"]).to(next(tr.vae.parameters()).dtype),
                          noise).float()
    m = torch.as_tensor(batch["inpainting_mask"]).float()
    want = torch.cat([z * m, m], dim=-1)
    assert len(seen) == 1 and torch.equal(seen[0], torch.cat([want, want]))


def test_box_text_preview_draws_only_the_starting_noise(tmp_path, monkeypatch):
    """A box+text preview is what it was: ``generate`` with no inpaint input,
    its draws all from the generator seeded 1000 + it."""
    from gligen_tpu_torch.inference import pipeline

    root = str(tmp_path)
    write_setup(root)
    tr = small_trainer(root, name="box_preview", preview_steps=2)
    ds = tr.build_dataset()
    batch = tr.collate([ds[0], ds[1]])
    seen = []

    def sampler(eps_fn, schedule, x_init, **kw):
        seen.append((x_init.clone(), kw["mask"], kw["x0"]))
        return x_init

    monkeypatch.setattr(pipeline, "plms_sample", sampler)
    tr.save_preview(batch, 5)
    want = torch.randn((2, LATENT, LATENT, 4), generator=torch.Generator().manual_seed(1005))
    (x_init, mask, x0), = seen
    assert mask is None and x0 is None and torch.equal(x_init, want)


# ---- the keypoint and spatial modalities ------------------------------------
MODALITY_SETUPS = {
    # (tokenizer, downsampler, latent, catalog name, its params, adapter target)
    "keypoint": ({"target": "keypoint", "params": {"max_persons_per_image": 2, "out_dim": CTX}},
                 None, LATENT, "COCO2017Keypoint",
                 {"max_persons_per_image": 2, "prob_real_caption": 0.5, "random_flip": True}),
    # the hed and sem downsamplers fix the latent at 64^2
    "hed": ({"target": "hed", "params": {"resize_input": 64, "out_dim": CTX}},
            {"target": "hed", "params": {}}, 64, "CC3MGroundingHed",
            {"prob_use_caption": 0.5, "random_flip": True}),
    "sem": ({"target": "sem", "params": {"resize_input": 64, "in_dim": 152, "out_dim": CTX}},
            {"target": "sem", "params": {"resize_input": 256, "in_dim": 152, "out_dim": 8}}, 64,
            "ADESemantic", {"prob_use_caption": 0.5, "random_flip": True}),
}


def write_modality_setup(root, modality):
    """A small config for ``modality`` and its dataset in the reference's
    format under ``root/DATA`` (``tools/modality_data.py``); returns the
    config's path."""
    from gligen_tpu_torch.tools import modality_data

    from test_torch_modality_datasets import seeded_images

    tokenizer, downsampler, latent, name, ds_params = MODALITY_SETUPS[modality]
    rng = np.random.default_rng(41)
    images = seeded_images(rng, [(150, 180), (140, 130), (170, 140), (130, 200)])
    data = os.path.join(root, "DATA")
    if modality == "keypoint":
        modality_data.write_keypoint_tree(data, images, rng)
    elif modality == "hed":
        modality_data.write_paired_tsvs(data, images, rng, ("hed",))
    else:
        modality_data.write_sem_tree(data, images, rng)
    params = dict(UNET, grounding_tokenizer=tokenizer, image_size=latent)
    if latent != LATENT:  # a third level: attention at 16^2 tokens, not 32^2
        params.update(channel_mult=[1, 2, 2], attention_resolutions=[4])
    if downsampler is not None:
        params["grounding_downsampler"] = downsampler
    image_size = 2 * latent  # the small VAE halves
    lines = ["model:", "  target: unet", "  params:"]
    lines += [f"    {k}: {_flow(v)}" for k, v in params.items()]
    lines += [f"diffusion: {_flow({'params': dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)})}",
              f"autoencoder: {_flow({'params': dict(VAE, resolution=image_size)})}",
              f"text_encoder: {_flow({'params': CLIP})}",
              "train_dataset_names:",
              f"  {name}: {_flow(dict(ds_params, image_size=image_size))}",
              "grounding_tokenizer_input:",
              f"  target: grounding_input.{modality}_grounding_tokinzer_input.GroundingNetInput"]
    path = os.path.join(root, "small.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("modality", ["keypoint", "hed", "sem"])
def test_modality_trainer_steps_from_the_reference_format(tmp_path, monkeypatch, modality):
    """Two steps (the first at learning rate 0, the warmup's) through
    ``python -m gligen_tpu_torch.main`` from the dataset on disk: finite
    losses, trainable tensors moved, frozen ones kept; the collated batch
    equal to the JAX ``collate``'s on the same items; a latent cache refused
    for a dataset that is not a box TSV."""
    initial = {}

    class Recorded(DezeroedComponents):
        @classmethod
        def create(cls, *args, **kwargs):
            comps = DezeroedComponents.create(*args, **kwargs)
            initial.update({n: p.detach().clone() for n, p in comps.unet.named_parameters()})
            return comps

    monkeypatch.setattr(trainer, "GligenComponents", Recorded)
    root = str(tmp_path)
    write_modality_setup(root, modality)
    tr = tmain.main(main_argv(root, "--total_iters", "2", "--save_every_iters", "1000",
                              "--disable_inference_in_training", "true"))
    assert tr.run.grounding_modality == modality and tr.state.step == 2
    with open(tr._metrics_path) as f:
        assert np.isfinite(json.loads(f.readline())["loss"])
    moved = [n for n, p in tr.unet.named_parameters() if not torch.equal(p, initial[n])]
    assert moved and set(moved) <= set(tr.state.params)

    ds = tr.build_dataset()
    items = [ds[i] for i in range(len(ds))]
    port, want_fn = _collate_stubs(modality, False)
    got, want = port(items[:2]), want_fn(items[:2])
    assert sorted(got) == sorted(want)
    for key in ("image", "input_ids"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])
    assert sorted(got["grounding"]) == sorted(want["grounding"])
    for key, value in want["grounding"].items():
        assert np.array_equal(got["grounding"][key].numpy(), np.asarray(value)), key
    if modality != "keypoint":
        assert np.array_equal(got["grounding_extra"].numpy(), np.asarray(want["grounding_extra"]))
    tr.run.cached_latents = str(tmp_path / "latents")
    with pytest.raises(ValueError, match="latent-cache"):
        tr.build_dataset()


def test_bench_train_realdata_input_only_on_a_small_tsv(tmp_path, capsys):
    from gligen_tpu_torch.tools import bench_train_realdata as bench

    path = str(tmp_path / "g.tsv")
    made, = bench.main(["--tsv", path, "--make", "--rows", "4"], device="cpu")
    assert made["rows"] == 4 and "inference_images" in made["images"]
    rows = tsv.TSVFile(path)
    # the payloads are the repository's JPEG bytes, unchanged
    raw = base64.b64decode(json.loads(rows[1][1])["image"])
    assert raw == bench.JPEGS[1].read_bytes()
    rec, = bench.main(["--tsv", path, "--input_only", "--batches", "2", "--batch", "2"],
                      device="cpu")
    assert rec["metric"] == "input_pipeline_images_per_sec" and rec["value"] > 0
    assert rec["batch"] == 2 and rec["workers"] == 1 and rec["host_cores_busy"] > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == [made, rec]
