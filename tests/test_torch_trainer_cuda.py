"""The training data path's host code and a small Trainer on the card.
The native readers and the JPEG decoder (no libjpeg) are built by ``g++``
from the checkout at first use; a JPEG row decodes as PIL's.  The CPU runs of the same code are
in ``test_torch_data.py`` and ``test_torch_trainer.py``.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_trainer_cuda.py -m gpu --noconftest -q

Tolerances: exact (bytes, pixels, restored tensors); the small train
step's loss finite; the small fp32 step against the CPU's as
``chip_smoke.FP32_TRAIN_*`` state.
"""

import json
import os

import numpy as np
import pytest
import torch

from gligen_tpu_torch.data import jpeg, native, tsv
from gligen_tpu_torch.training import checkpoints as ckpt_io
from gligen_tpu_torch.training import trainer

pytestmark = pytest.mark.gpu

# a 4 x 4 JPEG (quality 95) and the sum of its decoded RGB pixels
JPEG_4X4_SUM = 5825


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Trainer runs the CUDA kernels, which have no CPU "
                    "mode")
    return torch.device("cuda")


def test_native_tsv_reader_builds_from_the_checkout(cuda, tmp_path):
    path = str(tmp_path / "d.tsv")
    w = tsv.TSVWriter(path)
    for i in range(5):
        w.write([i, "x" * (i + 1)])
    w.close()
    reader = native.NativeTSV(path, str(tmp_path / "d.lineidx"))
    assert native.library_path("tsv_reader").exists()
    with open(path, "rb") as f:
        assert [reader.read_row(i) for i in range(5)] == f.read().splitlines(keepends=True)
    assert tsv.TSVFile(path)._ensure_native() is not None


def test_jpeg_decodes_or_raises_naming_libjpeg(cuda):
    """The port's own decoder (no libjpeg) builds on the card's machine and
    decodes a JPEG row as PIL does."""
    import chip_smoke

    jpeg.jpeg_library()
    pixels = tsv.decode_base64_image(chip_smoke.JPEG_4X4)
    assert pixels.shape == (4, 4, 3) and int(pixels.astype(np.int64).sum()) == JPEG_4X4_SUM


SMALL = {
    "model": {"target": "unet", "params": dict(
        image_size=8, in_channels=4, out_channels=4, model_channels=64,
        attention_resolutions=[1], num_res_blocks=1, channel_mult=[1, 2], num_heads=2,
        context_dim=64, fuser_type="gatedSA",
        grounding_tokenizer={"target": "text", "params": {"in_dim": 768, "out_dim": 64}})},
    "diffusion": {"params": {"timesteps": 1000, "linear_start": 0.00085, "linear_end": 0.012}},
    "autoencoder": {"params": dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, resolution=16)},
    "text_encoder": {"params": dict(vocab_size=49408, hidden_size=64, layers=1, heads=2)},
}


class Items:
    """Box items of the dataset's format, seeded."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"id": i, "caption": f"scene {i}",
                "image": rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32),
                "boxes": rng.random((5, 4)).astype(np.float32),
                "masks": (rng.random(5) > 0.3).astype(np.float32),
                "text_embeddings": rng.standard_normal((5, 768)).astype(np.float32)}


def test_small_trainer_trains_saves_and_resumes_on_the_card(cuda, tmp_path):
    run = trainer.TrainerConfig(output_root=str(tmp_path), batch_size=2, warmup_steps=1,
                                total_iters=3, save_every_iters=2, log_every_iters=1,
                                enable_ema=True)
    tr = trainer.Trainer(SMALL, run, device=cuda)
    state = tr.start_training(dataset=Items())
    assert state.step == 3
    with open(os.path.join(tr.tag_dir, "metrics.jsonl")) as f:
        assert all(np.isfinite(json.loads(line)["loss"]) for line in f)
    saved = ckpt_io.restore_training_checkpoint(ckpt_io.latest_checkpoint(tr.tag_dir))
    again = trainer.Trainer(SMALL, run, device=cuda)
    assert again.starting_iter == 3 and again.tag_dir == tr.tag_dir
    for name, p in again.state.params.items():
        assert torch.equal(p.detach().cpu(), saved["train_params"][name])
        assert torch.equal(again.state.ema_params[name].cpu(), saved["ema_params"][name])


def test_small_fp32_train_step_matches_the_cpu(cuda, monkeypatch):
    """Fault F9: one train step of a model in fp32 on the card (every
    kernel on its fp32 route, the flash backward's fp32 kernels among them;
    TF32 off) against the CPU's fp32 plain step, same weights, batch and
    draws (chip_smoke.py phase 8's fp32 row): the loss within 1e-4
    relative, each trainable gradient within 1e-3 relative L2, each fuser
    gate's within 1e-2 of itself plus 1e-3 of the largest
    (chip_smoke.FP32_TRAIN_*: the same fp32 arithmetic summed in other
    orders, each kernel within 1e-4 of its largest output)."""
    import chip_smoke
    from gligen_tpu_torch.ops import flash_attention as fa

    for name, value in dict(chip_smoke.CONFIGS["a"], GLIGEN_TPU_REMAT_POLICY="full").items():
        monkeypatch.setenv(name, value)
    before = (fa.flash_bwd_dq.routes["fp32"], fa.flash_bwd_dkv.routes["fp32"])
    ok, lines = chip_smoke.train_reference(torch, np, 0, cuda, True, dtype=torch.float32)
    assert ok, "\n".join(lines)
    assert fa.flash_bwd_dq.routes["fp32"] > before[0]
    assert fa.flash_bwd_dkv.routes["fp32"] > before[1]


def test_small_dots_train_step_equals_full_on_the_card(cuda, monkeypatch):
    """Remat 'dots' on the card (configuration (a), the smoke's small width
    at 64^2: the ds1 blocks take the fused kernels, launched through
    ctypes below the dispatcher): the loss and every trainable gradient
    equal 'full''s on the same weights, batch and draws (within
    chip_smoke.TRAIN_*, expected to the bit), and each kernel of a block
    launches twice a step under both, once under 'none'."""
    import chip_smoke
    from gligen_tpu_torch.inference.pipeline import GligenComponents

    for name, value in chip_smoke.CONFIGS["a"].items():
        monkeypatch.setenv(name, value)
    config = dict(chip_smoke.SMALL, unet_config=dict(chip_smoke.SMALL["unet_config"],
                                                     use_checkpoint=True))
    comps = GligenComponents.create(dtype=torch.bfloat16, seed=0, device=cuda, **config)
    chip_smoke.dezero_(comps.unet, torch.Generator(device=cuda).manual_seed(2))
    rng = np.random.default_rng(7)
    data = chip_smoke.train_batch(torch, np, rng, 2, 64, 1000, 64, "cpu")
    shape = (2, 32, 32, 4)
    draws = {"posterior": rng.standard_normal(shape), "u_t": rng.random(2),
             "noise": rng.standard_normal(shape), "u_drop": 0.5}
    wrappers = chip_smoke.kernel_wrappers()
    got, launches = {}, {}
    for policy in ("full", "dots", "none"):
        monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", policy)
        for w in wrappers.values():
            w.launches = 0
        got[policy] = chip_smoke.train_grads(torch, comps, cuda, data, draws)
        launches[policy] = {n: w.launches for n, w in wrappers.items()}
    (loss_f, g_f), (loss_d, g_d) = got["full"], got["dots"]
    assert abs(loss_d - loss_f) <= chip_smoke.TRAIN_LOSS_RTOL * abs(loss_f)
    for name, g in g_f.items():
        assert (g_d[name] - g).norm() <= chip_smoke.TRAIN_GRAD_RTOL * g.norm(), name
    assert launches["dots"] == launches["full"]
    for name in ("flash_fwd", "ln_matmuls", "matmul_residual", "ln_geglu"):
        assert launches["none"][name] < launches["full"][name], name
