"""The training data path's host code and a small Trainer on the card.
The native readers and the JPEG decoder (no libjpeg) are built by ``g++``
from the checkout at first use; a JPEG row decodes as PIL's.  The CPU runs of the same code are
in ``test_torch_data.py`` and ``test_torch_trainer.py``.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_trainer_cuda.py -m gpu --noconftest -q

Tolerances: exact (bytes, pixels, restored tensors); the small train
step's loss finite.
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
