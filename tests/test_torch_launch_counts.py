"""``chip_smoke.expected_launches`` against the calls the pipeline really
makes, and ``chip_smoke.expected_train_launches`` against the calls a
train step makes (forward, remat recompute and backward), on the CPU, in
each of the smoke's configurations.

On the card each wrapper counts a launch where its tensor is on CUDA.  Here
every wrapper's device test (``on_cuda``) is replaced by one that counts
the call and answers "CPU", so the plain versions run; the norm
dispatchers' device test answers "on the card", so they route as they do
there.  The fused conv calls ``gn_affine`` on both devices, so its
statistics count as on the card.  Two latent sizes: 16 (every block fused,
W % 8 == 0 at both UNet levels) and 8 (the inner level has 16 tokens and
W = 4, so its blocks take the module path and its ResBlocks the plain
conv).
"""

import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.ops import basic, flash_attention, fused_conv, fused_norm, fused_proj
from gligen_tpu_torch.training.train_step import create_train_state, make_train_step

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(scope="module")
def small():
    comps = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu", **chip_smoke.SMALL)
    chip_smoke.dezero_(comps.unet, torch.Generator().manual_seed(2))
    return comps


def count_calls(monkeypatch, config):
    """Set ``config``'s switches and count each wrapper's device tests."""
    for name, value in chip_smoke.CONFIGS[config].items():
        monkeypatch.setenv(name, value)
    calls = collections.Counter()

    def counting(x, op):
        calls[op] += 1
        return False

    for module in (flash_attention, fused_proj, fused_norm, fused_conv):
        monkeypatch.setattr(module, "on_cuda", counting)
    monkeypatch.setattr(basic, "_on_card", lambda x: True)
    return calls


@pytest.mark.parametrize("latent", [16, 8])
@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
def test_expected_launches_match_the_calls(monkeypatch, small, config, latent):
    calls = count_calls(monkeypatch, config)

    steps, alpha = 4, [0.3, 0.0, 0.7]
    ids, uc, grounding = chip_smoke.make_request(np.random.default_rng(1), 1, 1000, 64)
    noise = np.random.default_rng(2).standard_normal((1, latent, latent, 4)).astype(np.float32)
    with torch.no_grad():
        GenerationPipeline(small).generate(ids, uc, grounding, steps=steps, alpha_stages=alpha,
                                           latent_size=latent, noise=noise)
    expected, gated, free = chip_smoke.expected_launches(small, steps, alpha, latent, config)
    assert gated + free == 5  # the peeled Heun step's two calls and three more
    assert {name: calls[name] for name in expected} == expected
    kernels = {name for name, n in expected.items() if n}
    assert {"flash_fwd", "group_norm"} <= kernels
    assert ("layer_norm" in kernels) == (config == "b")
    assert ("gn_silu_conv3x3" in kernels) == (config == "c")


@pytest.mark.parametrize("use_checkpoint", [True, False])
@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
def test_expected_train_launches_match_the_calls(monkeypatch, config, use_checkpoint):
    """One train step at the smoke's small width on 64^2 images (latent
    32): the ds1 blocks (1024 tokens) take the fused kernels with and
    without remat, the ds2 blocks (256) only without it."""
    calls = count_calls(monkeypatch, config)
    monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", "full")
    unet_config = dict(chip_smoke.SMALL["unet_config"], use_checkpoint=use_checkpoint)
    comps = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu",
                                    **dict(chip_smoke.SMALL, unet_config=unet_config))
    chip_smoke.dezero_(comps.unet, torch.Generator().manual_seed(2))
    state = create_train_state(comps.unet, warmup_steps=1)
    step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    batch = chip_smoke.train_batch(torch, np, np.random.default_rng(3), 1, 64, 1000, 64, "cpu")
    step(state, batch, generator=torch.Generator().manual_seed(4))
    expected = chip_smoke.expected_train_launches(comps, 64, config, use_checkpoint)
    assert {name: calls[name] for name in expected} == expected
    assert 0 < expected["flash_bwd_dkv"] < expected["flash_bwd_dq"]
    assert (expected["ln_matmuls"] > 0) == (config != "b")
