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

from gligen_tpu_torch.inference.adapters import null_input
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.ops import basic, flash_attention, fused_conv, fused_norm, fused_proj
from gligen_tpu_torch.tools import perf_probe
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


@pytest.fixture(scope="module")
def small_grounding():
    """The smoke's small models of each other tokenizer and fuser, built
    once each."""
    models = {}

    def get(model):
        if model not in models:
            unet, _, _ = chip_smoke.SMALL_GROUNDING[model]
            config = dict(chip_smoke.SMALL,
                          unet_config=dict(chip_smoke.SMALL["unet_config"], **unet))
            models[model] = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu",
                                                    **config)
            chip_smoke.dezero_(models[model].unet, torch.Generator().manual_seed(2))
        return models[model]

    return get


@pytest.mark.parametrize("latent", [16, 8])
@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
@pytest.mark.parametrize("model", sorted(chip_smoke.SMALL_GROUNDING))
def test_expected_launches_for_each_tokenizer_and_fuser(monkeypatch, small_grounding, model,
                                                        config, latent):
    """The walk for the box+text+image and keypoint tokenizers (the gatedSA
    fuser: the same launches as box+text) and for the gatedCA (module path
    inside a fused block, a fuser-free tail) and gatedSA2 fusers (module
    path, every call gated: no fuser-free tail)."""
    comps = small_grounding(model)
    calls = count_calls(monkeypatch, config)
    _, tokenizer, n_box = chip_smoke.SMALL_GROUNDING[model]
    steps, alpha = 4, [0.3, 0.0, 0.7]
    ids, uc, grounding = chip_smoke.make_request(np.random.default_rng(1), 1, 1000, 64,
                                                 tokenizer, n_box)
    noise = np.random.default_rng(2).standard_normal((1, latent, latent, 4)).astype(np.float32)
    with torch.no_grad():
        GenerationPipeline(comps).generate(ids, uc, grounding, steps=steps, alpha_stages=alpha,
                                           latent_size=latent, noise=noise)
    expected, gated, free = chip_smoke.expected_launches(comps, steps, alpha, latent, config)
    assert (gated, free) == ((5, 0) if model == "gatedSA2" else (2, 3))
    assert {name: calls[name] for name in expected} == expected
    assert ("layer_norm" in {n for n, c in expected.items() if c}) == (config == "b")


@pytest.fixture(scope="module")
def small_spatial():
    """The smoke's small model of each spatial modality, built once each."""
    models = {}

    def get(model):
        if model not in models:
            config = dict(chip_smoke.SMALL, unet_config=dict(chip_smoke.SMALL["unet_config"],
                                                             **chip_smoke.SMALL_SPATIAL[model]))
            models[model] = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu",
                                                    **config)
            chip_smoke.dezero_(models[model].unet, torch.Generator().manual_seed(2))
        return models[model]

    return get


@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
@pytest.mark.parametrize("model", sorted(chip_smoke.SMALL_SPATIAL))
def test_expected_launches_for_each_spatial_modality(monkeypatch, small_spatial, model, config):
    """A spatial request (phase 13's: the map through ``prepare_batch_for``
    and the adapter, the scenario's alpha stages) at latent 64: the UNet's
    launches as box+text's, and under FUSED_NORM both (b) ConvNeXt's 22
    LayerNorms in each of the tokenizer's two forwards."""
    comps = small_spatial(model)
    calls = count_calls(monkeypatch, config)
    steps, alpha, latent = 4, chip_smoke.SPATIAL_ALPHA[model], chip_smoke.SPATIAL_LATENT
    rng = np.random.default_rng(1)
    ids, uc, _ = chip_smoke.make_request(rng, 1, 1000, 64)
    grounding, extra = chip_smoke.spatial_request(rng, model, 1)
    noise = np.random.default_rng(2).standard_normal((1, latent, latent, 4)).astype(np.float32)
    with torch.no_grad():
        GenerationPipeline(comps).generate(ids, uc, grounding, steps=steps, alpha_stages=alpha,
                                           latent_size=latent, noise=noise,
                                           grounding_extra=extra)
    expected, gated, free = chip_smoke.expected_launches(comps, steps, alpha, latent, config)
    assert gated + free == 5 and gated > 0 and free > 0
    assert {name: calls[name] for name in expected} == expected
    assert ("layer_norm" in {n for n, c in expected.items() if c}) == (config == "b")
    calls.clear()  # the tokenizer's two forwards alone
    with torch.no_grad():
        comps.unet.grounding_tokens(grounding)
        comps.unet.grounding_tokens(null_input(grounding))
    assert calls["layer_norm"] == (2 * 22 if config == "b" else 0)
    assert not calls["flash_fwd"] and not calls["group_norm"]


@pytest.mark.parametrize("model", sorted(chip_smoke.GROUNDING_MODELS))
def test_grounding_models_are_the_configs(model):
    """Phase 12's literals are configs/flickr_text_image.yaml's and
    configs/coco2017K.yaml's model, schedule and input adapter, each
    tokenizer and adapter under a reference alias of the config's own."""
    import yaml

    from gligen_tpu_torch.inference.adapters import get_adapter
    from gligen_tpu_torch.utils.registry import GROUNDING_NETS

    path = {"text_image": "flickr_text_image.yaml", "keypoint": "coco2017K.yaml"}[model]
    cfg = yaml.safe_load((Path(__file__).resolve().parents[1] / "configs" / path).read_text())
    want = dict(cfg["model"]["params"])
    want.pop("image_size")
    got = dict(chip_smoke.GROUNDING_MODELS[model])
    tok, want_tok = got.pop("grounding_tokenizer"), want.pop("grounding_tokenizer")
    assert got == want
    assert tok["params"] == want_tok["params"] and tok["target"] != want_tok["target"]
    assert GROUNDING_NETS.get(tok["target"]) is GROUNDING_NETS.get(want_tok["target"])
    assert chip_smoke.GROUNDING_SCHEDULE == cfg["diffusion"]["params"]
    assert chip_smoke.GROUNDING_INPUTS[model] == cfg["grounding_tokenizer_input"]["target"]
    assert get_adapter(chip_smoke.GROUNDING_INPUTS[model]) is get_adapter(model)


@pytest.fixture(scope="module")
def small_inpaint():
    small = dict(chip_smoke.SMALL,
                 unet_config=dict(chip_smoke.SMALL["unet_config"], inpaint_mode=True))
    comps = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu", **small)
    chip_smoke.dezero_(comps.unet, torch.Generator().manual_seed(2))
    return comps


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
def test_expected_inpaint_launches_match_the_calls(monkeypatch, small_inpaint, config, sampler):
    """An inpaint request (the smoke's phase 10, no alpha stages) with each
    sampler: the inpaint UNet's calls and the encode's attention and
    GroupNorms (``expected_fp32``, the fp32 routes on the card)."""
    calls = count_calls(monkeypatch, config)
    latent = 16
    ids, uc, grounding, inpaint = chip_smoke.inpaint_request(
        np.random.default_rng(1), 1, 1000, 64, 2 * latent, latent)
    noise = np.random.default_rng(2).standard_normal((1, latent, latent, 4)).astype(np.float32)
    with torch.no_grad():
        GenerationPipeline(small_inpaint).generate(ids, uc, grounding, steps=4, sampler=sampler,
                                                   latent_size=latent, noise=noise, **inpaint)
    expected, gated, free = chip_smoke.expected_launches(small_inpaint, 4, None, latent, config,
                                                         sampler=sampler, inpaint=True)
    assert (gated, free) == ((5, 0) if sampler == "plms" else (4, 0))
    assert {name: calls[name] for name in expected} == expected
    fp32 = chip_smoke.expected_fp32(small_inpaint, config)
    assert fp32 == {"flash_fwd": 1, "group_norm": 10}  # every config runs the GroupNorm kernel


@pytest.mark.parametrize("use_checkpoint,policy", [(True, "full"), (False, "full"),
                                                    (True, "dots")])
@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
def test_expected_train_launches_match_the_calls(monkeypatch, config, use_checkpoint, policy):
    """One train step at the smoke's small width on 64^2 images (latent
    32): the ds1 blocks (1024 tokens) take the fused kernels with and
    without remat, the ds2 blocks (256) only without it.  Remat 'dots'
    recomputes every kernel of a block, as 'full' does: the same counts."""
    calls = count_calls(monkeypatch, config)
    monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", policy)
    unet_config = dict(chip_smoke.SMALL["unet_config"], use_checkpoint=use_checkpoint)
    comps = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu",
                                    **dict(chip_smoke.SMALL, unet_config=unet_config))
    chip_smoke.dezero_(comps.unet, torch.Generator().manual_seed(2))
    state = create_train_state(comps.unet, warmup_steps=1)
    step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    batch = chip_smoke.train_batch(torch, np, np.random.default_rng(3), 1, 64, 1000, 64, "cpu")
    step(state, batch, generator=torch.Generator().manual_seed(4))
    expected = chip_smoke.expected_train_launches(comps, 64, config, use_checkpoint, policy)
    assert {name: calls[name] for name in expected} == expected
    assert 0 < expected["flash_bwd_dkv"] < expected["flash_bwd_dq"]
    assert (expected["ln_matmuls"] > 0) == (config != "b")
    if use_checkpoint:  # the blocks' launches twice: the forward and the recompute
        once = chip_smoke.expected_train_launches(comps, 64, config, True, "none")
        assert expected["flash_fwd"] > once["flash_fwd"]


def test_expected_train_launches_without_recompute(monkeypatch):
    """Remat 'none' under ``use_checkpoint``: the blocks take the fused
    kernels from 1024 tokens, as under remat, and launch them once."""
    calls = count_calls(monkeypatch, "a")
    monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", "none")
    unet_config = dict(chip_smoke.SMALL["unet_config"], use_checkpoint=True)
    comps = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu",
                                    **dict(chip_smoke.SMALL, unet_config=unet_config))
    chip_smoke.dezero_(comps.unet, torch.Generator().manual_seed(2))
    state = create_train_state(comps.unet, warmup_steps=1)
    step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    batch = chip_smoke.train_batch(torch, np, np.random.default_rng(3), 1, 64, 1000, 64, "cpu")
    step(state, batch, generator=torch.Generator().manual_seed(4))
    expected = chip_smoke.expected_train_launches(comps, 64, "a", True, "none")
    assert {name: calls[name] for name in expected} == expected
    full = chip_smoke.expected_train_launches(comps, 64, "a", True)
    assert 0 < expected["ln_matmuls"] < full["ln_matmuls"]


@pytest.mark.parametrize("model", ["keypoint", "hed"])
def test_expected_train_launches_match_the_calls_of_the_modalities(monkeypatch, model):
    """Phase 17's models at the smoke's small width, one train step in (a)
    under remat: the keypoint tokenizer (latent 32); hed's ConvNeXt
    tokenizer and downsampler (latent 64), whose trainable first conv gives
    the first block's attn1 a gradient, so its dq and dk/dv launch too."""
    calls = count_calls(monkeypatch, "a")
    monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", "full")
    rng = np.random.default_rng(5)
    if model == "keypoint":
        extra_config, size = chip_smoke.SMALL_GROUNDING["keypoint"][0], 64
        ids, _, grounding = chip_smoke.make_request(rng, 1, 1000, 64, tokenizer="keypoint")
        extra = None
    else:
        extra_config, size = chip_smoke.SMALL_SPATIAL["hed"], 2 * chip_smoke.SPATIAL_LATENT
        ids = rng.integers(1, 999, size=(1, 77)).astype(np.int64)
        grounding, extra = chip_smoke.spatial_request(rng, "hed", 1)  # a 512^2 map
    unet_config = dict(chip_smoke.SMALL["unet_config"], **extra_config, use_checkpoint=True)
    comps = GligenComponents.create(dtype=torch.float32, seed=0, device="cpu",
                                    **dict(chip_smoke.SMALL, unet_config=unet_config))
    chip_smoke.dezero_(comps.unet, torch.Generator().manual_seed(2))
    state = create_train_state(comps.unet, input_conv_train=extra is not None, warmup_steps=1)
    step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    batch = {"image": torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(ids),
             "grounding": {k: torch.as_tensor(v) for k, v in grounding.items()}}
    if extra is not None:
        batch["grounding_extra"] = torch.as_tensor(extra)
    step(state, batch, generator=torch.Generator().manual_seed(4))
    expected = chip_smoke.expected_train_launches(comps, size, "a", use_checkpoint=True)
    assert {name: calls[name] for name in expected} == expected
    # the first block's attn1: dq and dk/dv only where the first conv trains
    blocks = expected["flash_fwd"] // 6
    assert expected["flash_bwd_dq"] == 3 * blocks - (extra is None)


def _trace(calls, records):
    """A chrome trace as torch.profiler writes it on the card: host events
    (name, correlation) and the device records (category, correlation)."""
    events = [{"ph": "M", "name": "process_name", "args": {"name": "python"}}]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": i, "dur": 1,
                "args": {"correlation": c}} for i, (n, c) in enumerate(calls)]
    events += [{"ph": "f", "cat": "ac2g", "name": "ac2g", "id": c} for _, c in calls]
    events += [{"ph": "X", "cat": cat, "name": f"{cat} {c}", "ts": 100 + c, "dur": 1,
                "args": {"correlation": c}} for cat, c in records]
    return {"traceEvents": events}


# (host calls, device records, launches counted, device records kept); the
# one-launch GroupNorm's calls as the H100 trace has them, with its record
# and without (CUPTI dropped it); the three-launch route with its first
# record dropped; a copy and a memset; synchronisations alone
_ONE = [("cudaFuncSetAttribute", 58), ("cudaFuncSetAttribute", 59),
        ("cudaLaunchKernelExC", 60), ("cudaDeviceSynchronize", 63)]
_THREE = [("cudaLaunchKernel", 7), ("cudaLaunchKernel", 8), ("cudaLaunchKernel", 9),
          ("cudaDeviceSynchronize", 10)]


@pytest.mark.parametrize("calls, records, n_calls, n_records", [
    (_ONE, [("kernel", 60)], 1, 1),
    (_ONE, [], 1, 0),
    (_THREE, [("kernel", 8), ("kernel", 9)], 3, 2),
    ([("cudaMemsetAsync", 1), ("cudaMemcpyAsync", 2), ("cuLaunchKernel", 3)],
     [("gpu_memset", 1), ("gpu_memcpy", 2), ("kernel", 3)], 3, 3),
    ([("cudaDeviceSynchronize", 1), ("cudaStreamIsCapturing", 2)], [], 0, 0),
], ids=["one_launch", "one_launch_record_dropped", "three_launch_first_dropped",
        "copy_memset_driver", "no_launch"])
def test_launch_calls_counts_the_host_calls(calls, records, n_calls, n_records):
    got_calls, got_records = perf_probe.launch_calls(_trace(calls, records))
    assert len(got_calls) == n_calls
    assert len(got_records) == n_records
    assert all(c in got_calls for c, _ in got_records)
    # the starts: each call at its index, each record at 100 + its correlation
    assert {c: ts for c, (_, ts) in got_calls.items()} == {
        c: float(i) for i, (_, c) in enumerate(calls) if c in got_calls}
    assert [ts for _, ts in got_records] == [100.0 + c for _, c in records]


def test_without_first_launches_cuts_the_warm_up():
    """``traced``'s warm-up launches leave the trace with their device
    records and flows; the call's own launches, records and other host
    events stay, whatever order the events are written in."""
    warm = [("cudaLaunchKernel", c) for c in range(1, 4)]
    sync = [("cudaDeviceSynchronize", 4)]
    own = [("cudaLaunchKernelExC", 9), ("cudaLaunchKernel", 10)]
    trace = _trace(warm + sync + own, [("kernel", c) for c in (10, 1, 2, 3, 9)])
    trace["traceEvents"].reverse()
    cut = perf_probe.without_first_launches(trace, len(warm))
    calls, records = perf_probe.launch_calls(cut)
    assert sorted(calls) == [9, 10] and sorted(c for c, _ in records) == [9, 10]
    flows = sorted(ev["id"] for ev in cut["traceEvents"] if ev.get("cat") == "ac2g")
    assert flows == [4, 9, 10]
    assert any(ev.get("name") == "cudaDeviceSynchronize" for ev in cut["traceEvents"])
    assert perf_probe.device_breakdown(cut)[2] == 2


@pytest.mark.parametrize("dropped, tries, taken", [
    ([0], 4, 1), ([2, 0], 4, 2), ([1, 1, 0], 4, 3), ([1, 1, 1, 1], 4, 4), ([3, 0], 1, 1)])
def test_first_whole_traces_again_until_no_record_is_dropped(dropped, tries, taken):
    """``first_whole``: a trace whose launch calls all have their device
    records is taken at once; one that lost records (as CUPTI now and then
    drops a call's first GroupNorm records on the H100) is taken again, at
    most ``tries`` times, and the last is returned if none is whole."""
    launches = [("cudaLaunchKernel", c) for c in range(1, 6)]
    traces = [_trace(launches, [("kernel", c) for c in range(1 + d, 6)]) for d in dropped]
    took = []

    def take():
        took.append(len(took))
        return len(took), traces[len(took) - 1]

    out, trace = perf_probe.first_whole(take, tries)
    assert len(took) == taken and out == taken and trace["takes"] == taken
    assert trace["traceEvents"] is traces[taken - 1]["traceEvents"]
    assert perf_probe.unanswered_launches(trace) == dropped[taken - 1]


@pytest.mark.parametrize("tool", ["bench_block", "bench_resblock"])
def test_bench_tools_print_the_traces_taken(tool):
    """A profiled sandbox forward says how many traces it took and how many
    launch calls of the kept one lost their device record."""
    mod = importlib.import_module(f"gligen_tpu_torch.tools.{tool}")
    result = dict(ms=1.0, tflops=1.0, blocks=1, switches={}, out_finite=True,
                  breakdown={"flash_fwd": (1.0, 3)}, takes=(2, 0), shape=(1, 8, 8, 32))
    printed = mod.lines(result)
    assert printed[1] == ("profile: traces of the forward taken 2, launch calls of the last "
                          "with no device record 0")
    assert printed[2].startswith("profile:   flash_fwd")
    assert not any("traces" in line for line in mod.lines({**result, "takes": None}))


@pytest.mark.parametrize("pieces", [1, 5])
def test_train_phases_spans_the_loss_pieces(pieces):
    """``train_phases``: the loss phase runs from the first piece of the
    "train_step.loss" device span to the end of its last (the profiler
    cut it into 5 pieces on an H100 in an fp32 step), the backward after
    it, the optimizer from its first foreach kernel on."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    step = 10.0 * pieces
    events = [x("gpu_user_annotation", "train_step.loss", 10.0 * i, 5.0) for i in range(pieces)]
    events += [x("kernel", "multi_tensor_apply_kernel<...>", step + 50.0, 1.0)]
    phase_of = perf_probe.train_phases({"traceEvents": events})
    assert phase_of(0.0, None) == "loss" and phase_of(step - 6.0, None) == "loss"
    assert phase_of(step - 5.0, None) == "backward" and phase_of(step + 49.0, None) == "backward"
    assert phase_of(step + 50.0, None) == "optimizer"
    with pytest.raises(RuntimeError, match="no device span"):
        perf_probe.train_phases({"traceEvents": events[pieces:]})
