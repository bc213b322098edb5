"""At a small width on the CPU the plain reference agrees with the
program, and the check refuses the program broken underneath: a run of
each small cell driven by the harness (the look for a card skipped).

The program in fp32 against the fp32 reference is the reference's own
test: they differ by fp32 rounding alone.  In bf16 (the configuration's
compute dtype) each small cell passes its check; with each fault of
``benchmark/faults.py`` planted, ``correct`` comes out false."""

import time

import pytest

from benchmark import faults, harness
from benchmark.tests import small

GEN = (("box_text.gen_b16_plms50", "gligen_sd14_box_text"), ("hed.gen_b32_plms50", "gligen_sd14_hed"))
TRAIN = ("box_text.train_b32", "gligen_sd14_box_text")


def run(cell, cfg, wl, fault=None, seed=20240611):
    return harness.run_cell(harness.load_benchmark(), cell, seed, 0.05, False, "cpu",
                            time.perf_counter(), cfg_override=cfg, wl_override=wl, fault=fault)


@pytest.mark.parametrize("cell,config", GEN)
def test_generation_reference_agrees_with_the_program_in_fp32(cell, config):
    cfg = small.config(config)
    cfg["program"]["compute_dtype"] = "float32"
    rec = run(cell, cfg, small.workload(cell))
    assert rec["check"]["image_mae"][0] < 1e-5
    assert max(rec["check_detail"]["max_abs"]) < 1e-4


def test_training_reference_agrees_with_the_program_in_fp32():
    cfg = small.config(TRAIN[1])
    cfg["program"]["compute_dtype"] = "float32"
    rec = run(TRAIN[0], cfg, small.train_workload())
    assert rec["check"]["loss_gap"][0] < 1e-5
    assert rec["check"]["grad_gap"][0] < 1e-4 and rec["check"]["change_gap"][0] < 1e-4


@pytest.mark.parametrize("cell,config", GEN)
def test_a_sound_small_generation_run_is_correct(cell, config):
    rec = run(cell, small.config(config), small.workload(cell))
    assert rec["correct"], rec["check"]
    res = harness.result(harness.load_benchmark(), cell, rec, False)
    assert list(res)[-1] == "check" and res["metrics"]["gen_img_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", faults.GENERATION)
def test_generation_faults_fail_the_check(fault, monkeypatch):
    import gligen_tpu_torch.inference.pipeline as pipeline

    monkeypatch.setattr(pipeline, "plms_sample", pipeline.plms_sample)
    cell, config = GEN[0]
    rec = run(cell, small.config(config), small.workload(cell), fault=fault)
    assert not rec["correct"], rec["check"]


@pytest.mark.parametrize("fault", faults.TRAINING)
def test_training_faults_fail_the_check(fault):
    rec = run(TRAIN[0], small.config(TRAIN[1]), small.train_workload(), fault=fault)
    assert not rec["correct"], rec["check"]


def test_the_control_reads_above_the_program():
    """The control (the reference in fp8 in the program's place) at the
    small size: its images lie farther from the fp32 reference than the
    bf16 program's do, by 3x or more."""
    from benchmark.traffic import gen_closed as G

    cell, config = GEN[0]
    cfg, wl = small.config(config), small.workload(cell)
    rec = run(cell, cfg, wl)
    picked = rec["check_detail"]["picked"]
    inputs = G.Inputs(cfg, wl, 20240611)
    ref = G.reference_images(cfg, wl, 20240611, inputs, picked, "cpu")
    ctl = G.reference_images(cfg, wl, 20240611, inputs, picked, "cpu", "fp8")
    control = max(float((c - r).abs().mean()) for c, r in zip(ctl, ref))
    assert control > 3 * rec["check"]["image_mae"][0]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the program's CUDA kernels")
    rec = harness.run_cell(harness.load_benchmark(), GEN[0][0], 1, 3.0, False, "cuda",
                           time.perf_counter())
    assert rec["correct"], rec["check"]
