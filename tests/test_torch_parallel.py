"""Data parallelism of the port (``gligen_tpu_torch/parallel/mesh.py``) on
the CPU:

  * the mesh helpers: row slices, local batches, padding, the backend rule;
  * ``GenerationPipeline(mesh=make_mesh(["cpu", "cpu"]))`` gives the
    one-device call's images at batch 1 and 3 (padded to 2 and 4), with the
    generator's draws and with injected noise: atol 1e-5, the same fp32
    arithmetic on row blocks of another size;
  * the server's buckets and warmup shapes round up to mesh multiples (the
    counterparts of ``tests/test_serving_data_parallel.py:61-93``);
  * a two-process gloo train step at small width: its loss (the global
    mean) within 1e-5 relative of the one-process step on the global batch
    with the same draws, its averaged gradients within 2e-4 of each
    tensor's largest entry (``test_torch_train_step.py``'s tolerance), the
    ranks' parameters bit for bit equal, and the loss within 1e-5 of the
    JAX step's on the global batch;
  * ``main --multihost`` over two gloo processes: only rank 0 writes the
    metrics and the checkpoints, and a second launch resumes on both ranks;
  * ``dryrun_train_step`` over two processes: data parallel, tp = 2 and
    FSDP (``tests/test_torch_sharding.py`` holds TP and FSDP to the
    one-process step); TP and FSDP under remat 'dots' give the 'full'
    step bit for bit.

The worker processes (``tests/torch_dp_worker.py``) import no JAX; each
launch has a timeout of its own.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gligen_tpu_torch.data.tokenizer import HashTokenizer
from gligen_tpu_torch.inference import cli
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.parallel import mesh as dp
from gligen_tpu_torch.serving.server import MicroBatcher, ServingSession
from gligen_tpu_torch.training import train_step as tts

from test_torch_modules import CLIP, LATENT, UNET, VAE, grounding_inputs
from test_torch_serving import _StubPipeline
from test_torch_train_step import (GRAD_RTOL, LOSS_RTOL, TINY_CLIP, TINY_UNET, TINY_VAE,
                                   jax_reference, jax_setup, port_batch,
                                   port_components)  # noqa: F401 (fixtures)
from test_torch_trainer import write_setup

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_dp_worker.py")
LAUNCH_TIMEOUT = 120


# ---------------------------------------------------------------- helpers

def test_mesh_helpers():
    mesh = dp.make_mesh(["cpu", "cpu", torch.device("cpu")])
    assert mesh.size == 3 and mesh.distinct() == (torch.device("cpu"),)
    assert [dp.padded_rows(b, mesh) for b in (1, 3, 4, 7)] == [3, 3, 6, 9]
    assert dp.padded_rows(5, None) == 5
    x = torch.arange(6.0).reshape(3, 2)
    padded = dp.pad_rows(x, 5)
    assert padded.shape == (5, 2) and torch.equal(padded[3:], x[-1:].expand(2, 2))
    assert dp.pad_rows(x, 3) is x
    blocks = dp.shard_batch(mesh, {"a": torch.arange(6), "g": {"b": np.ones((6, 2))}})
    assert [b["a"].tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5]]
    assert all(b["g"]["b"].shape == (2, 2) for b in blocks)
    with pytest.raises(ValueError, match="not divisible"):
        dp.shard_batch(mesh, {"a": torch.arange(4)})
    # no group: one process holds the whole batch
    assert dp.world_size() == 1 and dp.is_process_zero()
    assert dp.process_batch_slice(4) == slice(0, 4)
    assert dp.local_batch_size(6, mesh) == 2 and dp.local_batch_size(6) == 6
    with pytest.raises(ValueError):
        dp.local_batch_size(4, mesh)
    assert dp.host_any(True) and not dp.host_any(False)
    assert dp.broadcast_object(("x", None)) == ("x", None)


def test_backend_rule_and_no_quiet_fallback(monkeypatch):
    assert dp.backend_for("cuda", 4, 4) == "nccl"
    assert dp.backend_for("cuda", 2, 1) == "gloo"  # two ranks share a card
    assert dp.backend_for("cpu", 2, 0) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dp.make_mesh()
        with pytest.raises(RuntimeError, match="not a card"):
            dp.make_mesh(["cuda:0"])
        for key, val in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                             MASTER_PORT="1").items():
            monkeypatch.setenv(key, val)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dp.init_process_group("cuda")


def test_replicate_shares_one_copy_per_device():
    module = torch.nn.Linear(2, 2)
    mesh = dp.make_mesh(["cpu", "cpu"])
    assert dp.replicate(mesh, module) == (module, module)


# ---------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def small_components():
    comps = GligenComponents.create(unet_config=UNET, dtype=torch.float32, vae_config=VAE,
                                    text_config=CLIP, device="cpu", seed=5)
    with torch.no_grad():
        cli.dezero_(comps.unet)
    return comps


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("draws", ["generator", "noise"])
def test_mesh_pipeline_rows_equal_one_device(small_components, batch, draws):
    rng = np.random.default_rng(batch)
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(batch, 77)).astype(np.int32)
    uc = np.full((batch, 77), CLIP["vocab_size"] - 1, np.int32)
    grounding = grounding_inputs(rng, batch)
    kw = dict(steps=3, guidance_scale=7.5, alpha_stages=[0.3, 0.0, 0.7], latent_size=LATENT)
    if draws == "noise":
        kw["noise"] = rng.standard_normal((batch, LATENT, LATENT, 4)).astype(np.float32)

    def run(mesh):
        pipe = GenerationPipeline(small_components, mesh=mesh)
        gen = torch.Generator().manual_seed(11) if draws == "generator" else None
        return pipe.generate(ids, uc, grounding, generator=gen, **kw)

    want = run(None)
    got = run(dp.make_mesh(["cpu", "cpu"]))
    assert got.shape == want.shape == (batch, 2 * LATENT, 2 * LATENT, 3)
    assert float(want.std()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def inpaint_components():
    comps = GligenComponents.create(unet_config=dict(UNET, inpaint_mode=True),
                                    dtype=torch.float32, vae_config=VAE, text_config=CLIP,
                                    device="cpu", seed=6)
    with torch.no_grad():
        cli.dezero_(comps.unet)
    return comps


@pytest.mark.parametrize("sampler", ["plms", "ddim"])
def test_mesh_inpainting_rows_equal_one_device(inpaint_components, sampler):
    """An inpainting call's three kinds of draws (the encode's posterior
    noise, the starting noise, each step's blend noise) give the mesh the
    one-device rows; 7 steps run 8 sampler steps (c = T // S), each with a
    blend draw of its own."""
    batch = 3
    rng = np.random.default_rng(7)
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(batch, 77)).astype(np.int32)
    uc = np.full((batch, 77), CLIP["vocab_size"] - 1, np.int32)
    grounding = grounding_inputs(rng, batch)
    image = rng.uniform(-1, 1, (batch, 2 * LATENT, 2 * LATENT, 3)).astype(np.float32)
    mask = np.zeros((batch, LATENT, LATENT, 1), np.float32)
    mask[:, : LATENT // 2] = 1.0

    def run(mesh):
        pipe = GenerationPipeline(inpaint_components, mesh=mesh)
        return pipe.generate(ids, uc, grounding, steps=7, sampler=sampler, latent_size=LATENT,
                             inpaint_image=image, inpaint_mask=mask,
                             generator=torch.Generator().manual_seed(13))

    want = run(None)
    got = run(dp.make_mesh(["cpu", "cpu"]))
    assert got.shape == want.shape == (batch, 2 * LATENT, 2 * LATENT, 3)
    assert float(want.std()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_draw_noise_draws_one_tensor_per_step():
    """The blend noise is ``steps`` draws of the rows' shape after the
    encode's and the starting noise, as the sampler would draw them one
    step at a time; injected draws are kept and consume nothing."""
    from gligen_tpu_torch.inference.pipeline import draw_noise

    shape, dev = (2, 4, 4, 4), torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    want = [torch.randn(shape, generator=gen) for _ in range(5)]
    noise, enc, blend = draw_noise(torch.Generator().manual_seed(3), dev, shape, 3, True)
    assert torch.equal(enc, want[0]) and torch.equal(noise, want[1])
    assert blend.shape == (3,) + shape and torch.equal(blend, torch.stack(want[2:]))
    given = torch.zeros(shape)
    noise, enc, blend = draw_noise(torch.Generator().manual_seed(3), dev, shape, 3, False,
                                   noise=given)
    assert noise is given and enc is None and blend is None


def test_mesh_over_two_devices_runs_a_thread_per_device(small_components, monkeypatch):
    """A mesh of two distinct devices (``cpu`` and ``cpu:0``: equal storage,
    distinct mesh keys) takes the multi-card branch: a replica copied to
    the second device, a thread per device, the blocks gathered in order
    on the first device.  Its rows equal the one-device call's."""
    import gligen_tpu_torch.inference.pipeline as pl

    seen = []
    real = pl._generate_rows

    def spy(c, dev, **kw):
        seen.append((threading.current_thread().name, dev, c.unet))
        return real(c, dev, **kw)

    batch = 3
    rng = np.random.default_rng(4)
    ids = rng.integers(1, CLIP["vocab_size"] - 1, size=(batch, 77)).astype(np.int32)
    uc = np.full((batch, 77), CLIP["vocab_size"] - 1, np.int32)
    grounding = grounding_inputs(rng, batch)
    kw = dict(steps=3, latent_size=LATENT)
    want = GenerationPipeline(small_components).generate(
        ids, uc, grounding, generator=torch.Generator().manual_seed(9), **kw)
    mesh = dp.make_mesh(["cpu", "cpu:0"])
    assert mesh.distinct() == (torch.device("cpu"), torch.device("cpu", 0))
    pipe = GenerationPipeline(small_components, mesh=mesh)
    monkeypatch.setattr(pl, "_generate_rows", spy)
    got = pipe.generate(ids, uc, grounding, generator=torch.Generator().manual_seed(9), **kw)
    assert sorted((str(d) for _, d, _ in seen)) == ["cpu", "cpu:0"]
    assert len({name for name, _, _ in seen}) == 2
    assert len({id(unet) for _, _, unet in seen}) == 2
    assert got.device == torch.device("cpu") and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_run_per_device_orders_results_by_block():
    from concurrent.futures import ThreadPoolExecutor

    from gligen_tpu_torch.inference.pipeline import run_per_device

    mesh = dp.make_mesh(["cpu:0", "cpu", "cpu:0", "cpu"])
    with ThreadPoolExecutor(2) as pool:
        got = run_per_device(mesh, pool, lambda i: (i, threading.current_thread().name))
    assert [i for i, _ in got] == [0, 1, 2, 3]
    # a device's blocks run in order in one thread
    assert got[0][1] == got[2][1] and got[1][1] == got[3][1]


def test_mesh_pipeline_pads_every_row_input(small_components, monkeypatch):
    """Every batch-leading input reaches each block padded by its last row:
    batch 3 over 2 replicas runs blocks of 2, the last repeating row 2."""
    import gligen_tpu_torch.inference.pipeline as pl

    seen = []
    real = pl._generate_rows

    def spy(c, dev, **kw):
        seen.append({k: v for k, v in kw.items() if isinstance(v, torch.Tensor)})
        return real(c, dev, **kw)

    monkeypatch.setattr(pl, "_generate_rows", spy)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 60, size=(3, 77)).astype(np.int32)
    noise = torch.randn(3, LATENT, LATENT, 4)
    pipe = GenerationPipeline(small_components, mesh=dp.make_mesh(["cpu", "cpu"]))
    out = pipe.generate(ids, ids, grounding_inputs(rng, 3), steps=1, latent_size=LATENT,
                        noise=noise)
    assert out.shape[0] == 3 and len(seen) == 2
    assert [s["input_ids"].shape[0] for s in seen] == [2, 2]
    assert torch.equal(seen[1]["noise"], torch.stack([noise[2], noise[2]]))
    assert torch.equal(seen[1]["input_ids"][1], seen[1]["input_ids"][0])


# ---------------------------------------------------------------- serving

def _meshed_stub(n):
    pipe = _StubPipeline()
    pipe.mesh = dp.make_mesh(["cpu"] * n)
    pipe.calls = []
    real = pipe.generate

    def generate(ids, uc_ids, grounding, **kw):
        pipe.calls.append(ids.shape[0])
        return real(ids, uc_ids, grounding, **kw)

    pipe.generate = generate
    return pipe


def test_buckets_round_up_to_mesh_multiples():
    batcher = MicroBatcher(_meshed_stub(8), threading.Lock(), window_ms=1, buckets=(1, 2, 4, 8))
    try:
        # 1/2/4/8 all pad to the same 8-row call on an 8-device mesh: dedupe
        assert batcher.buckets == (8,) and batcher.max_images >= 8
    finally:
        batcher.close()
    batcher4 = MicroBatcher(_meshed_stub(4), threading.Lock(), window_ms=1, buckets=(1, 2, 4, 8))
    try:
        assert batcher4.buckets == (4, 8)
    finally:
        batcher4.close()


def test_buckets_unchanged_without_mesh():
    batcher = MicroBatcher(_StubPipeline(), threading.Lock(), window_ms=1, buckets=(1, 2, 4, 8))
    try:
        assert batcher.buckets == (1, 2, 4, 8)
    finally:
        batcher.close()


def test_warmup_shapes_are_mesh_multiples():
    pipe = _meshed_stub(8)
    session = ServingSession(pipe, HashTokenizer())
    session.warmup(buckets=(1, 8), resolutions=(512,))
    assert session.ready, session.warmup_error
    # (1, 8) rounds to {8}: one warmup call, at the shape requests run
    assert pipe.calls == [8], pipe.calls


def test_batcher_pads_small_batch_to_mesh_bucket():
    pipe = _meshed_stub(8)
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=30)
    try:
        out = session.generate({"prompt": "p", "phrases": ["x"], "locations": [[0, 0, 1, 1]],
                                "batch_size": 3})
    finally:
        session.close()
    assert pipe.calls == [8]          # padded to the mesh-wide bucket
    assert len(out["images"]) == 3    # the caller still gets exactly 3


# ---------------------------------------------------------------- processes

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world=2, cwd=None):
    """``python tests/torch_dp_worker.py ARGS`` as ``world`` gloo ranks on
    the CPU; returns each rank's (returncode, stdout + stderr)."""
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, WORKER, *args], cwd=cwd or REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=LAUNCH_TIMEOUT)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (code, text) in enumerate(out):
        assert code == 0, f"rank {rank} exited {code}:\n{text[-3000:]}"
    return out


def test_two_process_train_step_equals_the_one_process_step(jax_setup, jax_reference,
                                                            tmp_path):
    """Global batch 2 split 1 + 1 over two gloo processes, the JAX draws of
    the global batch passed to every rank."""
    jax_loss, jax_grads, draws = jax_reference("image", 0.1)
    params, batch = jax_setup[3], port_batch(jax_setup[5], "image")
    comps = port_components(params, use_checkpoint=True)
    setup = {"unet_config": dict(TINY_UNET, use_checkpoint=True), "vae_config": TINY_VAE,
             "text_config": TINY_CLIP, "batch": batch,
             "draws": {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()},
             "state": {n: getattr(comps, n).state_dict()
                       for n in ("unet", "vae", "text_encoder")}}
    torch.save(setup, tmp_path / "setup.pt")
    launch(["step", str(tmp_path / "setup.pt"), str(tmp_path)])

    state = tts.create_train_state(comps.unet, base_lr=1e-4, warmup_steps=0, total_steps=10)
    step = tts.make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    loss = float(step(state, batch, draws=setup["draws"])["loss"])
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["loss"], jax_loss, rtol=LOSS_RTOL)
    for name, p in state.params.items():
        got, want = ranks[0]["grads"][name], p.grad
        assert torch.equal(got, ranks[1]["grads"][name]), name
        scale = max(float(want.abs().max()), 1e-12)
        assert float((got - want).abs().max()) <= GRAD_RTOL * scale, name
        jax_grad = jax_grads[name].T if got.dim() == 2 else jax_grads[name]  # Dense (I, O)
        np.testing.assert_allclose(got.numpy(), jax_grad, rtol=0, err_msg=name,
                                   atol=GRAD_RTOL * float(np.abs(jax_grad).max()))
    live = comps.unet.state_dict()
    for name, tensor in ranks[0]["unet"].items():
        assert torch.equal(tensor, ranks[1]["unet"][name]), name
        if name not in state.params:  # frozen: the one-process tensor, bit for bit
            assert torch.equal(tensor, live[name]), name


def test_main_multihost_writes_on_rank_zero_and_resumes(tmp_path):
    root = str(tmp_path)
    write_setup(root, flip=False, caption=1.0)
    argv = ["main", "--multihost", "--yaml_file", os.path.join(root, "small.yaml"),
            "--DATA_ROOT", os.path.join(root, "DATA"), "--OUTPUT_ROOT",
            os.path.join(root, "OUT"), "--device", "cpu", "--dtype", "float32",
            "--batch_size", "1", "--warmup_steps", "1", "--save_every_iters", "1",
            "--name", "dp", "--disable_inference_in_training", "true"]
    first = launch(argv + ["--total_iters", "2"])
    base = os.path.join(root, "OUT", "dp")
    assert os.listdir(base) == ["tag00"]
    tag = os.path.join(base, "tag00")
    with open(os.path.join(tag, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["iter"] for r in logged] == [0] and np.isfinite(logged[0]["loss"])
    names = set(os.listdir(tag))
    assert {"checkpoint_00000002", "checkpoint_latest"} <= names
    assert not any(n.startswith("checkpoint_00000001") for n in names)
    assert all("resumed" not in text for _, text in first)

    second = launch(argv + ["--total_iters", "3"])
    assert os.listdir(base) == ["tag00"]
    for _, text in second:
        assert "at iter 2" in text, text[-2000:]
    assert "checkpoint_00000003" in os.listdir(tag)
    with open(os.path.join(tag, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 1  # iter 2 is no logging step: rank 1 wrote nothing


SHARDED_DRYRUNS = {"tp": dict(tp=2), "fsdp": dict(fsdp=True)}


@pytest.fixture(scope="module")
def sharded_dryruns():
    """``dryrun_train_step(2, ...)`` under TP = 2 and FSDP, remat 'full'
    (the default), each run once for the module."""
    saved = os.environ.pop("GLIGEN_TPU_REMAT_POLICY", None)
    try:
        return {name: tts.dryrun_train_step(2, **kw) for name, kw in SHARDED_DRYRUNS.items()}
    finally:
        if saved is not None:
            os.environ["GLIGEN_TPU_REMAT_POLICY"] = saved


def test_dryrun_train_step_over_two_processes(sharded_dryruns):
    got = tts.dryrun_train_step(2)
    assert len(got["losses"]) == 2 and len(set(got["digests"])) == 1
    for kw, sharded in sharded_dryruns.items():
        assert len(sharded["losses"]) == 2 and len(set(sharded["losses"])) == 1, kw
        assert len(set(sharded["digests"])) == 1, kw


def test_dryrun_train_step_under_dots_equals_full(sharded_dryruns, monkeypatch):
    """Remat 'dots' (the ranks inherit the environment) over TP = 2 and
    FSDP: TP's collectives and FSDP's per-block gathers are recomputed,
    the 2-D products saved, and the step is the 'full' step's: the same
    loss and the same trainable tensors after it, bit for bit."""
    monkeypatch.setenv("GLIGEN_TPU_REMAT_POLICY", "dots")
    for name, kw in SHARDED_DRYRUNS.items():
        got = tts.dryrun_train_step(2, **kw)
        assert got == sharded_dryruns[name], name
