"""One process of the data-parallel tests of ``tests/test_torch_parallel.py``
(it imports no JAX; the launcher's variables come from the test):

  python tests/torch_dp_worker.py step SETUP OUT_DIR
      joins the gloo group, builds the setup's components on the CPU, loads
      its state dicts, takes one train step on this rank's rows of the
      setup's global batch with its global draws, and writes
      ``OUT_DIR/rank<r>.pt``: the loss, the trainable gradients and every
      UNet tensor after the step;
  python tests/torch_dp_worker.py shard SETUP OUT_DIR
      the tensor-parallel and FSDP checks of ``tests/test_torch_sharding.py``
      in one launch: the setup's FSDP step over every rank (no grid), then
      a grid of the setup's ``tp`` and its TP forwards (each case a model
      and its switch settings) and its dp x tp step; writes ``OUT_DIR/rank<r>.pt`` with each
      one's loss, full (gathered) gradients and trainable tensors, outputs
      and fused-helper counts;
  python tests/torch_dp_worker.py main ARGS...
      ``gligen_tpu_torch.main.main(ARGS)`` with de-zeroed components (a
      fresh model's zero output conv blocks every gradient) and without
      TensorBoard (its import alone takes seconds; metrics.jsonl is the
      record the test reads).
"""

import os
import sys

import torch

torch.set_num_threads(1)


def step(setup_path: str, out_dir: str) -> None:
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.parallel import mesh as dp
    from gligen_tpu_torch.training.train_step import create_train_state, make_train_step

    setup = torch.load(setup_path, weights_only=False)
    device = dp.init_process_group("cpu")
    try:
        comps = GligenComponents.create(unet_config=setup["unet_config"], dtype=torch.float32,
                                        vae_config=setup["vae_config"],
                                        text_config=setup["text_config"], device=device)
        for name in ("unet", "vae", "text_encoder"):
            getattr(comps, name).load_state_dict(setup["state"][name])
        state = create_train_state(comps.unet, base_lr=1e-4, warmup_steps=0, total_steps=10)
        train_step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
        rows = dp.process_batch_slice(setup["batch"]["input_ids"].shape[0])
        local = {k: ({g: x[rows] for g, x in v.items()} if isinstance(v, dict) else v[rows])
                 for k, v in setup["batch"].items()}
        loss = train_step(state, local, draws=setup["draws"])["loss"]
        torch.save({"loss": float(loss),
                    "grads": {n: p.grad.clone() for n, p in state.params.items()},
                    "unet": {n: t.clone() for n, t in comps.unet.state_dict().items()}},
                   os.path.join(out_dir, f"rank{dp.process_index()}.pt"))
    finally:
        dp.destroy_process_group()


def _count_fused():
    """Count the calls of the fused helpers (``models/layers.py``'s
    ``_fused_*``, ``ResBlock._fused``); returns the counts and an undo."""
    from gligen_tpu_torch.models import layers, unet

    counts = {}
    real = {name: getattr(layers, name)
            for name in ("_fused_self_attn", "_fused_cross_attn", "_fused_ff")}
    real_conv = unet.ResBlock._fused

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    for name, fn in real.items():
        setattr(layers, name, counted(name, fn))
    unet.ResBlock._fused = counted("conv", real_conv)

    def undo():
        for name, fn in real.items():
            setattr(layers, name, fn)
        unet.ResBlock._fused = real_conv

    return counts, undo


def _sharded_step(setup, fsdp: bool):
    """One train step of the setup's model on this rank's rows with the
    global draws: FSDP over every rank, or TP over the grid."""
    from gligen_tpu_torch.convert.from_jax import load_jax_params
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.parallel import fsdp as zero
    from gligen_tpu_torch.parallel import mesh as dp
    from gligen_tpu_torch.parallel.sharding import shard_unet_
    from gligen_tpu_torch.training.train_step import (create_train_state, full_tensors,
                                                      make_train_step)

    comps = GligenComponents.create(unet_config=setup["unet_config"], dtype=torch.float32,
                                    vae_config=setup["vae_config"],
                                    text_config=setup["text_config"], device="cpu")
    if not fsdp:
        shard_unet_(comps.unet, dp.tensor_parallel())
    load_jax_params(comps, setup["params"])
    if fsdp:
        zero.shard_unet_(comps.unet)
    state = create_train_state(comps.unet, base_lr=setup["lr"], warmup_steps=0, total_steps=10)
    train_step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    rows = dp.process_batch_slice(setup["batch"]["input_ids"].shape[0])
    local = {k: ({g: x[rows] for g, x in v.items()} if isinstance(v, dict) else v[rows])
             for k, v in setup["batch"].items()}
    counts, undo = _count_fused()
    try:
        loss = float(train_step(state, local, draws=setup["draws"])["loss"])
    finally:
        undo()
    return {"loss": loss, "counts": counts,
            "grads": full_tensors(comps.unet, {n: p.grad for n, p in state.params.items()}),
            "params": full_tensors(comps.unet, state.params),
            "resident": sum(p.numel() for p in comps.unet.parameters())}


def _tp_forwards(cases, tp):
    """Each case's TP UNet forward under its switch settings (a model
    sharded once, by name)."""
    from gligen_tpu_torch.convert.from_jax import load_module_from_jax
    from gligen_tpu_torch.models.unet import UNetModel
    from gligen_tpu_torch.parallel.sharding import shard_unet_

    unets, out = {}, {}
    for name, case in cases.items():
        if case["model"] not in unets:
            unet = UNetModel(**case["unet_config"])
            shard_unet_(unet, tp)
            load_module_from_jax(unet, case["params"])
            unets[case["model"]] = unet
        os.environ.update(case["switches"])
        counts, undo = _count_fused()
        try:
            with torch.no_grad():
                y = unets[case["model"]](*case["args"], case["grounding"], gate_scale=0.6)
        finally:
            undo()
        out[name] = {"out": y, "counts": counts}
    return out


def shard(setup_path: str, out_dir: str) -> None:
    from gligen_tpu_torch.parallel import mesh as dp

    setup = torch.load(setup_path, weights_only=False)
    dp.init_process_group("cpu")
    try:
        out = {}
        if "fsdp" in setup:
            out["fsdp"] = _sharded_step(setup["fsdp"], fsdp=True)
        grid = dp.init_grid(setup["tp"])
        if "forward" in setup:
            out["forward"] = _tp_forwards(setup["forward"], grid.tp)
        if "tp_step" in setup:
            out["tp_step"] = _sharded_step(setup["tp_step"], fsdp=False)
        torch.save(out, os.path.join(out_dir, f"rank{dp.process_index()}.pt"))
    finally:
        dp.destroy_process_group()


def main(argv) -> None:
    from gligen_tpu_torch import main as train_main
    from gligen_tpu_torch.inference import cli
    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.training import trainer

    class Dezeroed(GligenComponents):
        @classmethod
        def create(cls, *args, **kwargs):
            comps = GligenComponents.create(*args, **kwargs)
            with torch.no_grad():
                cli.dezero_(comps.unet)
            return comps

    trainer.GligenComponents = Dezeroed
    sys.modules["torch.utils.tensorboard"] = None
    train_main.main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "step":
        step(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "shard":
        shard(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "main":
        main(sys.argv[2:])
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]!r}")
