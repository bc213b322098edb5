"""One process of the data-parallel tests of ``tests/test_torch_parallel.py``
(it imports no JAX; the launcher's variables come from the test):

  python tests/torch_dp_worker.py step SETUP OUT_DIR
      joins the gloo group, builds the setup's components on the CPU, loads
      its state dicts, takes one train step on this rank's rows of the
      setup's global batch with its global draws, and writes
      ``OUT_DIR/rank<r>.pt``: the loss, the trainable gradients and every
      UNet tensor after the step;
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
    elif sys.argv[1] == "main":
        main(sys.argv[2:])
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]!r}")
