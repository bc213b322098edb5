"""The GLIGEN training step (counterpart of
``gligen_tpu/training/train_step.py``).

The selective-trainability rule (trainer.py:217-242): only the gated
fusers inside transformer blocks, the grounding tokenizer
(``position_net``), the grounding downsampler and, when the input conv was
widened, the first conv's weight train.  Every other UNet parameter gets
``requires_grad_(False)``, so the frozen 860 M parameters never get a
gradient buffer or an Adam moment; the VAE and the text encoder run under
``torch.no_grad()``.

Randomness is explicit: the VAE's posterior noise, the timesteps' uniform
draws, the diffusion noise and the whole-batch grounding drop's uniform
draw come, in that order, from a ``torch.Generator`` on the parameters'
device, or from a ``draws`` dict with the keys of ``DRAW_KEYS``.  Torch's
generators give other numbers than ``jax.random``, so the tests pass the
JAX package's draws through ``draws``.

PyTorch runs eagerly, so where the JAX package jits a pure step function,
``make_train_step`` returns a function that updates a ``TrainState`` in
place and returns the loss as a device tensor (no host synchronisation).

Data parallelism (``parallel/mesh.py``): in a process group each process
holds its rows of the global batch.  Every process draws the global
batch's posterior noise, timesteps and diffusion noise from the same
seeded generator (or takes the global ``draws``) and keeps its own rows;
the grounding drop's one draw is the same everywhere.  After ``backward``
the trainable gradients and the loss are averaged over the group, so that
every rank takes the same AdamW step, the step of one process on the
global batch, as JAX's jitted global step does by construction.

Tensor parallelism and FSDP (``parallel/sharding.py``, ``parallel/fsdp.py``,
over the grid of ``mesh.init_grid``): the draws cover the DP batch (the
local rows times the DP size; the TP ranks of a group share rows), and each
trainable gradient is reduced by ``sharding.gradient_rule``: an FSDP shard's
was reduce-scattered in the backward; a replicated tensor read inside a TP
region is summed over the TP group; then every other one is averaged over
the DP group, with the loss.  AdamW and the EMA are elementwise and the
optimizer clips no global norm, so they run on each rank's shards as they
are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from gligen_tpu_torch.diffusion.schedule import DiffusionSchedule
from gligen_tpu_torch.models.vae import sample_posterior
from gligen_tpu_torch.parallel import mesh as dp
from gligen_tpu_torch.parallel.sharding import (REPLICATED, gather_tensor, gradient_rule,
                                                 shard_unet_)

# the draws of one step, in the order a generator gives them
DRAW_KEYS = ("posterior", "u_t", "noise", "u_drop")


# ---------------------------------------------------------------- masks

def trainable_mask(unet: nn.Module, input_conv_train: bool = False) -> Dict[str, bool]:
    """{parameter name: trainable} over the UNet's parameters
    (train_step.py:35-50).  The port's names mirror the JAX paths with '.'
    for '/', so the rule is the same string test; the first conv trains
    its weight only."""
    return {
        name: ("transformer_blocks" in name and "fuser" in name)
        or "position_net" in name
        or "downsample_net" in name
        or (input_conv_train and name == "input_blocks_0_0.weight")
        for name, _ in unet.named_parameters()
    }


# ---------------------------------------------------------------- optim

def lr_multiplier(warmup_steps: int, total_steps: int,
                  scheduler_type: str = "constant") -> Callable[[int], float]:
    """The learning rate over ``base_lr`` at optimizer step c (0 first),
    as optax's ``join_schedules`` gives it (train_step.py:68-83): a linear
    warmup from 0 over ``warmup_steps`` (so step 0 changes no parameter),
    then constant or a cosine decay to 0 over the remaining steps."""
    if scheduler_type not in ("constant", "cosine"):
        raise ValueError(f"scheduler_type {scheduler_type!r}: 'constant' or 'cosine'")
    decay_steps = max(total_steps - warmup_steps, 1)

    def multiplier(c: int) -> float:
        if c < warmup_steps:
            return c / warmup_steps
        if scheduler_type == "constant":
            return 1.0
        return 0.5 * (1.0 + math.cos(math.pi * min(c - warmup_steps, decay_steps) / decay_steps))

    return multiplier


def make_optimizer(
    params: Iterable[torch.Tensor],
    base_lr: float = 5e-5,
    weight_decay: float = 0.0,
    warmup_steps: int = 10_000,
    total_steps: int = 500_000,
    scheduler_type: str = "constant",
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay, as
    optax.adamw) under the warmup schedule (train_step.py:86-100)."""
    opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    mult = lr_multiplier(warmup_steps, total_steps, scheduler_type)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, mult)


@dataclasses.dataclass
class TrainState:
    """The step count, the trainable parameters by name, the optimizer and
    its schedule, and optional EMA copies of the trainable parameters."""

    step: int
    params: Dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(unet: nn.Module, input_conv_train: bool = False, enable_ema: bool = False,
                       **optimizer_kw: Any) -> TrainState:
    """Freeze every UNet parameter outside ``trainable_mask`` and build the
    optimizer over the rest (``optimizer_kw`` go to ``make_optimizer``).
    The EMA copies are real copies, not aliases of the parameters."""
    mask = trainable_mask(unet, input_conv_train)
    params = {}
    for name, p in unet.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params[name] = p
    if not params:
        raise ValueError("no trainable parameter: the UNet has no fuser or position net")
    optimizer, scheduler = make_optimizer(list(params.values()), **optimizer_kw)
    ema = {n: p.detach().clone() for n, p in params.items()} if enable_ema else None
    return TrainState(0, params, optimizer, scheduler, ema)


# ---------------------------------------------------------------- step

def make_loss_fn(
    unet: nn.Module,
    vae: nn.Module,
    text_encoder: nn.Module,
    schedule: DiffusionSchedule,
    *,
    grounding_drop_prob: float = 0.1,
    l_simple_weight: float = 1.0,
) -> Callable:
    """The per-batch eps-MSE loss (train_step.py:134-206).

    ``loss_fn(batch, generator=None, draws=None)`` -> 0-d fp32 tensor.
    batch: {"image": (B, H, W, 3) in [-1, 1], or "latent_moments":
    (B, h, w, 8) posterior mean | logvar; "input_ids": (B, 77);
    "grounding": the tokenizer's inputs; for a UNet with a grounding
    downsampler, "grounding_extra": its spatial map (never dropped with the
    grounding); for an inpaint UNet, "inpainting_mask": (B, h, w, 1) latent
    keep-mask}.  The two latent
    branches give the same loss for the same draws.  In a process group the
    batch is this process's rows (``parallel.mesh.process_batch_slice``)
    and the draws are the global batch's, of which it keeps those rows."""
    device = next(unet.parameters()).device
    steps = schedule.num_timesteps

    def loss_fn(batch: Mapping[str, Any], generator: Optional[torch.Generator] = None,
                draws: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        if draws is not None and set(draws) != set(DRAW_KEYS):
            raise ValueError(f"draws has keys {sorted(draws)}, needs {sorted(DRAW_KEYS)}")
        world = dp.data_size()

        def draw(name, shape, normal):
            """The draw of the global batch (the local rows times the
            replicas), this process's rows of it."""
            if not shape:
                glob, rows = (), slice(None)
            else:
                glob = (shape[0] * world,) + tuple(shape[1:])
                rows = dp.process_batch_slice(glob[0])
            if draws is not None:
                t = torch.as_tensor(draws[name], dtype=torch.float32, device=device).reshape(glob)
            else:
                fn = torch.randn if normal else torch.rand
                t = fn(glob, generator=generator, device=device)
            return t[rows] if shape else t

        def to_device(x):
            return torch.as_tensor(x, device=device)

        with torch.no_grad():
            if "latent_moments" in batch:
                mean, logvar = to_device(batch["latent_moments"]).chunk(2, dim=-1)
                mean = mean.to(vae.dtype)
                z = sample_posterior(mean, logvar, draw("posterior", mean.shape, True),
                                     vae.scale_factor)
            else:
                image = to_device(batch["image"])
                b, h, w, _ = image.shape
                f = vae.downsample_factor
                z = vae.encode(image, draw("posterior", (b, h // f, w // f, vae.embed_dim), True))
            context = text_encoder.encode(to_device(batch["input_ids"]).long())

        b = z.shape[0]
        # t = floor(U[0, 1) * T), T clamped to T - 1 (trainer.py:335-337)
        t = torch.clamp((draw("u_t", (b,), False) * steps).long(), max=steps - 1)
        noise = draw("noise", z.shape, True)
        x_noisy = schedule.q_sample(z, t, noise)
        # the whole-batch grounding drop for CFG (openaimodel.py:428-429), on
        # the device: no host synchronisation
        drop = draw("u_drop", (), False) < grounding_drop_prob
        grounding = {k: torch.where(drop, torch.zeros_like(g), g)
                     for k, g in ((k, to_device(v)) for k, v in batch["grounding"].items())}
        extra = None
        if "inpainting_mask" in batch:  # train_step.py:192-195: z * m, then m
            m = to_device(batch["inpainting_mask"]).float()
            extra = torch.cat([z.float() * m, m], dim=-1)
        # a spatial map is not dropped with the grounding (train_step.py:184-201)
        ds_map = batch.get("grounding_extra")
        feats = None if ds_map is None else unet.downsampler_features(to_device(ds_map))
        eps = unet(x_noisy, t, context, grounding, gate_scale=1.0, use_sd_conv=False,
                   inpainting_extra=extra, grounding_extra_features=feats)
        return ((eps - noise) ** 2).mean() * l_simple_weight

    return loss_fn


def make_train_step(
    unet: nn.Module,
    vae: nn.Module,
    text_encoder: nn.Module,
    schedule: DiffusionSchedule,
    *,
    grounding_drop_prob: float = 0.1,
    ema_rate: float = 0.9999,
    l_simple_weight: float = 1.0,
) -> Callable:
    """``train_step(state, batch, generator=None, draws=None)`` -> {"loss":
    0-d device tensor}: the loss, its backward, one AdamW step, one
    schedule step and the EMA update e * rate + p * (1 - rate)
    (train_step.py:232-249).  It runs on the parameters' device and updates
    ``state`` in place; the gradients stay on the parameters until the
    next step.  In a process group the trainable gradients and the loss
    are averaged over it before the optimizer step (one bucketed
    ``all_reduce`` pass, ``parallel.mesh.all_reduce_mean_``): the loss
    returned is the global batch's."""
    loss_fn = make_loss_fn(unet, vae, text_encoder, schedule,
                           grounding_drop_prob=grounding_drop_prob,
                           l_simple_weight=l_simple_weight)
    rules = gradient_rules(unet)

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        # marks the forward's device span in a trace (tools/perf_probe.py train)
        with record_function("train_step.loss"):
            loss = loss_fn(batch, generator, draws)
        loss.backward()
        if dp.world_size() > 1:
            loss = loss.detach().reshape(1).clone()
            reduce_gradients_(state.params, rules, loss)
            loss = loss[0]
        state.optimizer.step()
        state.scheduler.step()
        if state.ema_params is not None:
            with torch.no_grad():
                ema = list(state.ema_params.values())
                torch._foreach_mul_(ema, ema_rate)
                torch._foreach_add_(ema, [state.params[n] for n in state.ema_params],
                                    alpha=1.0 - ema_rate)
        state.step += 1
        return {"loss": loss.detach()}

    return train_step


def gradient_rules(unet: nn.Module) -> Dict[str, str]:
    """{parameter name: ``sharding.gradient_rule``} of the UNet, from its
    TP plan (``unet.tp_plan``) and its FSDP specs (``unet.fsdp``), if any."""
    plan = getattr(unet, "tp_plan", None) or {}
    fsdp = getattr(unet, "fsdp", None)
    specs = fsdp.specs if fsdp is not None else {}
    return {name: gradient_rule(plan.get(name, REPLICATED), specs.get(name))
            for name, _ in unet.named_parameters()}


def reduce_gradients_(params: Mapping[str, nn.Parameter], rules: Mapping[str, str],
                      loss: torch.Tensor) -> None:
    """The trainable gradients reduced in place by ``rules`` over the grid
    (module docstring), with ``loss`` averaged over the DP group.  A
    "tp_sum" tensor that no op of this rank read (a rank-0 bias on another
    rank) contributes zeros."""
    tp = dp.tensor_parallel()
    summed = []
    for name, p in params.items():
        if rules[name] == "tp_sum":
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            summed.append(p.grad)
    if tp is not None:
        dp.all_reduce_sum_(summed, tp.group)
    dp.all_reduce_mean_([p.grad for n, p in params.items()
                         if rules[n] != "done" and p.grad is not None] + [loss],
                        group=dp.dp_group())


# ---------------------------------------------------------------- dryrun

# how long ``dryrun_train_step`` waits for each of its processes
DRYRUN_TIMEOUT_S = 120.0


def dryrun_train_step(n_devices: int, tp: int = 1, fsdp: bool = False) -> Dict[str, Any]:
    """A tiny-config train step over ``n_devices`` CPU processes in a gloo
    group (train_step.py:256-350), each data-parallel replica one row of
    the global batch: ``tp = 1`` the 1-D data case (the batch split, the
    parameters replicated, the gradients averaged); ``tp > 1`` a grid of
    ``n_devices / tp`` replicas of ``tp`` Megatron-paired ranks
    (``parallel/sharding.py``); ``fsdp`` the parameters ZeRO-3-sharded over
    every rank (``parallel/fsdp.py``).  Returns {"losses": per rank,
    "digests": per rank, a hash of the full trainable tensors after the
    step (gathered over the shards)}; raises unless every loss is finite
    and equal and every rank holds the same parameters."""
    if tp < 1 or n_devices % tp:
        raise ValueError(f"dryrun_train_step: tp {tp} does not divide {n_devices} processes")
    if tp > 1 and fsdp:
        raise ValueError("dryrun_train_step: tp > 1 or fsdp, not both (as the JAX dryrun)")
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = tmp.get_context("spawn")
    out = ctx.SimpleQueue()
    procs = [ctx.Process(target=_dryrun_worker, args=(rank, n_devices, port, out, tp, fsdp))
             for rank in range(n_devices)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(DRYRUN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    if alive or any(p.exitcode for p in procs):
        raise RuntimeError(f"dryrun_train_step: exit codes {[p.exitcode for p in procs]}")
    got = sorted(out.get() for _ in procs)
    losses, digests = [g[1] for g in got], [g[2] for g in got]
    if not all(math.isfinite(x) for x in losses) or len(set(losses)) != 1 \
            or len(set(digests)) != 1:
        raise RuntimeError(f"dryrun_train_step: ranks disagree: losses {losses}, "
                           f"parameter digests {digests}")
    return {"losses": losses, "digests": digests}


def _dryrun_worker(rank: int, world: int, port: int, out, tp: int = 1,
                   fsdp: bool = False) -> None:
    """One rank of ``dryrun_train_step``: join the group and its grid,
    build the tiny model from one seed, shard it, take one step on its
    replica's row, report."""
    import hashlib
    import os

    from gligen_tpu_torch.inference.pipeline import GligenComponents
    from gligen_tpu_torch.parallel import fsdp as zero

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    device = dp.init_process_group("cpu")
    try:
        grid = dp.init_grid(tp)
        ctx = 32
        comps = GligenComponents.create(
            unet_config=dict(model_channels=32, num_res_blocks=1, attention_resolutions=(1,),
                             channel_mult=(1, 2), num_heads=2, context_dim=ctx,
                             use_checkpoint=True, grounding_tokenizer={
                                 "target": "text", "params": {"in_dim": ctx, "out_dim": ctx}}),
            dtype=torch.float32, seed=0, device=device,
            vae_config=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32),
            text_config=dict(vocab_size=64, hidden_size=ctx, layers=1, heads=2,
                             max_positions=8))
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():  # a fresh model's zero output conv blocks every gradient
            for p in comps.unet.parameters():
                if not p.any():
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))
        if tp > 1:
            shard_unet_(comps.unet, grid.tp)
        elif fsdp:
            zero.shard_unet_(comps.unet)
        state = create_train_state(comps.unet, base_lr=1e-4, warmup_steps=2, total_steps=10)
        step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
        g = torch.Generator().manual_seed(1)
        b, lat = dp.data_size(), 8
        batch = {"image": torch.rand((b, lat * 4, lat * 4, 3), generator=g) * 2 - 1,
                 "input_ids": torch.randint(0, 64, (b, 8), generator=g),
                 "grounding": {"boxes": torch.rand((b, 3, 4), generator=g),
                               "masks": torch.ones((b, 3)),
                               "positive_embeddings": torch.randn((b, 3, ctx), generator=g)}}
        rows = dp.process_batch_slice(b)
        local = {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict) else v[rows])
                 for k, v in batch.items()}
        loss = float(step(state, local, generator=torch.Generator().manual_seed(2))["loss"])
        full = full_tensors(comps.unet, state.params)
        digest = hashlib.sha256()
        for name in sorted(full):
            digest.update(full[name].numpy().tobytes())
        out.put((rank, loss, digest.hexdigest()))
    finally:
        dp.destroy_process_group()


def full_tensors(unet: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full CPU copies of per-parameter tensors of a sharded UNet (its
    parameters, their gradients, their EMA), by parameter name: gathered
    over the TP group (``unet.tp_plan``) or the FSDP group (``unet.fsdp``),
    copied as they are otherwise.  Every rank of the group takes part."""
    plan, fsdp = getattr(unet, "tp_plan", None), getattr(unet, "fsdp", None)
    out = {}
    for name, t in tensors.items():
        t = t.detach()
        if fsdp is not None and fsdp.specs[name] is not None:
            t = dp.all_gather(t, fsdp.specs[name], fsdp.group)
        elif plan is not None and plan[name].dim is not None:
            tp, dim = dp.tensor_parallel(), plan[name].dim
            t = gather_tensor(dp.all_gather(t, dim, tp.group).chunk(tp.size, dim), plan[name])
        out[name] = t.cpu().clone()
    return out
