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
    branches give the same loss for the same draws."""
    device = next(unet.parameters()).device
    steps = schedule.num_timesteps

    def loss_fn(batch: Mapping[str, Any], generator: Optional[torch.Generator] = None,
                draws: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        if draws is not None and set(draws) != set(DRAW_KEYS):
            raise ValueError(f"draws has keys {sorted(draws)}, needs {sorted(DRAW_KEYS)}")

        def draw(name, shape, normal):
            if draws is not None:
                return torch.as_tensor(draws[name], dtype=torch.float32, device=device).reshape(shape)
            fn = torch.randn if normal else torch.rand
            return fn(shape, generator=generator, device=device)

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
    next step."""
    loss_fn = make_loss_fn(unet, vae, text_encoder, schedule,
                           grounding_drop_prob=grounding_drop_prob,
                           l_simple_weight=l_simple_weight)

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        # marks the forward's device span in a trace (tools/perf_probe.py train)
        with record_function("train_step.loss"):
            loss = loss_fn(batch, generator, draws)
        loss.backward()
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
