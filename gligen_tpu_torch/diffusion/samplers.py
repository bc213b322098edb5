"""PLMS sampler (counterpart of ``gligen_tpu/diffusion/samplers.py``).

The per-step constants are precomputed tables (timesteps, DDIM alphas, the
fuser gate schedule, the use-SD-first-conv flags, Adams-Bashforth
coefficients); step 0 is the peeled Heun (pseudo improved Euler)
bootstrap with its extra model call; the remaining steps run in a Python
loop whose state is x and the 3-deep epsilon history.

The sampler is model-agnostic: ``eps_fn(x, t, gate, use_sd)`` already
performs classifier-free guidance.  ``gate`` is a Python float and
``use_sd`` a Python bool, so the model can pick its first conv and skip
work on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gligen_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    alpha_generator,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)

EpsFn = Callable[[torch.Tensor, torch.Tensor, float, bool], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerTables:
    """Per-step constants, already in sampling (reversed-time) order."""

    ts: np.ndarray                 # (S,) timestep fed to the model
    ts_next: np.ndarray            # (S,) next timestep (Heun bootstrap target)
    a_t: np.ndarray                # (S,) DDIM alpha_cumprod at ts
    a_prev: np.ndarray             # (S,)
    sqrt_one_minus_at: np.ndarray  # (S,)
    gate: np.ndarray               # (S,) gated-fuser alpha schedule
    use_sd: np.ndarray             # (S,) bool: original-SD first conv active

    @classmethod
    def create(
        cls,
        schedule: DiffusionSchedule,
        steps: int,
        alpha_stages: Optional[Sequence[float]] = None,
    ) -> "SamplerTables":
        ddim_ts = make_ddim_timesteps(steps, schedule.num_timesteps)
        steps = len(ddim_ts)  # the actual count (c = T // S subset)
        _, alphas, alphas_prev = make_ddim_sampling_parameters(
            schedule.alphas_cumprod, ddim_ts, 0.0
        )
        order = np.arange(steps)[::-1]
        ts = ddim_ts[order]
        ts_next = np.concatenate([ts[1:], ts[-1:]])
        if alpha_stages is not None:
            gate = alpha_generator(steps, list(alpha_stages))
        else:
            gate = np.ones(steps, dtype=np.float32)
        # the port's UNet always carries first_conv_sd, so it is always restorable
        use_sd = (gate == 0.0) & (alpha_stages is not None)
        return cls(
            ts=ts.astype(np.int32),
            ts_next=ts_next.astype(np.int32),
            a_t=alphas[order].astype(np.float32),
            a_prev=alphas_prev[order].astype(np.float32),
            sqrt_one_minus_at=np.sqrt(1.0 - alphas)[order].astype(np.float32),
            gate=gate.astype(np.float32),
            use_sd=use_sd,
        )


# Adams-Bashforth multistep coefficients by history length:
# e' = c0*e_t + c1*old[-1] + c2*old[-2] + c3*old[-3]
_AB_COEFFS = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],  # unused (history 0 = the peeled step)
        [3 / 2, -1 / 2, 0.0, 0.0],
        [23 / 12, -16 / 12, 5 / 12, 0.0],
        [55 / 24, -59 / 24, 37 / 24, -9 / 24],
    ],
    dtype=np.float32,
)


def _gate_zero_from(tables: SamplerTables) -> int:
    """First step index from which the fuser gate is 0 for ALL remaining
    steps (== steps when the gate never reaches a zero tail)."""
    nz = np.nonzero(np.asarray(tables.gate) != 0.0)[0]
    return int(nz[-1]) + 1 if nz.size else 0


def plms_sample(
    eps_fn: EpsFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    steps: int = 50,
    alpha_stages: Optional[Sequence[float]] = None,
    eps_fn_gate0: Optional[EpsFn] = None,
) -> torch.Tensor:
    """PLMS sampling from the starting noise ``x_init`` (B, H, W, C).
    Returns the final latent, float32.

    ``eps_fn_gate0``: optional cheaper model for the gate==0 tail of the
    alpha schedule (a fuser-free UNet; exact, since gated fusers are the
    identity at gate 0).  When given, the steps from ``_gate_zero_from``
    on use it."""
    tables = SamplerTables.create(schedule, steps, alpha_stages=alpha_stages)
    steps = tables.ts.shape[0]
    k0 = _gate_zero_from(tables) if eps_fn_gate0 is not None else steps
    dev = x_init.device
    a_t, a_prev, som, coeffs = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (tables.a_t, tables.a_prev, tables.sqrt_one_minus_at, _AB_COEFFS)
    )
    b = x_init.shape[0]

    def model_with(fn, x, i, t_table):
        t = torch.full((b,), int(t_table[i]), dtype=torch.int32, device=dev)
        return fn(x, t, float(tables.gate[i]), bool(tables.use_sd[i]))

    def step_update(x, e, i):
        pred_x0 = (x - som[i] * e) / torch.sqrt(a_t[i])
        dir_xt = torch.sqrt(1.0 - a_prev[i]) * e
        return torch.sqrt(a_prev[i]) * pred_x0 + dir_xt

    # ---- peeled step 0: pseudo improved Euler (Heun) bootstrap ----
    fn0 = eps_fn if k0 > 0 else eps_fn_gate0
    x = x_init.float()
    e_t = model_with(fn0, x, 0, tables.ts)
    x_mid = step_update(x, e_t, 0)
    e_next = model_with(fn0, x_mid, 0, tables.ts_next)
    x = step_update(x, (e_t + e_next) / 2.0, 0)
    hist = [e_t, torch.zeros_like(e_t), torch.zeros_like(e_t)]  # most recent first

    for i in range(1, steps):
        e_t = model_with(eps_fn if i < k0 else eps_fn_gate0, x, i, tables.ts)
        c = coeffs[min(i, 3)]
        e_prime = c[0] * e_t + c[1] * hist[0] + c[2] * hist[1] + c[3] * hist[2]
        x = step_update(x, e_prime, i)
        hist = [e_t, hist[0], hist[1]]
    return x
