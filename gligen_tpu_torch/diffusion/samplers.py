"""PLMS and DDIM samplers (counterpart of ``gligen_tpu/diffusion/samplers.py``).

The per-step constants are precomputed tables (timesteps, DDIM alphas and
sigmas, the fuser gate schedule, the use-SD-first-conv flags,
Adams-Bashforth coefficients).  PLMS peels step 0, the Heun (pseudo
improved Euler) bootstrap with its extra model call, and runs the other
steps in a Python loop whose state is x and the 3-deep epsilon history;
DDIM runs every step in one loop.  With a ``mask`` and ``x0`` both
inpaint: each step starts by pinning the known region to
``q_sample(x0, t)`` (``_blend``).

The sampler is model-agnostic: ``eps_fn(x, t, gate, use_sd)`` already
performs classifier-free guidance.  ``gate`` is a Python float and
``use_sd`` a Python bool, so the model can pick its first conv and skip
work on the host.

Randomness: the JAX package draws each step's noise with
``fold_in(key, i)``; here each step's noise is row i of an injected
(S, ...) tensor, or a fresh draw from ``generator`` when none is given.
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
    sigma_t: np.ndarray            # (S,) DDIM noise scale (0 at eta 0)
    gate: np.ndarray               # (S,) gated-fuser alpha schedule
    use_sd: np.ndarray             # (S,) bool: original-SD first conv active

    @classmethod
    def create(
        cls,
        schedule: DiffusionSchedule,
        steps: int,
        eta: float = 0.0,
        alpha_stages: Optional[Sequence[float]] = None,
        first_conv_restorable: bool = True,
    ) -> "SamplerTables":
        """samplers.py:56-93.  ``first_conv_restorable``: the UNet has the
        original SD first conv (an inpaint UNet has none), so the gate-0
        steps of an alpha schedule may switch to it."""
        ddim_ts = make_ddim_timesteps(steps, schedule.num_timesteps)
        steps = len(ddim_ts)  # the actual count (c = T // S subset)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            schedule.alphas_cumprod, ddim_ts, eta
        )
        order = np.arange(steps)[::-1]
        ts = ddim_ts[order]
        ts_next = np.concatenate([ts[1:], ts[-1:]])
        if alpha_stages is not None:
            gate = alpha_generator(steps, list(alpha_stages))
        else:
            gate = np.ones(steps, dtype=np.float32)
        use_sd = (gate == 0.0) & (alpha_stages is not None) & bool(first_conv_restorable)
        return cls(
            ts=ts.astype(np.int32),
            ts_next=ts_next.astype(np.int32),
            a_t=alphas[order].astype(np.float32),
            a_prev=alphas_prev[order].astype(np.float32),
            sqrt_one_minus_at=np.sqrt(1.0 - alphas)[order].astype(np.float32),
            sigma_t=sigmas[order].astype(np.float32),
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


def _on(dev, *tables):
    return (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in tables)


def _step_noise(noise, generator, shape, dev):
    """Noise of step i: ``noise(i)`` -> row i of the injected (S, *shape)
    tensor, or a standard-normal draw from ``generator``."""
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        return lambda i: noise[i]
    return lambda i: torch.randn(shape, generator=generator, device=dev)


def _blend(x, t, schedule, mask, x0, noise):
    """Inpainting latent blend at a step's top (samplers.py:117-121):
    q_sample(x0, t) on the known region (mask 1), x elsewhere."""
    img_orig = schedule.q_sample(x0, t, noise)
    return img_orig * mask + (1.0 - mask) * x


def _blender(schedule, mask, x0, noise, generator, dev):
    """x, t, i -> the blended x (or x as it is without a mask)."""
    if mask is None:
        return lambda x, t, i: x
    if x0 is None:
        raise ValueError("inpainting needs x0 with the mask")
    mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    draw = _step_noise(noise, generator, x0.shape, dev)
    return lambda x, t, i: _blend(x, t, schedule, mask, x0, draw(i))


def plms_sample(
    eps_fn: EpsFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    steps: int = 50,
    alpha_stages: Optional[Sequence[float]] = None,
    first_conv_restorable: bool = True,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    blend_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eps_fn_gate0: Optional[EpsFn] = None,
) -> torch.Tensor:
    """PLMS sampling from the starting noise ``x_init`` (B, H, W, C)
    (samplers.py:124-246).  Returns the final latent, float32.

    ``mask`` (B, H, W, 1), 1 = known, and ``x0`` (the known latent)
    inpaint; ``blend_noise`` (S, *x0.shape) is each step's q_sample noise,
    drawn from ``generator`` when not given.  ``eps_fn_gate0``: optional
    cheaper model for the gate==0 tail of the alpha schedule (a fuser-free
    UNet; exact, since gated fusers are the identity at gate 0).  When
    given, the steps from ``_gate_zero_from`` on use it."""
    tables = SamplerTables.create(schedule, steps, alpha_stages=alpha_stages,
                                  first_conv_restorable=first_conv_restorable)
    steps = tables.ts.shape[0]
    k0 = _gate_zero_from(tables) if eps_fn_gate0 is not None else steps
    dev = x_init.device
    a_t, a_prev, som, coeffs = _on(dev, tables.a_t, tables.a_prev, tables.sqrt_one_minus_at,
                                   _AB_COEFFS)
    b = x_init.shape[0]
    ts = lambda i, table=tables.ts: torch.full((b,), int(table[i]), dtype=torch.int32, device=dev)
    blend = _blender(schedule, mask, x0, blend_noise, generator, dev)

    def model_with(fn, x, i, t):
        return fn(x, t, float(tables.gate[i]), bool(tables.use_sd[i]))

    def step_update(x, e, i):
        pred_x0 = (x - som[i] * e) / torch.sqrt(a_t[i])
        dir_xt = torch.sqrt(1.0 - a_prev[i]) * e
        return torch.sqrt(a_prev[i]) * pred_x0 + dir_xt

    # ---- peeled step 0: pseudo improved Euler (Heun) bootstrap ----
    fn0 = eps_fn if k0 > 0 else eps_fn_gate0
    x = blend(x_init.float(), ts(0), 0)
    e_t = model_with(fn0, x, 0, ts(0))
    x_mid = step_update(x, e_t, 0)
    e_next = model_with(fn0, x_mid, 0, ts(0, tables.ts_next))
    x = step_update(x, (e_t + e_next) / 2.0, 0)
    hist = [e_t, torch.zeros_like(e_t), torch.zeros_like(e_t)]  # most recent first

    for i in range(1, steps):
        x = blend(x, ts(i), i)
        e_t = model_with(eps_fn if i < k0 else eps_fn_gate0, x, i, ts(i))
        c = coeffs[min(i, 3)]
        e_prime = c[0] * e_t + c[1] * hist[0] + c[2] * hist[1] + c[3] * hist[2]
        x = step_update(x, e_prime, i)
        hist = [e_t, hist[0], hist[1]]
    return x


def ddim_sample(
    eps_fn: EpsFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    steps: int = 250,
    eta: float = 0.0,
    alpha_stages: Optional[Sequence[float]] = None,
    first_conv_restorable: bool = True,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    blend_noise: Optional[torch.Tensor] = None,
    sigma_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eps_fn_gate0: Optional[EpsFn] = None,
) -> torch.Tensor:
    """DDIM sampling (samplers.py:249-316).  Returns the final latent,
    float32.  ``eta`` > 0 adds sigma_t * noise at each step: row i of
    ``sigma_noise`` (S, *x_init.shape), or a draw from ``generator``.
    ``mask``/``x0``/``blend_noise`` inpaint as in ``plms_sample``;
    ``eps_fn_gate0`` runs the gate-0 tail, split at the same step."""
    tables = SamplerTables.create(schedule, steps, eta=eta, alpha_stages=alpha_stages,
                                  first_conv_restorable=first_conv_restorable)
    steps = tables.ts.shape[0]
    k0 = _gate_zero_from(tables) if eps_fn_gate0 is not None else steps
    dev = x_init.device
    a_t, a_prev, som, sig = _on(dev, tables.a_t, tables.a_prev, tables.sqrt_one_minus_at,
                                tables.sigma_t)
    b = x_init.shape[0]
    blend = _blender(schedule, mask, x0, blend_noise, generator, dev)
    sig_noise = _step_noise(sigma_noise, generator, x_init.shape, dev) if eta > 0 else None

    x = x_init.float()
    for i in range(steps):
        t = torch.full((b,), int(tables.ts[i]), dtype=torch.int32, device=dev)
        x = blend(x, t, i)
        fn = eps_fn if i < k0 else eps_fn_gate0
        e_t = fn(x, t, float(tables.gate[i]), bool(tables.use_sd[i]))
        pred_x0 = (x - som[i] * e_t) / torch.sqrt(a_t[i])
        dir_xt = torch.sqrt(1.0 - a_prev[i] - sig[i] ** 2) * e_t
        x = torch.sqrt(a_prev[i]) * pred_x0 + dir_xt
        if sig_noise is not None:
            x = x + sig[i] * sig_noise(i)
    return x
