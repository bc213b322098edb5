"""Diffusion schedules (counterpart of ``gligen_tpu/diffusion/schedule.py``).

The tables are computed on the host in float64 numpy and stored as
float32, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int) -> np.ndarray:
    """Uniform subset of DDPM timesteps, +1 shifted, with the reference's
    ``c = T // S`` semantics: a non-divisor S gives ``ceil((T-1) / (T//S))``
    steps, so callers size their tables from the returned length."""
    if not 1 <= num_ddim_timesteps <= num_ddpm_timesteps:
        raise ValueError(f"steps={num_ddim_timesteps} must be in [1, T={num_ddpm_timesteps}]")
    c = num_ddpm_timesteps // num_ddim_timesteps
    return np.arange(0, num_ddpm_timesteps - 1, c) + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float):
    """(sigmas, alphas, alphas_prev) for the DDIM update."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def alpha_generator(length: int, stages: Optional[Sequence[float]] = None) -> np.ndarray:
    """Per-step gated-attention scale: [const-1, linear-decay, const-0] stages."""
    if stages is None:
        stages = [1.0, 0.0, 0.0]
    if len(stages) != 3 or abs(sum(stages) - 1.0) >= 1e-9:
        raise ValueError(f"alpha stages {stages} must be 3 fractions summing to 1")
    n0 = int(stages[0] * length)
    n1 = int(stages[1] * length)
    n2 = length - n0 - n1
    decay = list(np.arange(0, 1, 1 / n1)[::-1]) if n1 != 0 else []
    return np.asarray([1.0] * n0 + decay + [0.0] * n2, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM tables, float32 numpy."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(
        cls, timesteps: int = 1000, linear_start: float = 1e-4, linear_end: float = 2e-2
    ) -> "DiffusionSchedule":
        """The linear beta schedule (in sqrt space), which every config uses."""
        betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps, dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas, axis=0)
        f32 = lambda a: a.astype(np.float32)
        return cls(betas=f32(betas), alphas_cumprod=f32(acp), sqrt_alphas_cumprod=f32(np.sqrt(acp)),
                   sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward noising q(x_t | x_0) in fp32 (schedule.py:164-169).
        t: (B,) integer timesteps on x_start's device.  The two 4 KB tables
        go to the device without a host synchronisation."""
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        a, b = (torch.from_numpy(table).to(x_start.device, non_blocking=True)[t].reshape(shape)
                for table in (self.sqrt_alphas_cumprod, self.sqrt_one_minus_alphas_cumprod))
        return a * x_start.float() + b * noise.float()
