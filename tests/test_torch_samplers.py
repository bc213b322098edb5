"""Schedule tables and the PLMS sampler of gligen_tpu_torch against
gligen_tpu, with a fake eps function written twice (jnp and torch) over the
same numpy starting noise.

The fake model depends on x, t, the gate and the first-conv flag, and its
fuser-free twin differs by a constant, so a step that calls the wrong
model, or the right one with the wrong table entry, shows.  Tolerance: the
tables are float32 on both sides (bit-equal); the sampled latents are fp32
through 10 steps whose coefficients reach 1/sqrt(a_t) ~ 15 and whose
values reach ~30 with this fake model: a few fp32 ulps, rtol 2e-6 with
atol 1e-5 near zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gligen_tpu.diffusion import samplers as js
from gligen_tpu.diffusion import schedule as jsch

from gligen_tpu_torch.diffusion import samplers as ts
from gligen_tpu_torch.diffusion import schedule as tsch

SCHED = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)


@pytest.mark.parametrize("timesteps", [1000, 250])
def test_schedule_tables(timesteps):
    sched = dict(SCHED, timesteps=timesteps)
    want = jsch.DiffusionSchedule.create(**sched)
    got = tsch.DiffusionSchedule.create(**sched)
    np.testing.assert_array_equal(got.betas, np.asarray(want.betas))
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))


@pytest.mark.parametrize("steps", [50, 10, 7, 1000])
def test_ddim_timesteps_and_alpha_generator(steps):
    np.testing.assert_array_equal(tsch.make_ddim_timesteps(steps, 1000),
                                  jsch.make_ddim_timesteps(steps, 1000))
    n = len(tsch.make_ddim_timesteps(steps, 1000))
    for stages in ([0.3, 0.0, 0.7], [0.2, 0.3, 0.5], None):
        np.testing.assert_array_equal(tsch.alpha_generator(n, stages), jsch.alpha_generator(n, stages))


@pytest.mark.parametrize("alpha_stages", [[0.3, 0.0, 0.7], [0.2, 0.3, 0.5], None])
def test_sampler_tables(alpha_stages):
    want = js.SamplerTables.create(jsch.DiffusionSchedule.create(**SCHED), 10,
                                   alpha_stages=alpha_stages)
    got = ts.SamplerTables.create(tsch.DiffusionSchedule.create(**SCHED), 10,
                                  alpha_stages=alpha_stages)
    for field in ("ts", "ts_next", "a_t", "a_prev", "sqrt_one_minus_at", "gate", "use_sd"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)), field)
    assert ts._gate_zero_from(got) == js._gate_zero_from(want)


def _jax_eps(offset):
    def eps(x, t, gate, use_sd):
        tt = t.astype(jnp.float32)[:, None, None, None] / 1000.0
        return 0.3 * jnp.sin(x + tt) + 0.2 * gate + 0.1 * use_sd.astype(jnp.float32) + offset
    return eps


def _torch_eps(offset, calls):
    def eps(x, t, gate, use_sd):
        calls.append((int(t[0]), gate, use_sd, offset))
        tt = t.float()[:, None, None, None] / 1000.0
        return 0.3 * torch.sin(x + tt) + 0.2 * gate + 0.1 * float(use_sd) + offset
    return eps


@pytest.mark.parametrize("with_gate0", [False, True])
def test_plms_sample_matches_jax(with_gate0):
    noise = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    alpha = [0.3, 0.0, 0.7]
    want = js.plms_sample(
        _jax_eps(0.0), jsch.DiffusionSchedule.create(**SCHED), jnp.asarray(noise), steps=10,
        alpha_stages=alpha, eps_fn_gate0=_jax_eps(0.05) if with_gate0 else None,
    )
    calls = []
    got = ts.plms_sample(
        _torch_eps(0.0, calls), tsch.DiffusionSchedule.create(**SCHED), torch.from_numpy(noise),
        steps=10, alpha_stages=alpha,
        eps_fn_gate0=_torch_eps(0.05, calls) if with_gate0 else None,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=2e-6)
    # the Heun step calls the model twice, then once per step: 11 calls;
    # with the fuser-free twin, the gate-0 steps (3..9) call it
    assert len(calls) == 11
    assert [c[3] for c in calls] == [0.0] * 4 + [0.05 if with_gate0 else 0.0] * 7
    assert [c[1] for c in calls] == [1.0] * 4 + [0.0] * 7
