"""The gatedSA2 and gatedCA fusers of the port against the JAX package's, on
the CPU in fp32: each fuser alone, inside a transformer block (16 visual
tokens: the module path; 64: the block's fused path around the fuser's
module path), F1 (a gatedSA2 block refuses ``skip_fuser``), and small UNets
of each through generate, with the alpha stages [0.3, 0, 0.7], with PLMS
and DDIM, against the JAX pipeline.

Tolerances: a fuser or block is a few fp32 layers of O(1) values (2e-5);
the pipelines as test_torch_pipeline.py (1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gligen_tpu.models import layers as jl

from gligen_tpu_torch.models import layers as tl

from test_torch_modules import UNET, close, grounding_inputs, jax_apply, port, rand, random_params, t
from test_torch_pipeline import compare_pipelines

torch.set_num_threads(1)

ATOL = 2e-5
JAX_FUSERS = {"gatedSA2": jl.GatedSelfAttentionDense2, "gatedCA": jl.GatedCrossAttentionDense}


@pytest.mark.parametrize("fuser", sorted(JAX_FUSERS))
def test_fuser_matches_jax(fuser):
    """The fuser alone at gate 0.7: 16 visual tokens (a 4 x 4 grid) over 9
    grounding tokens (3 x 3, which gatedSA2 resizes bicubically)."""
    rng = np.random.default_rng(0)
    x, objs = rand(rng, 2, 16, 32), rand(rng, 2, 9, 20)
    jm = JAX_FUSERS[fuser](2, 16)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(objs), 1.0)
    want = jax_apply(jm, params, jnp.asarray(x), jnp.asarray(objs), 0.7)
    module = port(tl.FUSERS[fuser](32, 20, 2, 16), params)
    with torch.no_grad():
        got = module(t(x), t(objs), 0.7)
        no_gate = module(t(x), t(objs), 0.0)
    close(got, want, atol=ATOL)
    assert float((got - t(x)).abs().max()) > 1e-2  # the fuser really acts
    assert torch.equal(no_gate, t(x))  # gate 0: the identity


def test_gated_sa2_needs_square_token_counts():
    module = tl.GatedSelfAttentionDense2(32, 20, 2, 16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="square"):
            module(torch.zeros(1, 16, 32), torch.zeros(1, 10, 20))
        with pytest.raises(ValueError, match="square"):
            module(torch.zeros(1, 15, 32), torch.zeros(1, 9, 20))


@pytest.mark.parametrize("n", [16, 64], ids=["module_path", "fused_path"])
@pytest.mark.parametrize("fuser", sorted(JAX_FUSERS))
def test_block_matches_jax(fuser, n):
    """A transformer block of each fuser at gate 0.7 (which gatedSA2 does
    not take: its gate stays 1, in both packages)."""
    rng = np.random.default_rng(1)
    x, ctx, objs = rand(rng, 2, n, 32), rand(rng, 2, 7, 24), rand(rng, 2, 16, 20)
    args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(objs))
    jm = jl.BasicTransformerBlock(2, 16, fuser)
    params = random_params(jm, *args, 1.0)
    want = jax_apply(jm, params, *args, 0.7)
    block = port(tl.BasicTransformerBlock(32, 24, 20, 2, 16, fuser_type=fuser), params)
    assert type(block.fuser) is tl.FUSERS[fuser]
    with torch.no_grad():
        got = block(t(x), t(ctx), t(objs), 0.7)
    close(got, want, atol=ATOL)
    if fuser == "gatedSA2":  # the gate stays 1 whatever the schedule says
        with torch.no_grad():
            assert torch.equal(block(t(x), t(ctx), t(objs), 0.0), got)


def test_f1_gated_sa2_block_refuses_skip_fuser():
    """F1: the reference asserts that gatedSA2 is never skipped
    (gligen_tpu/models/layers.py:608-610); the port's block raises, and the
    other fusers still skip."""
    rng = np.random.default_rng(2)
    x, ctx, objs = t(rand(rng, 1, 16, 32)), t(rand(rng, 1, 7, 24)), t(rand(rng, 1, 16, 20))
    block = tl.BasicTransformerBlock(32, 24, 20, 2, 16, fuser_type="gatedSA2")
    with torch.no_grad(), pytest.raises(ValueError, match="gatedSA2"):
        block(x, ctx, objs, 0.0, skip_fuser=True)
    for fuser in ("gatedSA", "gatedCA"):
        block = tl.BasicTransformerBlock(32, 24, 20, 2, 16, fuser_type=fuser)
        with torch.no_grad():
            block(x, ctx, None, 0.0, skip_fuser=True)
    with pytest.raises(ValueError, match="unknown fuser"):
        tl.BasicTransformerBlock(32, 24, 20, 2, 16, fuser_type="gatedXA")


@pytest.mark.parametrize("sampler", ["plms", "ddim"])
@pytest.mark.parametrize("fuser", sorted(JAX_FUSERS))
def test_fuser_unet_generate_matches_jax(fuser, sampler):
    """A small UNet of each fuser over 16 box tokens (a square count, for
    gatedSA2) through generate with the alpha stages: gatedCA's gate-0
    tail runs the fuser-free UNet, gatedSA2 runs its fusers on every call,
    as the JAX pipeline does."""
    grounding = grounding_inputs(np.random.default_rng(3), 2, n=16)
    compare_pipelines(dict(UNET, fuser_type=fuser), grounding, sampler=sampler)
