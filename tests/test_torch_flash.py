"""The flash-attention kernel's plain version (gligen_tpu_torch
ops/flash_attention.py) against the Pallas kernels it ports, run in
interpret mode on the CPU, and against the XLA attention path.

Inputs are fp32 from a numpy seed.  Tolerance 2e-5: the Pallas kernels
and the plain version both take fp32 scores and softmax; they differ in
summation order and in the online (Pallas) vs one-pass (plain) softmax,
which agree to a few fp32 ulps at O(1) outputs.  The kernel itself runs
only on the card: tests/test_torch_flash_cuda.py and chip_smoke.py hold
it to this plain version there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gligen_tpu.ops.attention import multi_head_attention as jax_mha
from gligen_tpu.ops.pallas_attention import flash_attention as jax_flash
from gligen_tpu.ops.pallas_attention import flash_attention_packed as jax_flash_packed

from gligen_tpu_torch.ops.attention import multi_head_attention
from gligen_tpu_torch.ops.flash_attention import (
    LOG2E,
    NEG_INF,
    _check_inputs,
    flash_attention,
    flash_attention_packed,
    flash_attention_plain,
    flash_fwd,
)

torch.set_num_threads(1)

ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "b,h,n,m,c",
    [
        (2, 2, 64, 64, 40),   # attn1 head dim at ds1
        (2, 2, 64, 94, 80),   # fuser: N + 30 keys, ds2 head dim
        (1, 3, 40, 77, 40),   # cross-attention over 77 text tokens, ragged N
    ],
)
def test_plain_matches_pallas_packed(b, h, n, m, c):
    rng = np.random.default_rng(b * 1000 + m)
    q, k, v = rand(rng, b, n, h * c), rand(rng, b, m, h * c), rand(rng, b, m, h * c)
    want = jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True)
    got = flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_padded_key_tail_equals_ragged_keys():
    """The TPU's fuser form (N+30 keys padded to a multiple of 128, masked
    by a bias row) equals the port's unpadded N+30 keys."""
    rng = np.random.default_rng(3)
    b, h, n, c, m_real, m_pad = 2, 2, 64, 40, 94, 128
    q = rand(rng, b, n, h * c)
    k, v = np.zeros((2, b, m_pad, h * c), np.float32)
    k[:, :m_real], v[:, :m_real] = rand(rng, b, m_real, h * c), rand(rng, b, m_real, h * c)
    mask = np.arange(m_pad)[None, :].repeat(b, 0) < m_real
    want = jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                            key_mask=jnp.asarray(mask), interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    padded = flash_attention_packed(tq, tk, tv, h, key_mask=torch.from_numpy(mask))
    ragged = flash_attention_packed(tq, tk[:, :m_real], tv[:, :m_real], h)
    np.testing.assert_allclose(padded.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ragged.numpy(), padded.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bh,n,m,d,with_bias", [(2, 128, 128, 512, False), (2, 96, 160, 64, True)])
def test_plain_matches_pallas_streamed(bh, n, m, d, with_bias):
    """block_kv below M forces the streamed (online-softmax) Pallas kernel;
    d = 512 is the VAE mid-attention's single head."""
    rng = np.random.default_rng(n + d)
    q, k, v = rand(rng, bh, n, d), rand(rng, bh, m, d), rand(rng, bh, m, d)
    bias = (rand(rng, bh, 1, m) * 0.5) if with_bias else None
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=None if bias is None else jnp.asarray(bias),
                     block_q=64, block_kv=64, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,n,m,c", [(2, 2, 64, 64, 40), (2, 1, 64, 64, 512), (2, 8, 16, 77, 80)])
def test_multi_head_attention_matches_xla_path(b, h, n, m, c):
    rng = np.random.default_rng(h * 100 + c)
    q, k, v = rand(rng, b, n, h * c), rand(rng, b, m, h * c), rand(rng, b, m, h * c)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, implementation="xla")
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_lse_is_log2_logsumexp_with_bias():
    rng = np.random.default_rng(5)
    b, h, n, m, c = 2, 2, 8, 13, 16
    q, k, v = rand(rng, b, n, h * c), rand(rng, b, m, h * c), rand(rng, b, m, h * c)
    bias = rand(rng, b, m)
    bias[:, -3:] = NEG_INF
    _, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), h,
                                   bias=torch.from_numpy(bias))
    s = np.einsum("bnhc,bmhc->bhnm", q.reshape(b, n, h, c).astype(np.float64),
                  k.reshape(b, m, h, c)) * c**-0.5 + bias[:, None, None, :]
    top = s.max(-1, keepdims=True)
    want = (np.log(np.exp(s - top).sum(-1)) + top[..., 0]) * LOG2E
    assert lse.shape == (b, h, n)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rand(rng, 1, 8, 32)) for _ in range(3))
    before = flash_fwd.launches
    out, _ = flash_fwd(q, k, v, 2)
    want, _ = flash_attention_plain(q, k, v, 2)
    assert torch.equal(out, want)
    assert flash_fwd.launches == before


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(dtype=torch.float32), TypeError),        # the kernel takes bf16 only
        (dict(m_k=9), ValueError),                      # k and v lengths differ
        (dict(c=520), ValueError),                      # head dim above 512
        (dict(bias=torch.float16), TypeError),          # bias must be fp32
        (dict(transposed=True), ValueError),            # last stride must be 1
    ],
)
def test_kernel_input_checks(change, error):
    """What the kernel does not take raises before any launch."""
    b, n, m, h, c = 2, 8, 8, 2, change.get("c", 16)
    dt = change.get("dtype", torch.bfloat16)
    q = torch.zeros((b, n, h * c), dtype=dt)
    k = torch.zeros((b, m, h * c), dtype=dt)
    v = torch.zeros((b, change.get("m_k", m), h * c), dtype=dt)
    if change.get("transposed"):
        q = torch.zeros((b, h * c, n), dtype=dt).transpose(1, 2)
    bias = torch.zeros((b, m), dtype=change["bias"]) if "bias" in change else None
    with pytest.raises(error):
        _check_inputs(q, k, v, h, bias)


def test_port_imports_without_jax_or_nvcc():
    """Every module of the port (the training package and the tools
    included) imports, and a CPU call, its backward, an optimizer step and
    the projection budget tool run, in a Python where jax, flax and
    gligen_tpu cannot be imported and no nvcc is on the PATH; only a kernel
    build asks for nvcc."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "gligen_tpu"):
    sys.modules[name] = None
import gligen_tpu_torch, torch
for mod in pkgutil.walk_packages(gligen_tpu_torch.__path__, "gligen_tpu_torch."):
    importlib.import_module(mod.name)
assert "gligen_tpu_torch.training.train_step" in sys.modules
for tool in ("timing", "perf_probe", "bench_proj", "bench_block", "bench_resblock"):
    assert f"gligen_tpu_torch.tools.{tool}" in sys.modules, tool
from gligen_tpu_torch.tools import bench_proj
assert len(bench_proj.run(batch=1, n=8, iters=1, device="cpu", channels=16)) == 8
from gligen_tpu_torch.ops import cuda_build
from gligen_tpu_torch.ops.attention import multi_head_attention
from gligen_tpu_torch.training.train_step import lr_multiplier, make_optimizer
x = torch.randn(1, 4, 16, requires_grad=True)
out = multi_head_attention(x, x, x, 2)
assert out.shape == (1, 4, 16)
out.sum().backward()  # the flash Function's plain backward on the CPU
opt, sched = make_optimizer([x], warmup_steps=2)
opt.step()
assert lr_multiplier(2, 10)(1) == 0.5
cuda_build.NVCC_CANDIDATES = ()
try:
    cuda_build.find_nvcc()
except RuntimeError as e:
    print("nvcc:", e)
else:
    raise SystemExit("found an nvcc")
print("ok")
"""
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
