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
    FWD_TILES,
    flash_attention_plain,
    flash_fwd,
    fwd_route,
    fwd_tiles,
    tma_ok,
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
for tool in ("timing", "perf_probe", "bench_proj", "bench_block", "bench_resblock",
             "bench_sweep_attn"):
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


@pytest.mark.parametrize(
    "d,want",
    [(1, (128, 128, 3)), (20, (128, 128, 3)), (40, (128, 128, 3)), (41, (128, 128, 2)),
     (80, (128, 128, 2)), (81, (128, 64, 2)), (160, (128, 64, 2)), (161, (64, 32, 2)),
     (512, (64, 32, 2))],
)
def test_forward_tile_table(d, want):
    """(BQ, BK, stages) by head-dim class, as csrc/flash_fwd.cu:fwd_tiles
    has them (chip_smoke.py holds the built table to this one): 128 query
    rows (two consumer warpgroups) up to d = 160, 64 rows and 32-key
    stages at the VAE's 512."""
    assert fwd_tiles(d) == want
    assert [top for top, *_ in FWD_TILES] == [40, 80, 160, 512]


def test_forward_tile_table_stops_at_512():
    with pytest.raises(ValueError):
        fwd_tiles(513)


ALIGNED = (4096, 8 * 320, 320)  # (data_ptr, batch stride, row stride) of a packed tensor


@pytest.mark.parametrize(
    "d,layouts,want",
    [
        (40, [ALIGNED] * 3, True),                      # every UNet and VAE site
        (512, [(0, 4096 * 512, 512)] * 3, True),        # the VAE head, one head
        (20, [ALIGNED] * 3, False),                     # d not a multiple of 8
        (40, [(4098, 2560, 320)] + [ALIGNED] * 2, False),  # q 2 bytes off 16
        (40, [ALIGNED, (4096, 2560, 326), ALIGNED], False),  # k row stride 326
        (40, [ALIGNED, ALIGNED, (4096, 2564, 320)], False),  # v batch stride
        (40, [ALIGNED, (4096, 0, 320), ALIGNED], False),  # an expanded batch
        (40, [ALIGNED, (4096 + 640, 2 * 2560, 640), (4096 + 1280, 2 * 2560, 640)], True),
    ],
)
def test_tma_route_rule(d, layouts, want):
    """(d, alignment) -> route: TMA needs d and every batch and row stride
    a multiple of 8 elements and 16-byte aligned bases
    (csrc/flash_fwd.cu:tma_ok); the last case is k and v as column slices
    of one fused projection output."""
    assert tma_ok(d, layouts) is want


def test_route_of_real_layouts():
    """The layouts the port's callers give the kernel: packed q/k/v, k and
    v sliced from one (B, M, 2*H*C) projection, and the VAE's (B*H, N, D)."""
    def t(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    q, kv = t(2, 64, 320), t(2, 94, 640)
    assert fwd_route(q, kv[..., :320], kv[..., 320:], 8) == "tma"
    assert fwd_route(t(2, 64, 512), t(2, 64, 512), t(2, 64, 512), 1) == "tma"
    assert fwd_route(t(2, 64, 60), t(2, 70, 60), t(2, 70, 60), 3) == "copy"  # d = 20
    assert fwd_route(q[:, 1:], q[:, 1:], q[:, 1:], 8) == "tma"  # row offsets keep alignment
    odd = t(2, 64, 330)[..., 3:323]
    assert fwd_route(odd, odd, odd, 8) == "copy"


def test_wgmma_header_is_generated():
    """csrc/wgmma.cuh is exactly what csrc/gen_wgmma.py writes."""
    sys.path.insert(0, os.path.join(REPO, "gligen_tpu_torch", "csrc"))
    try:
        import gen_wgmma
    finally:
        sys.path.pop(0)
    with open(gen_wgmma.HEADER) as f:
        assert f.read() == gen_wgmma.render()


def test_bench_sweep_attn_on_the_cpu():
    """The sweep tool at a tiny size: per key count, the table's row then
    one per configuration, each held against flash_attention_plain on every
    query row, 8 rows at a time (on the CPU every row is the plain version
    itself, so exactly); the products' FLOPs and the bound from the
    shapes."""
    from gligen_tpu_torch.tools import bench_sweep_attn, timing

    configs = ((64, 64, 2), (128, 128, 3))
    b, n, h, d = 1, 24, 2, 8
    rows = bench_sweep_attn.run(batch=b, n=n, ms_keys=(24, 31), configs=configs, iters=1,
                                device="cpu", heads=h, dim=d, check_rows=8)
    assert [(r["m"], r["tiles"]) for r in rows] == [
        (m, c) for m in (24, 31) for c in (None, *configs)]
    for r in rows:
        flops = 4 * b * h * n * r["m"] * d
        nbytes = 2 * (2 * b * n + 2 * b * r["m"]) * h * d + 4 * b * h * n
        assert (r["bound_ms"], r["bound_by"]) == timing.bound(nbytes, flops)
        assert r["tflops"] == pytest.approx(flops / r["ms"] / 1e9)
        assert r["ok"] and r["max_abs_err"] == 0.0 and r["lse_err"] == 0.0
        assert r["bound_share"] is None and r["sdpa_ms"] > 0
        assert r["table"] == (fwd_tiles(d) if r["tiles"] is None else None)
    out = bench_sweep_attn.lines(rows)
    assert len(out) == 1 + len(rows) and out[1].split()[2] == "table"
    assert bench_sweep_attn.parse_configs("128x64x3,64x64x2") == ((128, 64, 3), (64, 64, 2))


@pytest.mark.parametrize("chunk", [1, 7, 24, 100])
def test_plain_by_rows_covers_every_row(chunk):
    """The sweep tool's (and chip_smoke.py's) reference at large N: the
    plain version over query-row chunks is the plain version, on every
    row, with a bias row."""
    from gligen_tpu_torch.tools.bench_sweep_attn import plain_by_rows

    rng = np.random.default_rng(chunk)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, L, 16), dtype=np.float32))
               for L in (24, 19, 19))
    bias = torch.from_numpy(rng.standard_normal((2, 19), dtype=np.float32))
    out, lse = plain_by_rows(q, k, v, 2, bias=bias, rows=chunk)
    want, want_lse = flash_attention_plain(q, k, v, 2, bias=bias)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "want_max,err,ok",
    [(0.2, 3.9e-3, True), (0.2, 4.1e-3, False), (5.0, 1.9e-2, True), (5.0, 2.1e-2, False)],
)
def test_sweep_output_limit_is_relative(want_max, err, ok):
    """A row's output passes within 2e-2 of the plain output's largest
    magnitude, and never beyond 2e-2 absolute: an all-zero output fails
    where the outputs are small."""
    from gligen_tpu_torch.tools.bench_sweep_attn import out_ok

    want = torch.full((1, 4, 8), want_max)
    lse = torch.zeros((1, 1, 4))
    assert out_ok(want - err, lse, want, lse)[2] is ok
    assert out_ok(torch.zeros_like(want), lse, want, lse)[2] is False
