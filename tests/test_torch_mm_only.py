"""K7, the matmul-only mode of the fused projection kernel, and the tools
that run it, on the CPU.

``mm_only_plain`` (ops/fused_proj.py) against the body of the JAX tool's
matmul-only Pallas kernel (tools/bench_proj.py:_mm_kernel).  The kernel is
a closure inside that tool's ``main``, so it cannot be imported; its body's
expression, ``dot_general(x, w, preferred_element_type=float32)
.astype(x.dtype)``, is what each of its independent row blocks computes,
and is held here on whole arrays.  Tolerances: in fp32 both sides sum the
same products in another order, a few fp32 ulps of O(1) outputs (2e-5, as
in tests/test_torch_fused_proj.py); on bf16 inputs both take exact fp32
products and round one fp32 sum to bf16, so the outputs differ by at most
one bf16 ulp, where the two sums straddle a rounding boundary.

The tools (gligen_tpu_torch/tools/bench_proj.py, bench_block.py,
bench_resblock.py) run here at a small width with every wrapper's device
test replaced by one that counts a launch and answers "CPU", as in
tests/test_torch_launch_counts.py, so each row's and each forward's
launches show which kernels the card would run.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu_torch.ops import basic, flash_attention, fused_conv, fused_norm
from gligen_tpu_torch.ops import fused_proj as fp
from gligen_tpu_torch.tools import bench_block, bench_proj, bench_resblock, perf_probe, timing

from test_torch_modules import rand, t

torch.set_num_threads(1)

KERNEL_ATOL = 2e-5


def mm_kernel_body(x, w):
    """_mm_kernel's expression (tools/bench_proj.py:81-85) on x (B, N, K)
    and the JAX layout's w (K, F)."""
    return jax.lax.dot_general(x, w, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32).astype(x.dtype)


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) at each value's magnitude."""
    mag = np.maximum(np.abs(v), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("b,n,k,f", [(2, 100, 96, 136), (1, 77, 40, 24), (3, 33, 200, 104)])
def test_mm_only_plain_matches_mm_kernel_fp32(b, n, k, f):
    """Row counts that are multiples of no row block (64, 128, 1024)."""
    rng = np.random.default_rng(b * 1000 + n)
    x, w = rand(rng, b, n, k), rand(rng, k, f, scale=k**-0.5)
    want = mm_kernel_body(jnp.asarray(x), jnp.asarray(w))
    got = fp.mm_only_plain(t(x), t(w.T))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize("b,n,k,f", [(2, 100, 96, 136), (3, 33, 200, 104)])
def test_mm_only_plain_matches_mm_kernel_bf16(b, n, k, f):
    rng = np.random.default_rng(b * 7 + n)
    x = torch.from_numpy(rand(rng, b, n, k)).to(torch.bfloat16)
    w = torch.from_numpy(rand(rng, f, k, scale=k**-0.5)).to(torch.bfloat16)
    want = mm_kernel_body(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(w.float().numpy().T).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = fp.mm_only_plain(x, w)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, n, f)
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= bf16_ulp(want)).all(), float(diff.max())
    assert (diff > 0).mean() < 0.05  # almost every output is the same bf16 value


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    x, w = t(rand(rng, 2, 10, 16)), t(rand(rng, 24, 16))
    before = fp.mm_only.launches
    assert torch.equal(fp.mm_only(x, w), fp.mm_only_plain(x, w))
    assert fp.mm_only.launches == before
    assert fp.KERNELS["mm_only"] is fp.mm_only


@pytest.fixture
def as_if_on_card(monkeypatch):
    """CPU tensors reach the kernel's input checks; a launch fails the test."""
    monkeypatch.setattr(fp, "on_cuda", lambda x, op: True)

    def no_launch(self, *args):
        raise AssertionError("launched past the input checks")

    monkeypatch.setattr(fp.MmOnly, "_launch", no_launch)


@pytest.mark.parametrize(
    "x_shape,w_shape,dtype,w_device,error,match",
    [
        ((4, 16), (24, 16), torch.float32, "cpu", TypeError, "bfloat16"),   # bf16 only
        ((4, 20), (24, 20), torch.bfloat16, "cpu", ValueError, "multiple of 8"),  # K = 20
        ((4, 16), (20, 16), torch.bfloat16, "cpu", ValueError, "multiple of 8"),  # F = 20
        ((4, 16), (24, 32), torch.bfloat16, "cpu", ValueError, "do not fit"),
        ((4, 16), (24, 16), torch.bfloat16, "meta", ValueError, "is on meta"),  # another device
    ],
)
def test_kernel_input_checks(as_if_on_card, x_shape, w_shape, dtype, w_device, error, match):
    x = torch.zeros(x_shape, dtype=dtype)
    w = torch.zeros(w_shape, dtype=torch.bfloat16, device=w_device)
    with pytest.raises(error, match=match):
        fp.mm_only(x, w)


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA card is refused."""
    x, w = torch.empty((2, 8, 16), device="meta"), torch.empty((16, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fp.mm_only(x, w)


def test_an_input_that_requires_grad_raises():
    """Forward only, as in the JAX tool: no output without a gradient path."""
    x, w = torch.randn(4, 16, requires_grad=True), torch.randn(8, 16)
    with pytest.raises(RuntimeError, match="forward only"):
        fp.mm_only(x, w)
    with pytest.raises(RuntimeError, match="forward only"):
        fp.mm_only(x.detach(), w.requires_grad_())
    with torch.no_grad():
        assert torch.equal(fp.mm_only(x, w), fp.mm_only_plain(x.detach(), w.detach()))


def test_profiler_names_the_matmul_mode():
    """A trace that holds K7 does not break the breakdown (mode digit 3 of
    ``fused_proj_kernel<MODE, BM, BN, STAGES>``)."""
    name = ("void (anonymous namespace)::fused_proj_kernel<3, 128, 256, 3>"
            "((anonymous namespace)::Params)")
    assert perf_probe.category(name) == "mm_only (K7)"
    assert perf_probe.category(name.replace("<3, 128, 256, 3>", "<2, 64, 128, 2>")) == "ln_geglu"


# ---------------------------------------------------------------- the tools

@pytest.fixture
def counted(monkeypatch):
    """Every wrapper's device test counts a launch on the wrapper and
    answers "CPU"; the norm dispatchers route as on the card.  Counts start
    at 0 and are restored after the test."""
    wrappers = {**flash_attention.KERNELS, **fp.KERNELS, **fused_norm.KERNELS,
                **fused_conv.KERNELS}
    for w in wrappers.values():
        monkeypatch.setattr(w, "launches", 0)

    def counting(x, op):
        wrappers[op].launches += 1
        return False

    for module in (flash_attention, fp, fused_norm, fused_conv):
        monkeypatch.setattr(module, "on_cuda", counting)
    monkeypatch.setattr(basic, "_on_card", lambda x: True)
    for name in ("GLIGEN_TPU_FUSED_PROJ", "GLIGEN_TPU_FUSED_NORM", "GLIGEN_TPU_FUSED_CONV"):
        monkeypatch.delenv(name, raising=False)
    return wrappers


def test_bench_proj_on_the_cpu(counted):
    """The sites, their FLOPs and bytes, the bound, and each row's
    launches: K7 rows reach mm_only alone, K2 rows never mm_only; each K7
    row holds its outputs against mm_only_plain (here the plain version
    itself, so exactly), with one more launch per product; no row block is
    read on the CPU."""
    b, n, c, iters = 1, 64, 32, 1
    rows = bench_proj.run(batch=b, n=n, iters=iters, device="cpu", channels=c)
    m = b * n
    sites = [(f"q/k/v {c}->3x{c}", "ln_matmuls", [(c, c)] * 3),
             (f"to_out {c}->{c} gated", "matmul_residual", [(c, c)]),
             (f"GEGLU {c}->2x{4 * c}", "ln_geglu", [(c, 8 * c)]),
             (f"net_2 {4 * c}->{c}", "matmul_residual", [(4 * c, c)])]
    assert [(r["site"], r["kernel"]) for r in rows] == [
        (site, kind) for site, k2, _ in sites for kind in (k2, "mm_only")]
    calls = iters + 1  # a warm-up, then the timed calls
    for (site, k2, products), k2_row, k7_row in zip(sites, rows[::2], rows[1::2]):
        flops = sum(2 * m * k * f for k, f in products)
        k7_bytes = sum(2 * (m * k + f * k + m * f) for k, f in products)
        assert k2_row["flops"] == k7_row["flops"] == flops
        assert k7_row["bytes"] == k7_bytes
        assert k2_row["cublas_ms"] == k7_row["cublas_ms"] > 0
        for row in (k2_row, k7_row):
            assert (row["bound_ms"], row["bound_by"]) == timing.bound(row["bytes"], flops)
            assert row["ms"] > 0 and row["peak_share"] is None and row["row_blocks"] is None
        assert k7_row["launches"] == {"mm_only": calls * len(products), "K2": 0}
        assert k2_row["launches"] == {"mm_only": 0, "K2": calls}
        assert (k7_row["max_abs_err"], k7_row["ok"]) == (0.0, True)
        assert k7_row["check_launches"] == len(products)
        assert (k2_row["max_abs_err"], k2_row["ok"]) == (None, None)
    assert counted["mm_only"].launches == sum(
        r["launches"]["mm_only"] + r["check_launches"] for r in rows[1::2])
    # K2's bytes: x read once for all three of q/k/v, not once per product
    qkv = rows[0]["bytes"]
    assert qkv == 2 * m * c + 8 * c + 3 * 2 * c * c + 3 * 2 * m * c
    assert rows[1]["bytes"] - qkv == 2 * (2 * m * c) - 8 * c
    assert len(bench_proj.lines(rows)) == 1 + len(rows)


def test_row_block_mirrors_wide_rows(monkeypatch):
    """The tiles (row block, BN, stages) a row prints are the ones the tile
    table chose for each launch, read from the kernel's name
    ``fused_proj_kernel<MODE, BM, BN, STAGES>`` in the call's trace; other
    kernels and host events are passed over."""
    assert perf_probe.fused_proj_template("fused_proj_kernel<3, 128, 256, 3>") == (3, 128, 256, 3)
    assert perf_probe.fused_proj_template(
        "void (anonymous namespace)::fused_proj_kernel<0, 64, 160, 4>((anonymous namespace)::Params)"
    ) == (0, 64, 160, 4)
    names = ["void (anonymous namespace)::fused_proj_kernel<3, 128, 160, 4>(Params)",
             "void (anonymous namespace)::fused_proj_kernel<1, 64, 160, 3>(Params)",
             "void (anonymous namespace)::fused_proj_kernel<3, 128, 160, 4>(Params)",
             "nvjet_tst_128x64_64x8_1x2_h_bz_TNT"]
    trace = {"traceEvents": [{"ph": "X", "cat": "kernel", "name": n} for n in names]
             + [{"ph": "X", "cat": "cpu_op", "name": "fused_proj_kernel<2, 32, 64, 2>"}]}
    monkeypatch.setattr(perf_probe, "traced", lambda fn: (fn(), trace))
    assert bench_proj.row_blocks(lambda: None) == ((64, 160, 3), (128, 160, 4))


def test_bench_proj_sweep_on_the_cpu():
    """The sweep's rows: per site the table's tiles first, then each sweep
    configuration that fits the site's shared memory (none of the LN modes'
    128-row ones at K 1280); every row held against the plain version (here
    the plain version itself, so exactly)."""
    sites = [("ds1", "ln_matmuls", 64, 32, 32, 3), ("ds1", "matmul_residual", 64, 128, 32, 1),
             ("ds1", "ln_geglu", 64, 32, 128, 1), ("ds1", "mm_only", 64, 32, 256, 1),
             ("mid", "ln_matmuls", 16, 1280, 64, 3), ("mid", "ln_geglu", 16, 1280, 64, 1)]
    rows = bench_proj.run_sweep(iters=1, device="cpu", sites=sites)
    want = []
    for level, kind, m, k, f, n_w in sites:
        table = fp.proj_tiles(kind, m, k, f)
        want += [(level, kind, table, True)] + [
            (level, kind, t, False) for t in bench_proj.SWEEP_TILES[kind]
            if t != table and fp.proj_smem(kind, t, k) <= fp.MAX_BLOCK_SMEM]
    assert [(r["level"], r["kind"], r["tiles"], r["table"]) for r in rows] == want
    # at K 1280 a 128-row panel (320 KB) fits no block: only 64-row tiles
    mid = [r["tiles"] for r in rows if r["level"] == "mid" and r["kind"] == "ln_matmuls"]
    assert mid[0] == fp.proj_tiles("ln_matmuls", 16, 1280, 64) and len(mid) > 1
    assert all(t[0] == 64 for t in mid)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 and r["bound_share"] is None for r in rows)
    assert len(bench_proj.sweep_lines(rows)) == 1 + len(rows)
    # the ds1 sites of the tool, K7's three products, and the K2 sites of ds4 and mid
    full = bench_proj.sweep_sites(batch=16)
    assert [s[:2] for s in full[:7]] == [("ds1", k) for k in (
        "ln_matmuls", "matmul_residual", "ln_geglu", "matmul_residual", "mm_only", "mm_only",
        "mm_only")]
    assert [s[0] for s in full[7:]] == ["ds4"] * 4 + ["mid"] * 4
    assert full[0][2] == 16 * 4096 and full[7][2] == 1024 and full[11][2] == 256


@pytest.mark.parametrize("proj", ["1", "0"])
def test_bench_block_on_the_cpu(counted, monkeypatch, proj):
    """One block of 2 heads x 16 at 8x8 (64 tokens, the fused floor): each
    forward runs 3 flash launches, the ST GroupNorm and, on the fused path,
    4 ln_matmuls, 5 matmul_residual and 2 ln_geglu."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_PROJ", proj)
    result = bench_block.run(batch=1, hw=8, heads=2, dim_head=16, iters=1, device="cpu")
    assert result["out_finite"] and result["ms"] > 0 and result["breakdown"] is None
    assert result["switches"] == {"FUSED_PROJ": proj, "FUSED_NORM": "gn"}
    assert result["shape"] == (1, 8, 8, 32)
    forwards = 3  # the checked one, a warm-up and one timed
    per_forward = {"flash_fwd": 3, "group_norm": 1, "mm_only": 0,
                   **({"ln_matmuls": 4, "matmul_residual": 5, "ln_geglu": 2} if proj == "1"
                      else {"ln_matmuls": 0, "matmul_residual": 0, "ln_geglu": 0})}
    assert {k: counted[k].launches for k in per_forward} == {
        k: forwards * v for k, v in per_forward.items()}
    assert bench_block.lines(result)[0].startswith("block forward: ")


@pytest.mark.parametrize("conv", ["0", "1"])
def test_bench_resblock_on_the_cpu(counted, monkeypatch, conv):
    """Two ResBlocks of 32 channels at 8x8: two GroupNorms each, or two
    fused convs each under FUSED_CONV=1."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_CONV", conv)
    b, hw, c, blocks = 1, 8, 32, 2
    result = bench_resblock.run(batch=b, hw=hw, channels=c, blocks=blocks, iters=1, device="cpu")
    assert result["out_finite"] and result["ms"] > 0
    assert result["switches"] == {"FUSED_NORM": "gn", "FUSED_CONV": conv}
    flops = blocks * 2 * 2 * b * hw * hw * 9 * c * c
    assert math.isclose(result["tflops"], flops / result["ms"] / 1e9)
    per_run = 3 * 2 * blocks  # three forwards of two norms (or convs) per block
    fused = conv == "1"
    assert counted["gn_silu_conv3x3"].launches == (per_run if fused else 0)
    assert counted["gn_affine"].launches == (per_run if fused else 0)
    assert counted["group_norm"].launches == (0 if fused else per_run)
    assert bench_resblock.lines(result)[0].startswith(f"resblock x{blocks}: ")
