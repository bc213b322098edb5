"""The fp32 routes of the fused projections (K2) and the fused conv (K6) on
the tensor cores: csrc/gemm_tf32.cuh's 3xTF32 decomposition in torch,
against the plain versions and the JAX kernels (interpret mode, fp32 x);
and the fp32 routes' tile tables and plans.

The decomposition, as the kernels compute it: each operand split once into
halves, x = hi + lo (hi = rna(x), TF32, as ``tests/test_torch_flash.py:
tf32_rna``; lo = x - hi, which the tensor cores truncate to TF32); per
chain a fresh accumulator of hi.hi + hi.lo + lo.hi (products exact, their
sum rounded to fp32 once: the tensor cores' own order is not modelled),
added in fp32 to the running sum chain by chain; split-K ranges summed in
order 0, 1, ... (the kernels' reductions).  K2's chains are 32-column
k-slices, its LayerNorm one-pass fp32 statistics applied before the split;
K6 activates silu(x a + v) in fp32, and its chains are 32-channel slices
of nine taps each.

Tolerance: FP32_REL_TOL = 1e-4 of the plain output's largest magnitude,
the card's (chip_smoke.FP32_REL_TOL), against the plain versions and the
JAX kernels alike.  At the full K = 23,040 of the 8^2 conv one TF32 pass
exceeds it, so the tolerance tells the two apart.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gligen_tpu.ops import pallas_conv as jpc
from gligen_tpu.ops import pallas_matmul as pm

from gligen_tpu_torch.ops import fused_conv as fc
from gligen_tpu_torch.ops import fused_proj as fp
from gligen_tpu_torch.ops import launch

from test_torch_flash import tf32_rna
from test_torch_modules import rand, t

torch.set_num_threads(1)

FP32_REL_TOL = 1e-4
REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gligen_tpu_torch" / "csrc"


def tc_split(x):
    """(hi, lo) as the tensor cores see the kernels' split: hi = rna(x),
    and lo = x - hi (exact in fp32) truncated to TF32's top 19 bits."""
    x = x.contiguous()
    hi = tf32_rna(x)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def chain(pairs, passes=3):
    """One chain of the tensor cores: the sum of a @ w.T over ``pairs`` of
    k-slices, from TF32 halves (3 passes, or one hi.hi pass), exact
    products summed and rounded to fp32 once."""
    out = 0.0
    for a, w in pairs:
        (ah, al), (wh, wl) = tc_split(a), tc_split(w)
        out = out + ah.double() @ wh.double().T
        if passes == 3:
            out = out + ah.double() @ wl.double().T + al.double() @ wh.double().T
    return out.float()


def ranges(total, parts):
    """gemm_tf32.cuh:range_start: ``total`` items cut into ``parts`` in order."""
    return [(z * total // parts, (z + 1) * total // parts) for z in range(parts)]


def in_order(partials):
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return out


def tc_matmul(a, w, split=1, passes=3):
    """a (M, K) @ w (F, K).T as the K2 kernel: chains of 32-column
    k-slices added in fp32, slice ranges summed in order."""
    kslices = -(-a.shape[1] // 32)
    return in_order([in_order([chain([(a[:, 32 * s:32 * s + 32], w[:, 32 * s:32 * s + 32])],
                                     passes) for s in range(s0, s1)])
                     for s0, s1 in ranges(kslices, split)])


def ln_rows(x, s, b, eps=1e-5):
    """The converter's LayerNorm: one pass of fp32 sums and sums of squares,
    the variance clamped at 0."""
    k = x.shape[-1]
    mean = x.sum(-1, keepdim=True) / k
    var = ((x * x).sum(-1, keepdim=True) / k - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * s + b


def geglu(hg, wb):
    a, g = (hg + wb).chunk(2, dim=-1)
    return a * (0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476)))


def conv_model(x, a, v, w, wb, res=None, split=1, passes=3):
    """The K6 fp32 route: silu(x a + v) in fp32 with the padding after it,
    as im2col rows in (tap, c) order; a chain per 32-channel slice over its
    nine taps, ranges of slices summed in order; + bias (+ residual)."""
    b, h, wd, c = x.shape
    f = w.shape[0]
    xn = F.silu(x * a[:, None, None, :] + v[:, None, None, :])
    cols = F.pad(xn, (0, 0, 1, 1, 1, 1))
    taps = [cols[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c) for dy in range(3) for dx in range(3)]
    wk = w.permute(0, 2, 3, 1).reshape(f, 9, c)
    partials = []
    for s0, s1 in ranges(-(-c // 32), split):
        partials.append(in_order([
            chain([(taps[tap][:, 32 * s:32 * s + 32], wk[:, tap, 32 * s:32 * s + 32])
                   for tap in range(9)], passes) for s in range(s0, s1)]))
    out = in_order(partials) + wb
    if res is not None:
        out = out + res.reshape(-1, f)
    return out.reshape(b, h, wd, f)


def within(got, want):
    err = (got - want).abs().max().item()
    limit = FP32_REL_TOL * torch.as_tensor(want).abs().max().item()
    return err, limit


def assert_within(got, want):
    err, limit = within(got, torch.as_tensor(np.array(want)))
    assert err <= limit, (err, limit)


# -------------------------------------------------- the decomposition

@pytest.mark.parametrize("n_w,n,c,f,split", [(3, 100, 96, 128, 1), (2, 94, 200, 64, 2),
                                             (1, 64, 1280, 96, 3)])
def test_ln_matmuls_decomposition_matches_jax(n_w, n, c, f, split):
    """ln_matmuls_f32's decomposition (LN once per row, 1-3 weights, split
    ranges) against the plain version and the Pallas kernel in interpret
    mode, fp32 x."""
    rng = np.random.default_rng(n_w * 100 + n + split)
    x = rand(rng, 2, n, c) * 2.0 + 0.3
    s, b = 1.0 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    ws = [rand(rng, c, f, scale=c**-0.5) for _ in range(n_w)]
    want = pm.ln_matmuls(*(jnp.asarray(z) for z in (x, s, b)), tuple(jnp.asarray(w) for w in ws),
                         block_n=64, interpret=True)
    plain = fp.ln_matmuls_plain(t(x), t(s), t(b), [t(w.T) for w in ws])
    ln = ln_rows(t(x).reshape(-1, c), t(s), t(b))
    for w, jw, pw in zip(ws, want, plain):
        got = tc_matmul(ln, t(np.ascontiguousarray(w.T)), split).reshape(2, n, f)
        assert_within(got, jw)
        assert_within(got, pw)


@pytest.mark.parametrize("k,c,gate,split", [(256, 64, 0.43, 1), (640, 96, None, 4),
                                            (5120, 32, 0.7, 8)])
def test_matmul_residual_decomposition_matches_jax(k, c, gate, split):
    """matmul_residual_f32's: x + g (h @ W + b) after the ranges' sum."""
    rng = np.random.default_rng(k + c)
    h, x = rand(rng, 2, 96, k), rand(rng, 2, 96, c)
    w, b = rand(rng, k, c, scale=k**-0.5), rand(rng, c, scale=0.1)
    want = pm.matmul_residual(*(jnp.asarray(z) for z in (h, w, b, x)), gate=gate, block_n=64,
                              interpret=True)
    plain = fp.matmul_residual_plain(t(h), t(w.T), t(b), t(x), gate=gate)
    g = 1.0 if gate is None else gate
    prod = tc_matmul(t(h).reshape(-1, k), t(np.ascontiguousarray(w.T)), split)
    got = (t(x).reshape(-1, c) + (prod + t(b)) * g).reshape(2, 96, c)
    assert_within(got, want)
    assert_within(got, plain)


@pytest.mark.parametrize("n,c,split", [(64, 96, 1), (72, 320, 2)])
def test_ln_geglu_decomposition_matches_jax(n, c, split):
    """ln_geglu_f32's: the a and gate halves of one product, the exact-erf
    GEGLU after the ranges' sum."""
    rng = np.random.default_rng(n + c)
    x = rand(rng, 2, n, c)
    s, b = 1.0 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)
    w, wb = rand(rng, c, 8 * c, scale=c**-0.5), rand(rng, 8 * c, scale=0.1)
    want = pm.ln_geglu(*(jnp.asarray(z) for z in (x, s, b, w, wb)), block_n=32, interpret=True)
    plain = fp.ln_geglu_plain(t(x), t(s), t(b), t(w.T), t(wb))
    ln = ln_rows(t(x).reshape(-1, c), t(s), t(b))
    got = geglu(tc_matmul(ln, t(np.ascontiguousarray(w.T)), split), t(wb)).reshape(2, n, 4 * c)
    assert_within(got, want)
    assert_within(got, plain)


def conv_case(seed, b, h, w, c, f, residual):
    rng = np.random.default_rng(seed)
    x = rand(rng, b, h, w, c) * 2.0 + 0.3
    s, sb = 1.0 + rand(rng, c, scale=0.2), rand(rng, c, scale=0.1) + 1.0
    wk = rand(rng, 3, 3, c, f, scale=(9 * c) ** -0.5)  # HWIO, as the JAX kernel takes it
    wb = rand(rng, f, scale=0.1)
    res = rand(rng, b, h, w, f) if residual else None
    return x, s, sb, wk, wb, res


@pytest.mark.parametrize("shape,residual,split", [((2, 8, 8, 64, 96), True, 1),
                                                  ((1, 8, 16, 96, 40), False, 3),
                                                  ((2, 4, 8, 32, 64), True, 1)])
def test_conv_decomposition_matches_jax(shape, residual, split):
    """gn_silu_conv3x3_f32's decomposition against the plain version and
    the Pallas kernel in interpret mode (fp32 x): a ragged last slice (C =
    96), split ranges, the residual."""
    b, h, w, c, f = shape
    x, s, sb, wk, wb, res = conv_case(sum(shape), b, h, w, c, f, residual)
    jres = None if res is None else jnp.asarray(res)
    want = jpc.gn_silu_conv3x3(*(jnp.asarray(z) for z in (x, s, sb, wk, wb)), residual=jres,
                               interpret=True)
    a, v = fc.gn_affine_plain(t(x), t(s), t(sb))
    woihw = t(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))
    tres = None if res is None else t(res)
    plain = fc._ref_chain(t(x), a, v, woihw, t(wb), tres)
    got = conv_model(t(x), a, v, woihw, t(wb), tres, split)
    assert_within(got, want)
    assert_within(got, plain)


def test_full_k_conv_is_fp32_accurate_and_one_tf32_pass_is_not():
    """The 8^2 conv's full K = 9 x 2560 = 23,040, at one sample's 64 pixels
    and 16 output channels: the 3xTF32 decomposition with the kernel's
    split (3 ranges) is within the tolerance of the plain version and of
    the JAX kernel, and one TF32 pass exceeds it."""
    b, h, w, c, f = 1, 8, 8, 2560, 16
    x, s, sb, wk, wb, _ = conv_case(5, b, h, w, c, f, False)
    want = jpc.gn_silu_conv3x3(*(jnp.asarray(z) for z in (x, s, sb, wk, wb)), interpret=True)
    a, v = fc.gn_affine_plain(t(x), t(s), t(sb))
    woihw = t(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))
    plain = fc._ref_chain(t(x), a, v, woihw, t(wb))
    split = fc.conv_plan_f32(4, 8, 8, 2560, 1280)[3]
    assert split == 3
    got = conv_model(t(x), a, v, woihw, t(wb), None, split)
    assert_within(got, want)
    assert_within(got, plain)
    one_pass = conv_model(t(x), a, v, woihw, t(wb), None, split, passes=1)
    err, limit = within(one_pass, plain)
    assert err > limit, (err, limit)


# -------------------------------------------------- tables and plans

sys.path.insert(0, str(CSRC))
try:
    import gen_wgmma
finally:
    sys.path.pop(0)

_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def c_lists(source, macros):
    """{macro: [(BM, BN, stages), ...]} of csrc/<source>'s X-macro lists."""
    text = (CSRC / source).read_text()
    out = {}
    for macro in macros:
        body = re.search(rf"#define {macro}\(X\) (.*)", text).group(1)
        out[macro] = [tuple(map(int, x)) for x in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
    return out


def test_c_dispatch_holds_the_fp32_tables():
    """The serving libraries hold exactly the fp32 tables' configurations:
    dispatch_f32 and gn_silu_conv3x3_f32 refuse any other."""
    assert c_lists("fused_proj.cu", ("PROJ_F32_CONFIGS",))["PROJ_F32_CONFIGS"] == list(
        fp.PROJ_TILES_F32)
    assert c_lists("fused_conv.cu", ("CONV_F32_CONFIGS",))["CONV_F32_CONFIGS"] == list(
        fc.CONV_TILES_F32)


def test_fp32_tiles_fit_shared_memory_and_wgmma():
    """Each configuration fits a block's 227 KB (the projections' at any K,
    the conv's at the widest UNet map of 512^2 for 128 rows, of 1024^2 for
    64), and its BN is a width gen_wgmma.py writes for the form it issues:
    WgmmaRsTf32 (K2 and K6); ln_geglu's a and gate halves are whole
    8-column groups."""
    for bm, bn, stages in fp.PROJ_TILES_F32:
        for k in (8, 320, 640, 1280, 5120):
            assert fp.proj_smem_f32((bm, bn, stages), k)[0] <= fp.MAX_BLOCK_SMEM
        assert bm in (64, 128) and stages >= 2 and bn in gen_wgmma.RS_TF32_WIDTHS
        assert (bn // 2) % 8 == 0
    big, small = fc.CONV_TILES_F32
    assert fc.conv_smem_f32(big, 64) <= fc.MAX_BLOCK_SMEM < fc.conv_smem_f32(big, 128)
    assert fc.conv_smem_f32(small, 128) <= fc.MAX_BLOCK_SMEM
    assert fc.conv_smem_f32(small, 10**6) <= fc.MAX_BLOCK_SMEM
    for bm, bn, stages in fc.CONV_TILES_F32:
        assert bm in (64, 128) and stages >= 2 and bn in gen_wgmma.RS_TF32_WIDTHS


def test_fp32_smem_follows_the_c_layout():
    """ProjTf32Tile and ConvTf32Tile by hand."""
    # with the panel: 3 stages of W hi + lo (80 x 128 B), 11 barriers, a
    # (mean, rstd) pair for each of 128 rows -> the panel at 63,488; K = 320
    # resident, 10 slices of 128 x 128 B (228,352 bytes, within 232,448)
    assert fp.proj_smem_f32((128, 80, 3), 320) == (63488 + 10 * 16384 + 1024, True)
    # K = 640 streams: 3 stages of A (128 x 128 B) and W hi + lo, no panel;
    # a split of 4 leaves 10 of K = 1280's 40 slices to a block, resident
    assert fp.proj_smem_f32((128, 80, 3), 640) == (112640 + 1024, False)
    assert fp.proj_smem_f32((128, 80, 3), 1280, split=4) == (63488 + 10 * 16384 + 1024, True)
    # 3 stages of W hi + lo (64 x 128 B), 11 barriers -> the zero row at
    # 49,280, the halos at 50,176: 4 x 258 rows at W = 64 and BM 128, and
    # the raw rows, two boxes of 130 (one window); at BM 64 and W = 128,
    # three windows: 4 x 198 rows and three boxes of 66
    assert fc.conv_smem_f32((128, 64, 3), 64) == 50176 + (4 * 258 + 2 * 130) * 128 + 1024
    assert fc.conv_smem_f32((64, 64, 3), 128) == 50176 + (4 * 198 + 3 * 66) * 128 + 1024


def proj_shapes():
    """(mode, M, K, F, weights) of every K2 launch of chip_smoke.py's phase 3."""
    out = []
    for _, kind, b, n, c, k in chip_smoke.proj_cases(2):
        m = b * n
        out.append({"ln_matmuls": (kind, m, c, c, k), "matmul_residual": (kind, m, k, c, 1),
                    "ln_geglu": (kind, m, c, 4 * c, 1)}[kind])
    return out


def conv_shapes():
    with torch.device("meta"):
        from gligen_tpu_torch.models import unet as tu
        unet = tu.UNetModel()
    return [(b, h, h, cin, cout) for latent in (64, 128)
            for _, b, h, cin, cout, _ in chip_smoke.conv_cases(unet, 2, latent)]


@pytest.mark.parametrize("shape", proj_shapes(), ids=lambda s: "-".join(map(str, s)))
def test_every_proj_shape_has_an_fp32_plan(shape):
    """Every K2 shape of a 512^2 request: the table's tiles, whose output
    columns divide F, a split of at most the k-slices; the narrow shapes
    whose tiles leave SMs idle (the middle block's to_out and net_2: 32
    tiles of 128 x 80) are split to cover the card in one wave."""
    mode, m, k, f, n_w = shape
    bm, bn, stages, split = fp.proj_plan_f32(mode, m, k, f, n_w)
    out = bn // 2 if mode == "ln_geglu" else bn
    assert (bm, bn, stages) in fp.PROJ_TILES_F32 and f % out == 0
    assert 1 <= split <= min(launch.SPLIT_MOST, -(-k // 32))
    units = -(-m // bm) * n_w * -(-f // out)
    if mode == "matmul_residual" and m == 256:
        assert units < launch.SMS and 0.9 * launch.SMS <= units * split <= launch.SMS


@pytest.mark.parametrize("shape", conv_shapes(), ids=lambda s: "-".join(map(str, s)))
def test_every_conv_shape_has_an_fp32_plan(shape):
    """Every ResBlock conv at 512^2 and 1024^2: configuration of the
    library that fits shared memory (128 rows up to W 64, then 64), a split
    of at most the 32-channel slices; the 8^2 convs fill the card in one
    wave."""
    b, h, w, c, f = shape
    bm, bn, stages, split = fc.conv_plan_f32(b, h, w, c, f)
    assert (bm, bn, stages) in fc.CONV_TILES_F32
    assert fc.conv_smem_f32((bm, bn, stages), w) <= fc.MAX_BLOCK_SMEM
    assert bm == (128 if w <= 64 else 64)
    assert 1 <= split <= min(launch.SPLIT_MOST, -(-c // 32))
    units = -(-(b * h * w) // bm) * -(-f // bn)
    if h == 8:
        assert units < launch.SMS and 0.9 * launch.SMS <= units * split <= launch.SMS


def test_split_k_weighs_waves_against_the_reduction():
    """No split where the tiles already fill whole waves; one where a
    ragged second wave costs more than the partials' round trip."""
    assert launch.split_k(640, 90, 1e8, 2e7) == 1  # 64^2 K6: 4.85 waves of 37 us
    assert launch.split_k(40, 80, 1.1e9, 1.3e6) == 3  # 8^2: one wave of 120 blocks
    assert launch.split_k(160, 80, 1.1e9, 5.2e6) == 4  # 16^2: 1.25 waves, not 2
    assert launch.split_k(40, 2, 1.1e9, 1.3e6) == 2  # at most the slices
    assert launch.split_k(1, 1, 1e9, 1.0) == 1


def test_card_tests_cover_every_fp32_class_and_split():
    """tests/test_torch_fp32_cuda.py's K2 and K6 shapes reach every fp32
    tile class, split 1 and split > 1 of each kernel (ln_geglu's forced:
    no UNet shape of it splits), and a ragged M and F."""
    from test_torch_fp32_cuda import CONV_CASES, GEGLU_CASES, LN_CASES, RESIDUAL_CASES

    plans = {"ln_matmuls": {fp.proj_plan_f32("ln_matmuls", m, c, f, n_w)
                            for m, c, f, n_w in LN_CASES},
             "matmul_residual": {fp.proj_plan_f32("matmul_residual", m, k, c)
                                 for m, k, c, _ in RESIDUAL_CASES},
             "ln_geglu": {(*fp.proj_plan_f32("ln_geglu", m, c, 4 * c)[:3],
                           split or fp.proj_plan_f32("ln_geglu", m, c, 4 * c)[3])
                          for m, c, split in GEGLU_CASES},
             "conv": {fc.conv_plan_f32(b, h, w, cin, cout) for b, h, w, cin, cout, _ in CONV_CASES}}
    for kind, got in plans.items():
        assert {p[3] > 1 for p in got} == {False, True}, kind
        want = fc.CONV_TILES_F32 if kind == "conv" else fp.PROJ_TILES_F32
        assert {p[:3] for p in got} == set(want), kind
    assert any(m % 128 and f % 80 for m, _, f, _ in LN_CASES)
    assert any(m % 128 and c % 80 for m, _, c, _ in RESIDUAL_CASES)
    assert any(m % 128 and (4 * c) % 40 for m, c, _ in GEGLU_CASES)
    assert any((b * h * w) % 128 and cout % 64 for b, h, w, _, cout, _ in CONV_CASES)


def test_card_tests_walk_a_second_row_block():
    """A K2 block walks more than one row block (the persistent loop of
    csrc/fused_proj.cu:launch_f32_at) where the row blocks times the split
    outnumber the SMs; tests/test_torch_fp32_cuda.py reaches that walk in
    every mode with the panel resident (where the producer reloads it
    after the consumers release it), and with A streamed."""
    from test_torch_fp32_cuda import GEGLU_CASES, LN_CASES, RESIDUAL_CASES

    def walks(mode, m, k, f, n_w=1):
        bm, bn, stages, split = fp.proj_plan_f32(mode, m, k, f, n_w)
        return -(-m // bm) * split > launch.SMS, fp.proj_smem_f32((bm, bn, stages), k, split)[1]

    got = {"ln_matmuls": {walks("ln_matmuls", m, c, f, n_w) for m, c, f, n_w in LN_CASES},
           "matmul_residual": {walks("matmul_residual", m, k, c) for m, k, c, _ in RESIDUAL_CASES},
           "ln_geglu": {walks("ln_geglu", m, c, 4 * c) for m, c, split in GEGLU_CASES
                        if split is None}}
    for mode, seen in got.items():
        assert (True, True) in seen, mode
    assert (True, False) in got["matmul_residual"]


def test_conv_fp32_route_takes_no_plan_or_library():
    """The fp32 conv runs at conv_plan_f32 only: a caller's plan or library
    raises before any launch."""
    x = torch.randn(1, 4, 4, 8)
    a, v = torch.ones(1, 8), torch.zeros(1, 8)
    wt, wb = torch.randn(8, 3, 3, 8), torch.zeros(8)
    for kw in ({"plan": (128, 64, 3, 1)}, {"library": "fused_conv_sweep"}):
        with pytest.raises(ValueError, match="fp32 route takes no plan or library"):
            fc.gn_silu_conv3x3.conv(x, a, v, wt, wb, **kw)


def test_ptxas_report_reads_every_fp32_kernel():
    """chip_smoke.ptxas_configs, which phase 2's spill check reads, names
    the 3xTF32 kernels from their mangled names, the projections' bool
    PANEL argument included."""
    report = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116proj_tf32_kernelILi0ELi128ELi80ELi3ELb1EEEvNS_9ParamsF32E' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116proj_tf32_kernelILi2ELi128ELi80ELi3ELb0EEEvNS_9ParamsF32E' "
        "for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119conv3x3_tf32_kernelILi64ELi64ELi3EEEvNS_6ConvF32E' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 165 registers",
    ])
    assert chip_smoke.ptxas_configs(report) == [
        ("proj_tf32_kernel<0, 128, 80, 3, 1>", 168, 0, 0),
        ("proj_tf32_kernel<2, 128, 80, 3, 0>", 168, 4, 8),
        ("conv3x3_tf32_kernel<64, 64, 3>", 165, 0, 0)]
