"""The flash forward's fp32 route at the UNet's head dims (d = 40, 80, 160):
what csrc/flash_fwd.cu:flash_fwd_f32_qm_kernel computes, modelled in
torch, against the plain version and the JAX single-KV forward (interpret
mode, fp32 q/k/v); and the route's tile table, as the C entry holds it.

The model (``qm_model``), as the kernel computes it per (batch, head):
key tiles of BK keys (the table's) in order, with the online softmax of
``flash_fwd.cu:softmax_tile`` in log2 units (the max on the raw products
and the scale folded into the exponent without a bias; with one, the
biased scores); each tile's S one chain of 3xTF32 products over the whole
head dim, and its part of O one chain over the tile's keys, each from zero
(products exact, their sum rounded to fp32 once: the tensor cores' own
order is not modelled) and added to O in fp32 after O is rescaled.  The
split is the kernel's: hi = rna(x) (``tests/test_torch_flash.py:
tf32_rna``) and lo = x - hi, which the tensor cores truncate to TF32
(``tests/test_torch_fp32_tc.py:tc_split``).  Within an 8-key step the
kernel stores V^T's keys in the order 0, 2, 4, 6, 1, 3, 5, 7 so that P
feeds the product from S's accumulator registers; the order of a chain's
terms is not modelled, and ``test_key_order_of_p_and_v`` checks that the
two index maps agree.

Tolerance: FP32_REL_TOL = 1e-4 of the plain output's largest magnitude
and FP32_LSE_TOL = 1e-4 (log2 units), chip_smoke.py's, against the plain
version and the JAX kernel alike.  One TF32 pass misses it where the
scores are sharp (``test_one_tf32_pass_misses_the_limit``).
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gligen_tpu.ops.pallas_attention import flash_attention_packed as jax_flash_packed

from gligen_tpu_torch.ops.flash_attention import (
    FWD_TILES_F32,
    LOG2E,
    NEG_INF,
    flash_attention_plain,
    fwd_tiles_f32,
    key_mask_bias,
)

from test_torch_fp32_tc import tc_split

torch.set_num_threads(1)

FP32_REL_TOL = 1e-4  # chip_smoke.FP32_REL_TOL
FP32_LSE_TOL = 1e-4  # chip_smoke.FP32_LSE_TOL
REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gligen_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory a block can have on an H100


def chain(a, b, passes=3):
    """a @ b.T as one chain of the tensor cores: TF32 halves, exact
    products summed and rounded to fp32 once (3 passes, or hi.hi)."""
    (ah, al), (bh, bl) = tc_split(a), tc_split(b)
    out = ah.double() @ bh.double().transpose(-1, -2)
    if passes == 3:
        out = out + ah.double() @ bl.double().transpose(-1, -2)
        out = out + al.double() @ bh.double().transpose(-1, -2)
    return out.float()


def qm_model(q, k, v, heads, bias=None, bk=None, passes=3):
    """flash_fwd_f32_qm_kernel's arithmetic on (B, L, H*C) fp32 tensors;
    returns (out, lse) as ``flash_attention_plain`` does."""
    b, n, hc = q.shape
    m, c = k.shape[1], hc // heads
    bk = bk or fwd_tiles_f32(c)[1][1]
    scale = torch.tensor(c**-0.5, dtype=torch.float32) * LOG2E  # p.scale_log2, in fp32
    qh, kh, vh = (t.reshape(b, -1, heads, c).transpose(1, 2) for t in (q, k, v))
    o = torch.zeros((b, heads, n, c))
    mrow = torch.full((b, heads, n), -torch.inf)
    lrow = torch.zeros((b, heads, n))
    for k0 in range(0, m, bk):
        s = chain(qh, kh[:, :, k0:k0 + bk], passes)
        if bias is not None:
            x = (s.double() * scale.double()
                 + (bias[:, None, None, k0:k0 + bk] * LOG2E).double()).float()
            mx = x.amax(-1)
        else:
            mx = s.amax(-1) * scale
        mnew = torch.maximum(mrow, mx)
        use = torch.where(mnew == -torch.inf, torch.zeros_like(mnew), mnew)
        alpha = torch.exp2(mrow - use)
        if bias is not None:
            p = torch.exp2(x - use[..., None])
        else:
            p = torch.exp2((s.double() * scale.double() - use[..., None].double()).float())
        mrow, lrow = mnew, lrow * alpha + p.sum(-1)
        o = o * alpha[..., None] + chain(p, vh[:, :, k0:k0 + bk].transpose(-1, -2), passes)
    out = (o / lrow[..., None]).transpose(1, 2).reshape(b, n, hc)
    return out, mrow + torch.log2(lrow)


def inputs(seed, b, n, m, h, d, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, L, h * d)).astype(np.float32) for L in (n, m, m))
    return q * scale, k * scale, v


def errors(got, want):
    """(max abs error of the output, of the LSE, the output's limit)."""
    (out, lse), (w_out, w_lse) = got, want
    w_out = torch.as_tensor(np.array(w_out))
    limit = FP32_REL_TOL * w_out.abs().max().item()
    lse_err = None if w_lse is None else (lse - w_lse).abs().max().item()
    return (out - w_out).abs().max().item(), lse_err, limit


# (b, n, m, h, d, masked tail keys): ragged N and M, several key tiles; the
# masked cases carry a NEG_INF bias row over their last keys (the kernel's
# bias input; the JAX kernel's key mask)
CASES = [
    (1, 70, 150, 2, 40, 0),
    (2, 33, 77, 2, 40, 11),
    (1, 40, 94, 2, 80, 0),
    (1, 65, 70, 2, 80, 9),
    (1, 36, 100, 2, 160, 0),
    (1, 20, 70, 2, 160, 6),
]


@pytest.mark.parametrize("b,n,m,h,d,tail", CASES)
def test_model_matches_plain_and_jax(b, n, m, h, d, tail):
    q, k, v = inputs(n * m + d, b, n, m, h, d)
    mask = np.arange(m)[None, :].repeat(b, 0) < m - tail
    bias = key_mask_bias(torch.from_numpy(mask)) if tail else None
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = qm_model(tq, tk, tv, h, bias)
    err, lse_err, limit = errors(got, flash_attention_plain(tq, tk, tv, h, bias=bias))
    assert err <= limit and lse_err <= FP32_LSE_TOL, (err, limit, lse_err)
    want = jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                            key_mask=jnp.asarray(mask) if tail else None, interpret=True)
    err, _, limit = errors(got, (want, None))
    assert err <= limit, (err, limit)


def test_one_tf32_pass_misses_the_limit():
    """At ds1's head dim with q and k scaled x4 (sharp scores over 256
    keys), one TF32 pass misses the limit and the model's 3xTF32 meets it:
    the limit tells fp32 arithmetic from TF32."""
    q, k, v = (torch.from_numpy(a) for a in inputs(5, 1, 64, 256, 2, 40, scale=4.0))
    want = flash_attention_plain(q, k, v, 2)
    err3, lse3, limit = errors(qm_model(q, k, v, 2), want)
    err1, lse1, _ = errors(qm_model(q, k, v, 2, passes=1), want)
    assert err3 <= limit and lse3 <= FP32_LSE_TOL, (err3, limit, lse3)
    assert err1 > limit, (err1, limit)


def test_model_is_the_online_softmax_of_any_tile():
    """The model's result does not hang on its tile: BK = 32 and 64 agree
    to the tolerance, with a bias row (the tiles only regroup the sums)."""
    q, k, v = (torch.from_numpy(a) for a in inputs(9, 1, 50, 200, 2, 40))
    bias = torch.zeros((1, 200))
    bias[:, 180:] = NEG_INF
    a, b = qm_model(q, k, v, 2, bias, bk=32), qm_model(q, k, v, 2, bias, bk=64)
    err, lse_err, limit = errors(a, b)
    assert err <= limit and lse_err <= FP32_LSE_TOL


def test_key_order_of_p_and_v():
    """flash_fwd.cu's index maps: the TF32 A fragment of P that a thread
    (g, t) hands the O product for an 8-key step (k = t from S's register
    4j, k = t + 4 from 4j + 1: keys 2t and 2t + 1) and the word of a V^T
    row that store_vt8 writes each key to name the same key at every k,
    so P V sums every key once with its own V row."""
    def store_word(key):  # store_vt8: word of a 32-key row
        kk = key % 8
        return (key % 32) // 8 * 8 + (kk & 1) * 4 + kk // 2

    for step in range(4):
        at_word = {store_word(8 * step + kk) - 8 * step: kk for kk in range(8)}
        assert sorted(at_word) == list(range(8))
        for t in range(4):
            assert at_word[t] == 2 * t and at_word[t + 4] == 2 * t + 1


# ---------------------------------------------------------------- the table

def dispatch_source(sweep: bool) -> str:
    """The serving (or sweep) branch of csrc/flash_fwd.cu:f32qm::dispatch."""
    src = (CSRC / "flash_fwd.cu").read_text()
    body = src[src.index("cudaError_t dispatch(const Params& p"):]
    body = body[:body.index("return cudaErrorInvalidValue;")]
    serving, sweep_part = body.split("#else")
    return sweep_part if sweep else serving


def table_of(text: str):
    """{class: [(BQ, BK, buffers), ...]} of a dispatch branch."""
    out = {}
    for cls, bq, bk, nbuf in re.findall(r"launch<Q(\d+)<(\d+), (\d+), (\d+)>>", text):
        out.setdefault(int(cls), []).append((int(bq), int(bk), int(nbuf)))
    return out


def test_c_dispatch_holds_the_wrappers_table():
    """The serving library's qm configurations are FWD_TILES_F32's, one a
    class; the d > 160 class is the keys-as-rows kernel at its constants;
    the sweep library's are bench_sweep_attn.F32_CONFIGS."""
    from gligen_tpu_torch.tools.bench_sweep_attn import F32_CONFIGS

    want = {top: [tiles] for top, kernel, tiles in FWD_TILES_F32 if kernel == "qm"}
    assert table_of(dispatch_source(sweep=False)) == want
    assert table_of(dispatch_source(sweep=True)) == {c: list(t) for c, t in F32_CONFIGS.items()}
    src = (CSRC / "flash_fwd.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (kBQ|kKeys|kStages) = (\d+);",
                                                     src)}
    assert [(top, kernel, tiles) for top, kernel, tiles in FWD_TILES_F32 if kernel == "km"] == [
        (512, "km", (consts["kBQ"], consts["kKeys"], consts["kStages"]))]
    assert "if (d <= 160)" in src  # the C entry's split between the two kernels


def qm_smem(d_class, bq, bk, nbuf):
    """f32qm::Cfg::kSmem: Q's hi and lo, nbuf converted K/V tiles (K hi/lo
    in 32-column atoms, V^T hi/lo in 32-key atoms), 4 barriers, 1 KB of
    alignment slack."""
    atoms = -(-d_class // 32)
    q_bytes, k_bytes, v_bytes = atoms * bq * 128, atoms * bk * 128, (bk // 32) * d_class * 128
    return 2 * q_bytes + nbuf * (2 * k_bytes + 2 * v_bytes) + 32 + 1024


def test_every_configuration_fits_the_card():
    """Each qm configuration, the table's and the sweep's, fits 227 KB of
    shared memory, at most 3 consumer warpgroups, and legal wgmma widths
    that csrc/wgmma.cuh holds: S's N = BK (WgmmaSsTf32), O's N = the
    class's head dim, or its halves above 80 (WgmmaRsTf32)."""
    from gligen_tpu_torch.tools.bench_sweep_attn import F32_CONFIGS

    sys.path.insert(0, str(CSRC))
    try:
        import gen_wgmma
    finally:
        sys.path.pop(0)
    configs = [(top, tiles) for top, kernel, tiles in FWD_TILES_F32 if kernel == "qm"]
    configs += [(c, t) for c, ts in F32_CONFIGS.items() for t in ts]
    for d_class, (bq, bk, nbuf) in configs:
        assert qm_smem(d_class, bq, bk, nbuf) <= SMEM_LIMIT, (d_class, bq, bk, nbuf)
        assert bq % 64 == 0 and bq <= 192 and nbuf in (1, 2)
        o_n = d_class // 2 if d_class > 80 else d_class  # f32qm::Cfg::kON
        assert bk in gen_wgmma.SS_TF32_WIDTHS and o_n in gen_wgmma.RS_TF32_WIDTHS
        assert d_class % 8 == 0 and o_n % 8 == 0 and o_n <= 256


def test_unet_sites_take_the_new_kernel_and_the_vae_head_the_old():
    """Every flash shape of a 512^2 request (chip_smoke.kernel_cases: attn1,
    the fusers, cross-attention, gatedCA, gatedSA2 at every level) runs the
    qm kernel in fp32; the VAE's d = 512 head the keys-as-rows one."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    for name, _, _, _, _, d, _ in chip_smoke.kernel_cases(2):
        assert fwd_tiles_f32(d)[0] == ("km" if name == "vae_mid" else "qm"), name
    assert [fwd_tiles_f32(d)[0] for d in (4, 40, 64, 80, 160, 164, 512)] == [
        "qm", "qm", "qm", "qm", "qm", "km", "km"]
    with pytest.raises(ValueError):
        fwd_tiles_f32(516)


def test_bench_sweep_fp32_on_the_cpu():
    """The fp32 sweep at a tiny size: per level and key count, the table's
    row then one per configuration of its class, each held against the
    plain version on every query row (on the CPU every row is the plain
    version itself, so exactly); the bound is the 3xTF32 products' at the
    TF32 tensor rate."""
    from gligen_tpu_torch.tools import bench_sweep_attn, timing

    b, n, h = 1, 24, 2
    rows = bench_sweep_attn.run_fp32(batch=b, ms_keys=(24, 31), iters=1, device="cpu",
                                     heads=h, n=n, check_rows=8)
    want = [(lvl, m, c) for lvl, (_, d) in bench_sweep_attn.F32_LEVELS.items() for m in (24, 31)
            for c in (None, *bench_sweep_attn.F32_CONFIGS[d])]
    assert [(r["level"], r["m"], r["tiles"]) for r in rows] == want
    for r in rows:
        d = bench_sweep_attn.F32_LEVELS[r["level"]][1]
        flops = 4 * b * h * n * r["m"] * d
        nbytes = 4 * (2 * b * n + 2 * b * r["m"]) * h * d + 4 * b * h * n
        assert (r["bound_ms"], r["bound_by"]) == timing.bound(
            nbytes, 3 * flops, timing.TF32_TENSOR_FLOP_PER_S)
        assert r["ok"] and r["max_abs_err"] == 0.0 and r["lse_err"] == 0.0
        assert r["table"] == (fwd_tiles_f32(d)[1] if r["tiles"] is None else None)
    out = bench_sweep_attn.fp32_lines(rows)
    assert len(out) == 1 + len(rows) and out[1].split()[3] == "table"
