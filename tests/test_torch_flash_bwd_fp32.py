"""The flash backward's fp32 route (a model trained in fp32, fault F9): what
the wrapper takes, its tile table as the C dispatch holds it, and its
arithmetic against the JAX Pallas backward in fp32.

``csrc/flash_bwd.cu``'s fp32 entries (``flash_bwd_dq_f32``,
``flash_bwd_dkv_f32``) run 3xTF32 ``wgmma`` kernels at every head dim,
whose arithmetic ``tests/test_torch_flash_bwd_fp32_tc.py`` models.  The CPU
runs the plain backward (``flash_attention_bwd_plain``,
fp32 from the saved LSE) behind the autograd Function: here it is held to
``jax.grad`` of the Pallas kernels run in interpret mode
(``flash_attention_packed``, and the (B*H, N, D) form with a bias for
dbias), in fp32, at the training path's head dims 40, 80 and 160, with and
without a key mask.

Tolerance: FP32_REL_TOL = 1e-4 of each gradient's largest magnitude
(chip_smoke.py's fp32 limit, which its phase 3 holds the kernels to on the
card).  The same gradients with every product operand rounded to TF32 once
(q, k, v, dO, P and dS: one-pass TF32) miss it, so the limit tells fp32
arithmetic from TF32 (``test_one_tf32_pass_misses_the_limit``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.ops import pallas_attention as jpa

from gligen_tpu_torch.ops import flash_attention as fa

from test_torch_flash import tf32_rna
from test_torch_modules import rand, t

torch.set_num_threads(1)

FP32_REL_TOL = 1e-4  # chip_smoke.FP32_REL_TOL
CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"


def zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def bwd_args(b=2, n=20, m=30, h=2, c=8, dtype=torch.float32):
    q, k, v, do = (zeros(b, L, h * c, dtype=dtype) for L in (n, m, m, n))
    return q, k, v, h, do, zeros(b, h, n), zeros(b, h, n), None


def test_fp32_inputs_are_taken():
    """F9 on the CPU: the backward's input check takes fp32 q/k/v/dO of an
    aligned layout (before, it held them to the bf16 rule and raised
    TypeError, so an fp32 train step on the card raised in the backward),
    with a bias row too, and names the "fp32" route."""
    fa._check_bwd_inputs(*bwd_args())
    q, k, v, h, do, lse, delta, _ = bwd_args(m=31)
    fa._check_bwd_inputs(q, k, v, h, do, lse, delta, zeros(2, 31))
    kv = zeros(2, 31, 32)  # k and v sliced from one fused projection
    fa._check_bwd_inputs(q, kv[..., :16], kv[..., 16:], h, do, lse, delta, None)
    assert fa.bwd_route(q, k, v, do, h) == "fp32"
    assert fa.bwd_route(*(x.bfloat16() for x in (q, k, v, do)), h) == "tma"


@pytest.mark.parametrize("what", ["head_dim", "base", "row_stride", "do_base"])
def test_unaligned_fp32_inputs_are_refused(what):
    """What the fp32 kernels cannot load with 16-byte loads raises before
    any launch: a head dim, a base or a stride that is not a multiple of 4
    elements, of q, k, v or dO."""
    q, k, v, h, do, lse, delta, _ = bwd_args()
    if what == "head_dim":  # 2 heads of 6
        q, k, v, do = (zeros(*x.shape[:2], 12) for x in (q, k, v, do))
    elif what == "base":  # one element (4 bytes) into its storage
        q = zeros(2 * 20 * 16 + 1)[1:].reshape(2, 20, 16)
    elif what == "row_stride":  # every row at a stride of 18 elements
        k = zeros(2, 30, 18)[..., :16]
    else:
        do = zeros(2 * 20 * 16 + 2)[2:].reshape(2, 20, 16)
    with pytest.raises(ValueError, match="multiples of 4 elements"):
        fa._check_bwd_inputs(q, k, v, h, do, lse, delta, None)


def test_mixed_dtypes_are_refused():
    q, k, v, h, do, lse, delta, _ = bwd_args()
    with pytest.raises(ValueError, match="dO must be"):
        fa._check_bwd_inputs(q, k, v, h, do.bfloat16(), lse, delta, None)
    with pytest.raises(TypeError, match="float32"):
        fa._check_bwd_inputs(q, k.bfloat16(), v, h, do, lse, delta, None)


@pytest.mark.parametrize(
    "d,want",
    [(4, ((128, 64), (128, 32))), (40, ((128, 64), (128, 32))), (44, ((128, 32), (64, 32))),
     (80, ((128, 32), (64, 32))), (84, ((64, 16), (64, 16))), (160, ((64, 16), (64, 16)))],
)
def test_fp32_tile_table(d, want):
    """(dq tiles, dk/dv tiles) of the fp32 route by head-dim class: dq's
    (BQ queries, BK keys), dk/dv's (BK keys, BQ queries); the wrappers pick
    them by q's dtype.  The table also names each class's kernel
    (``bwd_kernel_f32``: 3xTF32 at every head dim; tiles of 16 rows in the
    d <= 160 class)."""
    assert fa.bwd_tiles_f32(d) == want
    assert fa.bwd_kernel_f32(d) == "tc"
    assert [top for top, *_ in fa.BWD_TILES_F32] == [top for top, *_ in fa.BWD_TILES]
    q = zeros(1, 1, 2 * d)
    assert (fa._bwd_tiles_of(q, 2, 0), fa._bwd_tiles_of(q, 2, 1)) == want
    assert fa._bwd_tiles_of(q.bfloat16(), 2, 0) == fa.bwd_tiles(d)[0]


@pytest.mark.parametrize("d", [164, 512])
def test_fp32_tile_table_stops_at_160(d):
    with pytest.raises(ValueError, match=f"head dim {d} above 160"):
        fa.bwd_tiles_f32(d)


def test_c_dispatch_holds_the_fp32_table():
    """csrc/flash_bwd.cu's serving fp32 dispatch lists (DQ40_F32 ...
    DKV160_F32, before the sweep library's #else) hold exactly
    BWD_TILES_F32, per class and kernel: (kernel, fixed rows, tile rows)."""
    src = (CSRC / "flash_bwd.cu").read_text()
    src = src[:src.index("#else", src.index("#ifndef FLASH_BWD_F32_SWEEP"))] + \
        src[src.index("#endif", src.index("#ifndef FLASH_BWD_F32_SWEEP")):]
    held = {}
    for kind, top, lists in re.findall(r"#define (DQ|DKV)(\d+)_F32\(X\) (.*)", src):
        held[(int(top), kind)] = [(k, int(r), int(t_)) for k, r, t_ in
                                  re.findall(r"X\((\w+), (\d+), (\d+)\)", lists)]
    assert held == {(top, kind): [(kernel, *tiles)] for top, kernel, dq, dkv in fa.BWD_TILES_F32
                    for kind, tiles in (("DQ", dq), ("DKV", dkv))}


def c_params(src: str, entry: str) -> int:
    """The number of parameters of ``extern "C" int entry(...)``."""
    body = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', src, re.S).group(1)
    return len(body.split(","))


@pytest.mark.parametrize("kind", ["dq", "dkv", "dq_f32", "dkv_f32"])
def test_ctypes_signatures_match_the_c_entries(kind):
    """Each entry's ctypes arguments (then the stream) are as many as its C
    parameters: a missing one would shift the stream into a tile."""
    entry, argtypes = fa._BWD_ENTRIES[kind]
    assert entry == f"flash_bwd_{kind if kind.endswith('f32') else kind + '_bf16'}"
    assert c_params((CSRC / "flash_bwd.cu").read_text(), entry) == len(argtypes) + 1


def jax_grads(q, k, v, g, h, mask):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jpa.flash_attention_packed(q_, k_, v_, h, key_mask=jm, block_q=32, block_kv=32,
                                         interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in
            jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))]


def port_grads(q, k, v, g, h, mask):
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention_packed(*leaves, h, key_mask=None if mask is None else t(mask))
    out.backward(t(g))
    return [x.grad for x in leaves]


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def case_inputs(d, n, m, masked, scale=1.0):
    rng = np.random.default_rng(d + n + m + int(masked))
    b, h = 2, 2
    q, k = rand(rng, b, n, h * d, scale=scale), rand(rng, b, m, h * d, scale=scale)
    v, g = rand(rng, b, m, h * d), rand(rng, b, n, h * d)
    mask = None
    if masked:
        mask = np.ones((b, m), bool)
        mask[0, m // 2:] = False
        mask[1, :5] = False
    return q, k, v, g, h, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize(
    "d,n,m",
    [(40, 64, 64),    # attn1 at ds1's head dim
     (40, 48, 78),    # the fuser's ragged N + 30 keys
     (80, 64, 94),    # ds2's head dim, N + 30
     (160, 40, 77)],  # ds4/mid's head dim over 77 keys
)
def test_fp32_gradients_match_jax(d, n, m, masked):
    """dq, dk and dv of the fp32 route (the plain backward on the CPU) within
    FP32_REL_TOL of each JAX gradient's largest magnitude."""
    q, k, v, g, h, mask = case_inputs(d, n, m, masked)
    want = jax_grads(q, k, v, g, h, mask)
    got = port_grads(q, k, v, g, h, mask)
    for name, gp, gj in zip("qkv", got, want):
        assert gp.dtype == torch.float32 and np.abs(gj).max() > 1e-2, name
        assert rel_err(gp.numpy(), gj) <= FP32_REL_TOL, (name, rel_err(gp.numpy(), gj))
    if masked:  # masked keys get exactly no gradient
        assert float(got[1][0, m // 2:].abs().max()) == 0.0
        assert float(got[2][1, :5].abs().max()) == 0.0


@pytest.mark.parametrize("d", [40, 80, 160])
def test_fp32_bias_gradient_matches_jax(d):
    """dbias (the dk/dv kernel's per-head row sums of dS, summed over heads
    by the wrapper) against the JAX bias gradient of the (B*H, N, D) form,
    ragged keys, with the other gradients, all within FP32_REL_TOL."""
    rng = np.random.default_rng(d)
    bh, n, m = 3, 40, 70
    q, k, v = rand(rng, bh, n, d), rand(rng, bh, m, d), rand(rng, bh, m, d)
    bias = rand(rng, bh, 1, m, scale=0.5)
    g = rand(rng, bh, n, d)

    def loss(q_, k_, v_, b_):
        out = jpa.flash_attention(q_, k_, v_, bias=b_, block_q=32, block_kv=32, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v, bias)]
    fa.flash_attention(*leaves[:3], bias=leaves[3]).backward(t(g))
    for name, leaf, gj in zip(("dq", "dk", "dv", "dbias"), leaves, want):
        assert np.abs(np.asarray(gj)).max() > 1e-2, name
        assert rel_err(leaf.grad.numpy(), gj) <= FP32_REL_TOL, (name, rel_err(leaf.grad.numpy(), gj))


def tf32_backward(q, k, v, heads, do, lse, delta):
    """``flash_attention_bwd_plain`` with every product operand rounded to
    TF32 once (q, k, v, dO, P, dS): what one TF32 pass of the tensor cores
    would give in place of the fp32 kernels."""
    b, n, hc = q.shape
    c = hc // heads
    r = tf32_rna
    qh, kh, vh, doh = (r(x).reshape(b, -1, heads, c) for x in (q, k, v, do))
    s = torch.einsum("bnhc,bmhc->bhnm", qh, kh) * c**-0.5
    p = torch.exp2(s * fa.LOG2E - lse[..., None])
    ds = p * (torch.einsum("bnhc,bmhc->bhnm", doh, vh) - delta[..., None])
    dq = torch.einsum("bhnm,bmhc->bnhc", r(ds), kh) * c**-0.5
    dk = torch.einsum("bhnm,bnhc->bmhc", r(ds), qh) * c**-0.5
    dv = torch.einsum("bhnm,bnhc->bmhc", r(p), doh)
    return [x.reshape(b, -1, hc) for x in (dq, dk, dv)]


def test_one_tf32_pass_misses_the_limit():
    """At ds1's head dim with q and k scaled x3 (sharp scores, still below
    the JAX forward's exp2 clamp at 2^80: pallas_attention.py's shift-free
    softmax), one TF32 pass misses FP32_REL_TOL on every gradient while the
    fp32 backward meets it against JAX: the limit tells fp32 from TF32."""
    q, k, v, g, h, mask = case_inputs(40, 64, 94, False, scale=3.0)
    want = jax_grads(q, k, v, g, h, mask)
    got = port_grads(q, k, v, g, h, mask)
    qt, kt, vt, gt = (t(a) for a in (q, k, v, g))
    out, lse = fa.flash_attention_plain(qt, kt, vt, h)
    tf32 = tf32_backward(qt, kt, vt, h, gt, lse, fa.attention_delta(out, gt, h))
    for name, gp, g1, gj in zip("qkv", got, tf32, want):
        assert rel_err(gp.numpy(), gj) <= FP32_REL_TOL, name
        assert rel_err(g1.numpy(), gj) > FP32_REL_TOL, (name, rel_err(g1.numpy(), gj))


def test_phase_2_reads_the_fp32_kernels_from_ptxas():
    """chip_smoke.ptxas_configs names the fp32 kernels of flash_bwd.cu (the
    3xTF32 ``flash_bwd_dq_tf32_kernel<D, NW, BK, NBUF, KS>`` and
    ``flash_bwd_dkv_tf32_kernel<D, NW, SPLIT, BQ, NBUF>``, the d <= 160
    class's among them), whose spills phase 2 fails on; the bf16 kernels
    are not read."""
    import chip_smoke

    prefix = "_ZN45_GLOBAL__N__af819228_12_flash_bwd_cu_b47bff4c3f32"
    kernels = [
        ("24flash_bwd_dq_tf32_kernelINS0_5DqCfgILi160ELi1ELi16ELi1ELi2EEEEEvNS0_6ParamsE", 255,
         (8, 4)),
        ("24flash_bwd_dq_tf32_kernelINS0_5DqCfgILi40ELi2ELi64ELi2ELi1EEEEEvNS0_6ParamsE", 198,
         (0, 0)),
        ("25flash_bwd_dkv_tf32_kernelINS0_6DkvCfgILi80ELi1ELi2ELi32ELi1EEEEEvNS0_6ParamsE", 176,
         (0, 0)),
    ]
    lines = []
    for mangled, regs, (stores, loads) in kernels:
        lines += [f"ptxas info    : Compiling entry function '{prefix}{mangled}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {prefix}{mangled}",
                  f"    0 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    lines += [
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dq_kernelI3CfgILi48E"
        "ELi40ELi1ELi2ELi1ELi64ELi3EEEEvNS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
    ]
    assert chip_smoke.ptxas_configs("\n".join(lines)) == [
        ("flash_bwd_dq_tf32_kernel<160, 1, 16, 1, 2>", 255, 8, 4),
        ("flash_bwd_dq_tf32_kernel<40, 2, 64, 2, 1>", 198, 0, 0),
        ("flash_bwd_dkv_tf32_kernel<80, 1, 2, 32, 1>", 176, 0, 0)]
