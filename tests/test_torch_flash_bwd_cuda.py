"""The CUDA flash-attention backward kernels (csrc/flash_bwd.cu) against
their plain PyTorch version, on the card.  The kernels have no CPU mode,
so these tests skip without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_flash_bwd_cuda.py -m gpu --noconftest -q

Tolerance: the kernels round P and dS to bf16 as the operands of their
products (fp32 accumulation) and write bf16 gradients; the plain version
computes in fp32 from the same bf16 inputs, LSE and delta.  Each gradient
agrees to 2e-2 of its largest magnitude: a few bf16 ulps (2^-8 relative)
of the largest entries, summed over up to 4126 products.  dbias is fp32:
the same bound.  The fp32 route's cases (below) are held to 1e-4 of the
largest magnitude: fp32 sums in another order.
"""

import pytest
import torch

from gligen_tpu_torch.ops import flash_attention as fa

REL_TOL = 2e-2
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inputs(device, b, n, m, h, d, masked, seed, strided=False):
    """Seeded bf16 q, k, v, dO (and a key mask's bias), with the LSE and
    delta of the forward kernel.  ``strided``: q starts one element (2
    bytes) into its storage and k, v are every other row of a larger tensor
    at an odd row stride, so TMA takes none of them (the copy route)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if strided:
        qs = torch.randn((b, n * h * d + 1), generator=gen, device=device).to(BF16)
        q = qs[:, 1:].reshape(b, n, h * d)
        kv = torch.randn((b, 2 * m, h * d + 3), generator=gen, device=device).to(BF16)
        k, v = kv[:, 0::2, : h * d], kv[:, 1::2, 3:]
    else:
        q, k, v = (torch.randn((b, L, h * d), generator=gen, device=device).to(BF16)
                   for L in (n, m, m))
    do = torch.randn((b, n, h * d), generator=gen, device=device).to(BF16)
    bias = None
    if masked:
        bias = torch.randn((b, m), generator=gen, device=device) * 0.5
        bias[:, m // 2 + 3:] = fa.NEG_INF
    out, lse = fa.flash_fwd(q, k, v, h, bias=bias)
    return q, k, v, do, bias, lse, fa.attention_delta(out, do, h)


def assert_close(got, want, name):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all(), name
    assert scale > 0 and err <= REL_TOL * scale, f"{name}: max abs err {err:.3e}, max |plain| {scale:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["packed", "strided"])
@pytest.mark.parametrize(
    "b,n,m,h,d,masked",
    [
        (2, 256, 256, 8, 40, False),   # attn1 at a small map, head dim 40
        (2, 1024, 1054, 4, 80, False),  # the fuser's N + 30 keys: a ragged key tile
        (2, 256, 286, 8, 160, False),  # head dim 160, ragged keys
        (2, 64, 77, 8, 160, False),    # cross-attention over 77 text tokens
        (2, 200, 170, 2, 64, True),    # a key mask with dbias, ragged query tile
        (1, 100, 90, 2, 36, True),     # head dim not a multiple of 8: the copy route
        (2, 333, 77, 4, 40, False),    # 77 keys at d 40; N a multiple of no tile
        (2, 50, 4126, 2, 40, False),   # the fuser's ragged 4126 keys; N under one tile
        (1, 300, 4126, 2, 40, True),   # 4126 keys with a key mask and dbias
        (2, 40, 77, 2, 80, False),     # N under one tile at d 80
        (2, 90, 150, 2, 160, True),    # a key mask with dbias at d 160 (split warpgroups)
    ],
)
def test_dq_dkv_dbias_match_plain(cuda, b, n, m, h, d, masked, strided):
    """Both kernels in every head-dim class (40, 80, 160) on both routes:
    TMA for packed inputs with d % 8 == 0, the copy route for a strided
    unaligned view or d = 36."""
    q, k, v, do, bias, lse, delta = inputs(cuda, b, n, m, h, d, masked, seed=n + m + d,
                                           strided=strided)
    route = "copy" if strided or d % 8 else "tma"
    counts = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    routes = (dict(fa.flash_bwd_dq.routes), dict(fa.flash_bwd_dkv.routes))
    dq = fa.flash_bwd_dq(q, k, v, h, do, lse, delta, bias)
    dk, dv, db = fa.flash_bwd_dkv(q, k, v, h, do, lse, delta, bias, dbias=masked)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (counts[0] + 1, counts[1] + 1)
    for wrapper, before in zip((fa.flash_bwd_dq, fa.flash_bwd_dkv), routes):
        assert wrapper.routes[route] == before[route] + 1, (route, before, wrapper.routes)
    want = fa.flash_attention_bwd_plain(q, k, v, h, do, lse, delta, bias)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == BF16 and got.shape == w.shape
        assert_close(got, w, name)
    if masked:
        assert db.shape == (b, m) and db.dtype == torch.float32
        assert_close(db, want[3], "dbias")
        # masked keys get no gradient at all
        assert dk[:, m // 2 + 3:].abs().max().item() == 0.0
        assert dv[:, m // 2 + 3:].abs().max().item() == 0.0
    else:
        assert db is None


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_repeat_runs_are_bit_identical(cuda, d):
    """No atomics: two runs give the same bits, in every head-dim class."""
    q, k, v, do, bias, lse, delta = inputs(cuda, 2, 300, 330, 4, d, True, seed=7)
    first = (fa.flash_bwd_dq(q, k, v, 4, do, lse, delta, bias),
             *fa.flash_bwd_dkv(q, k, v, 4, do, lse, delta, bias, dbias=True))
    second = (fa.flash_bwd_dq(q, k, v, 4, do, lse, delta, bias),
              *fa.flash_bwd_dkv(q, k, v, 4, do, lse, delta, bias, dbias=True))
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_untabled_tiles_are_refused(cuda, kind):
    """Each library launches only the configurations it was built with:
    the serving library the wrapper's table, the sweep library
    ``BWD_CONFIGS``."""
    from gligen_tpu_torch.tools.bench_sweep_attn import bwd_configs

    q, k, v, do, bias, lse, delta = inputs(cuda, 1, 64, 64, 2, 80, False, seed=5)
    args = (q, k, v, 2, do, lse, delta, bias)
    table, sweep = fa.bwd_tiles(80)[kind == "dkv"], bwd_configs(80)[kind == "dkv"]
    sweep_only = next(t for t in sweep if t != table)
    assert (64, 64, 3) not in (table, *sweep)
    for library, tiles in (("flash_bwd", (64, 64, 3)), ("flash_bwd", sweep_only),
                           ("flash_bwd_sweep", (64, 64, 3))):
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.launch_bwd(library, kind, *args, tiles)


def _sweep_cases():
    from gligen_tpu_torch.tools.bench_sweep_attn import BWD_CONFIGS

    return [(d, kind, tiles) for d, configs in BWD_CONFIGS.items()
            for kind, tiles_of in zip(("dq", "dkv"), configs) for tiles in tiles_of]


@pytest.mark.gpu
@pytest.mark.parametrize("d,kind,tiles", _sweep_cases())
def test_sweep_configurations_match_plain(cuda, d, kind, tiles):
    """The sweep library at each configuration, at ragged N and M with a
    key mask: what bench_sweep_attn.py --bwd times is the same function;
    its launches reach no wrapper's count."""
    q, k, v, do, bias, lse, delta = inputs(cuda, 2, 333, 1054, 2, d, True, seed=d)
    counts = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got, route = fa.launch_bwd("flash_bwd_sweep", kind, q, k, v, 2, do, lse, delta, bias, tiles,
                               dbias=True)
    assert route == "tma" and (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == counts
    want = fa.flash_attention_bwd_plain(q, k, v, 2, do, lse, delta, bias)
    if kind == "dq":
        assert_close(got, want[0], "dq")
    else:
        for name, g, w in zip(("dk", "dv", "dbias"), (*got[:2], got[2].sum(dim=1)), want[1:]):
            assert_close(g, w, name)


@pytest.mark.gpu
@pytest.mark.parametrize("need", ["q", "kv", "all"])
def test_function_matches_plain_autograd(cuda, need):
    """The autograd Function on the card (forward and backward kernels)
    against autograd through the plain forward in fp32 on the same bf16
    values, at a tiny shape; only the asked-for gradients launch."""
    b, n, m, h, d = 2, 70, 100, 2, 40
    q, k, v, do, bias, _, _ = inputs(cuda, b, n, m, h, d, True, seed=3)
    want_grad = {"q": need in ("q", "all"), "k": need in ("kv", "all"), "v": need in ("kv", "all"),
                 "bias": need == "all"}
    leaves = {name: t.detach().clone().requires_grad_(want_grad[name])
              for name, t in dict(q=q, k=k, v=v, bias=bias).items()}
    counts = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    out = fa.FlashAttention.apply(leaves["q"], leaves["k"], leaves["v"], leaves["bias"], h)
    wrt = [name for name, w in want_grad.items() if w]
    got = torch.autograd.grad(out, [leaves[name] for name in wrt], do)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches - counts[0], fa.flash_bwd_dkv.launches - counts[1]) == (
        int(want_grad["q"]), int(need != "q"))
    ref = {name: t.detach().float().requires_grad_(want_grad[name])
           for name, t in dict(q=q, k=k, v=v, bias=bias).items()}
    ref_out, _ = fa.flash_attention_plain(ref["q"], ref["k"], ref["v"], h, bias=ref["bias"])
    want = torch.autograd.grad(ref_out, [ref[name] for name in wrt], do.float())
    for name, g, w in zip(wrt, got, want):
        assert_close(g, w, name)


@pytest.mark.gpu
def test_head_dim_above_the_kernels_raises(cuda):
    q = torch.zeros((1, 16, 2 * 192), dtype=BF16, device=cuda)
    lse = torch.zeros((1, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="head dim 192"):
        fa.flash_bwd_dq(q, q, q, 2, q, lse, lse)


# ---------------------------------------------------------------- the fp32 route
#
# fp32 q/k/v/dO (a model trained in fp32, fault F9): flash_bwd_dq_f32 and
# flash_bwd_dkv_f32, 3xTF32 wgmma ("tc") in every head-dim class (the d <=
# 160 class with its resident pair raw), as BWD_TILES_F32 names them.
# Tolerance: each gradient within FP32_REL_TOL = 1e-4 of the plain version's
# largest magnitude (the plain version computes the same fp32 sums in
# another order, with TF32 off), chip_smoke.py's fp32 limit; one-pass TF32
# misses it.

FP32_REL_TOL = 1e-4


def inputs_f32(device, b, n, m, h, d, masked, seed):
    """Seeded fp32 q, k, v, dO (and a key mask's bias), with the LSE and
    delta of the fp32 forward."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn((b, L, h * d), generator=gen, device=device) for L in (n, m, m, n))
    bias = None
    if masked:
        bias = torch.randn((b, m), generator=gen, device=device) * 0.5
        bias[:, m // 2 + 3:] = fa.NEG_INF
    out, lse = fa.flash_fwd(q, k, v, h, bias=bias)
    return q, k, v, do, bias, lse, fa.attention_delta(out, do, h)


def assert_close_f32(got, want, name):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), name
    assert scale > 0 and err <= FP32_REL_TOL * scale, \
        f"{name}: max abs err {err:.3e}, max |plain| {scale:.3e}"


@pytest.fixture
def tf32_off(cuda):
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,n,m,h,d,masked",
    [
        (2, 256, 256, 8, 40, False),   # attn1 at a small map, head dim 40
        (2, 1024, 1054, 4, 80, False),  # the fuser's N + 30 keys: a ragged key tile
        (2, 256, 286, 8, 160, False),  # head dim 160, ragged keys
        (2, 64, 77, 8, 160, False),    # cross-attention over 77 text tokens
        (2, 200, 170, 2, 64, True),    # a key mask with dbias, ragged query tile
        (1, 100, 90, 2, 36, True),     # head dim 36 (a multiple of 4, not of 8)
        (2, 333, 77, 4, 40, False),    # 77 keys at d 40; N a multiple of no tile
        (2, 50, 4126, 2, 40, False),   # the fuser's ragged 4126 keys; N under one tile
        (1, 300, 4126, 2, 40, True),   # 4126 keys with a key mask and dbias
        (2, 36, 292, 8, 40, False),    # gatedSA2: 36 queries over N + 36 keys
        (2, 90, 150, 2, 160, True),    # a key mask with dbias at d 160
        (1, 70, 45, 2, 100, True),     # head dim 100 in the d <= 160 class, ragged tiles
        (2, 64, 94, 8, 160, True),     # the middle block's fuser, a key mask and dbias
        (2, 1024, 1054, 8, 80, True),  # ds2's fuser with a key mask and dbias
        (1, 70, 45, 2, 44, False),     # head dim 44 (the d <= 80 class's tail atoms)
        (3, 33, 31, 2, 8, True),       # head dim 8, one ragged tile each way
    ],
)
def test_fp32_dq_dkv_dbias_match_plain(tf32_off, b, n, m, h, d, masked):
    """Both fp32 kernels in every head-dim class, on the "fp32" route, each
    launch on the kernels BWD_TILES_F32 names for d (3xTF32 in every class)."""
    cuda = tf32_off
    q, k, v, do, bias, lse, delta = inputs_f32(cuda, b, n, m, h, d, masked, seed=n + m + d)
    routes = (dict(fa.flash_bwd_dq.routes), dict(fa.flash_bwd_dkv.routes))
    kernels = (dict(fa.flash_bwd_dq.fp32_kernels), dict(fa.flash_bwd_dkv.fp32_kernels))
    dq = fa.flash_bwd_dq(q, k, v, h, do, lse, delta, bias)
    dk, dv, db = fa.flash_bwd_dkv(q, k, v, h, do, lse, delta, bias, dbias=masked)
    torch.cuda.synchronize()
    kernel = "tc"
    assert fa.bwd_kernel_f32(d) == kernel
    for wrapper, before, ran in zip((fa.flash_bwd_dq, fa.flash_bwd_dkv), routes, kernels):
        assert wrapper.routes == dict(before, fp32=before["fp32"] + 1), (before, wrapper.routes)
        assert wrapper.fp32_kernels == dict(ran, **{kernel: ran[kernel] + 1})
    want = fa.flash_attention_bwd_plain(q, k, v, h, do, lse, delta, bias)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.shape == w.shape
        assert_close_f32(got, w, name)
    if masked:
        assert db.shape == (b, m)
        assert_close_f32(db, want[3], "dbias")
        assert dk[:, m // 2 + 3:].abs().max().item() == 0.0
        assert dv[:, m // 2 + 3:].abs().max().item() == 0.0
    else:
        assert db is None


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_fp32_strided_operands_match_plain(tf32_off, d):
    """k and v sliced from one fused projection (rows 2 H d apart), q from a
    wider one: the kernels read every operand through its strides."""
    cuda = tf32_off
    b, n, m, h = 2, 150, 130, 4
    gen = torch.Generator(device=cuda).manual_seed(d)
    qx = torch.randn((b, n, 3 * h * d), generator=gen, device=cuda)
    kv = torch.randn((b, m, 2 * h * d), generator=gen, device=cuda)
    q, k, v = qx[..., h * d:2 * h * d], kv[..., :h * d], kv[..., h * d:]
    do = torch.randn((b, n, h * d), generator=gen, device=cuda)
    out, lse = fa.flash_fwd(q, k, v, h)
    delta = fa.attention_delta(out, do, h)
    dq = fa.flash_bwd_dq(q, k, v, h, do, lse, delta)
    dk, dv, _ = fa.flash_bwd_dkv(q, k, v, h, do, lse, delta)
    want = fa.flash_attention_bwd_plain(q, k, v, h, do, lse, delta)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert_close_f32(got, w, name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_fp32_repeat_runs_are_bit_identical(tf32_off, d):
    """No atomics in the fp32 kernels either: two runs, the same bits."""
    q, k, v, do, bias, lse, delta = inputs_f32(tf32_off, 2, 300, 330, 4, d, True, seed=8)
    first = (fa.flash_bwd_dq(q, k, v, 4, do, lse, delta, bias),
             *fa.flash_bwd_dkv(q, k, v, 4, do, lse, delta, bias, dbias=True))
    second = (fa.flash_bwd_dq(q, k, v, 4, do, lse, delta, bias),
              *fa.flash_bwd_dkv(q, k, v, 4, do, lse, delta, bias, dbias=True))
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_fp32_tf32_witness_misses_the_limit(tf32_off):
    """The plain backward with one-pass TF32 products (``allow_tf32``)
    misses FP32_REL_TOL where the kernels meet it: the tests tell fp32 from
    TF32."""
    q, k, v, do, bias, lse, delta = inputs_f32(tf32_off, 2, 512, 512, 8, 40, False, seed=9)
    dq = fa.flash_bwd_dq(q, k, v, 8, do, lse, delta)
    want = fa.flash_attention_bwd_plain(q, k, v, 8, do, lse, delta)
    assert_close_f32(dq, want[0], "dq")
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = fa.flash_attention_bwd_plain(q, k, v, 8, do, lse, delta)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert max((a - w).abs().max().item() / w.abs().max().item()
               for a, w in zip(tf32[:3], want[:3])) > FP32_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["base", "row_stride"])
def test_fp32_unaligned_input_is_refused(cuda, what):
    """The fp32 route takes what 16-byte loads read and raises on anything
    else, before any launch: no copy, no bf16 cast, no plain fallback."""
    q, k, v, do, bias, lse, delta = inputs_f32(cuda, 1, 64, 64, 2, 40, False, seed=10)
    if what == "base":
        q = torch.zeros(64 * 80 + 1, device=cuda)[1:].reshape(1, 64, 80)
    else:
        k = torch.zeros((1, 64, 82), device=cuda)[..., :80]  # rows 82 elements apart
    counts = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="multiples of 4 elements"):
        fa.flash_bwd_dq(q, k, v, 2, do, lse, delta)
    with pytest.raises(ValueError, match="multiples of 4 elements"):
        fa.flash_bwd_dkv(q, k, v, 2, do, lse, delta)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == counts


@pytest.mark.gpu
def test_fp32_untabled_tiles_are_refused(cuda):
    """The library holds the fp32 kernels at BWD_TILES_F32 only."""
    q, k, v, do, bias, lse, delta = inputs_f32(cuda, 1, 64, 64, 2, 80, False, seed=5)
    assert fa.bwd_tiles_f32(80)[0] != (64, 64)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.launch_bwd("flash_bwd", "dq", q, k, v, 2, do, lse, delta, None, (64, 64))


@pytest.mark.gpu
def test_fp32_function_matches_plain_autograd(tf32_off):
    """The autograd Function in fp32 (the fp32 forward and backward
    kernels) against autograd through the plain forward on the same
    values."""
    b, n, m, h, d = 2, 70, 100, 2, 40
    q, k, v, do, bias, _, _ = inputs_f32(tf32_off, b, n, m, h, d, True, seed=3)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias)]
    routes = dict(fa.flash_bwd_dq.routes)
    got = torch.autograd.grad(fa.FlashAttention.apply(*leaves, h), leaves, do)
    assert fa.flash_bwd_dq.routes["fp32"] == routes["fp32"] + 1
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias)]
    want = torch.autograd.grad(fa.flash_attention_plain(*ref[:3], h, bias=ref[3])[0], ref, do)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert_close_f32(g, w, name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_fp32_sweep_library_matches_plain(tf32_off, d):
    """The fp32 sweep library (csrc/flash_bwd_f32_sweep.cu) at every
    configuration of bench_sweep_attn.BWD_F32_CONFIGS for the class."""
    from gligen_tpu_torch.tools.bench_sweep_attn import BWD_F32_CONFIGS

    q, k, v, do, bias, lse, delta = inputs_f32(tf32_off, 2, 200, 230, 2, d, True, seed=d + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, 2, do, lse, delta, bias)
    for kind, configs in zip(("dq", "dkv"), BWD_F32_CONFIGS[d]):
        for tiles in configs:
            got, route = fa.launch_bwd("flash_bwd_f32_sweep", kind, q, k, v, 2, do, lse, delta,
                                       bias, tiles, dbias=True)
            assert route == "fp32"
            if kind == "dq":
                assert_close_f32(got, want[0], f"dq {tiles}")
            else:
                assert_close_f32(got[0], want[1], f"dk {tiles}")
                assert_close_f32(got[1], want[2], f"dv {tiles}")
                assert_close_f32(got[2].sum(1), want[3], f"dbias {tiles}")
