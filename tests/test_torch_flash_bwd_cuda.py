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
the same bound.
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
