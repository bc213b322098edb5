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


def inputs(device, b, n, m, h, d, masked, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
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
@pytest.mark.parametrize(
    "b,n,m,h,d,masked",
    [
        (2, 256, 256, 8, 40, False),   # attn1 at a small map, head dim 40
        (2, 1024, 1054, 4, 80, False),  # the fuser's N + 30 keys: a ragged key tile
        (2, 256, 286, 8, 160, False),  # head dim 160, ragged keys
        (2, 64, 77, 8, 160, False),    # cross-attention over 77 text tokens
        (2, 200, 170, 2, 64, True),    # a key mask with dbias, ragged query tile
        (1, 100, 90, 2, 36, True),     # head dim not a multiple of 8: scalar loads
    ],
)
def test_dq_dkv_dbias_match_plain(cuda, b, n, m, h, d, masked):
    q, k, v, do, bias, lse, delta = inputs(cuda, b, n, m, h, d, masked, seed=n + m + d)
    counts = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(q, k, v, h, do, lse, delta, bias)
    dk, dv, db = fa.flash_bwd_dkv(q, k, v, h, do, lse, delta, bias, dbias=masked)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (counts[0] + 1, counts[1] + 1)
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
def test_repeat_runs_are_bit_identical(cuda):
    """No atomics: two runs give the same bits."""
    q, k, v, do, bias, lse, delta = inputs(cuda, 2, 300, 330, 4, 80, True, seed=7)
    first = (fa.flash_bwd_dq(q, k, v, 4, do, lse, delta, bias),
             *fa.flash_bwd_dkv(q, k, v, 4, do, lse, delta, bias, dbias=True))
    second = (fa.flash_bwd_dq(q, k, v, 4, do, lse, delta, bias),
              *fa.flash_bwd_dkv(q, k, v, 4, do, lse, delta, bias, dbias=True))
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


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
