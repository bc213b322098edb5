"""Every kernel on the tensor-parallel path at its TP = 2 shard shape
(``gligen_tpu_torch/parallel/sharding.py``: half the heads, half the
projection columns, half the ResBlock channels in 16 of the 32 groups)
against its plain PyTorch version, on the card.  The kernels have no CPU
mode, so these tests skip without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_sharding_cuda.py -m gpu --noconftest -q

Tolerances are the kernels' own (their card tests): the flash forward and
backward within 2e-2 of the plain output's largest magnitude (bf16 P, dS
and outputs), the LSE within 1e-3; the fused projections, the GroupNorm
and the fused conv within 2e-2 + 1e-2 |plain| (one bf16 ulp of outputs up
to ~5).
"""

import pytest
import torch

from gligen_tpu_torch.ops import flash_attention as fa
from gligen_tpu_torch.ops import fused_conv as fc
from gligen_tpu_torch.ops import fused_norm as fn
from gligen_tpu_torch.ops import fused_proj as fp

REL_TOL, LSE_TOL = 2e-2, 1e-3
ATOL, RTOL = 2e-2, 1e-2
BF16 = torch.bfloat16
TP = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def randn(gen, device, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def assert_rel(got, want, name):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all(), name
    assert scale > 0 and err <= REL_TOL * scale, f"{name}: max abs err {err:.3e} of {scale:.3e}"


def assert_close(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.allclose(got.float(), want.float(), atol=ATOL, rtol=RTOL), \
        (got.float() - want.float()).abs().max().item()


# (level, tokens, head dim): 8 heads of SD-1.4 split over two ranks
LEVELS = [("ds1", 4096, 40), ("ds2", 1024, 80), ("ds4", 256, 160)]
SITES = [("attn1", 0), ("fuser", 30), ("cross", None)]


@pytest.mark.gpu
@pytest.mark.parametrize("level,n,d", LEVELS, ids=[lv[0] for lv in LEVELS])
@pytest.mark.parametrize("site,extra", SITES, ids=[s[0] for s in SITES])
def test_flash_forward_and_backward_at_half_the_heads(cuda, level, n, d, site, extra):
    """attn1 (N keys), the gatedSA fuser (N + 30) and cross-attention (77)
    at 8 / TP heads, batch 4: the forward on the TMA route, dq and dk/dv."""
    h, b = 8 // TP, 4
    m = 77 if extra is None else n + extra
    gen = torch.Generator(device=cuda).manual_seed(n + m + d)
    q, k, v, do = (randn(gen, cuda, b, L, h * d, dtype=BF16) for L in (n, m, m, n))
    routes = dict(fa.flash_fwd.routes)
    out, lse = fa.flash_fwd(q, k, v, h)
    torch.cuda.synchronize()
    assert fa.flash_fwd.routes["tma"] == routes["tma"] + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, h)
    assert_rel(out, want, "out")
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    delta = fa.attention_delta(out, do, h)
    dq = fa.flash_bwd_dq(q, k, v, h, do, lse, delta)
    dk, dv, _ = fa.flash_bwd_dkv(q, k, v, h, do, lse, delta)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv),
                            fa.flash_attention_bwd_plain(q, k, v, h, do, lse, delta)):
        assert_rel(got, w, name)


# (level, tokens, channels) of a transformer block
BLOCKS = [("ds1", 4096, 320), ("ds2", 1024, 640), ("ds4", 256, 1280)]


@pytest.mark.gpu
@pytest.mark.parametrize("level,n,c", BLOCKS, ids=[blk[0] for blk in BLOCKS])
def test_fused_projections_at_their_shards(cuda, level, n, c):
    """q/k/v to C/2 columns; to_out from C/2 inputs and net_2 from 2C, each
    with rank 1's zero residual and bias; GEGLU to 2 x 2C."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = randn(gen, cuda, 4, n, c, dtype=BF16)
    s, sb = 1.0 + randn(gen, cuda, c, scale=0.1), randn(gen, cuda, c, scale=0.1)
    ws = [randn(gen, cuda, c // TP, c, scale=c**-0.5, dtype=BF16) for _ in range(3)]
    got = fp.ln_matmuls(x, s, sb, ws)
    for g, w in zip(got, fp.ln_matmuls_plain(x, s, sb, ws)):
        assert g.shape == (4, n, c // TP)
        assert_close(g, w)
    gate = torch.tensor(0.37, device=cuda)
    for k, g in ((c // TP, gate), (4 * c // TP, None)):
        h = randn(gen, cuda, 4, n, k, dtype=BF16)
        w = randn(gen, cuda, c, k, scale=k**-0.5, dtype=BF16)
        zero_b, zero_x = torch.zeros(c, device=cuda), torch.zeros_like(x)
        assert_close(fp.matmul_residual(h, w, zero_b, zero_x, gate=g),
                     fp.matmul_residual_plain(h, w, zero_b, zero_x, g))
    w = randn(gen, cuda, 8 * c // TP, c, scale=c**-0.5, dtype=BF16)
    wb = randn(gen, cuda, 8 * c // TP, scale=0.1)
    got = fp.ln_geglu(x, s, sb, w, wb)
    assert got.shape == (4, n, 4 * c // TP)
    assert_close(got, fp.ln_geglu_plain(x, s, sb, w, wb))


# (H, C_in, C_out) of SD-1.4 ResBlocks at 512^2
RESBLOCKS = [(64, 320, 320), (32, 320, 640), (16, 640, 1280), (8, 1280, 1280),
             (64, 640, 320)]


@pytest.mark.gpu
@pytest.mark.parametrize("hw,cin,cout", RESBLOCKS)
def test_resblock_kernels_at_their_shards(cuda, hw, cin, cout):
    """GroupNorm 2 (+ SiLU) over C_out/2 channels in 16 groups (one
    launch), gn_affine there, and the fused conv both ways: conv1 C_in ->
    C_out/2, conv2 C_out/2 -> C_out with rank 0's residual (at C_out/2 =
    160 the last 64-channel slice is ragged)."""
    gen = torch.Generator(device=cuda).manual_seed(hw + cin + cout)
    half, groups = cout // TP, 32 // TP
    h = randn(gen, cuda, 4, hw, hw, half, dtype=BF16) * 1.5 + 0.2
    s, sb = 1.0 + randn(gen, cuda, half, scale=0.1), randn(gen, cuda, half, scale=0.1)
    before = fn.group_norm_fused.launches
    got = fn.group_norm_fused(h, s, sb, groups, 1e-5, silu=True)
    assert fn.group_norm_fused.launches == before + 1
    assert_close(got, fn.group_norm_plain(h, s, sb, groups, 1e-5, silu=True))
    a, v = fn.gn_affine(h, s, sb, groups)
    wa, wv = fn.gn_affine_plain(h, s, sb, groups)
    assert torch.allclose(a, wa, atol=1e-5, rtol=1e-5) and torch.allclose(v, wv, atol=1e-5,
                                                                            rtol=1e-5)
    x = randn(gen, cuda, 4, hw, hw, cin, dtype=BF16)
    s1, b1 = 1.0 + randn(gen, cuda, cin, scale=0.1), randn(gen, cuda, cin, scale=0.1)
    w1, wb1 = randn(gen, cuda, half, cin, 3, 3, scale=(9 * cin) ** -0.5), randn(gen, cuda, half)
    assert_close(fc.gn_silu_conv3x3(x, s1, b1, w1, wb1),
                 fc.gn_silu_conv3x3_plain(x, s1, b1, w1, wb1))
    w2, wb2 = randn(gen, cuda, cout, half, 3, 3, scale=(9 * half) ** -0.5), randn(gen, cuda, cout)
    res = randn(gen, cuda, 4, hw, hw, cout, dtype=BF16)
    assert_close(fc.gn_silu_conv3x3(h, s, sb, w2, wb2, res, groups),
                 fc.gn_silu_conv3x3_plain(h, s, sb, w2, wb2, res, groups))
