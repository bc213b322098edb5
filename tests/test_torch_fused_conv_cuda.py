"""The CUDA fused GN -> SiLU -> conv3x3 kernel (csrc/fused_conv.cu, with
gn_affine's kernel of csrc/fused_norm.cu) against its plain PyTorch
version, on the card.  The kernels have no CPU mode, so these tests skip
without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_fused_conv_cuda.py -m gpu --noconftest -q

Tolerance, bf16 inputs and outputs of O(1): kernel and plain version
multiply the same bf16-rounded operands and sum in fp32 in another order,
and an activated value may round to the neighbouring bf16 value: about
one bf16 ulp (2^-7 relative) on outputs up to ~5 (a residual adds x ~ N(0,
1)): atol 2e-2 plus rtol 1e-2.
"""

import pytest
import torch

from gligen_tpu_torch.ops import fused_conv as fc

ATOL, RTOL = 2e-2, 1e-2
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,h,w,c,f,residual",
    [
        (4, 64, 64, 320, 320, True),     # out_layers at ds1
        (4, 32, 32, 960, 640, False),    # in_layers of an output block
        (4, 8, 8, 2560, 1280, False),    # 8^2: 256 rows, 64-row blocks
        (2, 12, 12, 64, 96, True),       # a ragged W of 12, C != F
        (1, 5, 7, 32, 40, False),        # odd H and W, one channel per group
    ],
)
def test_gn_silu_conv3x3_matches_plain(cuda, b, h, w, c, f, residual):
    gen = torch.Generator(device=cuda).manual_seed(b * h * w + c + f)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(dtype)

    x = randn(b, h, w, c, dtype=BF16)
    s, sb = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
    wk, wb = randn(f, c, 3, 3, scale=(9 * c) ** -0.5), randn(f, scale=0.1)
    res = randn(b, h, w, f, dtype=BF16) if residual else None
    before = fc.gn_silu_conv3x3.launches, fc.gn_affine.launches
    got = fc.gn_silu_conv3x3(x, s, sb, wk, wb, residual=res)
    torch.cuda.synchronize()
    assert (fc.gn_silu_conv3x3.launches, fc.gn_affine.launches) == (before[0] + 1, before[1] + 1)
    want = fc.gn_silu_conv3x3_plain(x, s, sb, wk, wb, residual=res)
    assert got.dtype == BF16 and got.shape == (b, h, w, f)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_refused_inputs_raise(cuda):
    """fp32 activations and channel counts that are not multiples of 8 are
    refused before any launch."""
    before = fc.gn_silu_conv3x3.launches, fc.gn_affine.launches
    ones = torch.ones(64, device=cuda)
    w = torch.zeros((32, 64, 3, 3), device=cuda)
    with pytest.raises(TypeError):
        fc.gn_silu_conv3x3(torch.zeros((1, 4, 4, 64), device=cuda), ones, ones, w, ones[:32])
    with pytest.raises(ValueError, match="multiple of 8"):
        fc.gn_silu_conv3x3(torch.zeros((1, 4, 4, 64), dtype=BF16, device=cuda), ones, ones,
                           torch.zeros((12, 64, 3, 3), device=cuda), ones[:12])
    assert (fc.gn_silu_conv3x3.launches, fc.gn_affine.launches) == before


def _operands(cuda, b, h, w, c, f, residual, seed):
    """The conv kernel's own operands: x with statistics of its own per
    (sample, channel), a shift far from 0, the affine from gn_affine, the
    weight already bf16 (F, 3, 3, C)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    x = (randn(b, h, w, c) * (0.5 * randn(b, 1, 1, c)).exp() + randn(b, 1, 1, c)).to(BF16)
    s, sb = 1.0 + randn(c, scale=0.1), 2.0 + randn(c, scale=0.1)
    wk, wb = randn(f, c, 3, 3, scale=(9 * c) ** -0.5), randn(f, scale=0.1)
    res = randn(b, h, w, f).to(BF16) if residual else None
    a, v = fc.gn_affine(x, s, sb)
    wt = wk.to(BF16).permute(0, 2, 3, 1).contiguous()
    return (x, a, v, wt, wb, res), fc._ref_chain(x, a, v, wk, wb, res)


@pytest.mark.gpu
@pytest.mark.parametrize("library,tiles", [("fused_conv", t) for _, t, _ in fc.CONV_TILES]
                         + [("fused_conv_sweep", t) for t in fc.SWEEP_CONV_TILES])
@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 16, 16, 192, 320, True), (3, 5, 7, 96, 40, False)])
def test_every_tile_configuration_and_split_matches_plain(cuda, library, tiles, split, shape):
    """Every configuration of the serving and the sweep library, with and
    without split-K (3 ranges of 3 slices; 2 of 2 with a ragged last
    slice), on a ResBlock-like shape and an odd one whose row tiles span
    samples."""
    b, h, w, c, f, residual = shape
    split = min(split, -(-c // 64))
    ops, want = _operands(cuda, b, h, w, c, f, residual, sum(tiles) + split)
    got = fc.gn_silu_conv3x3.conv(*ops, plan=(*tiles, split), library=library)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64, 64, 320, 320, True), (4, 8, 8, 2560, 1280, False),
                                   (4, 16, 16, 1280, 1280, True)])
def test_conv_repeats_bit_for_bit(cuda, shape):
    """Fixed summation orders, the split-K partials added in order, no
    float atomics: repeated calls give the same bits (8^2 and 16^2 take
    the split route)."""
    b, h, w, c, f, residual = shape
    ops, _ = _operands(cuda, b, h, w, c, f, residual, 1)
    assert fc.conv_plan(b, h, w, c, f)[3] == (1 if h == 64 else 8 if h == 8 else 2)
    first = fc.gn_silu_conv3x3.conv(*ops)
    assert all(torch.equal(first, fc.gn_silu_conv3x3.conv(*ops)) for _ in range(3))


def within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of the fp32 value want, elementwise."""
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    excess = (got.float() - want).abs() - ulp
    assert excess.max() <= 0, f"{(excess > 0).sum()} values past one bf16 ulp, worst by {excess.max()}"


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [-5.0, -50.0])
@pytest.mark.parametrize("tap", [(1, 1), (0, 0), (2, 1)])
@pytest.mark.parametrize("shape", [(4, 64, 64, 320), (4, 8, 8, 256), (2, 12, 12, 64)])
def test_activated_halo_is_silu_to_one_bf16_ulp(cuda, tap, shape, shift):
    """The activated halo itself: a weight that is the identity at one tap
    and zero elsewhere makes each output the neighbour's activated value
    (one nonzero fp32 product, exact) or exactly 0 where the neighbour lies
    outside the image.  Pre-activations around v = -5 (in [-8, -2], where
    1 + exp(-y) is large and an approximate sigmoid loses its digits) and
    v = -50 (silu near -1e-20, far out in the exponent range) are held to
    one bf16 ulp of the fp32 silu."""
    b, h, w, c = shape
    gen = torch.Generator(device=cuda).manual_seed(h * w + c)

    def uniform(*s, lo, hi):
        return lo + (hi - lo) * torch.rand(s, generator=gen, device=cuda)

    x = uniform(b, h, w, c, lo=-3.0, hi=3.0).to(BF16)
    a, v = uniform(b, c, lo=0.8, hi=1.0), uniform(b, c, lo=shift - 0.2, hi=shift + 0.2)
    wt = torch.zeros((c, 3, 3, c), dtype=BF16, device=cuda)
    wt[:, tap[0], tap[1], :] = torch.eye(c, dtype=BF16, device=cuda)
    got = fc.gn_silu_conv3x3.conv(x, a, v, wt, torch.zeros(c, device=cuda))
    torch.cuda.synchronize()
    act = torch.nn.functional.silu(x.float() * a[:, None, None] + v[:, None, None])
    dy, dx = tap[0] - 1, tap[1] - 1
    want = torch.zeros_like(act)
    want[:, max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = (
        act[:, max(0, dy):h + min(0, dy), max(0, dx):w + min(0, dx)])
    outside = want == 0
    assert torch.equal(got[outside], torch.zeros_like(got[outside]))
    within_one_bf16_ulp(got[~outside], want[~outside])
