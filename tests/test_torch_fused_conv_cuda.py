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
