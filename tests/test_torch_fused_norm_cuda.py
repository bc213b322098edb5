"""The CUDA GroupNorm, gn_affine and LayerNorm kernels (csrc/fused_norm.cu)
against their plain PyTorch versions, on the card.  The kernels have no
CPU mode, so these tests skip without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_fused_norm_cuda.py -m gpu --noconftest -q

Tolerance, bf16 inputs and outputs of O(1): kernel and plain version take
fp32 statistics of the same bf16 values in another order, so a normalised
value may round to the neighbouring bf16 value: about one bf16 ulp (2^-7
relative), atol 2e-2 plus rtol 1e-2.  The fp32 affine (a, v) agrees to a
few fp32 ulps: atol 1e-5.
"""

import pytest
import torch

from gligen_tpu_torch.ops import fused_norm as fn

ATOL, RTOL = 2e-2, 1e-2
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inputs(cuda, shape, seed):
    """x (B, ..., C) bf16 with a mean and a spread of its own per (sample,
    channel), so a kernel that reads another group's or sample's statistics
    fails; the fp32 scale and shift (C,)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=cuda)

    b, c = shape[0], shape[-1]
    view = (b,) + (1,) * (len(shape) - 2) + (c,)
    mu, sigma = randn(b, 1) + randn(b, c), (0.5 * randn(b, c)).exp()
    x = (randn(*shape) * sigma.view(view) + mu.view(view)).to(BF16)
    return x, 1.0 + 0.1 * randn(c), 0.1 * randn(c)


def launch_and_compare(kernel, fn_, plain, atol=ATOL, rtol=RTOL):
    before = kernel.launches
    got = fn_()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,silu,eps",
    [
        ((4, 64, 64, 320), True, 1e-5),    # ResBlock ds1
        ((4, 4096, 320), False, 1e-6),     # SpatialTransformer Normalize, (B, N, C)
        ((4, 8, 8, 2560), True, 1e-5),     # output block at 8^2
        ((2, 512, 512, 128), True, 1e-6),  # the VAE's top level: 67 MB per sample
        ((3, 12, 12, 64), True, 1e-5),     # a ragged W of 12
        ((2, 5, 7, 32), False, 1e-6),      # odd H and W, one channel per group
    ],
)
def test_group_norm_matches_plain(cuda, shape, silu, eps):
    x, s, b = inputs(cuda, shape, sum(shape))
    launch_and_compare(fn.group_norm_fused, lambda: fn.group_norm_fused(x, s, b, 32, eps, silu),
                       lambda: fn.group_norm_plain(x, s, b, 32, eps, silu))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64, 64, 320), (4, 8, 8, 2560), (3, 12, 12, 64)])
def test_gn_affine_matches_plain(cuda, shape):
    x, s, b = inputs(cuda, shape, 7)
    launch_and_compare(fn.gn_affine, lambda: fn.gn_affine(x, s, b),
                       lambda: fn.gn_affine_plain(x, s, b), atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_group_norm_repeats_bit_for_bit(cuda):
    """Fixed reduction orders, no float atomics."""
    x, s, b = inputs(cuda, (2, 128, 128, 256), 3)
    first = fn.group_norm_fused(x, s, b, 32, 1e-6, True)
    assert all(torch.equal(first, fn.group_norm_fused(x, s, b, 32, 1e-6, True))
               for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c", [(4 * 4096, 320), (4 * 4126, 320), (4 * 1054, 640),
                                    (4 * 94, 1280), (37, 24)])
def test_layer_norm_matches_plain(cuda, rows, c):
    """Every block's rows, and ragged counts: the fuser's N + 30, and 37."""
    x, s, b = inputs(cuda, (rows, c), rows + c)
    launch_and_compare(fn.layer_norm_fused, lambda: fn.layer_norm_fused(x, s, b),
                       lambda: fn.layer_norm_plain(x, s, b))


@pytest.mark.gpu
def test_refused_inputs_raise(cuda):
    """fp32 activations, widths that are not multiples of 8 and groups that
    do not divide the channels are refused before any launch."""
    before = {name: k.launches for name, k in fn.KERNELS.items()}
    ones = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        fn.group_norm_fused(torch.zeros((2, 4, 64), device=cuda), ones, ones)
    with pytest.raises(ValueError, match="groups"):
        fn.gn_affine(torch.zeros((2, 4, 48), dtype=BF16, device=cuda), ones[:48], ones[:48])
    with pytest.raises(ValueError, match="multiple of 8"):
        fn.layer_norm_fused(torch.zeros((4, 20), dtype=BF16, device=cuda), ones[:20], ones[:20])
    assert {name: k.launches for name, k in fn.KERNELS.items()} == before
