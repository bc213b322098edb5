"""K7, the matmul-only mode of csrc/fused_proj.cu (``fused_proj.mm_only``),
against its plain PyTorch version on the card.  The kernel has no CPU
mode, so these tests skip without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_mm_only_cuda.py -m gpu --noconftest -q

Tolerance, bf16 inputs and outputs of O(1): kernel and plain version
multiply the same bf16 operands and sum in fp32 in another order, so an
output may round to the neighbouring bf16 value: about one bf16 ulp (2^-7
relative), the fused projections' atol 2e-2 plus rtol 1e-2.
"""

import pytest
import torch

from gligen_tpu_torch.ops import fused_proj as fp
from gligen_tpu_torch.tools.bench_proj import row_blocks

ATOL, RTOL = 2e-2, 1e-2
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inputs(device, rows, k, f, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, k), generator=gen, device=device).to(BF16)
    w = (torch.randn((f, k), generator=gen, device=device) * k**-0.5).to(BF16)
    return x, w


MM_SHAPES = [
    (4 * 4096, 320, 320, 128),    # q / to_out at ds1
    (4 * 4096, 320, 2560, 128),   # GEGLU's product
    (4 * 4096, 1280, 320, 128),   # net_2's product
    (4 * 4126, 320, 320, 128),    # the fuser's N + 30 rows: a ragged last row block
    (256, 320, 320, 64),          # the middle block: 64-row blocks
    (999, 200, 104, 64),          # M, K, F off every row block, 64-column atom and tile
    (37, 8, 8, 64),               # smaller than one tile
    (12288 + 37, 200, 1096, 128), # the wide-F class, ragged in M, K and F
    (12288 + 37, 1096, 104, 128), # the wide-row class, ragged likewise
]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,k,f,block", MM_SHAPES)
def test_mm_only_matches_plain(cuda, rows, k, f, block):
    x, w = inputs(cuda, rows, k, f, rows + k + f)
    before = fp.mm_only.launches
    with torch.no_grad():
        got = fp.mm_only(x, w)
    torch.cuda.synchronize()
    assert fp.mm_only.launches == before + 1
    want = fp.mm_only_plain(x, w)
    assert got.dtype == BF16 and got.shape == want.shape == (rows, f)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)
    # the tiles the table gives the shape, from the launched kernel's name
    tiles = fp.proj_tiles("mm_only", rows, k, f)
    assert tiles[0] == block
    with torch.no_grad():
        assert row_blocks(lambda: fp.mm_only(x, w)) == (tiles,)


@pytest.mark.gpu
def test_repeat_runs_are_bit_identical(cuda):
    """No atomics and no split-K: each output is one sum in a fixed order."""
    x, w = inputs(cuda, 4 * 4126, 320, 2560, 7)
    first = fp.mm_only(x, w)
    second = fp.mm_only(x, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_refused_inputs_raise(cuda):
    """K = 20 is not a multiple of 8, and a fp32 weight is not bf16: both
    raise before any launch, as does an input that requires a gradient."""
    before = fp.mm_only.launches
    x = torch.zeros((4, 20), dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        fp.mm_only(x, torch.zeros((16, 20), dtype=BF16, device=cuda))
    x, w = inputs(cuda, 64, 32, 16, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        fp.mm_only(x, w.float())
    with pytest.raises(RuntimeError, match="forward only"):
        fp.mm_only(x, w.float().requires_grad_().to(BF16))
    assert fp.mm_only.launches == before
