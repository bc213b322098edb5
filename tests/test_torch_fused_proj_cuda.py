"""The CUDA fused projection kernels (csrc/fused_proj.cu) against their
plain PyTorch versions, on the card.  The kernels have no CPU mode, so
these tests skip without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_fused_proj_cuda.py -m gpu --noconftest -q

Tolerance, bf16 inputs and outputs of O(1): kernel and plain version
multiply the same bf16-rounded operands and sum in fp32 in another order,
and the normalised rows may round to the neighbouring bf16 value where the
fp32 LayerNorm statistics differ in their last bits.  The outputs then
differ by at most about one bf16 ulp (2^-7 relative): atol 2e-2 plus
rtol 1e-2, the flash kernel's absolute tolerance with room for outputs of
magnitude above 2 (the residual adds x ~ N(0, 1)).
"""

import pytest
import torch

from gligen_tpu_torch.ops import fused_proj as fp

ATOL, RTOL = 2e-2, 1e-2
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def launch_and_compare(kernel, fn, plain):
    before = kernel.launches
    got = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == BF16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,c,n_w",
    [
        (4 * 4096, 320, 3),   # attn1 q/k/v at ds1
        (4 * 4126, 320, 2),   # fuser k/v over N + 30 rows: a ragged last row tile
        (4 * 1024, 640, 1),   # q alone at ds2
        (4 * 256, 1280, 3),   # ds4
        (4 * 64, 1280, 1),    # middle block
        (3 * 37, 24, 2),      # small, odd rows and widths below one tile
    ],
)
def test_ln_matmuls_matches_plain(cuda, rows, c, n_w):
    gen = torch.Generator(device=cuda).manual_seed(rows + c)
    x = randn(gen, rows, c, scale=2.0, dtype=BF16) + 0.5
    s, b = 1.0 + randn(gen, c, scale=0.1), randn(gen, c, scale=0.1)
    f = c if c % 64 == 0 else 40
    ws = [randn(gen, f, c, scale=c**-0.5, dtype=BF16) for _ in range(n_w)]
    launch_and_compare(fp.ln_matmuls, lambda: fp.ln_matmuls(x, s, b, ws),
                       lambda: fp.ln_matmuls_plain(x, s, b, ws))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,k,c,gate",
    [
        (4 * 4096, 320, 320, "tensor"),  # fuser to_out at ds1, device gate
        (4 * 1024, 2560, 640, None),     # net_2 at ds2
        (4 * 256, 1280, 1280, 0.3),      # to_out at ds4, a number as the gate
        (4 * 64, 5120, 1280, "tensor"),  # fuser net_2 at mid
        (3 * 37, 48, 24, "tensor"),      # small, odd rows
    ],
)
def test_matmul_residual_matches_plain(cuda, rows, k, c, gate):
    gen = torch.Generator(device=cuda).manual_seed(rows + k)
    h, x = randn(gen, rows, k, dtype=BF16), randn(gen, rows, c, dtype=BF16)
    w, b = randn(gen, c, k, scale=k**-0.5, dtype=BF16), randn(gen, c, scale=0.1)
    g = torch.tensor(-0.61, device=cuda) if gate == "tensor" else gate
    launch_and_compare(fp.matmul_residual, lambda: fp.matmul_residual(h, w, b, x, gate=g),
                       lambda: fp.matmul_residual_plain(h, w, b, x, gate=g))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c", [(4 * 4096, 320), (4 * 1024, 640), (4 * 256, 1280),
                                    (4 * 64, 1280), (3 * 37, 24)])
def test_ln_geglu_matches_plain(cuda, rows, c):
    gen = torch.Generator(device=cuda).manual_seed(rows * 3 + c)
    x = randn(gen, rows, c, dtype=BF16)
    s, b = 1.0 + randn(gen, c, scale=0.1), randn(gen, c, scale=0.1)
    w, wb = randn(gen, 8 * c, c, scale=c**-0.5, dtype=BF16), randn(gen, 8 * c, scale=0.1)
    launch_and_compare(fp.ln_geglu, lambda: fp.ln_geglu(x, s, b, w, wb),
                       lambda: fp.ln_geglu_plain(x, s, b, w, wb))


@pytest.mark.gpu
def test_refused_width_raises(cuda):
    """C = 20 is not a multiple of 8: 16-byte row loads cannot take it."""
    x = torch.zeros((4, 20), dtype=BF16, device=cuda)
    s = torch.ones(20, device=cuda)
    w = torch.zeros((40, 20), dtype=BF16, device=cuda)
    before = {name: k.launches for name, k in fp.KERNELS.items()}
    with pytest.raises(ValueError, match="multiple of 8"):
        fp.ln_matmuls(x, s, s, (w,))
    with pytest.raises(ValueError, match="multiple of 8"):
        fp.matmul_residual(x, w[:20], s, x)
    with pytest.raises(ValueError, match="multiple of 8"):
        fp.ln_geglu(x, s, s, w, torch.zeros(40, device=cuda))
    assert {name: k.launches for name, k in fp.KERNELS.items()} == before
