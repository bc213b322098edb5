"""The CUDA flash-attention kernel against its plain PyTorch version, on
the card.  The kernel has no CPU mode, so these tests skip without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_flash_cuda.py -m gpu --noconftest -q

Tolerance, bf16 inputs and output: the kernel rounds P to bf16 before the
PV product and the output to bf16, so O(1) outputs differ from the plain
version's (fp32 softmax, one rounding) by a few bf16 ulps: atol 2e-2.
The log-sum-exp is fp32 on both sides: atol 1e-3 (log2 units).
"""

import pytest
import torch

from gligen_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_plain, flash_fwd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,n,m,h,d,padbias",
    [
        (4, 4096, 4096, 8, 40, False),   # attn1 at ds1
        (4, 1024, 1054, 8, 80, False),   # fuser at ds2: N + 30 keys
        (4, 256, 77, 8, 160, False),     # cross-attention at ds4
        (4, 64, 64, 8, 160, False),      # middle block
        (4, 256, 384, 8, 160, True),     # padded keys masked by a bias row
        (2, 4096, 4096, 1, 512, False),  # VAE mid-attention
        (3, 100, 70, 3, 20, False),      # head dim not a multiple of 8: scalar loads
    ],
)
def test_kernel_matches_plain(cuda, b, n, m, h, d, padbias):
    gen = torch.Generator(device=cuda).manual_seed(n + m + d)
    q, k, v = (torch.randn((b, L, h * d), generator=gen, device=cuda).to(torch.bfloat16)
               for L in (n, m, m))
    bias = None
    if padbias:
        bias = torch.zeros((b, m), device=cuda)
        bias[:, m - 98:] = NEG_INF
    before = flash_fwd.launches
    out, lse = flash_fwd(q, k, v, h, bias=bias)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    want, want_lse = flash_attention_plain(q, k, v, h, bias=bias)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
