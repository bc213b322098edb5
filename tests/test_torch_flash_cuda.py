"""The CUDA flash-attention kernel against its plain PyTorch version, on
the card.  The kernel has no CPU mode, so these tests skip without a GPU.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_flash_cuda.py -m gpu --noconftest -q

Tolerance, bf16 inputs and output: the kernel rounds P to bf16 before the
PV product and the output to bf16, so its outputs differ from the plain
version's (fp32 softmax, one rounding) by a few bf16 ulps of the largest
output: atol 2e-2, and at most 2e-2 of the plain output's largest
magnitude (on unit-scale inputs an output is ~sqrt(e/M), far below 2e-2
at thousands of keys, so the relative limit is the one that binds there).
The log-sum-exp is fp32 on both sides: atol 1e-3 (log2 units); where
every key of a row is masked by a NEG_INF bias the LSE is about -1.4e30,
so there it is held to 1e-6 relative.  Every shape a transformer block or
the VAE gives the kernel takes the TMA route; strided or unaligned inputs
and head dims that are not multiples of 8 take the copy route.
"""

import pytest
import torch

from gligen_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention_plain,
    flash_fwd,
    launch_fwd,
)
from gligen_tpu_torch.tools.bench_sweep_attn import CONFIGS

OUT_TOL = OUT_REL_TOL = 2e-2


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
    out, lse = launch(q, k, v, h, bias, "tma" if d % 8 == 0 else "copy")
    assert flash_fwd.launches == before + 1
    want, want_lse = flash_attention_plain(q, k, v, h, bias=bias)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert_out_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


def assert_out_close(out, want):
    """out within OUT_TOL, and within OUT_REL_TOL of max |want|."""
    torch.testing.assert_close(out.float(), want.float(), atol=OUT_TOL, rtol=0)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= OUT_REL_TOL * want.float().abs().max().item(), err


def launch(q, k, v, h, bias, route):
    """One kernel launch that must take ``route``."""
    before = dict(flash_fwd.routes)
    out, lse = flash_fwd(q, k, v, h, bias=bias)
    torch.cuda.synchronize()
    assert flash_fwd.routes[route] == before[route] + 1, (route, before, flash_fwd.routes)
    return out, lse


def inputs(cuda, b, n, m, h, d, scale=1.0):
    gen = torch.Generator(device=cuda).manual_seed(b * n + m * d)
    return [(torch.randn((b, L, h * d), generator=gen, device=cuda) * scale).to(torch.bfloat16)
            for L in (n, m, m)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,n,m,h,d",
    [
        (2, 4097, 4126, 2, 40),  # N and M multiples of no tile
        (3, 100, 77, 8, 40),     # a single ragged key tile
        (4, 64, 64, 8, 40),      # N below one query block
        (2, 333, 1054, 4, 80),
        (1, 257, 286, 2, 160),
        (1, 4000, 4000, 1, 512),  # the VAE head at B = 1, N not a multiple of 64
    ],
)
def test_ragged_edges(cuda, b, n, m, h, d):
    q, k, v = inputs(cuda, b, n, m, h, d)
    out, lse = launch(q, k, v, h, None, "tma")
    want, want_lse = flash_attention_plain(q, k, v, h)
    assert_out_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 160])
def test_scores_far_above_80(cuda, d):
    """q and k scaled by 8: scores of hundreds in log2 units, which the
    running max handles exactly as the plain version's max-shifted
    softmax does (no clamp)."""
    q, k, v = inputs(cuda, 2, 300, 500, 2, d)
    q, k = q * 8, k * 8
    out, lse = launch(q, k, v, 2, None, "tma")
    want, want_lse = flash_attention_plain(q, k, v, 2)
    assert want_lse.max().item() > 80
    assert_out_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_every_key_masked(cuda):
    """Batch 0: every key masked by a NEG_INF bias (a uniform softmax over
    the masked keys, as in the plain version); batch 1: all but 3 keys."""
    b, n, m, h, d = 2, 130, 200, 2, 40
    q, k, v = inputs(cuda, b, n, m, h, d)
    bias = torch.zeros((b, m), device=cuda)
    bias[0] = NEG_INF
    bias[1, 3:] = NEG_INF
    out, lse = launch(q, k, v, h, bias, "tma")
    want, want_lse = flash_attention_plain(q, k, v, h, bias=bias)
    assert_out_close(out, want)
    torch.testing.assert_close(lse[0], want_lse[0], atol=0, rtol=1e-6)
    torch.testing.assert_close(lse[1], want_lse[1], atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_strided_unaligned_input_takes_the_copy_route(cuda, d):
    """q starts one element (2 bytes) into its storage, and k and v are
    every other row of a larger tensor at an odd row stride: TMA takes
    neither, so the copy route loads them, into the same layout, in every
    head-dim class (1, 2, 3 and 8 swizzle atoms per row)."""
    b, n, m = 2, 150, 90
    h = 1 if d == 512 else 4
    gen = torch.Generator(device=cuda).manual_seed(11 + d)
    qs = torch.randn((b, n * h * d + 1), generator=gen, device=cuda).to(torch.bfloat16)
    q = qs[:, 1:].reshape(b, n, h * d)
    kv = torch.randn((b, 2 * m, h * d + 3), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = kv[:, 0::2, : h * d], kv[:, 1::2, 3:]
    assert q.data_ptr() % 16 and k.stride(1) % 8
    out, lse = launch(q, k, v, h, None, "copy")
    want, want_lse = flash_attention_plain(q, k, v, h)
    assert_out_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 512])
def test_two_runs_are_bit_identical(cuda, d):
    """No atomics: every output element is summed in one fixed order."""
    q, k, v = inputs(cuda, 2, 1000, 1030, 8 if d == 40 else 1, d)
    h = 8 if d == 40 else 1
    first = flash_fwd(q, k, v, h)
    second = flash_fwd(q, k, v, h)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", CONFIGS)
def test_sweep_configurations_match_plain(cuda, tiles):
    """The sweep library's d <= 40 class at each (BQ, BK, stages), at
    ragged N and M: what bench_sweep_attn.py times is the same function."""
    q, k, v = inputs(cuda, 2, 333, 1054, 4, 40)
    before = flash_fwd.launches
    out, lse, route = launch_fwd("flash_fwd_sweep", q, k, v, 4, None, tiles)
    assert route == "tma" and flash_fwd.launches == before  # no serving count
    want, want_lse = flash_attention_plain(q, k, v, 4)
    assert_out_close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_untabled_tiles_are_refused(cuda):
    """Each library launches only the configurations it was built with:
    the serving library the wrapper's table, the sweep library the d <= 40
    class."""
    q, k, v = inputs(cuda, 1, 64, 64, 2, 80)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_fwd("flash_fwd", q, k, v, 2, None, (64, 64, 2))
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_fwd("flash_fwd_sweep", q, k, v, 2, None, (128, 128, 2))
