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
and head dims that are not multiples of 8 take the copy route.  fp32
q/k/v (a model served in fp32, the inpaint encode) take the fp32 route,
3xTF32 products on the tensor cores (each drops ~2^-22 of a product) and
an fp32 softmax: its outputs within 1e-4 of the plain version's largest
magnitude, its LSE within 1e-4; one-pass TF32 products miss that limit at
the VAE head and at attn1 ds1 with sharp scores.  Head dims up to 160 (the
UNet's) run the queries-as-rows kernel, 512 (the VAE's) the keys-as-rows
one (``flash_fwd.fp32_kernels`` counts each).  With q and k scaled x 4 its
LSE stays within 1e-4 too; at x 8, where the plain fp32 LSE is itself
~2e-4 from fp64, within ``tools/lse_rows.py:derived_limit`` (fault F10).
"""

import pytest
import torch

from gligen_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention_plain,
    flash_fwd,
    launch_fwd,
)
from gligen_tpu_torch.tools.bench_sweep_attn import CONFIGS, F32_CONFIGS

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


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,n,m,h,d,padbias",
    [
        (2, 4096, 4096, 1, 512, False),  # the inpaint encode's VAE head
        (1, 1000, 1030, 1, 512, False),  # ragged query and key tiles
        (2, 100, 77, 2, 64, True),       # two heads, a masking bias row
        (1, 33, 5, 3, 4, False),         # the smallest head dim it takes
        (2, 300, 500, 2, 40, False),     # head dims that are no multiple of 32 or 64:
        (1, 257, 286, 2, 80, True),      # V by one TMA box an atom
    ],
)
def test_fp32_route_matches_plain_and_repeats(cuda, monkeypatch, b, n, m, h, d, padbias):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # a plain fp32 product
    gen = torch.Generator(device=cuda).manual_seed(n + m + d)
    q, k, v = (torch.randn((b, L, h * d), generator=gen, device=cuda) for L in (n, m, m))
    bias = None
    if padbias:
        bias = torch.zeros((b, m), device=cuda)
        bias[:, m - 20:] = NEG_INF
    out, lse = launch(q, k, v, h, bias, "fp32")
    want, want_lse = flash_attention_plain(q, k, v, h, bias=bias)
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, want, atol=1e-4 * want.abs().max().item(), rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    again = flash_fwd(q, k, v, h, bias=bias)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.gpu
def test_fp32_route_with_one_unmasked_key(cuda, monkeypatch):
    """Every key of a bias row masked by NEG_INF but one (another key in
    each batch row): the softmax puts all its weight on that key, as the
    plain version's does."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b, n, m, h, d = 2, 150, 300, 2, 80
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = (torch.randn((b, L, h * d), generator=gen, device=cuda) for L in (n, m, m))
    bias = torch.full((b, m), NEG_INF, device=cuda)
    bias[0, 7] = bias[1, 290] = 0.0
    out, lse = launch(q, k, v, h, bias, "fp32")
    want, want_lse = flash_attention_plain(q, k, v, h, bias=bias)
    torch.testing.assert_close(out, want, atol=1e-4 * want.abs().max().item(), rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    again = flash_fwd(q, k, v, h, bias=bias)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.gpu
def test_fp32_route_tells_fp32_from_tf32(cuda, monkeypatch):
    """At the VAE head, one-pass TF32 products (the plain version with
    allow_tf32) miss the fp32 route's limit, and the kernel's 3xTF32 meets
    it: the limit can tell fp32 arithmetic from TF32."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((2, 4096, 512), generator=gen, device=cuda) for _ in range(3))
    out, _ = launch(q, k, v, 1, None, "fp32")
    want, _ = flash_attention_plain(q, k, v, 1)
    limit = 1e-4 * want.abs().max().item()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tf32, _ = flash_attention_plain(q, k, v, 1)
    assert (out - want).abs().max().item() <= limit
    assert (tf32 - want).abs().max().item() > limit


@pytest.mark.gpu
def test_fp32_route_refuses_what_it_does_not_take(cuda):
    """Head dims and strides that are not multiples of 4 elements raise
    before any launch."""
    before = flash_fwd.launches
    q = torch.zeros((1, 8, 6), device=cuda)
    with pytest.raises(ValueError, match="multiples of 4"):
        flash_fwd(q, q, q, 1)
    q = torch.zeros((1, 8, 66), device=cuda)[:, :, :64]
    with pytest.raises(ValueError, match="multiples of 4"):
        flash_fwd(q, q, q, 1)
    assert flash_fwd.launches == before


# ---- the fp32 route at the UNet's head dims: flash_fwd_f32_qm_kernel

def qm_launch(q, k, v, h, bias=None):
    """One fp32 call that must launch the queries-as-rows kernel."""
    before = dict(flash_fwd.fp32_kernels)
    out, lse = launch(q, k, v, h, bias, "fp32")
    assert flash_fwd.fp32_kernels == {"qm": before["qm"] + 1, "km": before["km"]}
    return out, lse


def assert_fp32_close(out, lse, want, want_lse):
    """The fp32 route's limits: 1e-4 of the plain output's largest
    magnitude, the LSE to 1e-4 (log2 units)."""
    assert out.dtype == torch.float32 and out.shape == want.shape
    torch.testing.assert_close(out, want, atol=1e-4 * want.abs().max().item(), rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


# (N, d) of ds1 and ds2, and each site's (name, queries, keys) there
UNET_LEVELS = {"ds1": (4096, 40), "ds2": (1024, 80)}
SITES = {
    "attn1": lambda n: (n, n), "fuser": lambda n: (n, n + 30), "cross": lambda n: (n, 77),
    "fuser_text_image": lambda n: (n, n + 60), "fuser_keypoint": lambda n: (n, n + 136),
    "gated_ca_30": lambda n: (n, 30), "gated_ca_60": lambda n: (n, 60),
    "gated_ca_136": lambda n: (n, 136), "gated_sa2": lambda n: (36, n + 36),
    "fuser_spatial": lambda n: (n, n + 196), "fuser_sem": lambda n: (n, n + 64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("level", sorted(UNET_LEVELS))
@pytest.mark.parametrize("site", sorted(SITES))
def test_fp32_unet_sites_match_plain_and_repeat(cuda, monkeypatch, level, site):
    """Every UNet attention site of a batch-2 request at ds1 and ds2 (B =
    4 CFG rows, 8 heads) on the queries-as-rows kernel, within the fp32
    limits and bit for bit on a second call."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    n0, d = UNET_LEVELS[level]
    n, m = SITES[site](n0)
    gen = torch.Generator(device=cuda).manual_seed(n + m + d)
    q, k, v = (torch.randn((4, L, 8 * d), generator=gen, device=cuda) for L in (n, m, m))
    out, lse = qm_launch(q, k, v, 8)
    assert_fp32_close(out, lse, *flash_attention_plain(q, k, v, 8))
    again = flash_fwd(q, k, v, 8)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,n,m,h,d,bias_from",
    [
        (2, 36, 4132, 8, 40, None),    # gatedSA2 at ds1, batch 2
        (4, 4096, 77, 8, 40, None),    # the 77-key cross-attention
        (4, 4096, 4224, 8, 40, 4126),  # fuser_ds1_padbias: N + 30 keys padded, a bias row
        (1, 257, 286, 2, 40, None),    # ragged query and key tiles, each class
        (1, 257, 286, 2, 80, None),
        (1, 257, 286, 2, 160, 250),
        (4, 256, 452, 8, 160, None),   # ds4: the spatial fuser's N + 196
        (4, 64, 260, 8, 160, None),    # the middle block's N + 196
    ],
)
def test_fp32_qm_shapes_match_plain_and_repeat(cuda, monkeypatch, b, n, m, h, d, bias_from):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(n * 7 + m + d)
    q, k, v = (torch.randn((b, L, h * d), generator=gen, device=cuda) for L in (n, m, m))
    bias = None
    if bias_from is not None:
        bias = torch.zeros((b, m), device=cuda)
        bias[:, bias_from:] = NEG_INF
    out, lse = qm_launch(q, k, v, h, bias)
    assert_fp32_close(out, lse, *flash_attention_plain(q, k, v, h, bias=bias))
    again = flash_fwd(q, k, v, h, bias=bias)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_fp32_qm_with_one_unmasked_key(cuda, monkeypatch, d):
    """Every key masked by NEG_INF but one, in another key tile in each
    batch row: all the weight on that key, as in the plain version."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b, n, m, h = 2, 150, 300, 2
    gen = torch.Generator(device=cuda).manual_seed(19 + d)
    q, k, v = (torch.randn((b, L, h * d), generator=gen, device=cuda) for L in (n, m, m))
    bias = torch.full((b, m), NEG_INF, device=cuda)
    bias[0, 7] = bias[1, 290] = 0.0
    out, lse = qm_launch(q, k, v, h, bias)
    assert_fp32_close(out, lse, *flash_attention_plain(q, k, v, h, bias=bias))


@pytest.mark.gpu
def test_fp32_qm_tells_fp32_from_tf32(cuda, monkeypatch):
    """At attn1 ds1 (B = 4, 8 x 40) with q and k scaled x4 (sharp scores),
    one-pass TF32 products (the plain version with allow_tf32) miss the
    fp32 limit and the kernel's 3xTF32 meets it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(21)
    q, k, v = (torch.randn((4, 4096, 320), generator=gen, device=cuda) for _ in range(3))
    q, k = 4 * q, 4 * k
    out, _ = qm_launch(q, k, v, 8)
    want, _ = flash_attention_plain(q, k, v, 8)
    limit = 1e-4 * want.abs().max().item()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tf32, _ = flash_attention_plain(q, k, v, 8)
    assert (out - want).abs().max().item() <= limit
    assert (tf32 - want).abs().max().item() > limit


@pytest.mark.gpu
def test_fp32_tiles_name_the_kernel(cuda):
    """d <= 160 runs the queries-as-rows kernel and d = 512 the keys-as-rows
    one, as the wrapper counts them; the C entry refuses each kernel's
    tiles at the other's head dims, and any tiles its library lacks."""
    from gligen_tpu_torch.ops.flash_attention import fwd_tiles_f32, launch_fwd_f32

    q = torch.randn((1, 64, 512), device=cuda)
    before = dict(flash_fwd.fp32_kernels)
    flash_fwd(q, q, q, 1)
    flash_fwd(q, q, q, 8)
    torch.cuda.synchronize()
    assert flash_fwd.fp32_kernels == {"qm": before["qm"] + 1, "km": before["km"] + 1}
    km, qm = fwd_tiles_f32(512)[1], fwd_tiles_f32(40)[1]
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_fwd_f32("flash_fwd", q, q, q, 1, None, qm)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_fwd_f32("flash_fwd", q, q, q, 8, None, km)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_fwd_f32("flash_fwd", q, q, q, 8, None, (64, 32, 2))
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_fwd_f32("flash_fwd_f32_sweep", q, q, q, 2, None, (64, 32, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("d,tiles", [(d, t) for d, ts in F32_CONFIGS.items() for t in ts])
def test_fp32_sweep_configurations_match_plain(cuda, monkeypatch, d, tiles):
    """The fp32 sweep library's classes at each (BQ, BK, buffers), at ragged
    N and M: what bench_sweep_attn.py --fp32 times is the same function."""
    from gligen_tpu_torch.ops.flash_attention import launch_fwd_f32

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, L, 4 * d), generator=gen, device=cuda) for L in (333, 1054, 1054))
    before = flash_fwd.launches
    out, lse = launch_fwd_f32("flash_fwd_f32_sweep", q, k, v, 4, None, tiles)
    assert flash_fwd.launches == before  # no serving count
    assert_fp32_close(out, lse, *flash_attention_plain(q, k, v, 4))


# ---- fault F10: the fp32 route's LSE at scaled logits (tools/lse_rows.py)

@pytest.mark.gpu
@pytest.mark.parametrize("scale", [4, 8])
@pytest.mark.parametrize("case", ["attn1_ds1", "attn1_ds2", "fuser_ds1"])
def test_fp32_lse_at_scaled_logits(cuda, monkeypatch, case, scale):
    """q and k x 4 (scores to ~150 log2 units) and x 8 (~600) at ds1's attn1
    and fuser and ds2's attn1, batch 4: the LSE within FP32_LSE_TOL = 1e-4
    of the plain version at x 4, which the queries-as-rows kernel meets
    with each chain's hi.hi products last; at x 8, where the plain fp32 LSE
    is itself ~2e-4 from fp64, within ``lse_rows.derived_limit`` (the two
    fp32 computations' worst-case error), which one TF32 pass exceeds."""
    from gligen_tpu_torch.tools import lse_rows

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    (row,) = lse_rows.lse_rows(torch, cuda, cases=[c for c in lse_rows.CASES if c[0] == case],
                               scales=(scale,))
    assert row["derived"] == (scale == 8) and (scale == 8 or row["limit"] == 1e-4)
    assert row["ok"], lse_rows.row_line(row)
