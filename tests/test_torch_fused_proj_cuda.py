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
from gligen_tpu_torch.tools.bench_proj import row_blocks

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


def k2_inputs(cuda, kind, rows, k, f, seed, n_w=1):
    """Seeded card inputs of a K2 mode, in the wrapper's argument order."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = randn(gen, rows, k, scale=2.0, dtype=BF16) + 0.5
    s, b = 1.0 + randn(gen, k, scale=0.1), randn(gen, k, scale=0.1)
    if kind == "ln_matmuls":
        return (x, s, b, [randn(gen, f, k, scale=k**-0.5, dtype=BF16) for _ in range(n_w)])
    if kind == "matmul_residual":
        return (x, randn(gen, f, k, scale=k**-0.5, dtype=BF16), randn(gen, f, scale=0.1),
                randn(gen, rows, f, dtype=BF16), torch.tensor(-0.61, device=cuda))
    return (x, s, b, randn(gen, 2 * f, k, scale=k**-0.5, dtype=BF16), randn(gen, 2 * f, scale=0.1))


def call(kind, args):
    return fp.KERNELS[kind](*args)


# One shape per K2 rule of the tile table (tests/test_torch_fused_proj.py
# checks that every rule is hit), ragged in M against BM, in K against the
# 64-column atom and in F against the tile's output columns: (mode, rows,
# K, F).  ln_geglu's F is no multiple of BN / 2, so a tensor map of extent
# 2F over W would read gate rows into the a-half's last box.
TABLE_SHAPES = [
    ("ln_matmuls", 12288 + 37, 200, 104),
    ("ln_matmuls", 999, 520, 168),
    ("ln_matmuls", 333, 1096, 200),
    ("matmul_residual", 12288 + 37, 200, 104),
    ("matmul_residual", 999, 1096, 168),
    ("ln_geglu", 999, 200, 104),
    ("ln_geglu", 999, 520, 200),
    ("ln_geglu", 333, 1096, 72),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rows,k,f", TABLE_SHAPES)
def test_every_tile_class_matches_plain(cuda, kind, rows, k, f):
    """Each K2 class of PROJ_TILES at a ragged shape, 3 weights for
    ln_matmuls; the launch takes the class's tiles (from its kernel's name
    in a trace)."""
    tiles = fp.proj_tiles(kind, rows, k, f)
    args = k2_inputs(cuda, kind, rows, k, f, rows + k + f, n_w=3)
    with torch.no_grad():
        launch_and_compare(fp.KERNELS[kind], lambda: call(kind, args),
                           lambda: getattr(fp, f"{kind}_plain")(*args))
        assert row_blocks(lambda: call(kind, args)) == (tiles,)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ln_matmuls", "matmul_residual", "ln_geglu"])
@pytest.mark.parametrize("rows,k,f", [(4 * 4126, 320, 320), (4 * 64, 1280, 8), (5, 8, 8)])
def test_fuser_rows_and_narrow_outputs(cuda, kind, rows, k, f):
    """The fuser's 4 x 4126 rows (a ragged last row block of 128), F = 8 (one
    16-byte chunk a row, most of the tile's W rows TMA's zeros) and a
    5-row, 8-wide call."""
    args = k2_inputs(cuda, kind, rows, k, f, 3 * rows + f, n_w=2)
    with torch.no_grad():
        launch_and_compare(fp.KERNELS[kind], lambda: call(kind, args),
                           lambda: getattr(fp, f"{kind}_plain")(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rows,k,f", [("ln_matmuls", 4 * 4126, 320, 320),
                                           ("matmul_residual", 4 * 4096, 1280, 320),
                                           ("ln_geglu", 4 * 1024, 640, 2560)])
def test_repeat_runs_are_bit_identical(cuda, kind, rows, k, f):
    """No atomics and no split-K: each output is one sum in a fixed order."""
    args = k2_inputs(cuda, kind, rows, k, f, 11, n_w=3)
    with torch.no_grad():
        first, second = call(kind, args), call(kind, args)
    torch.cuda.synchronize()
    for a, b in zip(*((first, second) if isinstance(first, tuple) else ((first,), (second,)))):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_untabled_tiles_are_refused(cuda):
    """The serving library holds only the table's configurations: any other
    triple returns an error before a launch, and counts none."""
    args = k2_inputs(cuda, "ln_matmuls", 256, 320, 320, 5)
    before = fp.ln_matmuls.launches
    with pytest.raises(RuntimeError, match="launch failed at tiles"):
        fp.sweep_call("ln_matmuls", (128, 96, 2), *args, library="fused_proj")
    assert fp.ln_matmuls.launches == before
