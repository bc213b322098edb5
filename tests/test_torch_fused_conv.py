"""The fused GN -> SiLU -> conv3x3 path of gligen_tpu_torch against
gligen_tpu's.

Kernel: the plain version of ops/fused_conv.py against the Pallas kernel it
ports (ops/pallas_conv.py in interpret mode on the CPU), with and without a
residual, with C != F.  Build: the library's hash covers the headers the
two GEMM sources share.  ResBlocks and UNet calls:
the port under GLIGEN_TPU_FUSED_CONV=1 against the JAX package under the
same switch with GLIGEN_TPU_FLASH_INTERPRET=1 (as tests/test_pallas_conv.py
runs it), the same weights carried by the bridge.  Routing: the mode and
the (H, out_channels) table of ``auto`` are the JAX package's.

Tolerances, fp32 on both sides (JAX with "highest" matmul precision): the
conv's outputs are O(1) sums over 9 * C products taken in another order,
atol 2e-5 as tests/test_pallas_conv.py; a ResBlock or a UNet call chains
convs, norms and (in the UNet) attention: atol 1e-4, as
tests/test_torch_modules.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gligen_tpu.models import unet as ju
from gligen_tpu.ops import pallas_conv as jpc

from gligen_tpu_torch.models import unet as tu
from gligen_tpu_torch.ops import fused_conv as fc

from test_torch_modules import (
    LATENT, UNET, close, grounding_inputs, jax_apply, jax_unet, port, rand, random_params, t,
)

torch.set_num_threads(1)

KERNEL_ATOL = 2e-5


def conv_inputs(seed, b, h, w, c, f):
    rng = np.random.default_rng(seed)
    x = rand(rng, b, h, w, c) * 2.0 + 0.3
    scale, bias = 1.0 + rand(rng, c, scale=0.2), rand(rng, c, scale=0.1)
    wk = rand(rng, 3, 3, c, f, scale=(9 * c) ** -0.5)  # HWIO, as the JAX kernel takes it
    wb = rand(rng, f, scale=0.1)
    res = rand(rng, b, h, w, f)
    return x, scale, bias, wk, wb, res


def oihw(wk):
    return t(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))


@pytest.fixture
def fused_conv_env(monkeypatch):
    """The JAX package's fused conv on the CPU: Pallas in interpret mode."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_CONV", "1")
    monkeypatch.setenv("GLIGEN_TPU_FLASH_INTERPRET", "1")


# ---------------------------------------------------------------- kernel

@pytest.mark.parametrize(
    "shape,residual",
    [((2, 8, 8, 64, 96), False),   # C != F
     ((2, 8, 8, 64, 64), True),    # the out_layers chain: + residual
     ((1, 6, 8, 32, 64), True),    # H not a multiple of 8, C != F, residual
     ((2, 4, 16, 32, 32), False)],  # H != W, one channel per group
)
def test_gn_silu_conv3x3_plain_matches_pallas(shape, residual):
    b, h, w, c, f = shape
    x, s, sb, wk, wb, res = conv_inputs(sum(shape), b, h, w, c, f)
    res = res if residual else None
    want = jpc.gn_silu_conv3x3(
        *(jnp.asarray(a) for a in (x, s, sb, wk, wb)),
        residual=None if res is None else jnp.asarray(res), interpret=True,
    )
    got = fc.gn_silu_conv3x3_plain(t(x), t(s), t(sb), oihw(wk), t(wb),
                                   None if res is None else t(res))
    assert tuple(got.shape) == (b, h, w, f)
    close(got, want, atol=KERNEL_ATOL)


def test_ref_chain_matches_jax():
    """The plain chain alone, from the same (a, v): the padding comes after
    the activation, so a tap outside the image adds 0, not silu(v)."""
    x, s, sb, wk, wb, res = conv_inputs(3, 2, 4, 8, 32, 40)
    a, v = jpc.gn_affine(*(jnp.asarray(arr) for arr in (x, s, sb)))
    want = jpc._ref_chain(jnp.asarray(x), a, v, jnp.asarray(wk), jnp.asarray(wb),
                          jnp.asarray(res), "silu")
    got = fc._ref_chain(t(x), t(a), t(v), oihw(wk), t(wb), t(res))
    close(got, want, atol=KERNEL_ATOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, s, sb, wk, wb, res = (t(a) for a in conv_inputs(4, 1, 4, 8, 32, 32))
    w = wk.permute(3, 2, 0, 1)
    before = fc.gn_silu_conv3x3.launches, fc.gn_affine.launches
    assert torch.equal(fc.gn_silu_conv3x3(x, s, sb, w, wb, residual=res),
                       fc.gn_silu_conv3x3_plain(x, s, sb, w, wb, residual=res))
    assert (fc.gn_silu_conv3x3.launches, fc.gn_affine.launches) == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fc.gn_silu_conv3x3(x.to("meta"), s, sb, w, wb)


@pytest.mark.parametrize("source,headers", [
    ("fused_conv", ["common.cuh", "gemm_sm90.cuh", "gemm_tf32.cuh", "hopper.cuh", "wgmma.cuh"]),
    ("fused_conv_sweep", ["fused_conv.cu", "common.cuh", "gemm_sm90.cuh", "gemm_tf32.cuh",
                          "hopper.cuh", "wgmma.cuh"]),
    ("fused_proj", ["common.cuh", "gemm_sm90.cuh", "gemm_tf32.cuh", "hopper.cuh", "wgmma.cuh"]),
])
def test_library_hash_covers_the_shared_headers(monkeypatch, tmp_path, source, headers):
    """The conv and the projections include common.cuh, the Hopper core
    gemm_sm90.cuh and the fp32 routes' 3xTF32 core gemm_tf32.cuh, which
    include hopper.cuh and wgmma.cuh (the conv's sweep library includes the
    conv's source): a change to any of them gives the source another
    library path, so a stale library is never reused."""
    from gligen_tpu_torch.ops import cuda_build

    files = cuda_build.source_files(source)
    assert [f.name for f in files] == [f"{source}.cu", *headers]
    for f in files:
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    paths = {cuda_build.library_path(source)}
    for header in headers:
        with open(tmp_path / header, "a") as fh:
            fh.write("\n// changed\n")
        paths.add(cuda_build.library_path(source))
    assert len(paths) == 1 + len(headers)


# ---------------------------------------------------- the kernel's plan

def _c_configs(source):
    """The (BM, BN, stages) a library holds: csrc/fused_conv.cu's
    CONV_CONFIGS X-macro list (the sweep library's under FUSED_CONV_SWEEP)."""
    import re

    from gligen_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / "fused_conv.cu").read_text()
    serving, sweep = re.findall(r"#define CONV_CONFIGS\(X\)((?:.*\\\n)*.*)", text)
    lists = {"fused_conv": serving, "fused_conv_sweep": sweep}
    return {tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", lists[source])}


def test_tile_tables_are_the_libraries_lists():
    assert {tiles for _, tiles, _ in fc.CONV_TILES} == _c_configs("fused_conv")
    assert set(fc.SWEEP_CONV_TILES) == _c_configs("fused_conv_sweep")


def _unet_conv_shapes():
    """(B, H, W, C, F) of every ResBlock conv at 512^2 and 1024^2 (4 UNet
    rows), from chip_smoke.conv_cases on a storage-free UNet."""
    import chip_smoke

    with torch.device("meta"):
        unet = tu.UNetModel()
    return [(b, h, h, cin, cout) for latent in (64, 128)
            for _, b, h, cin, cout, _ in chip_smoke.conv_cases(unet, 2, latent)]


RAGGED = [(2, 12, 12, 64, 96), (1, 5, 7, 32, 40), (4, 8, 8, 2560, 1280), (1, 1, 300, 32, 40)]


@pytest.mark.parametrize("shape", _unet_conv_shapes() + RAGGED)
def test_every_conv_shape_has_a_plan_the_library_takes(shape):
    """Every ResBlock conv at 512^2 and 1024^2 and the card tests' ragged
    shapes: a configuration of the serving library whose shared memory
    fits the H100's 232,448 bytes a block, a split of at most the channel
    slices; a shape whose tiles leave SMs idle (8^2: 16 tiles) gets enough
    blocks to cover the card in one wave: 128 on the 132 SMs, since a
    ninth range would start a second wave of 12."""
    b, h, w, c, f = shape
    bm, bn, stages, split = fc.conv_plan(b, h, w, c, f)
    assert (bm, bn, stages) in _c_configs("fused_conv")
    assert fc.conv_smem((bm, bn, stages), w) <= 232448
    assert 1 <= split <= -(-c // 64)
    blocks = -(-(b * h * w) // bm) * -(-f // bn)
    if h == 8 and c >= 1280:
        assert blocks < fc.SMS and 0.95 * fc.SMS <= blocks * split <= fc.SMS


def test_halo_takes_the_smaller_form():
    """One window of BM + 2W + 2 rows, or three of BM + 2 when W is wider
    than BM + 2; the largest buffer is 3 (BM + 2) rows at any W."""
    assert fc.halo_rows(128, 64) == 258
    assert fc.halo_rows(128, 130) == 390 == fc.halo_rows(128, 10**6)
    assert fc.halo_rows(64, 66) == 198 and fc.halo_rows(64, 67) == 198


def conv_model(x, a, v, w, wb, res, bm, split):
    """csrc/fused_conv.cu's decomposition in torch: per row block of bm
    output pixels and per 64-channel slice, the activated halo (the
    pixels shifted by -W-1 .. W+1 in (b, y, x) order, as one window or as
    three, each through its own sample's a and v, rounded to x's dtype once,
    0 past C), then nine products of shifted halo rows -- a row of zeros
    where the neighbour lies outside the image, so the padding comes after
    the activation -- with the (F, 64) weight tile at column tap * C + 64 *
    slice of the (F, 9C) weight (zero past 9C, as TMA reads it); the
    slices cut into ``split`` ranges whose partial products are summed in
    order 0, 1, ..., then + bias (+ residual), one cast."""
    b, h, wd, c = x.shape
    f = w.shape[0]
    m, hw, slices = b * h * wd, h * wd, -(-c // 64)
    xf = x.reshape(m, c).float()
    wk = torch.nn.functional.pad(w.to(x.dtype).float().permute(0, 2, 3, 1).reshape(f, 9 * c),
                                 (0, 64))
    rows = fc.halo_rows(bm, wd)
    contiguous = bm + 2 * wd + 2 <= 3 * (bm + 2)
    partials = []
    for sp in range(split):
        part = torch.zeros(m, f)
        for m0 in range(0, m, bm):
            j = torch.arange(rows)
            src = (m0 - wd - 1 + j if contiguous
                   else m0 + (j // (bm + 2) - 1) * wd - 1 + j % (bm + 2))
            rel = torch.arange(bm)
            mm = m0 + rel
            yy, xx = mm % hw // wd, mm % wd
            for cs in range(sp * slices // split, (sp + 1) * slices // split):
                ch = 64 * cs + torch.arange(64)
                okr, okc = (src >= 0) & (src < m), ch < c
                halo = torch.zeros(rows + 1, 64)  # + the row of zeros
                sv, cv = src[okr], ch[okc]
                act = xf[sv][:, cv] * a[sv // hw][:, cv] + v[sv // hw][:, cv]
                halo[:rows][okr.nonzero()[:, 0][:, None], okc.nonzero()[:, 0]] = (
                    torch.nn.functional.silu(act).to(x.dtype).float())
                for tap in range(9):
                    dy, dx = tap // 3 - 1, tap % 3 - 1
                    inside = ((mm < m) & (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0)
                              & (xx + dx < wd))
                    base = 1 + (dy + 1) * wd if contiguous else (dy + 1) * (bm + 2) + 1
                    r = torch.where(inside, base + rel + dx, torch.full_like(rel, rows))
                    k0 = tap * c + 64 * cs
                    prod = halo[r] @ wk[:, k0:k0 + 64].T
                    keep = mm < m
                    part[mm[keep]] += prod[keep]
        partials.append(part)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    out = out + wb.float()
    if res is not None:
        out = out + res.reshape(m, f).float()
    return out.reshape(b, h, wd, f).to(x.dtype)


@pytest.mark.parametrize(
    "shape,residual,bm,split",
    [((2, 8, 8, 32, 40), True, 16, 1),     # one window; a tile spans two image rows
     ((2, 2, 8, 32, 32), True, 32, 1),     # a tile spans two samples
     ((1, 4, 16, 128, 48), True, 8, 2),    # three windows (W > BM + 2), split
     ((1, 4, 8, 96, 40), False, 16, 2),    # a ragged last slice, split
     ((1, 5, 12, 32, 40), False, 16, 1),   # W = 12 (JAX's plain chain)
     ((2, 3, 12, 32, 32), True, 8, 1)],    # W = 12, three windows
)
def test_conv_decomposition_matches_jax(shape, residual, bm, split):
    """The kernel's decomposition against the JAX package: its Pallas
    kernel in interpret mode where it takes the shape (W a multiple of 8),
    else its plain chain from its own (a, v).  Per-(sample, channel)
    statistics of their own and a shift v far from 0, so a halo that held
    silu(v) at the image edge, or another sample's a and v, fails."""
    b, h, w, c, f = shape
    x, s, sb, wk, wb, res = conv_inputs(sum(shape) + bm, b, h, w, c, f)
    x = x * (1.0 + np.arange(c, dtype=np.float32) / c) + np.arange(b, dtype=np.float32)[
        :, None, None, None]
    sb = sb + 2.0  # v far from 0: silu(v) is no zero
    res = res if residual else None
    ja = [jnp.asarray(arr) for arr in (x, s, sb, wk, wb)]
    jres = None if res is None else jnp.asarray(res)
    if w % 8 == 0:
        want = jpc.gn_silu_conv3x3(*ja, residual=jres, interpret=True)
    else:
        a_j, v_j = jpc.gn_affine(*ja[:3])
        want = jpc._ref_chain(ja[0], a_j, v_j, ja[3], ja[4], jres, "silu")
    a, v = fc.gn_affine_plain(t(x), t(s), t(sb))
    got = conv_model(t(x), a, v, oihw(wk), t(wb), None if res is None else t(res), bm, split)
    close(got, want, atol=KERNEL_ATOL)


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("value", [None, "0", "1", "auto", "yes"])
def test_conv_mode_parses_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("GLIGEN_TPU_FUSED_CONV", raising=False)
    else:
        monkeypatch.setenv("GLIGEN_TPU_FUSED_CONV", value)
    monkeypatch.setenv("GLIGEN_TPU_FLASH_INTERPRET", "1")  # JAX's mode off the TPU
    assert tu._fused_conv_mode() == ju._fused_conv_mode()


def test_auto_picks_exactly_the_jax_table():
    """Over every ResBlock map of the 512^2 UNet (H from 64 to 8, out
    channels 320 to 1280), ``auto`` fuses exactly (32, 640), and ``1``
    every map whose W is a multiple of 8."""
    assert tu._FUSED_CONV_WINS == ju._FUSED_CONV_WINS == {(32, 640)}
    maps = [(h, c) for h in (64, 32, 16, 8, 12) for c in (320, 640, 1280)]
    assert {m for m in maps if tu.fuses_conv("auto", m[0], m[0], m[1])} == {(32, 640)}
    assert {m for m in maps if tu.fuses_conv("1", m[0], m[0], m[1])} == {
        m for m in maps if m[0] != 12}
    assert not any(tu.fuses_conv("0", h, h, c) for h, c in maps)


@pytest.mark.parametrize("mode,hw,cin,cout,calls",
                         [("1", 8, 32, 64, 2), ("1", 12, 32, 32, 0), ("auto", 16, 32, 64, 0),
                          ("auto", 32, 640, 640, 2), ("0", 8, 32, 32, 0)])
def test_resblock_routes_to_the_kernel(monkeypatch, mode, hw, cin, cout, calls):
    """Each ResBlock the mode picks runs two fused calls, the rest none."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_CONV", mode)
    seen = []

    def spy(x, *a, **k):
        seen.append(x.shape)
        return torch.zeros(x.shape[:3] + (cout,))

    monkeypatch.setattr(tu, "gn_silu_conv3x3", spy)
    block = tu.ResBlock(cin, cout, 16)
    with torch.no_grad():
        block(torch.randn(1, hw, hw, cin), torch.randn(1, 16))
    assert len(seen) == calls


# ------------------------------------------------------- ResBlock parity

@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 64)])
def test_resblock_matches_jax(fused_conv_env, cin, cout):
    """The fused ResBlock (the skip conv when C != F) against the JAX fused
    ResBlock; its parameter tree, from the fused init, loads strictly."""
    rng = np.random.default_rng(cin + cout)
    x, emb = rand(rng, 2, 8, 8, cin), rand(rng, 2, 128)
    jm = ju.ResBlock(cout)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(emb), seed=cout)
    want = jax_apply(jm, params, jnp.asarray(x), jnp.asarray(emb))
    block = port(tu.ResBlock(cin, cout, 128), params)
    with torch.no_grad():
        got = block(t(x), t(emb))
    close(got, want)


@pytest.fixture(scope="module")
def unet_pair():
    model, params = jax_unet(seed=6)
    return model, params, port(tu.UNetModel(**UNET), params)


@pytest.mark.parametrize("gated", [True, False])
def test_unet_call_matches_jax(monkeypatch, fused_conv_env, unet_pair, gated):
    """The tiny UNet under FUSED_CONV=1 (with the fused projections, as the
    JAX package runs them in interpret mode): its W = 8 ResBlocks take the
    fused conv and its W = 4 ones the module path, on both sides."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_PROJ", "1")
    model, params, unet = unet_pair
    rng = np.random.default_rng(13)
    x, ctx = rand(rng, 2, LATENT, LATENT, 4), rand(rng, 2, 77, UNET["context_dim"])
    ts = np.array([801, 101], np.int32)
    g = grounding_inputs(rng, 2)
    kw = dict(gate_scale=0.6) if gated else dict(gate_scale=0.0, use_sd_conv=True, skip_fusers=True)
    want = jax_apply(model, params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                     {k: jnp.asarray(v) for k, v in g.items()}, **kw)
    with torch.no_grad():
        got = unet(t(x), t(ts), t(ctx), {k: t(v) for k, v in g.items()}, **kw)
    close(got, want)
