"""The fused projection path of gligen_tpu_torch against gligen_tpu's.

Kernels: each plain version of ops/fused_proj.py against the Pallas kernel
it ports (ops/pallas_matmul.py, run in interpret mode on the CPU) and
against that kernel's own reference chain (``_ref``).  Blocks and UNet
calls: the port's fused path against the JAX fused path
(``GLIGEN_TPU_FUSED_PROJ=1`` with ``GLIGEN_TPU_FLASH_INTERPRET=1``, as
tests/test_fused_proj.py runs it), with the same weights carried by the
bridge.  Below the 64-token floor both sides take the module path.

Tolerances, fp32 on both sides (JAX with "highest" matmul precision):
the kernels' outputs are O(1) sums over at most 256 products taken in
another order, which agree to a few fp32 ulps: atol 2e-5.  A block or a
UNet call chains several products, LayerNorms and softmaxes, and the
Pallas flash kernel's online softmax differs from the port's in order:
atol 1e-4, as in tests/test_torch_modules.py.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gligen_tpu.models import layers as jl
from gligen_tpu.ops import pallas_matmul as pm

from gligen_tpu_torch.models import layers as tl
from gligen_tpu_torch.models import unet as tu
from gligen_tpu_torch.ops import fused_proj as fp
from gligen_tpu_torch.ops import launch

from test_torch_modules import (
    LATENT, UNET, close, grounding_inputs, jax_apply, jax_unet, port, rand, random_params, t,
)

torch.set_num_threads(1)

KERNEL_ATOL = 2e-5


def norm_params(rng, c):
    return 1.0 + rand(rng, c, scale=0.1), rand(rng, c, scale=0.1)


@pytest.fixture
def fused_env(monkeypatch):
    """The JAX package's fused path on the CPU: Pallas in interpret mode."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_PROJ", "1")
    monkeypatch.setenv("GLIGEN_TPU_FLASH_INTERPRET", "1")


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("n_w,n", [(1, 100), (3, 160), (2, 94)])
def test_ln_matmuls_plain_matches_pallas(n_w, n):
    """1, 2 and 3 weights; N not a multiple of the 64-row block."""
    rng = np.random.default_rng(n_w * 100 + n)
    x = rand(rng, 2, n, 96) * 2.0 + 0.3
    s, b = norm_params(rng, 96)
    ws = [rand(rng, 96, 128, scale=96**-0.5) for _ in range(n_w)]
    js = [jnp.asarray(a) for a in (x, s, b)]
    want = pm.ln_matmuls(*js, tuple(jnp.asarray(w) for w in ws), block_n=64, interpret=True)
    ref = pm._ln_matmuls_ref(*js, tuple(jnp.asarray(w) for w in ws), 1e-5)
    got = fp.ln_matmuls_plain(t(x), t(s), t(b), [t(w.T) for w in ws])
    assert len(got) == n_w
    for g, w_, r in zip(got, want, ref):
        assert tuple(g.shape) == (2, n, 128)
        close(g, w_, atol=KERNEL_ATOL)
        close(g, r, atol=KERNEL_ATOL)


@pytest.mark.parametrize("gate", [None, 0.7, "tensor"])
def test_matmul_residual_plain_matches_pallas(gate):
    """No gate (1), a number, and a 0-d fp32 tensor (the sampler's
    gate * tanh(alpha)); 96 rows against a 64-row block."""
    rng = np.random.default_rng(7)
    h, x = rand(rng, 2, 96, 256), rand(rng, 2, 96, 64)
    w, b = rand(rng, 256, 64, scale=256**-0.5), rand(rng, 64, scale=0.1)
    g = 0.43 if gate == "tensor" else gate
    jargs = [jnp.asarray(a) for a in (h, w, b, x)]
    want = pm.matmul_residual(*jargs, gate=g, block_n=64, interpret=True)
    ref = pm._matmul_residual_ref(*jargs, jnp.float32(1.0 if g is None else g))
    tg = torch.tensor(g) if gate == "tensor" else gate
    got = fp.matmul_residual_plain(t(h), t(w.T), t(b), t(x), gate=tg)
    close(got, want, atol=KERNEL_ATOL)
    close(got, ref, atol=KERNEL_ATOL)


@pytest.mark.parametrize("n", [64, 72])
def test_ln_geglu_plain_matches_pallas(n):
    """The Pallas kernel's polynomial erf is within 1.5e-7 of the exact
    erf the port uses, far below the tolerance."""
    rng = np.random.default_rng(n)
    x = rand(rng, 2, n, 96)
    s, b = norm_params(rng, 96)
    w, wb = rand(rng, 96, 256, scale=96**-0.5), rand(rng, 256, scale=0.1)
    jargs = [jnp.asarray(a) for a in (x, s, b, w, wb)]
    want = pm.ln_geglu(*jargs, block_n=32, interpret=True)
    ref = pm._ln_geglu_ref(*jargs, 1e-5)
    got = fp.ln_geglu_plain(t(x), t(s), t(b), t(w.T), t(wb))
    assert tuple(got.shape) == (2, n, 128)
    close(got, want, atol=KERNEL_ATOL)
    close(got, ref, atol=KERNEL_ATOL)


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(3)
    x, h = t(rand(rng, 2, 10, 16)), t(rand(rng, 2, 10, 64))
    s, b = (t(a) for a in norm_params(rng, 16))
    w, w2, wg = t(rand(rng, 24, 16)), t(rand(rng, 16, 64)), t(rand(rng, 128, 16))
    bias, gbias = t(rand(rng, 16)), t(rand(rng, 128))
    before = {name: k.launches for name, k in fp.KERNELS.items()}
    (got,) = fp.ln_matmuls(x, s, b, (w,))
    assert torch.equal(got, fp.ln_matmuls_plain(x, s, b, (w,))[0])
    assert torch.equal(fp.matmul_residual(h, w2, bias, x, gate=0.5),
                       fp.matmul_residual_plain(h, w2, bias, x, gate=0.5))
    assert torch.equal(fp.ln_geglu(x, s, b, wg, gbias), fp.ln_geglu_plain(x, s, b, wg, gbias))
    assert {name: k.launches for name, k in fp.KERNELS.items()} == before


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA card is refused, never
    computed by the plain version."""
    x = torch.empty((2, 8, 16), device="meta")
    w = torch.empty((16, 16), device="meta")
    s = torch.empty((16,), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fp.ln_matmuls(x, s, s, (w,))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fp.matmul_residual(x, w, s, x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fp.ln_geglu(x, s, s, torch.empty((32, 16), device="meta"), torch.empty((32,), device="meta"))


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(dtype=torch.float32), TypeError),  # the kernels take bf16 activations
        (dict(transposed=True), ValueError),     # rows must be contiguous
        (dict(offset=4), ValueError),            # 16-byte aligned starts
        (dict(width=20), ValueError),            # widths are multiples of 8
    ],
)
def test_kernel_input_checks(change, error):
    """What the kernels do not take raises before any launch."""
    c = change.get("width", 16)
    base = torch.zeros(8 * c + 8, dtype=change.get("dtype", torch.bfloat16))
    x = base[change.get("offset", 0):][: 8 * c].view(8, c)
    if change.get("transposed"):
        x = torch.zeros((c, 8), dtype=torch.bfloat16).T
    with pytest.raises(error):
        launch.check_widths("op", C=c)
        launch.check("op", x.device, x=(x, torch.bfloat16))


# ------------------------------------------------------------ the tile table

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def table_triples(mode):
    """The distinct (BM, BN, stages) of ``mode``'s rules, in rule order."""
    out = []
    for rule_mode, *_, tiles in fp.PROJ_TILES:
        if rule_mode == mode and tiles not in out:
            out.append(tiles)
    return out


def smoke_shapes():
    """(mode, M, K, F) of every projection launch of chip_smoke.py's phase 3
    (the 512^2 request's and train step's shapes, K7's tool shapes) and of
    bench_proj.py's K2 sites at its 16 x 4096 rows."""
    shapes = []
    for _, kind, b, n, c, k in chip_smoke.proj_cases(2) + chip_smoke.mm_cases():
        m = b * n
        shapes.append({"ln_matmuls": (kind, m, c, c), "matmul_residual": (kind, m, k, c),
                       "ln_geglu": (kind, m, c, 4 * c), "mm_only": (kind, m, k, c)}[kind])
    m, c = 16 * 4096, 320
    shapes += [("ln_matmuls", m, c, c), ("matmul_residual", m, c, c),
               ("ln_geglu", m, c, 4 * c), ("matmul_residual", m, 4 * c, c)]
    return shapes


def test_every_smoke_shape_has_a_tabled_triple():
    """Every shape phase 3 and the tools launch falls in a class, whose
    triple the serving library holds (the spatial fusers' k/v over 4 x
    (N + 196) and 4 x (N + 64) rows at every level too); the LN modes' K
    stays within their panel's reach."""
    shapes = smoke_shapes()
    assert len(shapes) == 4 * 10 + 5 + 4
    for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        for t in (196, 64):
            assert ("ln_matmuls", 4 * (n + t), c, c) in shapes, (n, t)
    for mode, m, k, f in shapes:
        assert fp.proj_tiles(mode, m, k, f) in table_triples(mode), (mode, m, k, f)
    # the ds1 rows take 128-row blocks, the middle block's 64-row ones
    assert fp.proj_tiles("ln_matmuls", 4 * 4096, 320, 320)[0] == 128
    assert fp.proj_tiles("matmul_residual", 4 * 64, 5120, 1280)[0] == 64


def test_card_tests_cover_every_tile_class():
    """The card tests' shapes (test_torch_fused_proj_cuda.TABLE_SHAPES and
    test_torch_mm_only_cuda's) fall in every rule of the table."""
    from test_torch_fused_proj_cuda import TABLE_SHAPES
    from test_torch_mm_only_cuda import MM_SHAPES

    def rule_of(mode, m, k, f):
        return next(i for i, (rm, top, fm, ff, _) in enumerate(fp.PROJ_TILES)
                    if rm == mode and (top is None or k <= top) and m >= fm and f >= ff)

    hit = {rule_of(*shape) for shape in TABLE_SHAPES}
    hit |= {rule_of("mm_only", rows, k, f) for rows, k, f, _ in MM_SHAPES}
    assert hit == set(range(len(fp.PROJ_TILES)))


@pytest.mark.parametrize("rule", fp.PROJ_TILES, ids=lambda r: f"{r[0]}-{r[4]}")
def test_table_entries_fit_shared_memory_and_wgmma(rule):
    """Each entry, at its largest K (the streamed modes' smem does not grow
    with K), fits a block's 227 KB: panel plus ring plus staging; BN is a
    width gen_wgmma.py writes, a multiple of 8 up to 256, whose output
    columns fill whole staging atoms."""
    sys.path.insert(0, str(REPO / "gligen_tpu_torch" / "csrc"))
    try:
        import gen_wgmma
    finally:
        sys.path.pop(0)
    mode, top, _, _, (bm, bn, stages) = rule
    assert fp.proj_smem(mode, (bm, bn, stages), top or 5120) <= fp.MAX_BLOCK_SMEM
    assert bm in (64, 128) and stages >= 2
    assert bn % 8 == 0 and bn <= 256 and bn in gen_wgmma.SS_WIDTHS
    # the staging tile is whole 32-column atoms of the TMA store's boxes
    assert (bn // 2 if mode == "ln_geglu" else bn) % 32 == 0


def test_proj_smem_follows_the_c_layout():
    """Sm90Tile's layout by hand: ring, a 64-row bf16 staging tile per
    consumer warpgroup, 8 bytes a barrier (two per stage, the panel's two,
    one per consumer warpgroup) rounded up to 1 KB, panel, 1 KB of
    alignment slack."""
    # ln_matmuls 128x160x4, K 320: 4 W tiles of 160 x 128 B; 2 x 64 rows x 320 B
    ring, staging = 4 * 160 * 128, 2 * 64 * 320
    panel_at = -(-(ring + staging + 8 * (10 + 2)) // 1024) * 1024
    assert fp.proj_smem("ln_matmuls", (128, 160, 4), 320) == panel_at + 128 * 5 * 128 + 1024
    # mm_only 64x160x3: the A tile streamed (64 x 128 B a stage), no panel
    ring, staging = 3 * (64 + 160) * 128, 64 * 320
    assert fp.proj_smem("mm_only", (64, 160, 3), 1280) == \
        -(-(ring + staging + 8 * (8 + 1)) // 1024) * 1024 + 1024
    # ln_geglu's staging holds BN / 2 output columns: 128 -> 256 bytes a row
    assert fp.proj_smem("ln_geglu", (128, 256, 3), 320) == \
        -(-(3 * 256 * 128 + 2 * 64 * 256 + 8 * 10) // 1024) * 1024 + 128 * 5 * 128 + 1024


def _c_lists(sweep: bool) -> dict:
    """The (BM, BN, stages) lists of csrc/fused_proj.cu's dispatch, by mode,
    with FUSED_PROJ_SWEEP defined or not."""
    src = (REPO / "gligen_tpu_torch" / "csrc" / "fused_proj.cu").read_text()
    block = src[src.index("#ifndef FUSED_PROJ_SWEEP"):]
    block = block[:block.index("#endif")].split("#else")[int(sweep)]
    names = {"LN_MATMULS": "ln_matmuls", "RESIDUAL": "matmul_residual", "GEGLU": "ln_geglu",
             "MATMUL": "mm_only"}
    return {names[macro]: [tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
            for macro, body in re.findall(r"#define (\w+)\(X\) (.*)", block)}


def test_c_dispatch_holds_the_python_tables():
    """The serving library holds exactly PROJ_TILES' triples and the sweep
    library exactly bench_proj.SWEEP_TILES, per mode: dispatch refuses any
    other triple (cudaErrorInvalidValue)."""
    from gligen_tpu_torch.tools.bench_proj import SWEEP_TILES

    assert _c_lists(sweep=False) == {mode: table_triples(mode) for mode in fp.KERNELS}
    assert _c_lists(sweep=True) == {mode: list(t) for mode, t in SWEEP_TILES.items()}


@pytest.mark.parametrize("mode,m,k,f", [("ln_matmuls", 256, 2560, 320),
                                        ("ln_geglu", 4096, 1288, 640)])
def test_shapes_without_a_class_are_refused(mode, m, k, f):
    """The LN modes keep BM x K resident, so no class takes K > 1280."""
    with pytest.raises(ValueError, match="no tile class"):
        fp.proj_tiles(mode, m, k, f)


def test_ln_modes_refuse_wide_k_before_a_launch(monkeypatch):
    """A CUDA-bound call of an LN mode at K 1288 raises after the input
    checks and before any launch."""
    monkeypatch.setattr(fp, "on_cuda", lambda x, op: True)
    monkeypatch.setattr(fp.LnMatmuls, "_launch", lambda self, *a: pytest.fail("launched"))
    x = torch.zeros((4, 1288), dtype=torch.bfloat16)
    s = torch.ones(1288)
    with pytest.raises(ValueError, match="no tile class"):
        fp.ln_matmuls._forward(x, s, s, torch.zeros((8, 1288), dtype=torch.bfloat16), eps=1e-5)


# ------------------------------------------------------------ block parity

@pytest.mark.parametrize("n", [64, 48])
def test_fuser_matches_jax(fused_env, n):
    """N = 64 is the small-N floor (fused on both sides); N = 48 is below
    it, where both sides take the module path."""
    assert tl._fused_proj_ok(n) == jl._fused_proj_ok(n, True) == (n >= 64)
    rng = np.random.default_rng(n)
    x, objs = rand(rng, 2, n, 32), rand(rng, 2, 5, 20)
    args = (jnp.asarray(x), jnp.asarray(objs))
    jm = jl.GatedSelfAttentionDense(2, 16)
    params = random_params(jm, *args, 1.0, seed=n)
    want = jax_apply(jm, params, *args, 0.7)
    fuser = port(tl.GatedSelfAttentionDense(32, 20, 2, 16), params)
    with torch.no_grad():
        got = fuser(t(x), t(objs), 0.7)
    close(got, want)


@pytest.mark.parametrize("n", [64, 48])
def test_block_matches_jax(fused_env, n):
    rng = np.random.default_rng(n + 1)
    x, ctx, objs = rand(rng, 2, n, 32), rand(rng, 2, 7, 24), rand(rng, 2, 5, 20)
    args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(objs))
    params = random_params(jl.BasicTransformerBlock(2, 16, "gatedSA"), *args, 1.0, seed=n)
    want = jax_apply(jl.BasicTransformerBlock(2, 16, "gatedSA"), params, *args, 0.7)
    block = port(tl.BasicTransformerBlock(32, 24, 20, 2, 16), params)
    with torch.no_grad():
        got = block(t(x), t(ctx), t(objs), 0.7)
    close(got, want)


# -------------------------------------------------------------- UNet calls

@pytest.fixture(scope="module")
def unet_pair():
    model, params = jax_unet(seed=5)
    return model, params, port(tu.UNetModel(**UNET), params)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("gated", [True, False])
def test_unet_call_matches_jax(monkeypatch, unet_pair, fused, gated):
    """A gated call and a fuser-free one (SD first conv) of the tiny UNet,
    whose ds1 blocks have the 64-token floor, in both configurations."""
    monkeypatch.setenv("GLIGEN_TPU_FUSED_PROJ", fused)
    monkeypatch.setenv("GLIGEN_TPU_FLASH_INTERPRET", "1")
    model, params, unet = unet_pair
    rng = np.random.default_rng(11)
    x, ctx = rand(rng, 2, LATENT, LATENT, 4), rand(rng, 2, 77, UNET["context_dim"])
    ts = np.array([901, 301], np.int32)
    g = grounding_inputs(rng, 2)
    kw = dict(gate_scale=0.6) if gated else dict(gate_scale=0.0, use_sd_conv=True, skip_fusers=True)
    want = jax_apply(model, params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                     {k: jnp.asarray(v) for k, v in g.items()}, **kw)
    with torch.no_grad():
        got = unet(t(x), t(ts), t(ctx), {k: t(v) for k, v in g.items()}, **kw)
    close(got, want)


def test_one_state_dict_drives_both_configurations(monkeypatch, unet_pair):
    """The fused and the module path read the same parameters: one state
    dict, both configurations, the same eps (fp32 sums in another order)."""
    _, _, unet = unet_pair
    rng = np.random.default_rng(12)
    x, ctx = t(rand(rng, 2, LATENT, LATENT, 4)), t(rand(rng, 2, 77, UNET["context_dim"]))
    ts = t(np.array([501, 41], np.int32))
    g = {k: t(v) for k, v in grounding_inputs(rng, 2).items()}
    outs = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("GLIGEN_TPU_FUSED_PROJ", fused)
        with torch.no_grad():
            outs[fused] = unet(x, ts, ctx, g, gate_scale=0.8)
    assert float(outs["1"].abs().max()) > 1e-2
    close(outs["1"], outs["0"].numpy())
