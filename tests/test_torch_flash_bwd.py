"""The flash-attention backward of gligen_tpu_torch against gligen_tpu's.

The port's autograd Function (``FlashAttention``), which runs its plain
backward (``flash_attention_bwd_plain``) for CPU tensors, against
``jax.grad`` of the Pallas flash kernels run in interpret mode, as
tests/test_pallas_attention.py runs them: the packed layout
(``flash_attention_packed``) at the training path's head dims 40, 80 and
160, the fuser's ragged N+30 keys and a key mask; and the bias gradient of
the (B*H, N, D) form (``flash_attention``).

Tolerance, fp32 on both sides (JAX with "highest" matmul precision): the
gradients are O(1) sums over at most 94 keys of products of O(1) terms,
taken in another order and from an LSE rounded once more (the Pallas
kernel's online softmax): they agree to a few fp32 ulps, atol 2e-5.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.ops import pallas_attention as jpa

from gligen_tpu_torch.ops import flash_attention as fa

from test_torch_modules import close, rand, t

torch.set_num_threads(1)

ATOL = 2e-5


def port_grads(fn, args, cotangent, wrt):
    leaves = [t(a).requires_grad_(i in wrt) for i, a in enumerate(args)]
    out = fn(*leaves)
    out.backward(t(cotangent))
    return [leaves[i].grad for i in wrt]


@pytest.mark.parametrize(
    "d,n,m,masked",
    [
        (40, 64, 64, False),   # attn1, head dim 40 (ds1)
        (80, 64, 94, False),   # the fuser's N + 30 keys, head dim 80 (ds2)
        (160, 48, 78, True),   # head dim 160 (ds4, mid) with a key mask
        (160, 40, 77, False),  # cross-attention over 77 text tokens
    ],
)
def test_packed_gradients_match_jax(d, n, m, masked):
    rng = np.random.default_rng(d + n + m)
    b, h = 2, 2
    q, k, v = rand(rng, b, n, h * d), rand(rng, b, m, h * d), rand(rng, b, m, h * d)
    g = rand(rng, b, n, h * d)  # a nonzero random cotangent
    mask = None
    if masked:
        mask = np.ones((b, m), bool)
        mask[0, m // 2:] = False
        mask[1, :5] = False
    jm = None if mask is None else jnp.asarray(mask)

    def jax_loss(q_, k_, v_):
        out = jpa.flash_attention_packed(q_, k_, v_, h, key_mask=jm, block_q=32, block_kv=32,
                                         interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tm = None if mask is None else t(mask)
    got = port_grads(lambda *a: fa.flash_attention_packed(*a, h, key_mask=tm), (q, k, v), g,
                     wrt=(0, 1, 2))
    for name, gp, gj in zip("qkv", got, want):
        assert float(np.abs(np.asarray(gj)).max()) > 1e-2, name  # not vacuous
        close(gp, gj, atol=ATOL)
    if masked:  # masked keys get exactly no gradient
        assert float(got[1][0, m // 2:].abs().max()) == 0.0
        assert float(got[2][1, :5].abs().max()) == 0.0


def test_bias_gradient_matches_jax():
    """dbias: the sum of dS over query rows (and heads), against the JAX
    bias gradient of the (B*H, N, D) form, with a ragged key count."""
    rng = np.random.default_rng(5)
    bh, n, m, d = 3, 40, 70, 16
    q, k, v = rand(rng, bh, n, d), rand(rng, bh, m, d), rand(rng, bh, m, d)
    bias = rand(rng, bh, 1, m, scale=0.5)
    g = rand(rng, bh, n, d)

    def jax_loss(q_, k_, v_, b_):
        out = jpa.flash_attention(q_, k_, v_, bias=b_, block_q=32, block_kv=32, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    got = port_grads(lambda *a: fa.flash_attention(*a[:3], bias=a[3]), (q, k, v, bias), g,
                     wrt=(0, 1, 2, 3))
    assert float(np.abs(np.asarray(want[3])).max()) > 1e-2
    for gp, gj in zip(got, want):
        close(gp, gj, atol=ATOL)


def test_only_the_needed_gradients_are_computed(monkeypatch):
    """The backward asks the dq wrapper only when q needs a gradient and
    the dk/dv wrapper only when k, v or the bias does: the cross-attention
    (frozen k/v) runs dq alone, an input that needs none runs neither."""
    rng = np.random.default_rng(6)
    q, k, v, g = (t(rand(rng, 1, 12, 8)) for _ in range(4))
    calls = []
    orig = fa.on_cuda

    def spy(x, op):
        calls.append(op)
        return orig(x, op)

    monkeypatch.setattr(fa, "on_cuda", spy)
    for need in ("q", "kv", "none"):
        calls.clear()
        leaves = [x.clone().requires_grad_(need == "q" if i == 0 else need == "kv")
                  for i, x in enumerate((q, k, v))]
        out = fa.flash_attention_packed(*leaves, 2)
        if need != "none":
            out.backward(g)
        assert [c for c in calls if c.startswith("flash_bwd")] == {
            "q": ["flash_bwd_dq"], "kv": ["flash_bwd_dkv"], "none": []}[need]


def test_plain_backward_matches_autograd_of_the_plain_forward():
    """The plain backward from the saved LSE equals autograd through the
    plain forward, fp32 on both: a few ulps of O(1) values, atol 1e-5."""
    rng = np.random.default_rng(7)
    b, n, m, h, c = 2, 9, 13, 2, 4
    q, k, v, do = (t(rand(rng, *s)) for s in
                   ((b, n, h * c), (b, m, h * c), (b, m, h * c), (b, n, h * c)))
    bias = t(rand(rng, b, m, scale=0.5))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, bias)]
    out, lse = fa.flash_attention_plain(*leaves[:3], h, bias=leaves[3])
    want = torch.autograd.grad(out, leaves, do)
    delta = fa.attention_delta(out.detach(), do, h)
    got = fa.flash_attention_bwd_plain(q, k, v, h, do, lse.detach(), delta, bias)
    for gp, gw in zip(got, want):
        torch.testing.assert_close(gp, gw, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "d,want",
    [(1, ((128, 64, 3), (128, 64, 3))), (40, ((128, 64, 3), (128, 64, 3))),
     (41, ((128, 64, 2), (64, 64, 2))), (80, ((128, 64, 2), (64, 64, 2))),
     (81, ((64, 64, 2), (64, 32, 3))), (160, ((64, 64, 2), (64, 32, 3)))],
)
def test_backward_tile_table(d, want):
    """(dq tiles, dk/dv tiles) by head-dim class, from the backward sweep
    (tools/bench_sweep_attn.py --bwd): dq's (BQ, BK, stages), dk/dv's (BK
    keys, BQ, stages); at d = 160 dk/dv's 64 keys are split over two
    warpgroups (dK and dV)."""
    assert fa.bwd_tiles(d) == want
    assert [top for top, *_ in fa.BWD_TILES] == [40, 80, 160]


@pytest.mark.parametrize("d", [161, 512])
def test_backward_tile_table_stops_at_160(d):
    with pytest.raises(ValueError, match=f"head dim {d} above 160"):
        fa.bwd_tiles(d)


def _c_dispatch(sweep: bool) -> dict:
    """The (rows, tile, stages) lists of csrc/flash_bwd.cu's dispatch, by
    (head-dim class, kernel), with FLASH_BWD_SWEEP defined or not."""
    src = (Path(fa.__file__).parent.parent / "csrc" / "flash_bwd.cu").read_text()
    block = src[src.index("#ifndef FLASH_BWD_SWEEP"):]
    block = block[:block.index("#endif")].split("#else")[int(sweep)]
    held = {}
    for kind, top, lists in re.findall(r"#define (DQ|DKV)(\d+)\(X\) (.*)", block):
        held[(int(top), kind)] = [tuple(map(int, t)) for t in
                                  re.findall(r"X\((\d+), (\d+), (\d+)\)", lists)]
    return held


def test_c_dispatch_holds_the_python_tables():
    """The serving library holds exactly BWD_TILES and the sweep library
    exactly bench_sweep_attn.BWD_CONFIGS, per class and kernel."""
    from gligen_tpu_torch.tools.bench_sweep_attn import BWD_CONFIGS

    assert _c_dispatch(sweep=False) == {
        (top, kind): [tiles] for top, dq, dkv in fa.BWD_TILES
        for kind, tiles in (("DQ", dq), ("DKV", dkv))}
    assert _c_dispatch(sweep=True) == {
        (top, kind): list(configs[i]) for top, configs in BWD_CONFIGS.items()
        for i, kind in enumerate(("DQ", "DKV"))}


def test_backward_route():
    """The backward kernels' route (``bwd_route``, through the forward's
    ``tma_ok``): TMA for contiguous packed inputs and for k/v sliced from
    one fused projection, copies for a strided unaligned view or a head dim
    that is not a multiple of 8."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    q, kv, do = z(2, 64, 320), z(2, 94, 640), z(2, 64, 320)
    assert fa.bwd_route(q, kv[..., :320], kv[..., 320:], do, 8) == "tma"
    assert fa.bwd_route(z(2, 64, 320), z(2, 77, 320), z(2, 77, 320), z(2, 64, 320), 8) == "tma"
    qs = z(2, 64 * 320 + 1)[:, 1:].reshape(2, 64, 320)  # 2 bytes off 16
    assert fa.bwd_route(qs, kv[..., :320], kv[..., 320:], do, 8) == "copy"
    odd = z(2, 2 * 94, 323)[:, 0::2, :320]  # an odd row stride
    assert fa.bwd_route(q, odd, odd, do, 8) == "copy"
    assert fa.bwd_route(z(1, 100, 72), z(1, 90, 72), z(1, 90, 72), z(1, 100, 72), 2) == "copy"


def test_bench_sweep_attn_bwd_on_the_cpu():
    """The backward sweep at a tiny size: per key count, dq's table row and
    configurations, then dk/dv's, each held against the plain backward (on
    the CPU every row is the plain version itself, so exactly); FLOPs and
    the bound from the shapes."""
    from gligen_tpu_torch.tools import bench_sweep_attn, timing

    b, n, h, d = 1, 24, 2, 8
    rows = bench_sweep_attn.run_bwd(batch=b, n=n, dim=d, heads=h, ms_keys=(24, 31), iters=1,
                                    device="cpu")
    dq_cfg, dkv_cfg = bench_sweep_attn.bwd_configs(d)
    assert [(r["m"], r["kind"], r["tiles"]) for r in rows] == [
        (m, kind, c) for m in (24, 31)
        for kind, cfg in (("dq", dq_cfg), ("dkv", dkv_cfg)) for c in (None, *cfg)]
    for r in rows:
        m, n_products = r["m"], 3 if r["kind"] == "dq" else 4
        flops = n_products * 2 * b * h * n * m * d
        rows_read = 3 * b * n + 2 * b * m if r["kind"] == "dq" else 2 * b * n + 4 * b * m
        assert (r["bound_ms"], r["bound_by"]) == timing.bound(2 * rows_read * h * d + 8 * b * h * n,
                                                              flops)
        assert r["ok"] and r["rel_err"] == 0.0 and r["bound_share"] is None and r["sdpa_ms"] > 0
        assert r["table"] == (fa.bwd_tiles(d)[r["kind"] == "dkv"] if r["tiles"] is None else None)
    out = bench_sweep_attn.bwd_lines(rows)
    assert len(out) == 1 + len(rows) and out[1].split()[3] == "table"
