"""The flash backward's fp32 route on the tensor cores: what
csrc/flash_bwd.cu's 3xTF32 kernels (``flash_bwd_dq_tf32_kernel``,
``flash_bwd_dkv_tf32_kernel``) compute, modelled in torch, against the plain
version and ``jax.grad`` of the JAX Pallas kernels (interpret mode, fp32);
their operand layouts' index maps; and the route's tile table as the C
dispatch holds it.

The model (``bwd_model``), as the kernels compute it per (batch, head):
dq over key tiles of BK keys, dk/dv over query tiles of BQ queries (the
table's), in order; each tile's scores S (S^T) and dP (dP^T) one chain of
3xTF32 products over the head dim, P = exp2(s scale log2e + bias log2e -
lse) from one fp32 fma and dS = P (dP - delta) in fp32, and each tile's part
of dQ (dS K), dV (P^T dO) and dK (dS^T Q) one chain over the tile's keys
(queries), from zero, added to the gradient in fp32; dQ and dK scaled once
at the end; dbias the fp32 row sums of dS^T.  A chain's products are exact
and their sum rounded to fp32 once (the tensor cores' own order is not
modelled); the split is the kernels': hi = rna(x) (``tests/
test_torch_flash.py:tf32_rna``) and lo = x - hi, which the tensor cores
truncate to TF32 (``tests/test_torch_fp32_tc.py:tc_split``).  The d <= 160
class (its resident pair raw, split in registers) runs over tiles of 16
keys (queries); each of its scores is two chains, hi.hi and hi.lo + lo.hi,
each rounded once and summed in fp32 (``raw_chain``); dq's 64-query blocks
take the even and the odd key tiles in two parts, dQ = the even tiles' sum
+ the odd tiles' (``KEY_PARTS``); the products over a tile run in two
halves of the head dim, which only split the columns.

Tolerance: FP32_REL_TOL = 1e-4 of each gradient's largest magnitude
(chip_smoke.py's), against the plain version and the JAX gradients alike.
q and k are scaled x3 at most: the JAX forward clamps each score's exp2 at
2^80 (its shift-free softmax), so sharper scores leave its reference.  One
TF32 pass misses the limit (``test_one_tf32_pass_misses_the_limit``).
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.ops import pallas_attention as jpa

from gligen_tpu_torch.ops import flash_attention as fa

from test_torch_flash_fp32_tc import chain
from test_torch_fp32_tc import tc_split
from test_torch_modules import rand, t

torch.set_num_threads(1)

FP32_REL_TOL = 1e-4  # chip_smoke.FP32_REL_TOL
REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gligen_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory a block can have on an H100


def heads_first(x, heads):
    """(B, L, H*C) -> (B, H, L, C)."""
    b, n, hc = x.shape
    return x.reshape(b, n, heads, hc // heads).transpose(1, 2)


def probs(s, scale_log2, bias_log2, lse):
    """exp2(fma(s, scale log2e, bias - lse)): one fp32 rounding of the
    exponent, as the kernels' fmaf."""
    return torch.exp2((s.double() * scale_log2.double() + (bias_log2 - lse).double()).float())


# dq's key parts in the d <= 160 class (flash_bwd.cu:launch_tc, DqCfg's KS)
# at its 64-query blocks: part p takes key tiles p, p + 2, ...
KEY_PARTS = 2


def raw_chain(a, b, passes=3):
    """a @ b.T as the d <= 160 class's two chains from zero (raw_chains):
    the hi.hi products and the hi.lo + lo.hi products, each summed exactly
    and rounded to fp32 once, then added in fp32."""
    if passes != 3:
        return chain(a, b, passes)
    (ah, al), (bh, bl) = tc_split(a), tc_split(b)
    big = (ah.double() @ bh.double().transpose(-1, -2)).float()
    small = (ah.double() @ bl.double().transpose(-1, -2)
             + al.double() @ bh.double().transpose(-1, -2)).float()
    return big + small


def bwd_model(q, k, v, heads, do, lse, delta, bias=None, tiles=None, passes=3):
    """The fp32 route's arithmetic on (B, L, H*C) fp32 tensors: (dq, dk,
    dv, dbias or None) as ``flash_attention_bwd_plain`` returns them.
    ``tiles``: (BK keys of dq, BQ queries of dk/dv), default the table's."""
    b, n, hc = q.shape
    m, c = k.shape[1], hc // heads
    assert fa.bwd_kernel_f32(c) == "tc"
    dq_tiles, dkv_tiles = fa.bwd_tiles_f32(c)
    bk, bq = tiles or (dq_tiles[1], dkv_tiles[1])
    raw = c > 80  # the d <= 160 class: its resident pair raw, KEY_PARTS parts of dq
    score = raw_chain if raw else chain
    parts = KEY_PARTS if raw and dq_tiles[0] == 64 else 1
    scale = torch.tensor(c**-0.5, dtype=torch.float32)
    scale_log2 = scale * fa.LOG2E  # p.scale_log2, in fp32
    qh, kh, vh, doh = (heads_first(x, heads) for x in (q, k, v, do))
    bl = torch.zeros((b, m)) if bias is None else bias * fa.LOG2E  # log2 units, in fp32
    bl = bl[:, None, :]  # (B, 1, M)
    lse_r, delta_r = lse[..., None], delta[..., None]  # (B, H, N, 1)

    dqs = [torch.zeros((b, heads, n, c)) for _ in range(parts)]
    for it, k0 in enumerate(range(0, m, bk)):
        s = score(qh, kh[:, :, k0:k0 + bk], passes)
        dp = score(doh, vh[:, :, k0:k0 + bk], passes)
        p = probs(s, scale_log2, bl[..., None, k0:k0 + bk], lse_r)
        ds = p * (dp - delta_r)
        dqs[it % parts] = dqs[it % parts] + chain(ds, kh[:, :, k0:k0 + bk].transpose(-1, -2),
                                                  passes)
    dq = dqs[0] + dqs[1] if parts == 2 else dqs[0]

    dk = torch.zeros((b, heads, m, c))
    dv = torch.zeros((b, heads, m, c))
    db = torch.zeros((b, heads, m))
    for q0 in range(0, n, bq):
        st = score(kh, qh[:, :, q0:q0 + bq], passes)
        dpt = score(vh, doh[:, :, q0:q0 + bq], passes)
        lq = lse[:, :, None, q0:q0 + bq]  # (B, H, 1, BQ)
        pt = probs(st, scale_log2, bl[..., None], lq)  # the bias a constant per key row
        dst = pt * (dpt - delta[:, :, None, q0:q0 + bq])
        db = db + dst.sum(-1)
        dv = dv + chain(pt, doh[:, :, q0:q0 + bq].transpose(-1, -2), passes)
        dk = dk + chain(dst, qh[:, :, q0:q0 + bq].transpose(-1, -2), passes)
    out = [(x * sc).transpose(1, 2).reshape(b, -1, hc)
           for x, sc in ((dq, scale), (dk, scale), (dv, 1.0))]
    return (*out, None if bias is None else db.sum(1))


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def case(seed, b, n, m, h, d, masked, scale=1.0):
    """Seeded fp32 q, k, v, dO and a key mask (its last keys masked in row
    0, its first in row 1), as numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k = rand(rng, b, n, h * d, scale=scale), rand(rng, b, m, h * d, scale=scale)
    v, g = rand(rng, b, m, h * d), rand(rng, b, n, h * d)
    mask = None
    if masked:
        mask = np.ones((b, m), bool)
        mask[0, m - m // 3:] = False
        mask[1 % b, :5] = False
    return q, k, v, g, mask


def model_grads(q, k, v, g, h, mask, **kw):
    """The model's (dq, dk, dv) from the plain forward's LSE and delta."""
    qt, kt, vt, gt = (t(a) for a in (q, k, v, g))
    bias = None if mask is None else fa.key_mask_bias(t(mask))
    out, lse = fa.flash_attention_plain(qt, kt, vt, h, bias=bias)
    delta = fa.attention_delta(out, gt, h)
    args = (qt, kt, vt, h, gt, lse, delta, bias)
    return bwd_model(*args, **kw), fa.flash_attention_bwd_plain(*args)


def jax_grads(q, k, v, g, h, mask):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jpa.flash_attention_packed(q_, k_, v_, h, key_mask=jm, block_q=32, block_kv=32,
                                         interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in
            jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize(
    "d,n,m,scale",
    [(40, 100, 100, 1.0),   # attn1 at ds1's head dim, two dq key tiles, four dk/dv query tiles
     (40, 72, 102, 3.0),    # the fuser's ragged N + 30 keys, sharp scores
     (80, 70, 100, 1.0),    # ds2's head dim, N + 30
     (80, 33, 45, 3.0),
     (36, 40, 70, 1.0),     # a head dim below its class's
     (160, 40, 77, 1.0),    # the d <= 160 class: 16-key tiles, raw Q/dO (K/V), two key parts
     (160, 70, 100, 3.0),   # the same over several ragged tiles each way, sharp scores
     (100, 33, 45, 1.0)],   # a head dim below the d <= 160 class's
)
def test_model_matches_plain_and_jax(d, n, m, scale, masked):
    """dq, dk and dv of the model within FP32_REL_TOL of the plain version
    and of each JAX gradient's largest magnitude; masked keys get exactly no
    gradient."""
    q, k, v, g, mask = case(d + n + m, 2, n, m, 2, d, masked, scale)
    (dq, dk, dv, _), plain = model_grads(q, k, v, g, 2, mask)
    want = jax_grads(q, k, v, g, 2, mask)
    for name, gm, gp, gj in zip("qkv", (dq, dk, dv), plain[:3], want):
        assert gm.dtype == torch.float32 and np.abs(gj).max() > 1e-2, name
        assert rel_err(gm.numpy(), gp.numpy()) <= FP32_REL_TOL, (name, "plain")
        assert rel_err(gm.numpy(), gj) <= FP32_REL_TOL, (name, rel_err(gm.numpy(), gj))
    if masked:
        assert float(dk[0, m - m // 3:].abs().max()) == 0.0
        assert float(dv[1, :5].abs().max()) == 0.0


@pytest.mark.parametrize("d", [40, 80, 160])
def test_model_bias_gradient_matches_jax(d):
    """dbias (the dk/dv kernel's per-head row sums of dS^T, summed over
    heads) of the model against the JAX bias gradient of the (B*H, N, D)
    form with a random bias row, ragged keys, with the other gradients."""
    rng = np.random.default_rng(d + 1)
    bh, n, m = 3, 40, 70
    q, k, v = rand(rng, bh, n, d), rand(rng, bh, m, d), rand(rng, bh, m, d)
    bias = rand(rng, bh, 1, m, scale=0.5)
    g = rand(rng, bh, n, d)

    def loss(q_, k_, v_, b_):
        out = jpa.flash_attention(q_, k_, v_, bias=b_, block_q=32, block_kv=32, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    qt, kt, vt, gt = (t(a) for a in (q, k, v, g))
    bt = t(bias).reshape(bh, m)
    out, lse = fa.flash_attention_plain(qt, kt, vt, 1, bias=bt)
    got = bwd_model(qt, kt, vt, 1, gt, lse, fa.attention_delta(out, gt, 1), bt)
    for name, gm, gj in zip(("dq", "dk", "dv", "dbias"), got, want):
        gj = np.asarray(gj).reshape(gm.shape)
        assert np.abs(gj).max() > 1e-2, name
        assert rel_err(gm.numpy(), gj) <= FP32_REL_TOL, (name, rel_err(gm.numpy(), gj))


def test_one_tf32_pass_misses_the_limit():
    """At ds1's head dim with q and k x3, one TF32 pass misses FP32_REL_TOL
    on a gradient where the model's 3xTF32 meets it: the limit tells fp32
    arithmetic from TF32."""
    q, k, v, g, _ = case(11, 2, 64, 94, 2, 40, False, scale=3.0)
    (dq3, dk3, dv3, _), plain = model_grads(q, k, v, g, 2, None)
    (dq1, dk1, dv1, _), _ = model_grads(q, k, v, g, 2, None, passes=1)
    errs3 = [rel_err(a.numpy(), w.numpy()) for a, w in zip((dq3, dk3, dv3), plain)]
    errs1 = [rel_err(a.numpy(), w.numpy()) for a, w in zip((dq1, dk1, dv1), plain)]
    assert max(errs3) <= FP32_REL_TOL, errs3
    assert max(errs1) > FP32_REL_TOL, errs1


def test_model_does_not_hang_on_its_tiles():
    """The model's gradients at the sweep's other tiles agree with the
    table's to the tolerance: the tiles only regroup the sums."""
    q, k, v, g, mask = case(13, 2, 70, 100, 2, 40, True)
    (a, _) = model_grads(q, k, v, g, 2, mask, tiles=(32, 64))
    (b, _) = model_grads(q, k, v, g, 2, mask, tiles=(64, 32))
    for x, y in zip(a[:3], b[:3]):
        assert rel_err(x.numpy(), y.numpy()) <= FP32_REL_TOL


# ---------------------------------------------------------------- layouts

def quartet(d):
    """flash_bwd.cu:f32::Quartet<D>: (atoms, atom(h, c), col(h, c))."""
    whole, tail = d // 32, d % 32
    slots = 32 // tail if tail else 1
    atoms = 4 * whole + ((4 + slots - 1) // slots if tail else 0)
    atom = lambda h, c: h * whole + c // 32 if c < 32 * whole else 4 * whole + h // slots
    col = lambda h, c: c % 32 if c < 32 * whole else (h % slots) * tail + c - 32 * whole
    return atoms, atom, col


@pytest.mark.parametrize("d,atoms", [(40, 5), (80, 10), (64, 8), (48, 6)])
def test_quartet_columns_are_distinct_and_k_steps_whole(d, atoms):
    """Every column of the four halves of a quartet has its own place in a
    32-column atom (the tail atoms shared by several halves), each 8-column
    k-step lies within one atom at a 32-byte offset (a k-step's descriptor
    start), and no atom holds a column past D: 5 atoms at d = 40, not 8."""
    n_atoms, atom, col = quartet(d)
    assert n_atoms == atoms
    seen = {(atom(h, c), col(h, c)) for h in range(4) for c in range(d)}
    assert len(seen) == 4 * d and all(0 <= a < atoms and 0 <= x < 32 for a, x in seen)
    for h in range(4):
        for kk in range(d // 8):
            places = {(atom(h, c), col(h, c) - (c - 8 * kk)) for c in range(8 * kk, 8 * kk + 8)}
            assert len(places) == 1 and col(h, 8 * kk) % 8 == 0
    src = (CSRC / "flash_bwd.cu").read_text()
    assert "return c < 32 * kWhole ? h * kWhole + c / 32 : 4 * kWhole + h / kSlots;" in \
        src.replace("hf", "h")
    assert "return c < 32 * kWhole ? c % 32 : (h % kSlots) * kTail + c - 32 * kWhole;" in \
        src.replace("hf", "h")


def test_fragment_and_transposed_key_orders_agree():
    """The A fragment a thread (g, t) hands an RS product for an 8-key
    step (flash_bwd.cu:f32::frags: k = t from accumulator register 4j, the
    column 2t; k = t + 4 from 4j + 1, the column 2t + 1; rows g + 8 from 4j
    + 2 and 4j + 3) and the word of a transposed row that Trans::store8
    (hopper.cuh:store_vt8) writes each key to name the same key at every
    k: dS K, P^T dO and dS^T Q sum every key (query) once with its own
    row."""
    def store_word(key):  # Trans::store8: word of a 32-key row
        kk = key % 8
        return (key % 32) // 8 * 8 + (kk & 1) * 4 + kk // 2

    def frag_column(reg, t_):  # the accumulator column of A register `reg` of thread t
        return 2 * t_ + (reg >= 2)

    for step in range(4):
        at_word = {store_word(8 * step + kk) - 8 * step: kk for kk in range(8)}
        assert sorted(at_word) == list(range(8))
        for t_ in range(4):
            assert at_word[t_] == frag_column(0, t_) and at_word[t_ + 4] == frag_column(2, t_)
    assert "word = (key % KEYS) / 8 * 8 + (kk & 1) * 4 + kk / 2;" in \
        (CSRC / "hopper.cuh").read_text()  # store_vt8, which Trans::store8 calls
    src = (CSRC / "flash_bwd.cu").read_text()
    assert "store_vt8<D, kKeys>(base + 2 * mx * kHalf, base + (2 * mx + 1) * kHalf, key, cg, x);" \
        in src
    body = src[src.index("__device__ __forceinline__ void frags("):]
    order = re.findall(r"split_tc\(x\[4 \* j(?: \+ (\d))?\], fh\[j\]\[(\d)\]", body[:800])
    # registers a[0..3] = accumulator entries 4j, 4j + 2, 4j + 1, 4j + 3
    assert [(int(e or 0), int(r)) for e, r in order] == [(0, 0), (2, 1), (1, 2), (3, 3)]


# ------------------------------------------------------- the d <= 160 class's layouts

def raw_offset(r, c, rows):
    """flash_bwd.cu:f32::Raw<D>::store8: the byte of row r, column c of a
    raw matrix of ``rows`` rows (32-column atoms, 128-byte swizzled)."""
    cg = c // 8
    chunk = 2 * (cg % 4) + (c % 8) // 4
    return (cg // 4) * rows * 128 + r * 128 + ((chunk ^ (r & 7)) << 4) + (c % 4) * 4


@pytest.mark.parametrize("rows", [64, 128])
def test_raw_fragments_are_the_tf32_a_layout(rows):
    """Raw<D>::frag's ldmatrix addresses (lanes 8i .. 8i + 7 give matrix
    i's rows; a lane receives word lane % 4 of row lane / 4 of each matrix)
    read back, at every k-step of every warp's 16 rows, the TF32 A fragment
    of those rows: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the
    step's 8 columns.  Raw<D>::store8 gives each (row, column) a place of
    its own, and the eight rows an ldmatrix matrix reads lie in eight
    distinct 16-byte bank groups (no bank conflict)."""
    d = 160
    where = {raw_offset(r, c, rows): (r, c) for r in range(rows) for c in range(d)}
    assert len(where) == rows * d and max(where) < rows * d * 4
    for row0 in range(0, rows, 16):
        for kk in range(d // 8):
            addr = []
            for lane in range(32):
                row = row0 + 8 * ((lane // 8) & 1) + lane % 8
                addr.append((kk // 4) * rows * 128 + row * 128
                            + (((2 * (kk % 4) + lane // 16) ^ (row & 7)) << 4))
            for lane in range(32):
                g, t_ = lane // 4, lane % 4
                got = [where[addr[8 * i + g] + 4 * t_] for i in range(4)]
                assert got == [(row0 + g, 8 * kk + t_), (row0 + g + 8, 8 * kk + t_),
                               (row0 + g, 8 * kk + t_ + 4), (row0 + g + 8, 8 * kk + t_ + 4)]
            for i in range(4):
                assert len({addr[8 * i + j] % 128 // 16 for j in range(8)}) == 8
    src = (CSRC / "flash_bwd.cu").read_text()
    assert "(((2 * (cg % 4) + i) ^ (r & 7)) << 4)) = x[i];" in src  # store8
    assert "const int row = row0 + 8 * ((lane / 8) & 1) + lane % 8;" in src  # frag
    assert "(((2 * (kk % 4) + lane / 16) ^ (row & 7)) << 4));" in src


def vt_offset(key, col, keys, d=160):
    """hopper.cuh:store_vt8<D, KEYS>: the byte of (key, head-dim column col)
    in a transposed half: atoms of ``keys`` keys (rows of 4 keys bytes), the
    keys of each 8-key step in the A fragment's order, swizzled by the
    row's bytes (128: chunk ^ (row & 7); 64: chunk ^ ((row >> 1) & 3))."""
    row_bytes, kk, e = 4 * keys, key % 8, col % 8
    word = (key % keys) // 8 * 8 + (kk & 1) * 4 + kk // 2
    base = (key // keys) * d * row_bytes + (col - e) * row_bytes + (word % 4) * 4
    return base + e * row_bytes + (((word // 4) ^ (e if keys == 32 else e // 2)) << 4)


def wgmma_reads(start, n, k, keys):
    """The byte a K-major TF32 descriptor at ``start`` (sw128_desc or
    sw64_desc: rows of 128 or 64 bytes, SBO 8 rows) reads for row n and
    element k of its 8-element k-step: the linear address, its 16-byte chunk
    index XOR-ed with address bits 7.. (3 bits at 128 B, 2 at 64 B)."""
    lin = start + n * 4 * keys + 4 * k
    bits = 3 if keys == 32 else 2
    return lin ^ (((lin >> 7) & ((1 << bits) - 1)) << 4)


@pytest.mark.parametrize("keys", [32, 16])
def test_transposed_atoms_read_back_each_key(keys):
    """The transposed operands (K^T; Q^T and dO^T) as Trans<D, T>::store8
    writes them and as an RS product's B descriptor (Trans::desc: the
    k-step's 32-byte offset in the row, rows n0 .. of a half) reads them:
    at every 8-key step, every row n of both halves of the head dim (n0 =
    0, 80) and every k, the byte read holds the key the A fragment puts at
    k (keys 2t at k = t, 2t + 1 at k = t + 4) and the column n.  Every (key,
    column) has its own place inside the half.  16-key atoms are the d <=
    160 class's tiles (64-byte rows, 64-byte swizzle)."""
    d = 160
    place = {vt_offset(key, c, keys): (key, c) for key in range(keys) for c in range(d)}
    assert len(place) == keys * d and max(place) < keys * d * 4
    steps = keys // 8
    for j in range(steps):
        for n0 in (0, 80):
            start = n0 * 4 * keys + (j % steps) * 32  # Trans::desc, one atom
            for n in range(80):
                for k in range(8):
                    key = 8 * j + (2 * k if k < 4 else 2 * (k - 4) + 1)
                    assert place[wgmma_reads(start, n, k, keys)] == (key, n0 + n)
    src = (CSRC / "flash_bwd.cu").read_text()
    assert ("const uint32_t addr = base + hf * kHalf + (j / steps) * D * kRow + n0 * kRow + "
            "(j % steps) * 32;") in src
    assert "return kKeys == 32 ? sw128_desc(addr, 16, 1024) : sw64_desc(addr, 16, 512);" in src
    hopper = (CSRC / "hopper.cuh").read_text()
    assert "(((word / 4) ^ (KEYS == 32 ? e : e / 2)) << 4);" in hopper
    assert "((uint64_t)(sbo >> 4) << 32) | (2ull << 62);" in hopper  # sw64_desc's mode


@pytest.mark.parametrize("t,warps", [(16, 4), (16, 8), (32, 4), (32, 12)])
def test_share_units_cover_a_tile_once(t, warps):
    """Share<D, T, WARPS>'s units (a lane's row lane % kRows and 8 columns
    from 8 (kLanes (u % kCols) + lane / kRows); rounds of one unit a warp)
    load and store every (row, 8-column group) of a tile of T rows exactly
    once: 32 rows of 8 columns a unit, 16 rows of 16 at T = 16."""
    d = 160
    rows = min(t, 32)
    lanes = 32 // rows
    cols = d // (8 * lanes)
    units = (t // rows) * cols
    rounds = (units + warps - 1) // warps
    seen = []
    for warp in range(warps):
        for r in range(rounds):
            u = warp + warps * r
            if u < units:
                seen += [(rows * (u // cols) + lane % rows, lanes * (u % cols) + lane // rows)
                         for lane in range(32)]
    assert sorted(seen) == [(r, c) for r in range(t) for c in range(d // 8)]
    src = (CSRC / "flash_bwd.cu").read_text()
    assert "const int row = row0 + kRows * (u / kCols) + lane % kRows;" in src
    assert "const int col = 8 * (kLanes * (u % kCols) + lane / kRows);" in src


def test_bench_bwd_variants_edits_apply():
    """Every variant of tools/bench_bwd_variants.py edits text the source
    holds (the tool stops on a missing one), changes it (but ``base``), and
    leaves the d <= 160 class alone in the fp32 sweep lists."""
    from gligen_tpu_torch.tools import bench_bwd_variants as bv

    src = (CSRC / "flash_bwd.cu").read_text()
    base = bv.variant_source([], src)
    for name, edits in bv.VARIANTS.items():
        out = bv.variant_source(edits, src)
        assert (out == base) == (name == "base"), name
        sweep = out[out.index("#else", out.index("#ifndef FLASH_BWD_F32_SWEEP")):]
        assert "#define DQ160_F32(X) X(tc, 64, 16) X(tc, 128, 16)" in sweep
        assert all(f"#define {k}{c}_F32(X)\n" in sweep for k in ("DQ", "DKV") for c in (40, 80))
    with pytest.raises(ValueError, match="edit not in flash_bwd.cu"):
        bv.variant_source([("no such text", "")], src)
    assert set(bv.EXACT) < set(bv.VARIANTS)


# ---------------------------------------------------------------- the table

def f32_lists(sweep: bool):
    """{(class, "DQ"|"DKV"): [(kernel, rows, tile), ...]} of flash_bwd.cu's
    *_F32 X-macro lists, the serving library's or the sweep library's."""
    src = (CSRC / "flash_bwd.cu").read_text()
    part = src[src.index("#ifndef FLASH_BWD_F32_SWEEP"):]
    part = part[:part.index("template <bool DQ>")]
    serving, rest = part.split("#else")
    sweep_part, shared = rest.split("#endif")
    assert "_F32(X)" not in shared
    held = {}
    for kind, top, lists in re.findall(r"#define (DQ|DKV)(\d+)_F32\(X\) (.*)",
                                       sweep_part if sweep else serving):
        held[(int(top), kind)] = [(k, int(r), int(t_)) for k, r, t_ in
                                  re.findall(r"X\((\w+), (\d+), (\d+)\)", lists)]
    return held


def test_c_dispatch_holds_the_table():
    """The serving library's fp32 lists hold exactly BWD_TILES_F32, kernel
    and tiles, per class; the sweep library's every class at
    bench_sweep_attn.BWD_F32_CONFIGS, the table's tiles among them."""
    from gligen_tpu_torch.tools.bench_sweep_attn import BWD_F32_CONFIGS

    assert f32_lists(sweep=False) == {
        (top, kind): [(kernel, *tiles)] for top, kernel, dq, dkv in fa.BWD_TILES_F32
        for kind, tiles in (("DQ", dq), ("DKV", dkv))}
    sweep = f32_lists(sweep=True)
    assert set(sweep) == {(top, kind) for top in BWD_F32_CONFIGS for kind in ("DQ", "DKV")}
    for top, (dq, dkv) in BWD_F32_CONFIGS.items():
        assert sweep[(top, "DQ")] == [("tc", *x) for x in dq]
        assert sweep[(top, "DKV")] == [("tc", *x) for x in dkv]
        assert fa.bwd_tiles_f32(top)[0] in dq and fa.bwd_tiles_f32(top)[1] in dkv
    assert [kernel for _, kernel, _, _ in fa.BWD_TILES_F32] == ["tc", "tc", "tc"]


def tc_smem(d, res, tile, trans, side, nbuf, raw=False, parts=1, xchg=0):
    """flash_bwd.cu:f32::tc_smem: a resident pair of `res` rows (a quartet,
    or raw: two fp32 matrices); per key part nbuf buffers (a quartet of
    `tile` rows and `trans` transposed matrices' hi and lo), nbuf side
    vectors of `side` floats and 4 barriers; `xchg` bytes of an exchange
    area; 1 KB of alignment slack."""
    atoms = quartet(d)[0]
    resident = 2 * d * res * 4 if raw else atoms * res * 128
    return (resident + parts * (nbuf * (atoms * tile * 128 + trans * 2 * tile * d * 4)
                                + nbuf * side * 4 + 32) + xchg + 1024)


def smem_of(top, kind, rows, tile, nbuf):
    """A configuration's shared memory as launch_tc builds it: the d <= 160
    class raw, its 64-query dq blocks in two key parts (a buffer each), its
    split dk/dv slabs with the P^T exchange (two tiles of 128 x tile / 2
    floats a slab, and a barrier)."""
    raw = top > 80
    if kind == "dq":
        return tc_smem(top, rows, tile, 1, tile, nbuf, raw, 2 if raw and rows == 64 else 1)
    xchg = (rows // 64) * (2 * 128 * (tile // 2) * 4 + 8) if raw else 0
    return tc_smem(top, rows, tile, 2, 2 * tile, nbuf, raw, 1, xchg)


def configs():
    """(class, kind, rows, tile) of every 3xTF32 configuration, the table's
    and the sweep's."""
    from gligen_tpu_torch.tools.bench_sweep_attn import BWD_F32_CONFIGS

    out = [(top, kind, *tiles) for top, kernel, dq, dkv in fa.BWD_TILES_F32 if kernel == "tc"
           for kind, tiles in (("dq", dq), ("dkv", dkv))]
    out += [(top, kind, *x) for top, (dq, dkv) in BWD_F32_CONFIGS.items()
            for kind, xs in (("dq", dq), ("dkv", dkv)) for x in xs]
    return out


def test_every_configuration_fits_the_card():
    """Each 3xTF32 configuration, the table's and the sweep's, fits 227 KB
    of shared memory with one buffer (a part) at least (launch_tc takes two
    where they fit), at most 3 warpgroups (key parts and split slabs
    counted), and wgmma widths csrc/wgmma.cuh holds: the SS products' N = the tile
    (WgmmaSsTf32), the RS products' N = the class's head dim (WgmmaRsTf32);
    in the d <= 160 class every product is RS, over the head dim at N = the
    tile and over the tile in halves of N = 80."""
    sys.path.insert(0, str(CSRC))
    try:
        import gen_wgmma
    finally:
        sys.path.pop(0)
    src = (CSRC / "flash_bwd.cu").read_text()
    assert "static_assert(kSmem == tc_smem(D, BQ, BK, 1, BK, NBUF, kRaw, KS)" in src
    assert "static_assert(kSmem == tc_smem(D, BK, BQ, 2, 2 * BQ, NBUF, kRaw, 1, kXBytes)" in src
    for top, kind, rows, tile in configs():
        smem = smem_of(top, kind, rows, tile, 1)
        assert smem <= SMEM_LIMIT, (top, kind, rows, tile, smem)
        split = 2 if kind == "dkv" and top > 40 else 1
        parts = 2 if kind == "dq" and top > 80 and rows == 64 else 1
        assert rows % 64 == 0 and (rows // 64) * split * parts <= 3
        if top > 80:
            assert tile == 16 and tile in gen_wgmma.RS_TF32_WIDTHS
            assert top // 2 in gen_wgmma.RS_TF32_WIDTHS
        else:
            assert tile in (32, 64) and tile in gen_wgmma.SS_TF32_WIDTHS
            assert top in gen_wgmma.RS_TF32_WIDTHS


def test_table_takes_two_buffers_where_they_fit():
    """The serving table's configurations, with their buffer counts as
    launch_tc picks them: d <= 40's double-buffered; at d <= 80 dq's 128
    resident queries (160 KB) and dk/dv's four transposed halves of 32
    queries (40 KB) leave room for one; at d <= 160 the raw pair (80 KB)
    leaves room for one buffer in each of dq's two key parts (60 KB each)
    and one of dk/dv's (80 KB)."""
    nbufs = {}
    for top, kernel, dq, dkv in fa.BWD_TILES_F32:
        assert kernel == "tc"
        for kind, (rows, tile) in (("dq", dq), ("dkv", dkv)):
            nbufs[(top, kind)] = 2 if smem_of(top, kind, rows, tile, 2) <= SMEM_LIMIT else 1
    assert nbufs == {(40, "dq"): 2, (40, "dkv"): 2, (80, "dq"): 1, (80, "dkv"): 1,
                     (160, "dq"): 1, (160, "dkv"): 1}
    assert smem_of(160, "dq", 64, 16, 1) == 206016 and smem_of(160, "dkv", 64, 16, 1) == 173224
    src = (CSRC / "flash_bwd.cu").read_text()
    assert "constexpr int ks = raw && R == 64 ? 2 : 1;" in src
    assert "static constexpr int kXBytes = kShareP ? NW * (kXPBytes + 8) : 0;" in src
    assert "static constexpr int kXPBytes = 2 * 128 * (BQ / 2) * 4;" in src


def test_the_training_sites_take_the_new_kernels():
    """Every fp32 backward shape of the train step (chip_smoke.bwd_cases_f32)
    runs the 3xTF32 kernels, d = 160 (ds4 and the middle block) too."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    kinds = {d: fa.bwd_kernel_f32(d) for *_, d, _, _ in chip_smoke.bwd_cases_f32(4)}
    assert kinds == {40: "tc", 80: "tc", 160: "tc"}
    assert [fa.bwd_kernel_f32(d) for d in (4, 40, 44, 80, 84, 160)] == ["tc"] * 6
    with pytest.raises(ValueError, match="above 160"):
        fa.bwd_kernel_f32(164)


def test_wrappers_count_launches_by_kernel(monkeypatch):
    """Each backward wrapper counts an fp32 launch under the kernel the
    table names for its head dim, and a bf16 launch under none."""
    calls = []

    def fake_launch(library, kind, q, *args, **kw):
        calls.append(kind)
        out = torch.zeros_like(q)
        return (out, "fp32" if q.dtype == torch.float32 else "tma") if kind == "dq" else \
            ((out, out, None), "fp32" if q.dtype == torch.float32 else "tma")

    monkeypatch.setattr(fa, "launch_bwd", fake_launch)
    monkeypatch.setattr(fa, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(fa, "_check_bwd_inputs", lambda *a: None)
    for wrapper in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        before = dict(wrapper.fp32_kernels)
        for d in (40, 80, 160):
            q = torch.zeros((1, 4, 2 * d))
            wrapper(q, q, q, 2, q, None, None)
        wrapper(q.bfloat16(), q.bfloat16(), q.bfloat16(), 2, q.bfloat16(), None, None)
        assert wrapper.fp32_kernels == {"tc": before["tc"] + 3}


def test_bench_sweep_bwd_fp32_on_the_cpu():
    """The fp32 backward sweep at a tiny size: per level, key count and
    kernel, the table's row then one per configuration of its class, each
    held against the plain version (on the CPU every row is the plain
    version itself, so exactly); the bound is the function's 3xTF32
    products at the TF32 tensor rate."""
    from gligen_tpu_torch.tools import bench_sweep_attn, timing

    b, n, h = 1, 24, 2
    rows = bench_sweep_attn.run_bwd_fp32(batch=b, ms_keys=(24, 31), iters=1, device="cpu",
                                         heads=h, n=n)
    want = [(lvl, m, kind, c) for lvl, (_, d) in bench_sweep_attn.BWD_F32_LEVELS.items()
            for m in (24, 31) for i, kind in enumerate(("dq", "dkv"))
            for c in (None, *bench_sweep_attn.BWD_F32_CONFIGS[d][i])]
    assert [(r["level"], r["m"], r["kind"], r["tiles"]) for r in rows] == want
    for r in rows:
        d = bench_sweep_attn.BWD_F32_LEVELS[r["level"]][1]
        flops = 2 * b * h * n * r["m"] * d * (3 if r["kind"] == "dq" else 4)
        rows_ = 3 * b * n + 2 * b * r["m"] if r["kind"] == "dq" else 2 * b * n + 4 * b * r["m"]
        nbytes = 4 * rows_ * h * d + 8 * b * h * n
        assert (r["bound_ms"], r["bound_by"]) == timing.bound(
            nbytes, 3 * flops, timing.TF32_TENSOR_FLOP_PER_S)
        assert r["ok"] and r["rel_err"] == 0.0
        table = fa.bwd_tiles_f32(d)[0 if r["kind"] == "dq" else 1]
        assert r["table"] == (table if r["tiles"] is None else None)
    out = bench_sweep_attn.bwd_fp32_lines(rows)
    assert len(out) == 1 + len(rows) and "table" in out[1]


def test_perf_probe_names_the_fp32_backward_kernels():
    """perf_probe's categories of the fp32 backward kernels as the
    profiler names them: the 3xTF32 dq and dk/dv kernels, the d <= 160
    class's apart (ds4 and the middle block), and a parent tree's FMA
    kernel's dq (Cfg ending in false) and dk/dv (true) instances."""
    from gligen_tpu_torch.tools import perf_probe

    ns = "(anonymous namespace)::f32::"
    names = {
        f"void {ns}flash_bwd_dq_tf32_kernel<{ns}DqCfg<40, 2, 64, 2, 1> >({ns}Params)":
            "flash_bwd dq fp32 3xTF32 (K4')",
        f"void {ns}flash_bwd_dkv_tf32_kernel<{ns}DkvCfg<80, 1, 2, 32, 1> >({ns}Params)":
            "flash_bwd dk/dv fp32 3xTF32 (K4')",
        f"void {ns}flash_bwd_dq_tf32_kernel<{ns}DqCfg<160, 1, 16, 1, 2> >({ns}Params)":
            "flash_bwd dq fp32 3xTF32 d160 (K4')",
        f"void {ns}flash_bwd_dkv_tf32_kernel<{ns}DkvCfg<160, 1, 2, 16, 1> >({ns}Params)":
            "flash_bwd dk/dv fp32 3xTF32 d160 (K4')",
        f"void {ns}flash_bwd_f32_kernel<{ns}Cfg<160, 64, 32, false> >({ns}Params)":
            "flash_bwd dq fp32 FMA (K4')",
        f"void {ns}flash_bwd_f32_kernel<{ns}Cfg<160, 64, 32, true> >({ns}Params)":
            "flash_bwd dk/dv fp32 FMA (K4')",
    }
    for name, cat in names.items():
        assert perf_probe.category(name) == cat, name
