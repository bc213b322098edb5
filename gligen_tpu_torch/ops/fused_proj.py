"""Fused projection kernels: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``gligen_tpu/ops/pallas_matmul.py``.  Three kernels of
``csrc/fused_proj.cu`` wrap every projection of a transformer block:

  * ``ln_matmuls``:      y_i = LN(x) @ W_i        (to_q/to_k/to_v, one LN)
  * ``matmul_residual``: y = x + g * (h @ W + b)  (to_out, FF net_2)
  * ``ln_geglu``:        y = a * gelu(g), [a | g] = LN(x) @ W + b  (FF net_0)

and a fourth mode of the same kernel, ``mm_only`` (K7): y = x @ W alone,
the counterpart of ``tools/bench_proj.py``'s matmul-only Pallas kernel,
which only the projection budget tool (``tools/bench_proj.py`` of this
package) runs.  Forward only, as in the JAX tool, which gives it no
``custom_vjp``.

Numerics are the TPU kernels': fp32 LayerNorm statistics, the normalised
rows cast to the compute dtype before the product, the product in fp32
from the rounded operands, bias and gate in fp32, one final cast.  The
plain versions call the plain LayerNorm (``layer_norm_xla``), never the
dispatching one, so on card tensors they launch no kernel.

Every kernel runs at a tile configuration (BM rows, BN wgmma columns,
ring stages) from a fixed table by shape class (``PROJ_TILES``,
``proj_tiles``); the wrapper passes it to the C entry, and the library is
built at exactly the table's configurations.

The three K2 wrappers also take fp32 x, h and weights (a model served in
fp32, as the JAX kernels compute in ``x.dtype``): each mode's fp32 route
of the same source (``ln_matmuls_f32``, ``matmul_residual_f32``,
``ln_geglu_f32``), counted as route "fp32" beside the bf16 kernel's
"wgmma": fp32 statistics and epilogue, the products as 3xTF32 wgmma
(``csrc/gemm_tf32.cuh``: each operand split into TF32 hi and lo, never
one-pass TF32), one fp32 output, at a tile configuration from its own
table (``PROJ_TILES_F32``) and a split of the k-slices from
``proj_plan_f32``.  Any other dtype raises.

Weights are ``nn.Linear``'s (F, K), not JAX's (K, F).  Each K2 wrapper
casts them to x's dtype at every call (the JAX modules' ``dtype`` semantics),
outside the autograd Function, so the gradient reaches the fp32
parameter through the cast.  It runs the plain version for a CPU tensor
and the kernel for a CUDA tensor; it never falls back from one to the
other.

Gradients: each K2 wrapper's output is differentiable (``launch.
differentiable``).  The backward differentiates the reference chain, as
the JAX custom VJPs do (pallas_matmul.py:109-113, :157-163, :234-238,
:319-326): LayerNorm with fp32 statistics, products in the compute dtype
(``F.linear``, which the JAX package also leaves to plain matmuls), bias
and gate in fp32.  A tensor gate gets its gradient, sum(dout * (h @ W^T +
b)): the only path by which the fusers' ``alpha_attn``/``alpha_dense``
train.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from gligen_tpu_torch.ops.basic import layer_norm_xla, tf32_off
from gligen_tpu_torch.ops.launch import (
    F32, I32, PTR, Kernel, c_entry, check, check_widths, differentiable, kernel_dtype, on_cuda,
    split_k,
)

MAX_WEIGHTS = 3
Gate = Union[None, float, torch.Tensor]
Tiles = Tuple[int, int, int]

# The tile table by shape class: (mode, largest K or None for any, fewest
# rows M, fewest output columns F, (BM, BN, stages)); the first rule a
# shape meets gives its tiles (``proj_tiles``).  BM is 128 (two consumer
# warpgroups) or 64 (one); BN the wgmma width, i.e. the output columns of a
# tile, but for ln_geglu its a and gate halves of BN / 2 each; stages the
# TMA ring's depth.  The LN modes keep the block's BM x K rows resident in
# shared memory, so their K is bounded (BM 128 up to K 320, 64 up to 1280).
# 128-row blocks where the row blocks alone fill the card (M >= 12,288:
# 96 blocks and more).  The host (csrc/fused_proj.cu:launch) splits a row
# block's column tiles over several blocks only where the row blocks alone
# would leave SMs idle, or where a streamed A's K is long enough that each
# tile would read A from memory again.  The rules come from the sweep
# (tools/bench_proj.py --sweep, SWEEP_TILES); the serving library
# (csrc/fused_proj.cu:dispatch) holds exactly these configurations.
PROJ_TILES = (
    ("ln_matmuls", 320, 12288, 0, (128, 160, 4)),
    ("ln_matmuls", 640, 0, 0, (64, 160, 4)),
    ("ln_matmuls", 1280, 0, 0, (64, 128, 3)),
    ("matmul_residual", None, 12288, 0, (128, 160, 5)),
    ("matmul_residual", None, 0, 0, (64, 160, 4)),
    ("ln_geglu", 1280, 0, 0, (64, 128, 3)),
    ("mm_only", None, 12288, 1024, (128, 256, 3)),
    ("mm_only", None, 12288, 0, (128, 160, 5)),
    ("mm_only", None, 0, 0, (64, 160, 4)),
)
LN_MODES = ("ln_matmuls", "ln_geglu")
MAX_BLOCK_SMEM = 232448  # a block's dynamic shared memory on the H100 (227 KB)


def proj_tiles(mode: str, m: int, k: int, f: int) -> Tiles:
    """(BM, BN, stages) of ``mode`` (a key of ``KERNELS``) for M rows, input
    width K and output width F (ln_geglu: F = half of W's rows).  Raises
    for a shape no class takes."""
    for rule_mode, top, fewest_m, fewest_f, tiles in PROJ_TILES:
        if rule_mode == mode and (top is None or k <= top) and m >= fewest_m and f >= fewest_f:
            return tiles
    raise ValueError(f"{mode}: no tile class for M {m}, K {k}, F {f}"
                     + (" (the LN modes take K up to 1280)" if mode in LN_MODES else ""))


def proj_smem(mode: str, tiles: Tiles, k: int) -> int:
    """Dynamic shared memory of ``mode`` at ``tiles`` and input width K, by
    csrc/gemm_sm90.cuh's arithmetic (Sm90Tile::smem): the ring's stages (W
    tile, + the A tile when A is streamed), a 64-row bf16 staging tile per
    consumer warpgroup, the barriers, the LN modes' panel and 1 KB to
    align the base."""
    bm, bn, stages = tiles
    panel = mode in LN_MODES
    out = bn // 2 if mode == "ln_geglu" else bn
    consumers = bm // 64
    stage = (0 if panel else bm * 128) + bn * 128
    bars = stages * stage + consumers * 64 * out * 2
    panel_offset = -(-(bars + 8 * (2 * stages + 2 + consumers)) // 1024) * 1024
    return panel_offset + (bm * -(-k // 64) * 128 if panel else 0) + 1024


# The fp32 routes' tiles, every mode's (csrc/fused_proj.cu:PROJ_F32_CONFIGS):
# 128 rows (two consumer warpgroups), 80 wgmma columns (ln_geglu: 40 output
# columns and their gates; 80 and 40 divide every UNet width, 320 to 5120),
# 3 ring stages of one 32-column k-slice each.
# A block's A slices stay resident where they fit (``proj_smem_f32``),
# else they stream with W, so any K.
PROJ_TILES_F32 = ((128, 80, 3),)


def proj_smem_f32(tiles: Tiles, k: int, split: int = 1) -> Tuple[int, bool]:
    """(dynamic shared memory, whether A is resident) of the fp32 routes at
    ``tiles``, input width K and ``split`` ranges of its 32-column
    k-slices, by csrc/fused_proj.cu's arithmetic (ProjTf32Tile::smem,
    launch_f32): the stages (W hi and lo, and the A slice when A streams),
    three barriers a stage and two for the panel, the row block's LN
    statistics, the panel (a range's A slices, when they fit in a block's
    227 KB), 1 KB to align the base."""
    bm, bn, stages = tiles
    kslices = -(-k // 32)
    slices = -(-kslices // split)  # the longest range's

    def smem(panel: bool) -> int:
        stage = (0 if panel else bm * 128) + 2 * bn * 128
        panel_at = -(-(stages * stage + 8 * (3 * stages + 2) + 8 * bm) // 1024) * 1024
        return panel_at + (slices * bm * 128 if panel else 0) + 1024

    return (smem(True), True) if smem(True) <= MAX_BLOCK_SMEM else (smem(False), False)


def proj_plan_f32(mode: str, m: int, k: int, f: int, n_w: int = 1) -> Tuple[int, int, int, int]:
    """(BM, BN, stages, split) of ``mode``'s fp32 route for M rows, input
    width K, output width F (ln_geglu: half of W's rows) and ``n_w``
    weights: the table's tiles, and the k-slices (32 columns each) cut into
    ``split`` ranges where that fills the card (``launch.split_k``)."""
    (bm, bn, stages), = PROJ_TILES_F32
    out = bn // 2 if mode == "ln_geglu" else bn
    units = -(-m // bm) * n_w * -(-f // out)
    fw = 2 * f if mode == "ln_geglu" else f
    split = split_k(units, -(-k // 32), 6 * bm * bn * k, 4 * n_w * m * fw)
    return bm, bn, stages, split


def _product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T in real fp32 from operands rounded to a's dtype (no bf16
    cuBLAS reductions, and TF32 off on the card whatever the caller's
    switch): the plain versions' reference product."""
    with tf32_off():
        return a.float() @ w.to(a.dtype).float().T


def ln_matmuls_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    ws: Sequence[torch.Tensor],
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """x: (..., C); scale/bias: (C,); ws: (F_i, C) each.  Returns a tuple
    of (..., F_i) in x's dtype (pallas_matmul.py:_ln_matmuls_ref)."""
    ln = layer_norm_xla(x, scale, bias, eps=eps)
    return tuple(_product(ln, w).to(x.dtype) for w in ws)


def _gate_value(gate: Gate):
    if gate is None:
        return 1.0
    return gate.float() if isinstance(gate, torch.Tensor) else float(gate)


def matmul_residual_plain(
    h: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    x: torch.Tensor,
    gate: Gate = None,
) -> torch.Tensor:
    """h: (..., K); w: (C, K); bias: (C,); x: (..., C); gate: a scalar
    (a 1-element tensor or a number; 1 when absent).  Returns x + gate *
    (h @ w.T + bias) in x's dtype (pallas_matmul.py:_matmul_residual_ref)."""
    y = (_product(h.to(x.dtype), w) + bias.float()) * _gate_value(gate)
    return (x.float() + y).to(x.dtype)


def ln_geglu_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    w: torch.Tensor,
    w_bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x: (..., C); w: (2F, C); w_bias: (2F,).  Returns a * gelu(g) with
    [a | g] = LN(x) @ w.T + w_bias and the exact (erf) GELU, (..., F) in
    x's dtype (pallas_matmul.py:_ln_geglu_ref)."""
    hg = _product(layer_norm_xla(x, scale, bias, eps=eps), w) + w_bias.float()
    a, g = hg.chunk(2, dim=-1)
    return (a * F.gelu(g)).to(x.dtype)


def mm_only_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K); w: (F, K).  Returns x @ w.T, (..., F) in x's dtype: fp32
    products of operands rounded to x's dtype, one final cast
    (tools/bench_proj.py:_mm_kernel, ``dot_general(...,
    preferred_element_type=float32).astype(o_ref.dtype)``)."""
    return _product(x, w).to(x.dtype)


def _ln_matmuls_chain(x, scale, bias, *ws, eps):
    ln = layer_norm_xla(x, scale, bias, eps=eps)
    return tuple(F.linear(ln, w) for w in ws)


def _matmul_residual_chain(h, w, bias, x, gate, gate_value):
    y = (F.linear(h, w).float() + bias) * (gate_value if gate is None else gate)
    return (x.float() + y).to(x.dtype)


def _ln_geglu_chain(x, scale, bias, w, w_bias, eps):
    hg = F.linear(layer_norm_xla(x, scale, bias, eps=eps), w).float() + w_bias
    a, g = hg.chunk(2, dim=-1)
    return (a * F.gelu(g)).to(x.dtype)


class _Proj(Kernel):
    """A mode of csrc/fused_proj.cu.  ``_run`` launches the C entry at the
    table's tiles for the shape (counted, route "wgmma"), its fp32 route
    ``f32_entry`` for fp32 operands at ``proj_plan_f32``'s plan (counted,
    route "fp32"), or the bf16 entry at ``tiles`` in ``library`` (the tile
    sweep's: not counted, since that is no launch of this wrapper's
    kernel)."""

    library, mode = "fused_proj", ""
    ROUTES = ("wgmma", "fp32")
    f32_entry, f32_argtypes = "", ()

    def _run(self, device, c_args, shape, tiles=None, library=None, f32=False, n_w=1) -> None:
        if f32:
            if library is not None:
                raise ValueError(f"{self.mode}: the tile sweep runs the bf16 kernel only")
            m, _, f = shape
            plan = proj_plan_f32(self.mode, *shape, n_w)
            fw = 2 * f if self.mode == "ln_geglu" else f
            part = (None if plan[3] == 1 else
                    torch.empty((plan[3], n_w, m, fw), dtype=torch.float32, device=device))
            self._launch(device, *c_args, None if part is None else part.data_ptr(), *plan,
                         entry=(self.f32_entry, self.f32_argtypes), route="fp32")
            return
        if library is None:
            self._launch(device, *c_args, *proj_tiles(self.mode, *shape), route="wgmma")
            return
        fn = c_entry(library, self.entry, self.argtypes)
        err = fn(*c_args, *tiles, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{library} {self.entry} launch failed at tiles {tiles}: "
                               f"cudaError {err}")


TILE_ARGS = (I32,) * 3  # bm, bn, stages
F32_PLAN_ARGS = (PTR,) + (I32,) * 4  # part, bm, bn, stages, split


class LnMatmuls(_Proj):
    mode, entry, f32_entry = "ln_matmuls", "ln_matmuls_bf16", "ln_matmuls_f32"
    # x, scale, bias, n_w, w0..w2, y0..y2, m, k, f, eps, then bm, bn, stages
    # (fp32: part, bm, bn, stages, split)
    argtypes = (PTR,) * 3 + (I32,) + (PTR,) * 6 + (I32,) * 3 + (F32,) + TILE_ARGS
    f32_argtypes = argtypes[:-3] + F32_PLAN_ARGS

    def __call__(self, x, scale, bias, ws, eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
        """Same contract as ``ln_matmuls_plain``; 1 to 3 weights of one
        shape.  Differentiable."""
        ws = tuple(w.to(x.dtype) for w in ws)
        return differentiable(functools.partial(self._forward, eps=eps),
                              functools.partial(_ln_matmuls_chain, eps=eps),
                              x, scale.float(), bias.float(), *ws)

    def _forward(self, x, scale, bias, *ws, eps, tiles=None, library=None):
        if not on_cuda(x, "ln_matmuls"):
            return ln_matmuls_plain(x, scale, bias, ws, eps)
        if not 1 <= len(ws) <= MAX_WEIGHTS:
            raise ValueError(f"ln_matmuls takes 1 to {MAX_WEIGHTS} weights, got {len(ws)}")
        c = x.shape[-1]
        f = ws[0].shape[0]
        if any(w.shape != (f, c) for w in ws) or scale.shape != (c,) or bias.shape != (c,):
            raise ValueError(f"ln_matmuls: x (..., {c}) needs (F, {c}) weights of one shape "
                             f"and ({c},) norm parameters")
        check_widths("ln_matmuls", C=c, F=f)
        dtype = kernel_dtype("ln_matmuls", x)
        check("ln_matmuls", x.device, x=(x, dtype), scale=(scale, torch.float32),
               bias=(bias, torch.float32), **{f"w{i}": (w, dtype) for i, w in enumerate(ws)})
        outs = tuple(torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device) for _ in ws)
        pad = (None,) * (MAX_WEIGHTS - len(ws))
        m = x.numel() // c
        self._run(x.device, (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), len(ws),
                             *(w.data_ptr() for w in ws), *pad, *(o.data_ptr() for o in outs),
                             *pad, m, c, f, eps), (m, c, f), tiles, library,
                  dtype == torch.float32, len(ws))
        return outs


class MatmulResidual(_Proj):
    mode, entry, f32_entry = "matmul_residual", "matmul_residual_bf16", "matmul_residual_f32"
    # h, w, bias, x, gate, gate_value, y, m, k, f, then bm, bn, stages
    # (fp32: part, bm, bn, stages, split)
    argtypes = (PTR,) * 5 + (F32, PTR) + (I32,) * 3 + TILE_ARGS
    f32_argtypes = argtypes[:-3] + F32_PLAN_ARGS

    def __call__(self, h, w, bias, x, gate: Gate = None) -> torch.Tensor:
        """Same contract as ``matmul_residual_plain``.  A tensor gate is
        read by the kernel on the device (no host synchronisation).
        Differentiable, in the gate too."""
        tensor_gate = gate if isinstance(gate, torch.Tensor) else None
        gate_value = 1.0 if gate is None or tensor_gate is not None else float(gate)
        return differentiable(functools.partial(self._forward, gate_value=gate_value),
                              functools.partial(_matmul_residual_chain, gate_value=gate_value),
                              h, w.to(x.dtype), bias.float(), x, tensor_gate)

    def _forward(self, h, w, bias, x, gate, gate_value, tiles=None, library=None):
        if not on_cuda(x, "matmul_residual"):
            return matmul_residual_plain(h, w, bias, x, gate_value if gate is None else gate)
        c, k = w.shape
        if h.shape[:-1] != x.shape[:-1] or h.shape[-1] != k or x.shape[-1] != c or bias.shape != (c,):
            raise ValueError(f"matmul_residual: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                             f"bias {tuple(bias.shape)} and x {tuple(x.shape)} do not fit")
        check_widths("matmul_residual", K=k, C=c)
        dtype = kernel_dtype("matmul_residual", x)
        check("matmul_residual", x.device, h=(h, dtype), w=(w, dtype),
               bias=(bias, torch.float32), x=(x, dtype))
        gate_ptr = None
        if gate is not None:
            if gate.numel() != 1:
                raise ValueError(f"matmul_residual: gate must hold one value, has {gate.numel()}")
            check("matmul_residual", x.device, gate=(gate, torch.float32))
            gate_ptr = gate.data_ptr()
        out = torch.empty_like(x)
        m = x.numel() // c
        self._run(x.device, (h.data_ptr(), w.data_ptr(), bias.data_ptr(), x.data_ptr(), gate_ptr,
                             gate_value, out.data_ptr(), m, k, c), (m, k, c), tiles, library,
                  dtype == torch.float32)
        return out


class LnGeglu(_Proj):
    mode, entry, f32_entry = "ln_geglu", "ln_geglu_bf16", "ln_geglu_f32"
    # x, scale, bias, w, w_bias, y, m, k, f, eps, then bm, bn, stages
    # (fp32: part, bm, bn, stages, split)
    argtypes = (PTR,) * 6 + (I32,) * 3 + (F32,) + TILE_ARGS
    f32_argtypes = argtypes[:-3] + F32_PLAN_ARGS

    def __call__(self, x, scale, bias, w, w_bias, eps: float = 1e-5) -> torch.Tensor:
        """Same contract as ``ln_geglu_plain``.  Differentiable."""
        return differentiable(functools.partial(self._forward, eps=eps),
                              functools.partial(_ln_geglu_chain, eps=eps),
                              x, scale.float(), bias.float(), w.to(x.dtype), w_bias.float())

    def _forward(self, x, scale, bias, w, w_bias, eps, tiles=None, library=None):
        if not on_cuda(x, "ln_geglu"):
            return ln_geglu_plain(x, scale, bias, w, w_bias, eps)
        c = x.shape[-1]
        f2 = w.shape[0]
        if (w.shape != (f2, c) or f2 % 2 or w_bias.shape != (f2,) or scale.shape != (c,)
                or bias.shape != (c,)):
            raise ValueError(f"ln_geglu: x (..., {c}) needs a (2F, {c}) weight, a (2F,) bias "
                             f"and ({c},) norm parameters; w is {tuple(w.shape)}")
        f = f2 // 2
        check_widths("ln_geglu", C=c, F=f)
        dtype = kernel_dtype("ln_geglu", x)
        check("ln_geglu", x.device, x=(x, dtype), scale=(scale, torch.float32),
               bias=(bias, torch.float32), w=(w, dtype), w_bias=(w_bias, torch.float32))
        out = torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device)
        m = x.numel() // c
        self._run(x.device, (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
                             w_bias.data_ptr(), out.data_ptr(), m, c, f, eps), (m, c, f),
                  tiles, library, dtype == torch.float32)
        return out


class MmOnly(_Proj):
    mode, entry = "mm_only", "matmul_bf16"
    # a, w, y, m, k, f, bm, bn, stages
    argtypes = (PTR,) * 3 + (I32,) * 3 + TILE_ARGS

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Same contract as ``mm_only_plain``; bf16 x and w on the card.
        Forward only: with gradients enabled, an input that requires one
        raises, since the kernel's output could not carry it."""
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise RuntimeError("mm_only is forward only (the JAX tool's kernel has no "
                               "custom_vjp): call it under torch.no_grad()")
        return self._forward(x, w)

    def _forward(self, x, w, tiles=None, library=None):
        if not on_cuda(x, "mm_only"):
            return mm_only_plain(x, w)
        f, k = w.shape
        if x.shape[-1] != k:
            raise ValueError(f"mm_only: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit")
        check_widths("mm_only", K=k, F=f)
        check("mm_only", x.device, x=(x, torch.bfloat16), w=(w, torch.bfloat16))
        out = torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device)
        m = x.numel() // k
        self._run(x.device, (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, f), (m, k, f),
                  tiles, library)
        return out


ln_matmuls = LnMatmuls()
matmul_residual = MatmulResidual()
ln_geglu = LnGeglu()
mm_only = MmOnly()
KERNELS = {"ln_matmuls": ln_matmuls, "matmul_residual": matmul_residual, "ln_geglu": ln_geglu,
           "mm_only": mm_only}


def sweep_call(kind: str, tiles: Tiles, *args, library: str = "fused_proj_sweep"):
    """One forward of ``kind`` on card tensors at ``tiles`` through
    ``library`` (the tile sweep's, csrc/fused_proj_sweep.cu), with the
    wrapper's checks and no launch counted; ``args`` as the wrapper's
    (ln_matmuls: x, scale, bias, ws; matmul_residual: h, w, bias, x, gate;
    ln_geglu: x, scale, bias, w, w_bias; mm_only: x, w).  Forward only."""
    kernel = KERNELS[kind]
    run = dict(tiles=tiles, library=library)
    if kind == "ln_matmuls":
        x, scale, bias, ws = args
        return kernel._forward(x, scale.float(), bias.float(), *(w.to(x.dtype) for w in ws),
                               eps=1e-5, **run)
    if kind == "matmul_residual":
        h, w, bias, x, gate = args
        tensor_gate = gate if isinstance(gate, torch.Tensor) else None
        value = 1.0 if gate is None or tensor_gate is not None else float(gate)
        return kernel._forward(h, w.to(x.dtype), bias.float(), x, tensor_gate, value, **run)
    if kind == "ln_geglu":
        x, scale, bias, w, w_bias = args
        return kernel._forward(x, scale.float(), bias.float(), w.to(x.dtype), w_bias.float(),
                               1e-5, **run)
    return kernel._forward(*args, **run)
