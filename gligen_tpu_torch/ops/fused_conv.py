"""Fused GroupNorm -> SiLU -> 3x3 conv (-> + residual): the CUDA kernel's
wrapper and its plain version.

Counterpart of ``gligen_tpu/ops/pallas_conv.py``.  The GroupNorm
statistics come first, folded into the per-(sample, channel) affine a, v
(``gn_affine``, ops/fused_norm.py); then ``csrc/fused_conv.cu`` computes

    xn  = bf16(silu(x * a + v))                  (zero padding after it)
    out = conv3x3_SAME(xn) + bias (+ residual)   (fp32 accumulate, one cast)

as an implicit GEMM in the kernel's own body, as the TPU kernel computes
it in its own.  Layout: x NHWC (B, H, W, C); the conv weight is the port's
Conv2d OIHW (F, C, 3, 3), which the wrapper casts to x's dtype and permutes
to (F, 3, 3, C) at each call (K-contiguous per output channel).

The kernel runs at a tile configuration (BM rows, BN columns, weight-ring
stages) and a split of its 64-channel slices from a fixed table by shape
class (``CONV_TILES``, ``conv_plan``); the wrapper passes them to the C
entry, and the library is built at exactly the table's configurations.

The wrapper runs the plain versions for a CPU tensor and the kernels for a
CUDA tensor; it never falls back from one to the other, and raises on what
the kernel does not take (a dtype other than bf16 or fp32, C or F not
multiples of 8).  fp32 x (a model served in fp32, as pallas_conv.py
computes in ``x.dtype``) takes the fp32 route of the same source,
``gn_silu_conv3x3_f32``: the statistics from ``gn_affine``'s fp32 route,
the activation unrounded, the conv as 3xTF32 wgmma (``csrc/
gemm_tf32.cuh``: each operand split into TF32 hi and lo, never one-pass
TF32), one fp32 output, at its own tiles and split (``CONV_TILES_F32``,
``conv_plan_f32``); counted as route "fp32" beside the bf16 kernel's
"wgmma".  W need not be a multiple of 8: that is the TPU's sublane rule, which
stays in the routing (models/unet.py).

Gradients, as in pallas_conv.py:121-171: the statistics (``gn_affine``)
are differentiable on their own, and the conv's backward differentiates
``_ref_chain`` in (x, a, v, w, wb, residual).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from gligen_tpu_torch.ops.fused_norm import gn_affine, gn_affine_plain
from gligen_tpu_torch.ops.launch import (
    I32, PTR, SMS, Kernel, c_entry, check, check_widths, differentiable, kernel_dtype, on_cuda,
    split_k,
)

Tiles = Tuple[int, int, int]
MAX_BLOCK_SMEM = 232448  # a block's dynamic shared memory on the H100 (227 KB)

# The tile table by shape class: (fewest output pixels M = B*H*W, (BM, BN,
# stages), most split); the first rule a shape meets gives its tiles
# (``conv_tiles``).  BM is 128 (two consumer warpgroups) or 64 (one); BN the
# output columns of a tile, the wgmma width; stages the weight ring's depth.
# Where the row and column tiles alone leave SMs idle (8^2 and 16^2: M =
# 256, 1024 at 4 UNet rows), the channel slices are split into up to "most
# split" ranges, as few as cover the card (``conv_split``; 1 wherever the
# tiles fill it), summed in order by a second kernel.  The sweep
# (perf_probe.py convs --sweep, SWEEP_CONV_TILES) found one configuration
# the fastest, or within 3% of it, at every ResBlock conv of 512^2, so the
# table has one class; the serving library (csrc/fused_conv.cu:
# CONV_CONFIGS) holds exactly its configurations.
CONV_TILES = ((0, (128, 160, 4), 8),)
# The sweep library's (csrc/fused_conv_sweep.cu) configurations.
SWEEP_CONV_TILES = ((128, 128, 4), (128, 160, 3), (128, 160, 5), (64, 128, 4), (64, 160, 4))


def conv_tiles(m: int) -> Tuple[Tiles, int]:
    """((BM, BN, stages), most split) of the first class M output pixels meet."""
    for fewest_m, tiles, most in CONV_TILES:
        if m >= fewest_m:
            return tiles, most
    raise ValueError(f"gn_silu_conv3x3: no tile class for M {m}")


def halo_rows(bm: int, w: int) -> int:
    """Rows of one halo buffer (csrc/fused_conv.cu:halo_rows): the row
    block's pixels shifted by -W-1 .. W+1 as one window, or three windows
    of BM + 2 (one per dy) where W is wide enough that they are fewer."""
    return bm + 2 * w + 2 if bm + 2 * w + 2 <= 3 * (bm + 2) else 3 * (bm + 2)


def conv_smem(tiles: Tiles, w: int) -> int:
    """Dynamic shared memory at ``tiles`` and image width W, by
    csrc/fused_conv.cu's arithmetic (ConvTile::smem): the weight ring, a
    64-row bf16 staging tile per consumer warpgroup, the barriers, a row of
    zeros, two halo buffers and 1 KB to align the base."""
    bm, bn, stages = tiles
    consumers = bm // 64
    bars = stages * bn * 128 + consumers * 64 * bn * 2
    zero = -(-(bars + 8 * (2 * stages + 4 + consumers)) // 128) * 128
    halo = -(-(zero + 128) // 1024) * 1024
    return halo + 2 * halo_rows(bm, w) * 128 + 1024


def conv_split(m: int, c: int, f: int, tiles: Tiles, most: int) -> int:
    """How many ranges the ceil(C / 64) channel slices are cut into: 1 where
    the tiles alone give every SM a block; else, up to ``most``, the fewest
    that minimise waves of blocks over the SMs times each block's share of
    K."""
    bm, bn, _ = tiles
    blocks = -(-m // bm) * -(-f // bn)
    if blocks >= SMS:
        return 1
    splits = range(1, max(1, min(most, -(-c // 64))) + 1)
    return min(splits, key=lambda s: (-(-blocks * s // SMS) / s, s))


def conv_plan(b: int, h: int, w: int, c: int, f: int) -> Tuple[int, int, int, int]:
    """(BM, BN, stages, split) of the conv kernel for x (B, H, W, C) -> F."""
    m = b * h * w
    tiles, most = conv_tiles(m)
    if conv_smem(tiles, w) > MAX_BLOCK_SMEM:
        raise ValueError(f"gn_silu_conv3x3: tiles {tiles} at W {w} need {conv_smem(tiles, w)} "
                         f"bytes of shared memory, more than {MAX_BLOCK_SMEM}")
    return (*tiles, conv_split(m, c, f, tiles, most))


# The fp32 route's tiles (csrc/fused_conv.cu:CONV_F32_CONFIGS), the first
# whose shared memory holds the shape's halo: 128 rows (two consumer
# warpgroups), 64 columns, 3 weight stages; 64 rows where a 128-row block's
# fp32 halo (hi and lo, two buffers, and the raw rows) would not fit, W > 64.
CONV_TILES_F32 = ((128, 64, 3), (64, 64, 3))


def conv_smem_f32(tiles: Tiles, w: int) -> int:
    """Dynamic shared memory of the fp32 route at ``tiles`` and image width
    W, by csrc/fused_conv.cu's arithmetic (ConvTf32Tile::smem): the weight
    ring (hi and lo a stage), three barriers a stage and two for the raw halo,
    a row of zeros, two halo buffers of hi and lo rows (128 bytes: 32
    channels), the raw rows (TMA boxes of BM + 2 rows: as many as cover one
    window, or three) and 1 KB to align the base."""
    bm, bn, stages = tiles
    bars = stages * 2 * bn * 128
    zero = -(-(bars + 8 * (3 * stages + 2)) // 128) * 128
    halo = -(-(zero + 128) // 1024) * 1024
    rows = halo_rows(bm, w)
    boxes = -(-rows // (bm + 2)) if bm + 2 * w + 2 <= 3 * (bm + 2) else 3
    return halo + (4 * rows + boxes * (bm + 2)) * 128 + 1024


def conv_plan_f32(b: int, h: int, w: int, c: int, f: int) -> Tuple[int, int, int, int]:
    """(BM, BN, stages, split) of the fp32 route for x (B, H, W, C) -> F:
    the first tiles whose shared memory fits, and the 32-channel slices
    cut into ``split`` ranges where that fills the card
    (``launch.split_k``)."""
    m = b * h * w
    tiles = next((t for t in CONV_TILES_F32 if conv_smem_f32(t, w) <= MAX_BLOCK_SMEM), None)
    if tiles is None:
        raise ValueError(f"gn_silu_conv3x3: no fp32 tiles fit W {w} in {MAX_BLOCK_SMEM} bytes")
    bm, bn, _ = tiles
    units = -(-m // bm) * -(-f // bn)
    split = split_k(units, -(-c // 32), 6 * bm * bn * 9 * c, 4 * m * f)
    return (*tiles, split)


def cuda_launches(plan) -> int:
    """CUDA launches of one conv kernel call at ``plan`` (either route's):
    the conv, and the in-order reduction of the split partials."""
    return 1 if plan[3] == 1 else 2


def _ref_chain(x, a, v, w, wb, residual=None) -> torch.Tensor:
    """pallas_conv.py:106-118: silu(x * a + v) in fp32, rounded to x's
    dtype, SAME-padded 3x3 conv in fp32 from the rounded operands (TF32 off
    on the card), + fp32 bias (+ residual in fp32), one cast.  w is OIHW."""
    xn = F.silu(x.float() * a[:, None, None, :] + v[:, None, None, :])
    xn = xn.to(x.dtype).float().permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(xn, w.to(x.dtype).float(), wb.float(), padding=1).permute(0, 2, 3, 1)
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def gn_silu_conv3x3_plain(x, scale, bias, w, wb, residual=None, num_groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """conv3x3_SAME(silu(GroupNorm(x) * scale + bias)) + wb [+ residual]
    (pallas_conv.py:174-202).  x (B, H, W, C); scale/bias (C,); w (F, C, 3,
    3); wb (F,); residual (B, H, W, F).  Returns (B, H, W, F) in x's dtype."""
    a, v = gn_affine_plain(x, scale, bias, num_groups, eps)
    return _ref_chain(x, a, v, w, wb, residual)


class GnSiluConv3x3(Kernel):
    """``routes`` counts the conv kernel's launches by route: "wgmma" (bf16)
    and "fp32" (``gn_silu_conv3x3_f32``)."""

    library, entry = "fused_conv", "gn_silu_conv3x3_bf16"
    ROUTES = ("wgmma", "fp32")
    # x, a, v, w, bias, residual, y, part, b, h, w, c, f, bm, bn, stages, split
    # (both routes)
    argtypes = (PTR,) * 8 + (I32,) * 9

    def __call__(self, x, scale, bias, w, wb, residual=None, num_groups: int = 32,
                 eps: float = 1e-5) -> torch.Tensor:
        """Same contract as ``gn_silu_conv3x3_plain``: ``gn_affine``'s
        kernel for the statistics, then the conv kernel.  Differentiable."""
        if x.is_cuda:  # what the conv kernel refuses raises before the statistics launch
            self._check(x, w, wb, residual)
        a, v = gn_affine(x, scale, bias, num_groups, eps)
        return differentiable(self._forward, _ref_chain, x, a, v, w, wb, residual)

    @staticmethod
    def _check(x, w, wb, residual, taps_first=False):
        """What the conv kernel refuses raises; w is OIHW (F, C, 3, 3), or
        (F, 3, 3, C) with ``taps_first``."""
        if x.dim() != 4:
            raise ValueError(f"gn_silu_conv3x3: x must be (B, H, W, C), got {tuple(x.shape)}")
        b, h, wd, c = x.shape
        f = w.shape[0]
        want = (f, 3, 3, c) if taps_first else (f, c, 3, 3)
        if w.shape != want or wb.shape != (f,):
            raise ValueError(f"gn_silu_conv3x3: x (..., {c}) needs an {want} weight and an (F,) "
                             f"bias; w is {tuple(w.shape)}")
        if residual is not None and residual.shape != (b, h, wd, f):
            raise ValueError(f"gn_silu_conv3x3: residual {tuple(residual.shape)} is not "
                             f"{(b, h, wd, f)}")
        check_widths("gn_silu_conv3x3", C=c, F=f)
        dtype = kernel_dtype("gn_silu_conv3x3", x)
        check("gn_silu_conv3x3", x.device, x=(x, dtype),
              **({} if residual is None else {"residual": (residual, dtype)}))

    def _forward(self, x, a, v, w, wb, residual):
        if not on_cuda(x, "gn_silu_conv3x3"):
            return _ref_chain(x, a, v, w, wb, residual)
        return self.conv(x, a, v, w.to(x.dtype).permute(0, 2, 3, 1).contiguous(), wb.float(),
                         residual)

    def conv(self, x, a, v, wt, wb, residual=None, plan=None, library=None) -> torch.Tensor:
        """The conv kernel alone on card tensors: x (B, H, W, C) bf16, the
        affine a, v (B, C) fp32, the weight wt already (F, 3, 3, C) bf16, the
        bias wb (F,) fp32, the residual (B, H, W, F) bf16 or None.  At the
        table's ``conv_plan`` (a counted launch), or at ``plan`` (BM, BN,
        stages, split) in ``library`` (the tile sweep's: not counted).  With
        fp32 x, wt and residual: the fp32 route at ``conv_plan_f32``
        (counted; no plan or library)."""
        self._check(x, wt, wb, residual, taps_first=True)
        b, h, wd, c = x.shape
        f = wt.shape[0]
        check("gn_silu_conv3x3", x.device, w=(wt, x.dtype), wb=(wb, torch.float32),
              a=(a, torch.float32), v=(v, torch.float32))
        if a.shape != (b, c) or v.shape != (b, c):
            raise ValueError(f"gn_silu_conv3x3: a and v must be {(b, c)}")
        f32 = x.dtype == torch.float32
        if f32 and (plan is not None or library is not None):
            raise ValueError("gn_silu_conv3x3: the fp32 route takes no plan or library")
        out = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
        if plan is None:
            plan = (conv_plan_f32 if f32 else conv_plan)(b, h, wd, c, f)
        plan = tuple(plan)
        part = (None if plan[3] == 1 else
                torch.empty((plan[3], b * h * wd, f), dtype=torch.float32, device=x.device))
        args = (x.data_ptr(), a.data_ptr(), v.data_ptr(), wt.data_ptr(), wb.data_ptr(),
                None if residual is None else residual.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), b, h, wd, c, f, *plan)
        if f32:
            self._launch(x.device, *args, entry=("gn_silu_conv3x3_f32", self.argtypes),
                         route="fp32")
            return out
        if library is None:
            self._launch(x.device, *args, route="wgmma")
            return out
        fn = c_entry(library, self.entry, self.argtypes)
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{library} {self.entry} launch failed at {plan}: cudaError {err}")
        return out


gn_silu_conv3x3 = GnSiluConv3x3()
KERNELS = {"gn_silu_conv3x3": gn_silu_conv3x3}
