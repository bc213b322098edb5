"""Flash attention: the CUDA kernels' wrappers, their plain versions and
the autograd Function that joins them.

Counterpart of ``gligen_tpu/ops/pallas_attention.py``.  The forward kernel,
``csrc/flash_fwd.cu``, replaces both TPU forwards: the single-KV packed
forward behind ``flash_attention_packed`` (UNet attn1, the gated
self-attention fuser, cross-attention) and the streamed forward behind
``flash_attention`` (the VAE's single-head mid-attention).  The backward
kernels, ``csrc/flash_bwd.cu``, replace ``_flash_bwd`` and
``_flash_packed_bwd``: one computes dq, the other dk and dv (and the bias
gradient).

The forward computes, per (batch, head), ``softmax(scale * q k^T + bias) v``
with fp32 scores and softmax, and the per-row log-sum-exp in LOG2 units
(as the TPU kernel stores it); the backward recomputes the probabilities
from that LSE.  ``FlashAttention`` is the ``torch.autograd.Function``
(the JAX package's ``custom_vjp``): its forward saves q, k, v, bias, out
and the LSE, its backward launches the dq kernel when q needs a gradient
and the dk/dv kernel when k, v or the bias does.

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other.  Every kernel
loads its bf16 operands by TMA where TMA can read them (``tma_ok``) and by
plain copies otherwise: a choice made from the layout, before the launch,
and counted per route.  Each kernel's tiles come from a fixed table by
head dim (``FWD_TILES``, ``BWD_TILES``, and the fp32 routes'
``FWD_TILES_F32``, ``BWD_TILES_F32``) that its library is built at.
The forward also takes fp32 q/k/v (a model served in fp32, and the
inpaint image's fp32 VAE encode): a route of its own, ``flash_fwd_f32`` of
the same source (``launch_fwd_f32``), counted as route "fp32": fp32 in and
out, an fp32 softmax, and both products as 3xTF32 on the tensor cores (x =
hi + lo in TF32; hi.hi + hi.lo + lo.hi), fp32-accurate to a few ulps.  Two
kernels serve it, named by their tiles in ``FWD_TILES_F32``: the UNet's
head dims (d <= 160) take ``flash_fwd_f32_qm_kernel`` (queries as the
products' rows), the VAE's 512 ``flash_fwd_f32_kernel`` (keys as the rows);
``FlashForward.fp32_kernels`` counts each one's launches.  The backward's
fp32 route (a model trained in fp32), ``flash_bwd_dq_f32`` and
``flash_bwd_dkv_f32`` of ``csrc/flash_bwd.cu``, counted as route "fp32",
runs the kernels ``BWD_TILES_F32`` names for the head dim: 3xTF32 on the
tensor cores ("tc") in every class (the d <= 160 class with Q and dO, or K
and V, resident unsplit); each wrapper's ``fp32_kernels`` counts their
launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from gligen_tpu_torch.ops.launch import F32, I32, PTR, c_entry, on_cuda

NEG_INF = -1e30  # additive bias of a masked key (pallas_attention.py's NEG_INF)
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 512
MAX_BWD_HEAD_DIM = 160  # the backward kernels' largest class (BWD_TILES)
STRIDES = ctypes.POINTER(ctypes.c_longlong)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel.

    q: (B, N, H*C), k/v: (B, M, H*C), bias: optional fp32 (B, M) additive.
    The scale is C**-0.5.  Returns (out (B, N, H*C) in q's dtype,
    lse (B, H, N) fp32, log2 units).
    """
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // heads
    scale = c**-0.5
    qh = q.reshape(b, n, heads, c).float()
    kh = k.reshape(b, m, heads, c).float()
    vh = v.reshape(b, m, heads, c).float()
    s = torch.einsum("bnhc,bmhc->bhnm", qh, kh) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    lse = torch.logsumexp(s, dim=-1) * LOG2E
    out = torch.einsum("bhnm,bmhc->bnhc", torch.softmax(s, dim=-1), vh)
    return out.reshape(b, n, hc).to(q.dtype), lse


# The forward kernel's tile table, by head-dim class: (largest head dim, BQ
# query rows, BK keys, ring stages).  The wrapper passes the chosen tiles to
# the C entry; the serving library (csrc/flash_fwd.cu:dispatch) is built
# with exactly these configurations and refuses any other.
FWD_TILES = ((40, 128, 128, 3), (80, 128, 128, 2), (160, 128, 64, 2), (512, 64, 32, 2))


def fwd_tiles(d: int) -> Tuple[int, int, int]:
    """(BQ, BK, stages) of the forward kernel for head dim ``d``."""
    for top, bq, bk, stages in FWD_TILES:
        if d <= top:
            return bq, bk, stages
    raise ValueError(f"head dim {d} above {MAX_HEAD_DIM}")


def tma_ok(d: int, layouts) -> bool:
    """Whether TMA can read every operand (csrc/hopper.cuh:tma_operand_ok):
    d a multiple of 8 elements (16 bytes), and each operand's base address
    16-byte aligned with positive batch and row strides that are multiples
    of 8 elements.  ``layouts``: (data_ptr, batch stride, row stride) of
    each operand (q, k, v; the backward adds dO).  Anything else takes the
    copy route."""
    return d % 8 == 0 and all(
        ptr % 16 == 0 and sb > 0 and sn > 0 and sb % 8 == 0 and sn % 8 == 0
        for ptr, sb, sn in layouts
    )


def fwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> str:
    """"tma" or "copy": how the forward kernel loads these operands."""
    layouts = [(t.data_ptr(), t.stride(0), t.stride(1)) for t in (q, k, v)]
    return "tma" if tma_ok(q.shape[2] // heads, layouts) else "copy"


# the forward entry's ctypes arguments before the stream
_FWD_ARGTYPES = (
    (PTR,) * 6                 # q, k, v, bias, o, lse
    + (I32,) * 5               # batch, heads, n, m, d
    + (ctypes.c_longlong,) * 13  # q/k/v/o (batch, head, row) strides, bias row stride
    + (F32,) + (I32,) * 4      # scale, tma, BQ, BK, stages
)


def launch_fwd(library, q, k, v, heads, bias, tiles):
    """One launch of ``library``'s forward entry at ``tiles`` (BQ, BK,
    stages) on checked CUDA inputs; returns (out, lse, route).  Raises if
    the library does not hold that configuration for this head dim."""
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // heads
    out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    route = fwd_route(q, k, v, heads)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), c, t.stride(1)]
    err = c_entry(library, "flash_fwd_bf16", _FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), lse.data_ptr(),
        b, heads, n, m, c,
        *strides, bias.stride(0) if bias is not None else 0,
        c**-0.5, int(route == "tma"), *tiles,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{library} launch failed (d {c}, {route} route, tiles {tiles}): "
                           f"cudaError {err}")
    return out, lse, route


# The fp32 route's tile table, by head-dim class: (largest head dim, kernel,
# (BQ query rows, BK keys, stages)).  "qm" is flash_fwd_f32_qm_kernel
# (queries as the products' M rows; its third number is the converted K/V
# buffers), "km" flash_fwd_f32_kernel (keys as the M rows, at its one
# configuration).  The tiles name the kernel: the C entry
# (csrc/flash_fwd.cu:flash_fwd_f32) runs d <= 160 only at the qm tiles its
# library holds (f32qm::dispatch, exactly these in the serving library) and
# d > 160 only at (32, 128, 4), and refuses anything else.  The qm tiles are
# the ones tools/bench_sweep_attn.py --fp32 picked.
FWD_TILES_F32 = (
    (40, "qm", (192, 64, 2)),
    (80, "qm", (128, 32, 2)),
    (160, "qm", (64, 32, 1)),
    (512, "km", (32, 128, 4)),
)


def fwd_tiles_f32(d: int) -> Tuple[str, Tuple[int, int, int]]:
    """(kernel, (BQ, BK, stages)) of the fp32 route for head dim ``d``."""
    for top, kernel, tiles in FWD_TILES_F32:
        if d <= top:
            return kernel, tiles
    raise ValueError(f"head dim {d} above {MAX_HEAD_DIM}")


# the fp32 route's entry: q, k, v, bias, o, lse, the shapes and strides, the
# scale, the tiles
_FWD32_ARGTYPES = (PTR,) * 6 + (I32,) * 5 + (ctypes.c_longlong,) * 13 + (F32,) + (I32,) * 3


def launch_fwd_f32(library, q, k, v, heads, bias, tiles):
    """One launch of ``library``'s fp32 entry at ``tiles`` (BQ, BK, stages)
    on checked CUDA inputs (``_check_f32``); returns (out fp32, lse).
    Raises if the library does not hold that configuration for this head
    dim."""
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // heads
    out = torch.empty((b, n, hc), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), c, t.stride(1)]
    err = c_entry(library, "flash_fwd_f32", _FWD32_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(), lse.data_ptr(),
        b, heads, n, m, c, *strides, bias.stride(0) if bias is not None else 0, c**-0.5,
        *tiles, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{library} flash_fwd_f32 launch failed (d {c}, tiles {tiles}): "
                           f"cudaError {err}")
    return out, lse


def _check_f32(q, k, v, heads, bias, op="flash_fwd", more=()):
    """What the fp32 routes take: ``_check_inputs`` in fp32, and what TMA
    (the forward) and 16-byte loads (the backward) read of an fp32 operand:
    a head dim, every base and every stride a multiple of 4 elements (16
    bytes), of q, k, v and ``more`` (the backward's dO)."""
    _check_inputs(q, k, v, heads, bias, dtype=torch.float32)
    c = q.shape[2] // heads
    if c % 4 or any(t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(1) % 4
                    for t in (q, k, v, *more)):
        raise ValueError(f"{op} fp32: head dim {c}, bases and strides must be multiples "
                         "of 4 elements (16 bytes)")


def _check_inputs(q, k, v, heads, bias, dtype=torch.bfloat16):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"flash_fwd takes {dtype} q/k/v here, {name} is {t.dtype}")
        if t.dim() != 3 or t.stride(2) != 1:
            raise ValueError(f"{name} must be (B, L, H*C) with a unit last stride")
    b, n, hc = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hc:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    if hc % heads:
        raise ValueError(f"width {hc} not divisible by {heads} heads")
    if not 1 <= hc // heads <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hc // heads} outside [1, {MAX_HEAD_DIM}]")
    if n < 1 or k.shape[1] < 1:
        raise ValueError("empty query or key sequence")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != q.device:
            raise TypeError("bias must be float32 on q's device")
        if bias.shape != (b, k.shape[1]) or bias.stride(1) != 1:
            raise ValueError(f"bias must be (B, M) = {(b, k.shape[1])} with a unit last stride")


class Counted:
    """A flash kernel's wrapper: ``launches`` counts kernel launches (never
    plain-version calls), so a run can show that its attention went
    through the kernel; ``routes`` counts them by route ("tma" or
    "copy", and the fp32 routes' "fp32").  The counts take a lock: a server
    launches from several threads at once."""

    def __init__(self, routes=("tma", "copy")):
        self.launches = 0
        self.routes = dict.fromkeys(routes, 0)
        self._count_lock = threading.Lock()

    def _count(self, route: str) -> None:
        with self._count_lock:
            self.launches += 1
            self.routes[route] += 1


class FlashForward(Counted):
    """Wrapper of ``csrc/flash_fwd.cu``: bf16 routes by ``fwd_route``, fp32
    inputs by the "fp32" route; ``fp32_kernels`` counts the fp32 route's
    launches by kernel ("qm" or "km", ``FWD_TILES_F32``)."""

    def __init__(self):
        super().__init__(("tma", "copy", "fp32"))
        self.fp32_kernels = {"qm": 0, "km": 0}

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        heads: int,
        bias: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Same contract as ``flash_attention_plain``."""
        if not on_cuda(q, "flash_fwd"):
            return flash_attention_plain(q, k, v, heads, bias=bias)
        if q.dtype == torch.float32:
            _check_f32(q, k, v, heads, bias)
            kernel, tiles = fwd_tiles_f32(q.shape[2] // heads)
            out, lse = launch_fwd_f32("flash_fwd", q, k, v, heads, bias, tiles)
            with self._count_lock:
                self.fp32_kernels[kernel] += 1
            self._count("fp32")
            return out, lse
        _check_inputs(q, k, v, heads, bias)
        tiles = fwd_tiles(q.shape[2] // heads)
        out, lse, route = launch_fwd("flash_fwd", q, k, v, heads, bias, tiles)
        self._count(route)
        return out, lse

flash_fwd = FlashForward()


def attention_delta(out: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per (batch, head, query row): (B, H, N) fp32,
    computed outside the kernels as pallas_attention.py:969-973 does."""
    b, n, hc = out.shape
    prod = do.float() * out.float()
    return prod.reshape(b, n, heads, hc // heads).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward kernels, in fp32 from the
    saved LSE (log2 units, (B, H, N)) and ``attention_delta``.

    Returns (dq, dk, dv) in q's dtype and, when a bias is given, dbias
    (B, M) fp32: the sum over heads and query rows of dS."""
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // heads
    scale = c**-0.5
    qh, kh, vh, doh = (t.reshape(b, -1, heads, c).float() for t in (q, k, v, do))
    s = torch.einsum("bnhc,bmhc->bhnm", qh, kh) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.exp2(s * LOG2E - lse[..., None])
    dp = torch.einsum("bnhc,bmhc->bhnm", doh, vh)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhnm,bmhc->bnhc", ds, kh) * scale
    dk = torch.einsum("bhnm,bnhc->bmhc", ds, qh) * scale
    dv = torch.einsum("bhnm,bnhc->bmhc", p, doh)
    grads = tuple(g.reshape(b, -1, hc).to(q.dtype) for g in (dq, dk, dv))
    return (*grads, None if bias is None else ds.sum(dim=(1, 2)))


def _check_bwd_inputs(q, k, v, heads, do, lse, delta, bias):
    """What the backward kernels take: bf16 q/k/v as the forward's bf16
    routes take them, or fp32 q/k/v as its fp32 route does (``_check_f32``:
    multiples of 4 elements, dO included); dO contiguous, of q's dtype and
    shape; the LSE and delta contiguous fp32 (B, H, N)."""
    b, n, hc = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or not do.is_contiguous():
        raise ValueError(f"dO must be a contiguous {q.dtype} tensor of q's shape {tuple(q.shape)}")
    if q.dtype == torch.float32:
        _check_f32(q, k, v, heads, bias, op="flash_bwd", more=(do,))
    else:
        _check_inputs(q, k, v, heads, bias)
    bwd_tiles(hc // heads)  # raises above MAX_BWD_HEAD_DIM
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, heads, n) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 (B, H, N) = {(b, heads, n)}")


# The backward kernels' tile table, by head-dim class: (largest head dim,
# dq's (BQ query rows, BK keys, ring stages), dk/dv's (BK keys, BQ query
# rows, ring stages)).  The wrappers pass the chosen tiles to the C entries;
# the serving library (csrc/flash_bwd.cu:dispatch) is built with exactly
# these configurations and refuses any other.
BWD_TILES = (
    (40, (128, 64, 3), (128, 64, 3)),
    (80, (128, 64, 2), (64, 64, 2)),
    (160, (64, 64, 2), (64, 32, 3)),
)


def bwd_tiles(d: int) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """(dq tiles, dk/dv tiles) of the backward kernels for head dim ``d``."""
    for top, dq, dkv in BWD_TILES:
        if d <= top:
            return dq, dkv
    raise ValueError(f"flash backward: head dim {d} above {MAX_BWD_HEAD_DIM}")


# The fp32 route's tile table, by head-dim class: (largest head dim, kernel,
# dq's (BQ query rows, BK keys), dk/dv's (BK keys, BQ query rows)).  "tc" is
# the 3xTF32 wgmma pair (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel;
# in the d <= 160 class with the resident pair raw and tiles of 16 rows).
# The serving library (csrc/flash_bwd.cu:f32::dispatch, its *_F32 lists)
# holds exactly these and refuses any other; the tiles are the ones
# tools/bench_sweep_attn.py --bwd --fp32 picked.
BWD_TILES_F32 = (
    (40, "tc", (128, 64), (128, 32)),
    (80, "tc", (128, 32), (64, 32)),
    (160, "tc", (64, 16), (64, 16)),
)


def bwd_tiles_f32(d: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(dq tiles, dk/dv tiles) of the fp32 route for head dim ``d``."""
    for top, _, dq, dkv in BWD_TILES_F32:
        if d <= top:
            return dq, dkv
    raise ValueError(f"flash backward: head dim {d} above {MAX_BWD_HEAD_DIM}")


def bwd_kernel_f32(d: int) -> str:
    """The fp32 route's kernels for head dim ``d`` ("tc")."""
    for top, kernel, _, _ in BWD_TILES_F32:
        if d <= top:
            return kernel
    raise ValueError(f"flash backward: head dim {d} above {MAX_BWD_HEAD_DIM}")


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
              heads: int) -> str:
    """"tma" or "copy": how the backward kernels load these bf16 operands
    (``tma_ok`` over q, k, v and dO); "fp32" for fp32 ones."""
    if q.dtype == torch.float32:
        return "fp32"
    layouts = [(t.data_ptr(), t.stride(0), t.stride(1)) for t in (q, k, v, do)]
    return "tma" if tma_ok(q.shape[2] // heads, layouts) else "copy"


# (entry, ctypes arguments before the stream) of each backward kernel
_BWD_ENTRIES = {
    # q, k, v, do, bias, lse, delta, dq, batch, heads, n, m, d, strides, scale,
    # tma, BQ, BK, stages
    "dq": ("flash_bwd_dq_bf16", (PTR,) * 8 + (I32,) * 5 + (STRIDES, F32) + (I32,) * 4),
    # q, k, v, do, bias, lse, delta, dk, dv, dbias, batch, heads, n, m, d,
    # strides, scale, tma, BK, BQ, stages
    "dkv": ("flash_bwd_dkv_bf16", (PTR,) * 10 + (I32,) * 5 + (STRIDES, F32) + (I32,) * 4),
    # the fp32 route: the same, without tma, and (fixed rows, tile rows)
    "dq_f32": ("flash_bwd_dq_f32", (PTR,) * 8 + (I32,) * 5 + (STRIDES, F32) + (I32,) * 2),
    "dkv_f32": ("flash_bwd_dkv_f32", (PTR,) * 10 + (I32,) * 5 + (STRIDES, F32) + (I32,) * 2),
}


def launch_bwd(library, kind, q, k, v, heads, do, lse, delta, bias, tiles, dbias=False):
    """One launch of ``library``'s backward entry ``kind`` ("dq" or "dkv")
    at ``tiles`` on checked CUDA inputs: the bf16 entries (``BWD_TILES``'
    triples) or, for fp32 inputs, the fp32 ones (``BWD_TILES_F32``' pairs).
    Returns (dq, route) or ((dk, dv, per-head dbias (B, H, M) or None),
    route).  Raises if the library does not hold that configuration for this
    head dim."""
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // heads
    if kind == "dq":
        grads = dict(dq=torch.empty_like(q, memory_format=torch.contiguous_format))
        outs = [grads["dq"].data_ptr()]
    else:
        grads = dict(dk=torch.empty((b, m, hc), dtype=k.dtype, device=k.device))
        grads["dv"] = torch.empty_like(grads["dk"])
        db = torch.empty((b, heads, m), dtype=torch.float32, device=k.device) if dbias else None
        outs = [grads["dk"].data_ptr(), grads["dv"].data_ptr(), db.data_ptr() if dbias else None]
    named = dict(q=q, k=k, v=v, do=do, **grads)
    strides = []
    for name in ("q", "k", "v", "do", "dq", "dk", "dv"):
        t = named.get(name)
        strides += [t.stride(0), c, t.stride(1)] if t is not None else [0, 0, 0]
    strides.append(bias.stride(0) if bias is not None else 0)
    route = bwd_route(q, k, v, do, heads)
    entry, argtypes = _BWD_ENTRIES[kind + "_f32" if route == "fp32" else kind]
    tma = () if route == "fp32" else (int(route == "tma"),)
    err = c_entry(library, entry, argtypes)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        bias.data_ptr() if bias is not None else None, lse.data_ptr(), delta.data_ptr(),
        *outs, b, heads, n, m, c, (ctypes.c_longlong * len(strides))(*strides), c**-0.5,
        *tma, *tiles, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{library} {entry} launch failed (d {c}, {route} route, tiles "
                           f"{tiles}): cudaError {err}")
    if kind == "dq":
        return grads["dq"], route
    return (grads["dk"], grads["dv"], db), route


def _bwd_tiles_of(q: torch.Tensor, heads: int, kind: int):
    """The backward kernel's tiles for q's dtype (``BWD_TILES_F32`` for
    fp32, else ``BWD_TILES``); kind 0 dq, 1 dk/dv."""
    table = bwd_tiles_f32 if q.dtype == torch.float32 else bwd_tiles
    return table(q.shape[2] // heads)[kind]


class BackwardCounted(Counted):
    """A backward kernel's wrapper: routes by ``bwd_route`` ("tma" or
    "copy" for bf16, "fp32"), and ``fp32_kernels`` counts the fp32 route's
    launches by kernel ("tc", ``BWD_TILES_F32``)."""

    def __init__(self):
        super().__init__(("tma", "copy", "fp32"))
        self.fp32_kernels = {"tc": 0}

    def _count_launch(self, route: str, q: torch.Tensor, heads: int) -> None:
        if route == "fp32":
            with self._count_lock:
                self.fp32_kernels[bwd_kernel_f32(q.shape[2] // heads)] += 1
        self._count(route)


class FlashBackwardDq(BackwardCounted):
    """dq kernel of ``csrc/flash_bwd.cu``."""

    def __call__(self, q, k, v, heads, do, lse, delta, bias=None) -> torch.Tensor:
        """dq of ``flash_attention_bwd_plain``, in q's dtype."""
        if not on_cuda(q, "flash_bwd_dq"):
            return flash_attention_bwd_plain(q, k, v, heads, do, lse, delta, bias)[0]
        _check_bwd_inputs(q, k, v, heads, do, lse, delta, bias)
        tiles = _bwd_tiles_of(q, heads, 0)
        dq, route = launch_bwd("flash_bwd", "dq", q, k, v, heads, do, lse, delta, bias, tiles)
        self._count_launch(route, q, heads)
        return dq


class FlashBackwardDkv(BackwardCounted):
    """dk/dv (and dbias) kernel of ``csrc/flash_bwd.cu``."""

    def __call__(self, q, k, v, heads, do, lse, delta, bias=None, dbias: bool = False):
        """(dk, dv, dbias) of ``flash_attention_bwd_plain``; dbias (B, M)
        fp32 only when ``dbias`` is asked for (it needs a bias), else None."""
        if dbias and bias is None:
            raise ValueError("flash_bwd_dkv: dbias needs a bias")
        if not on_cuda(q, "flash_bwd_dkv"):
            _, dk, dv, db = flash_attention_bwd_plain(q, k, v, heads, do, lse, delta, bias)
            return dk, dv, db if dbias else None
        _check_bwd_inputs(q, k, v, heads, do, lse, delta, bias)
        tiles = _bwd_tiles_of(q, heads, 1)
        (dk, dv, db), route = launch_bwd("flash_bwd", "dkv", q, k, v, heads, do, lse, delta,
                                         bias, tiles, dbias=dbias)
        self._count_launch(route, q, heads)
        # the heads share the bias: sum their partial sums (pallas_attention.py:1078)
        return dk, dv, db.sum(dim=1) if dbias else None


flash_bwd_dq = FlashBackwardDq()
flash_bwd_dkv = FlashBackwardDkv()
KERNELS = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


class FlashAttention(torch.autograd.Function):
    """The flash forward kernel, differentiated by the backward kernels
    (pallas_attention.py's ``_flash_packed`` custom VJP).  The forward
    saves q, k, v, bias, out and the LSE; the backward runs the dq kernel
    only when q needs a gradient (the 77-token cross-attention's k/v come
    from the frozen text encoder) and the dk/dv kernel only when k, v or
    the bias does."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads):
        out, lse = flash_fwd(q, k, v, heads, bias=bias)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        need_q, need_k, need_v, need_bias, _ = ctx.needs_input_grad
        do = do.contiguous()  # autograd may hand over a strided cotangent
        delta = attention_delta(out, do, ctx.heads)
        dq = flash_bwd_dq(q, k, v, ctx.heads, do, lse, delta, bias) if need_q else None
        dk = dv = dbias = None
        if need_k or need_v or need_bias:
            dk, dv, dbias = flash_bwd_dkv(q, k, v, ctx.heads, do, lse, delta, bias,
                                          dbias=need_bias)
        return dq, dk if need_k else None, dv if need_v else None, dbias, None


def key_mask_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, M) bool (True = attend) -> fp32 additive bias, NEG_INF on masked keys."""
    return torch.zeros(key_mask.shape, dtype=torch.float32, device=key_mask.device).masked_fill(
        ~key_mask, NEG_INF
    )


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention over the packed layout (pallas_attention.py:1093).

    q: (B, N, H*C), k/v: (B, M, H*C), key_mask: optional (B, M) bool
    (True = attend).  Returns (B, N, H*C) in q's dtype.  Any M works as it
    is: the kernels mask the ragged key tile themselves, so no padding is
    needed.  Differentiable through ``FlashAttention``."""
    bias = None if key_mask is None else key_mask_bias(key_mask)
    return FlashAttention.apply(q, k, v, bias, heads)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(BH, N, D) layout (pallas_attention.py:719): one head per row of the
    leading axis; bias optional (BH, 1, M) additive, which gets its
    gradient (dbias) when it needs one.  Returns (BH, N, D)."""
    if bias is not None:
        bias = bias.reshape(bias.shape[0], bias.shape[-1]).float()
    return FlashAttention.apply(q, k, v, bias, 1)
