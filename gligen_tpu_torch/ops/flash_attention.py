"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``gligen_tpu/ops/pallas_attention.py``.  One kernel,
``csrc/flash_fwd.cu``, replaces both TPU forwards on the 512^2 path: the
single-KV packed forward behind ``flash_attention_packed`` (UNet attn1 and
the gated self-attention fuser) and the streamed forward behind
``flash_attention`` (the VAE's single-head mid-attention).  Forward only:
inference needs no gradient; the backward kernels come with training.

Both versions compute, per (batch, head), ``softmax(scale * q k^T + bias) v``
with fp32 scores and softmax, and the per-row log-sum-exp in LOG2 units
(as the TPU kernel stores it).

``FlashForward.__call__`` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from gligen_tpu_torch.ops.launch import on_cuda

NEG_INF = -1e30  # additive bias of a masked key (pallas_attention.py's NEG_INF)
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 512


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


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its ctypes signature."""
    from gligen_tpu_torch.ops.cuda_build import load_library

    fn = load_library("flash_fwd").flash_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6            # q, k, v, bias, o, lse
        + [ctypes.c_int] * 5             # batch, heads, n, m, d
        + [ctypes.c_longlong] * 13       # q/k/v/o (batch, head, row) strides, bias row stride
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, vec, stream
    )
    return fn


def _check_inputs(q, k, v, heads, bias):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd takes bfloat16 q/k/v, {name} is {t.dtype}")
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


class FlashForward:
    """Wrapper of ``csrc/flash_fwd.cu``.

    ``launches`` counts kernel launches (never plain-version calls), so a
    run can show that its attention went through the kernel."""

    def __init__(self):
        self.launches = 0

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
        _check_inputs(q, k, v, heads, bias)
        b, n, hc = q.shape
        m = k.shape[1]
        c = hc // heads
        out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
        tensors = (q, k, v, out)
        # 16-byte vector loads need every row start 16-byte aligned
        vec = int(
            c % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors)
            and all(s % 8 == 0 for t in tensors for s in t.stride()[:2])
        )
        strides = []
        for t in tensors:
            strides += [t.stride(0), c, t.stride(1)]
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), lse.data_ptr(),
            b, heads, n, m, c,
            *strides, bias.stride(0) if bias is not None else 0,
            c**-0.5, vec, torch.cuda.current_stream(q.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"flash_fwd_bf16 launch failed: cudaError {err}")
        self.launches += 1
        return out, lse


flash_fwd = FlashForward()


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
    is: the kernel masks the ragged key tile itself, so no padding is
    needed."""
    bias = None if key_mask is None else key_mask_bias(key_mask)
    return flash_fwd(q, k, v, heads, bias=bias)[0]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(BH, N, D) layout (pallas_attention.py:719): one head per row of the
    leading axis; bias optional (BH, 1, M) additive.  Returns (BH, N, D)."""
    if bias is not None:
        bias = bias.reshape(bias.shape[0], bias.shape[-1]).float()
    return flash_fwd(q, k, v, 1, bias=bias)[0]
