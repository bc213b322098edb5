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

The wrapper runs the plain versions for a CPU tensor and the kernels for a
CUDA tensor; it never falls back from one to the other, and raises on what
the kernel does not take (a dtype other than bf16, C or F not multiples of
8).  W need not be a multiple of 8: that is the TPU's sublane rule, which
stays in the routing (models/unet.py).

Gradients, as in pallas_conv.py:121-171: the statistics (``gn_affine``)
are differentiable on their own, and the conv's backward differentiates
``_ref_chain`` in (x, a, v, w, wb, residual).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gligen_tpu_torch.ops.fused_norm import gn_affine, gn_affine_plain
from gligen_tpu_torch.ops.launch import I32, PTR, Kernel, check, check_widths, differentiable, on_cuda


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
    library, entry = "fused_conv", "gn_silu_conv3x3_bf16"
    # x, a, v, w, bias, residual, y, b, h, w, c, f
    argtypes = (PTR,) * 7 + (I32,) * 5

    def __call__(self, x, scale, bias, w, wb, residual=None, num_groups: int = 32,
                 eps: float = 1e-5) -> torch.Tensor:
        """Same contract as ``gn_silu_conv3x3_plain``: ``gn_affine``'s
        kernel for the statistics, then the conv kernel.  Differentiable."""
        if x.is_cuda:  # what the conv kernel refuses raises before the statistics launch
            self._check(x, w, wb, residual)
        a, v = gn_affine(x, scale, bias, num_groups, eps)
        return differentiable(self._forward, _ref_chain, x, a, v, w, wb, residual)

    @staticmethod
    def _check(x, w, wb, residual):
        if x.dim() != 4:
            raise ValueError(f"gn_silu_conv3x3: x must be (B, H, W, C), got {tuple(x.shape)}")
        b, h, wd, c = x.shape
        f = w.shape[0]
        if w.shape != (f, c, 3, 3) or wb.shape != (f,):
            raise ValueError(f"gn_silu_conv3x3: x (..., {c}) needs an (F, {c}, 3, 3) weight and "
                             f"an (F,) bias; w is {tuple(w.shape)}")
        if residual is not None and residual.shape != (b, h, wd, f):
            raise ValueError(f"gn_silu_conv3x3: residual {tuple(residual.shape)} is not "
                             f"{(b, h, wd, f)}")
        check_widths("gn_silu_conv3x3", C=c, F=f)
        check("gn_silu_conv3x3", x.device, x=(x, torch.bfloat16),
              **({} if residual is None else {"residual": (residual, torch.bfloat16)}))

    def _forward(self, x, a, v, w, wb, residual):
        if not on_cuda(x, "gn_silu_conv3x3"):
            return _ref_chain(x, a, v, w, wb, residual)
        b, h, wd, c = x.shape
        f = w.shape[0]
        wt = w.to(x.dtype).permute(0, 2, 3, 1).contiguous()
        wb = wb.float()
        check("gn_silu_conv3x3", x.device, w=(wt, torch.bfloat16), wb=(wb, torch.float32),
              a=(a, torch.float32), v=(v, torch.float32))
        out = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
        self._launch(
            x.device, x.data_ptr(), a.data_ptr(), v.data_ptr(), wt.data_ptr(), wb.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            b, h, wd, c, f,
        )
        return out


gn_silu_conv3x3 = GnSiluConv3x3()
KERNELS = {"gn_silu_conv3x3": gn_silu_conv3x3}
