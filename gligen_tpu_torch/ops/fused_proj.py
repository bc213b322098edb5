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

from gligen_tpu_torch.ops.basic import layer_norm_xla
from gligen_tpu_torch.ops.launch import (
    F32, I32, PTR, Kernel, check, check_widths, differentiable, on_cuda,
)

MAX_WEIGHTS = 3
Gate = Union[None, float, torch.Tensor]


def _product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T in real fp32 from operands rounded to a's dtype (no bf16
    cuBLAS reductions): the plain versions' reference product."""
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


class LnMatmuls(Kernel):
    library, entry = "fused_proj", "ln_matmuls_bf16"
    # x, scale, bias, n_w, w0..w2, y0..y2, m, k, f, eps
    argtypes = (PTR,) * 3 + (I32,) + (PTR,) * 6 + (I32,) * 3 + (F32,)

    def __call__(self, x, scale, bias, ws, eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
        """Same contract as ``ln_matmuls_plain``; 1 to 3 weights of one
        shape.  Differentiable."""
        ws = tuple(w.to(x.dtype) for w in ws)
        return differentiable(functools.partial(self._forward, eps=eps),
                              functools.partial(_ln_matmuls_chain, eps=eps),
                              x, scale.float(), bias.float(), *ws)

    def _forward(self, x, scale, bias, *ws, eps):
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
        check("ln_matmuls", x.device, x=(x, torch.bfloat16), scale=(scale, torch.float32),
               bias=(bias, torch.float32), **{f"w{i}": (w, torch.bfloat16) for i, w in enumerate(ws)})
        outs = tuple(torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device) for _ in ws)
        pad = (None,) * (MAX_WEIGHTS - len(ws))
        self._launch(
            x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), len(ws),
            *(w.data_ptr() for w in ws), *pad, *(o.data_ptr() for o in outs), *pad,
            x.numel() // c, c, f, eps,
        )
        return outs


class MatmulResidual(Kernel):
    library, entry = "fused_proj", "matmul_residual_bf16"
    # h, w, bias, x, gate, gate_value, y, m, k, f
    argtypes = (PTR,) * 5 + (F32, PTR) + (I32,) * 3

    def __call__(self, h, w, bias, x, gate: Gate = None) -> torch.Tensor:
        """Same contract as ``matmul_residual_plain``.  A tensor gate is
        read by the kernel on the device (no host synchronisation).
        Differentiable, in the gate too."""
        tensor_gate = gate if isinstance(gate, torch.Tensor) else None
        gate_value = 1.0 if gate is None or tensor_gate is not None else float(gate)
        return differentiable(functools.partial(self._forward, gate_value=gate_value),
                              functools.partial(_matmul_residual_chain, gate_value=gate_value),
                              h, w.to(x.dtype), bias.float(), x, tensor_gate)

    def _forward(self, h, w, bias, x, gate, gate_value):
        if not on_cuda(x, "matmul_residual"):
            return matmul_residual_plain(h, w, bias, x, gate_value if gate is None else gate)
        c, k = w.shape
        if h.shape[:-1] != x.shape[:-1] or h.shape[-1] != k or x.shape[-1] != c or bias.shape != (c,):
            raise ValueError(f"matmul_residual: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                             f"bias {tuple(bias.shape)} and x {tuple(x.shape)} do not fit")
        check_widths("matmul_residual", K=k, C=c)
        check("matmul_residual", x.device, h=(h, torch.bfloat16), w=(w, torch.bfloat16),
               bias=(bias, torch.float32), x=(x, torch.bfloat16))
        gate_ptr = None
        if gate is not None:
            if gate.numel() != 1:
                raise ValueError(f"matmul_residual: gate must hold one value, has {gate.numel()}")
            check("matmul_residual", x.device, gate=(gate, torch.float32))
            gate_ptr = gate.data_ptr()
        out = torch.empty_like(x)
        self._launch(
            x.device, h.data_ptr(), w.data_ptr(), bias.data_ptr(), x.data_ptr(), gate_ptr,
            gate_value, out.data_ptr(), x.numel() // c, k, c,
        )
        return out


class LnGeglu(Kernel):
    library, entry = "fused_proj", "ln_geglu_bf16"
    # x, scale, bias, w, w_bias, y, m, k, f, eps
    argtypes = (PTR,) * 6 + (I32,) * 3 + (F32,)

    def __call__(self, x, scale, bias, w, w_bias, eps: float = 1e-5) -> torch.Tensor:
        """Same contract as ``ln_geglu_plain``.  Differentiable."""
        return differentiable(functools.partial(self._forward, eps=eps),
                              functools.partial(_ln_geglu_chain, eps=eps),
                              x, scale.float(), bias.float(), w.to(x.dtype), w_bias.float())

    def _forward(self, x, scale, bias, w, w_bias, eps):
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
        check("ln_geglu", x.device, x=(x, torch.bfloat16), scale=(scale, torch.float32),
               bias=(bias, torch.float32), w=(w, torch.bfloat16), w_bias=(w_bias, torch.float32))
        out = torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device)
        self._launch(
            x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
            w_bias.data_ptr(), out.data_ptr(), x.numel() // c, c, f, eps,
        )
        return out


class MmOnly(Kernel):
    library, entry = "fused_proj", "matmul_bf16"
    # a, w, y, m, k, f
    argtypes = (PTR,) * 3 + (I32,) * 3

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Same contract as ``mm_only_plain``; bf16 x and w on the card.
        Forward only: with gradients enabled, an input that requires one
        raises, since the kernel's output could not carry it."""
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise RuntimeError("mm_only is forward only (the JAX tool's kernel has no "
                               "custom_vjp): call it under torch.no_grad()")
        if not on_cuda(x, "mm_only"):
            return mm_only_plain(x, w)
        f, k = w.shape
        if x.shape[-1] != k:
            raise ValueError(f"mm_only: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit")
        check_widths("mm_only", K=k, F=f)
        check("mm_only", x.device, x=(x, torch.bfloat16), w=(w, torch.bfloat16))
        out = torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device)
        self._launch(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // k, k, f)
        return out


ln_matmuls = LnMatmuls()
matmul_residual = MatmulResidual()
ln_geglu = LnGeglu()
mm_only = MmOnly()
KERNELS = {"ln_matmuls": ln_matmuls, "matmul_residual": matmul_residual, "ln_geglu": ln_geglu,
           "mm_only": mm_only}
