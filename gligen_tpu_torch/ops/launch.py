"""Calling the package's CUDA entry points: what every kernel wrapper shares.

A wrapper runs its kernel's plain version for a CPU tensor and the kernel
for a CUDA tensor (``on_cuda``); it never falls back from one to the other.
Before a launch it checks what the kernel takes (``check``,
``check_widths``) and raises on anything else.  ``Kernel`` binds one C
entry point of ``csrc/<library>.cu`` through ctypes and counts its
launches.  ``differentiable`` makes a kernel's output carry gradients: a
kernel writes a fresh tensor through a raw pointer, which autograd cannot
see into.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Optional, Tuple

import torch

PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

SMS = 132  # the H100 SXM's streaming multiprocessors
TF32_FLOP_PER_SM_S = 495e12 / SMS  # its dense TF32 tensor-core rate, per SM
HBM_BYTES_PER_S = 3.35e12
REDUCE_LAUNCH_S = 4e-6  # a second kernel's launch and its wave's ramp, roughly
SPLIT_MOST = 8  # the fp32 routes' most ranges of the k-slices


def on_cuda(x: torch.Tensor, op: str) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one (kernel)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{op} runs on CPU or CUDA tensors, got {x.device}")
    return True


def check(op: str, device: torch.device, **operands: Tuple[torch.Tensor, torch.dtype]) -> None:
    """What the kernel does not take raises before any launch: every
    operand on x's device, of its dtype, contiguous and 16-byte aligned."""
    for name, (t, dtype) in operands.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, x on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be contiguous and 16-byte aligned")


def check_widths(op: str, **widths: int) -> None:
    """16-byte row loads need every width to be a multiple of 8 elements."""
    for name, n in widths.items():
        if n < 8 or n % 8:
            raise ValueError(f"{op}: {name} = {n} must be a positive multiple of 8")


@functools.lru_cache(maxsize=None)
def c_entry(library: str, entry: str, argtypes: tuple):
    """The built library's C function, with its ctypes signature (the
    stream comes last)."""
    from gligen_tpu_torch.ops.cuda_build import load_library

    fn = getattr(load_library(library), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, PTR]
    return fn


class Kernel:
    """One C entry point ``entry`` of ``csrc/<library>.cu`` taking
    ``argtypes`` and then the stream, returning a cudaError_t.
    ``launches`` counts calls that launched it (never plain-version
    calls), so a run can show that its path went through the kernel;
    ``routes`` counts them by route (``ROUTES``: e.g. the bf16 kernel's
    and the fp32 route's).  The counts take a lock: a server launches from
    several threads at once."""

    library = ""
    entry = ""
    argtypes: tuple = ()
    ROUTES: tuple = ()

    def __init__(self):
        self.launches = 0
        self.routes = dict.fromkeys(self.ROUTES, 0)
        self._count_lock = threading.Lock()

    def _launch(self, device: torch.device, *args, entry: Optional[Tuple[str, tuple]] = None,
                route: Optional[str] = None) -> None:
        """Launch ``entry`` ((name, argtypes); this wrapper's own by default)
        on ``args`` and count it, under ``route`` too when given."""
        name, argtypes = entry or (self.entry, self.argtypes)
        err = c_entry(self.library, name, argtypes)(*args,
                                                    torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        with self._count_lock:
            self.launches += 1
            if route is not None:
                self.routes[route] += 1


def split_k(units: int, slices: int, unit_flops: float, part_bytes: float,
            most: int = SPLIT_MOST) -> int:
    """Into how many ranges a 3xTF32 kernel (the fp32 routes of
    csrc/fused_proj.cu and csrc/fused_conv.cu) cuts the k-slices of its
    ``units`` output tiles of ``unit_flops`` tensor-core operations each:
    the fewest of 1 .. min(most, slices) that minimise the estimated time,
    waves of blocks (one an SM) times a block's share of its tile at the
    TF32 rate, plus the in-order reduction of the partial products
    (``part_bytes`` a range, written once and read once) at the memory
    rate and its launch."""

    def cost(s: int) -> float:
        waves = -(-units * s // SMS)
        reduce = REDUCE_LAUNCH_S + 2 * s * part_bytes / HBM_BYTES_PER_S if s > 1 else 0.0
        return waves * unit_flops / s / TF32_FLOP_PER_SM_S + reduce

    return min(range(1, max(1, min(most, slices)) + 1), key=lambda s: (cost(s), s))


def kernel_dtype(op: str, x: torch.Tensor) -> torch.dtype:
    """The dtype of a kernel that has a bf16 kernel and an fp32 route: x's,
    if it is one of the two; anything else raises."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{op}: x must be bfloat16 or float32 (the fp32 route), got {x.dtype}")
    return x.dtype


class _ChainVJP(torch.autograd.Function):
    """Forward: ``run`` (the kernel, or its plain version on the CPU).
    Backward: the vector-Jacobian product of ``chain``, a reference form
    of the same function in plain PyTorch ops, recomputed from the saved
    inputs (the JAX package's ``custom_vjp`` pattern, e.g.
    pallas_matmul.py:157-163)."""

    @staticmethod
    def forward(ctx, run, chain, *inputs):
        out = run(*inputs)
        ctx.chain = chain
        ctx.save_for_backward(*inputs)
        return out

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if x is None else x.detach().requires_grad_(need)
                      for x, need in zip(ctx.saved_tensors, needs)]
            outs = ctx.chain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = iter(torch.autograd.grad(outs, [x for x, need in zip(leaves, needs) if need],
                                       grads, allow_unused=True))
        return (None, None, *(next(got) if need else None for need in needs))


def differentiable(run: Callable, chain: Callable, *inputs):
    """``run(*inputs)`` whose gradient is that of ``chain(*inputs)``.
    ``inputs`` are tensors or None; every other argument is bound into
    ``run`` and ``chain``."""
    return _ChainVJP.apply(run, chain, *inputs)
