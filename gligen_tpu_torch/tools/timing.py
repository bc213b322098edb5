"""Timing, bounds and seeded weights shared by ``chip_smoke.py`` and the
tools of this package.

  * ``timed``: device ms (and host ms) per call on one NVIDIA GPU, the
    calls queued behind a spinning kernel and timed by CUDA events;
    ``ms_per_call`` the same on the card and the host's wall time on the
    CPU, where the tests run the tools at a small size;
  * ``bound``: a kernel's least time on one H100 SXM, from its bytes and
    its operations;
  * ``dezero_``: random values for a fresh model's zero-initialised
    weights, so that its output depends on every layer;
  * ``card_line`` / ``card_setup``: the card's name and power limit.

Only ``torch`` is imported, and only inside the functions.
"""

from __future__ import annotations

import subprocess
import time

# One NVIDIA H100 SXM (the data sheet's dense rates, 700 W): the least time
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
TF32_TENSOR_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12

SLEEP_CYCLES = 50_000_000  # ~25 ms of one spinning block at the H100's clock


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def card_setup(tool: str) -> str:
    """Exit unless a CUDA card is present; turn TF32 off for matmul and
    cuDNN (the kernels and their yardsticks compare bf16 and fp32 math);
    return ``card_line()``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card_line()


def bound(nbytes: float, ops: float, rate: float = BF16_TENSOR_FLOP_PER_S):
    """(least ms, "bytes" or "operations") for moving ``nbytes`` (each input
    read once, each output written once) and doing ``ops`` at ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn, iters: int = 10):
    """(device ms, host ms) per call of ``fn``, the mean of ``iters`` calls
    after one warm-up.  The calls are queued behind a spinning kernel and
    timed by CUDA events once the host has queued them all, so the device
    runs them back to back: the device time leaves out the host's time to
    queue each call (the wrapper's checks, allocation and launch), which is
    the host time.  The spin is lengthened until the host gets ahead."""
    import torch

    fn()
    torch.cuda.synchronize()
    for cycles in (SLEEP_CYCLES * 4**i for i in range(4)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        queued_ahead = not start.query()  # the device is still spinning
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters, host_ms
    raise RuntimeError(f"the host took {host_ms:.3f} ms per call: too slow to queue "
                       f"{iters} calls ahead of the device")


def time_ms(fn, iters: int = 10) -> float:
    return timed(fn, iters)[0]


def ms_per_call(fn, iters: int, device) -> float:
    """Milliseconds per call of ``fn``: on the card the device time
    (``timed``); on the CPU, where the tests run the tools at a small size,
    the host's wall time per call after one warm-up, which is no device
    number."""
    import torch

    if torch.device(device).type == "cuda":
        return timed(fn, iters)[0]
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def dezero_(module, generator) -> None:
    """Random values for the zero-initialised weights (UNet out_2,
    out_layers_3, proj_out), 0.5 for every fuser's gates, N(0, 1) for the
    position nets' zero-initialised features (every ``null_*`` feature, the
    keypoint net's person and keypoint identities) and U(0.1, 1) for
    ConvNeXt's layer scales (``gamma``, 1e-6 fresh), so the output depends
    on every layer: a fresh model otherwise predicts eps = 0, every
    keypoint token of a fresh keypoint net is the same, and a ConvNeXt
    block's residual branch is 1e-6 of its input."""
    import torch

    from gligen_tpu_torch.models.grounding.convnext import ConvNeXtBlock
    from gligen_tpu_torch.models.layers import Conv2d, Dense, GatedFuser

    zero_features = ("person_embeddings", "keypoint_embeddings")
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Dense, Conv2d)) and m.zero_init:
                std = m.weight[0].numel() ** -0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                           device=m.weight.device) * std)
            elif isinstance(m, GatedFuser):
                m.alpha_attn.fill_(0.5)
                m.alpha_dense.fill_(0.5)
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.copy_(0.1 + 0.9 * torch.rand(m.gamma.shape, generator=generator,
                                                     device=m.gamma.device))
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("null_") or name in zero_features:
                    p.copy_(torch.randn(p.shape, generator=generator, device=p.device))
