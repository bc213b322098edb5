"""attn_roofline.gen: the flash forward's share of its roofline over one
profiled request: the sum over every attention site of the request (UNet
calls and VAE decode, shapes from the reference) of its least time (its
FLOPs at the bf16 peak or its bytes at the HBM rate, the longer), over the
device time of the flash forward kernels in the trace, in %."""

from benchmark.trace import FLASH_FWD
from benchmark.work import flops


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "gen" or not prof:
        return None
    flash_ms = sum(prof["by_cat"].get(c, (0.0, 0))[0] for c in FLASH_FWD)
    if flash_ms <= 0:
        return None
    work = flops.request_work(record)
    least = sum(flops.attention_least_s(s) for s in work["attention_sites"])
    return 100.0 * least / (flash_ms / 1e3)
