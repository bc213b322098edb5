"""attn_bwd_roofline.train: the flash backward's share of its roofline
over one profiled step: the sum over the step's attention sites of the
least time of the gradients each needs (``work.flops.attention_bwd_least_s``:
dq alone at the cross-attention, dq, dk and dv elsewhere), over the
device time of the flash backward kernels (dq, dk/dv) in the trace, in %."""

from benchmark.trace import FLASH_BWD
from benchmark.work import flops


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "train" or not prof:
        return None
    bwd_ms = sum(prof["by_cat"].get(c, (0.0, 0))[0] for c in FLASH_BWD)
    if bwd_ms <= 0:
        return None
    least = sum(flops.attention_bwd_least_s(s) for s in flops.train_work(record)["attention_sites"])
    return 100.0 * least / (bwd_ms / 1e3)
