"""mfu.train: the model FLOPs of the window's completed steps (forward
and backward without the remat recompute, counted from the reference's
shapes) over the window times the H100's bf16 peak (989 TFLOP/s), in %.
A traced run leaves its profiled step out of both."""

from benchmark.work import flops


def read(record):
    if record.get("kind") != "train":
        return None
    steps = record["requests"]
    done = sum(1 for r in steps if r["ok"] and not r.get("profiled"))
    if not done:
        return None
    window = record["window_s"] - sum(r["end"] - r["start"] for r in steps if r.get("profiled"))
    work = flops.train_work(record)
    return 100.0 * done * work["flops"] / (window * flops.BF16_FLOP_PER_S)
