"""backward_ms.train: the device time of a step's backward (from the end
of its UNet forward to the optimizer's start, the remat recompute
included), by CUDA events the benchmark records there, the mean over the
window's steps."""


def read(record):
    ms = record.get("backward_ms") if record.get("kind") == "train" else None
    return sum(ms) / len(ms) if ms else None
