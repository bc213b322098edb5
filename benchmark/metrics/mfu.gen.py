"""mfu.gen: the model FLOPs of the window's completed requests (products
and convolutions, counted from the reference's shapes) over the window
times the H100's bf16 peak (989 TFLOP/s), in %.  A traced run leaves its
profiled request out of both."""

from benchmark.work import flops


def read(record):
    if record.get("kind") != "gen":
        return None
    reqs = record["requests"]
    done = sum(1 for r in reqs if r["ok"] and not r.get("profiled"))
    if not done:
        return None
    window = record["window_s"] - sum(r["end"] - r["start"] for r in reqs if r.get("profiled"))
    work = flops.request_work(record)
    return 100.0 * done * work["flops"] / (window * flops.BF16_FLOP_PER_S)
