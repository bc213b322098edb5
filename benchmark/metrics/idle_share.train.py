"""idle_share.train: the device's idle share of one profiled train step,
1 - busy / wall, busy the union of its kernel and copy intervals in the
trace and wall the host clock around the same step, in %."""


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "train" or not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
