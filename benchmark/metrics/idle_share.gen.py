"""idle_share.gen: the device's idle share of one profiled request,
1 - busy / wall, busy the union of its kernel and copy intervals in the
trace and wall the host clock around the same request, in %."""


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "gen" or not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
