"""setup_s: process start to the window's start (weights, build, warm-up;
on a checkout's first run the kernels' builds too), by the host clock."""


def read(record):
    return record.get("setup_s")
