"""unet_call_ms.gen: the mean device time of a UNet call over the window,
from CUDA events that the benchmark's wrapper records around each UNet
forward (``spans.py``); calls with and without the fusers together."""


def read(record):
    calls = record.get("unet_call_ms") if record.get("kind") == "gen" else None
    return sum(calls) / len(calls) if calls else None
