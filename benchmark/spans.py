"""The benchmark's own spans around the program's layers (a traced run
only): each wrapper keeps a ``bench.<layer>`` host span (name and the
host's Unix clock in ns at its start and end), which names the device's
idle gaps in the profiled stretch (``trace.named_gaps``: the profiler
traces the device alone, since tracing every host op would slow the host
and open gaps of its own), and the UNet and grounding wrappers record CUDA
events around each call for the whole window.  The wrappers are set on the
component instances; the program is not edited."""

from __future__ import annotations

import functools
import time
from typing import Dict, List


class Spans:
    def __init__(self):
        self.unet_events: List = []        # (start, end) CUDA events of every UNet call
        self.grounding_events: List = []   # per request: [(start, end), ...]
        self.host: List = []               # (name, start ns, end ns) of every span

    def install(self, comps) -> None:
        """Wrap the UNet's forward, its grounding tokenizer and
        downsampler, the text encoder and the VAE decode of ``comps``
        (a ``GligenComponents``)."""
        unet = comps.unet
        unet.forward = self._timed(unet.forward, "bench.unet_call", self.unet_events.append)
        unet.grounding_tokens = self._timed(unet.grounding_tokens, "bench.grounding",
                                            self._add_grounding)
        if unet.downsample_net is not None:
            unet.downsampler_features = self._timed(unet.downsampler_features,
                                                    "bench.downsampler", self._add_grounding)
        comps.vae.decode = self.ranged(comps.vae.decode, "bench.vae_decode")
        comps.text_encoder.encode = self.ranged(comps.text_encoder.encode, "bench.text_encode")

    def new_request(self) -> None:
        self.grounding_events.append([])

    def _add_grounding(self, events) -> None:
        if self.grounding_events:
            self.grounding_events[-1].append(events)

    def ranged(self, fn, name):
        """``fn`` inside a host span ``name``."""
        @functools.wraps(fn)
        def wrapped(*a, **k):
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                self.host.append((name, t0, time.time_ns()))

        return wrapped

    def _timed(self, fn, name, add):
        """``fn`` inside a host span, its (start, end) CUDA events handed to ``add``."""
        import torch

        fn = self.ranged(fn, name)

        @functools.wraps(fn)
        def wrapped(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            add((start, end))
            return out

        return wrapped

    def readings(self) -> Dict[str, List[float]]:
        """Milliseconds of every UNet call, and the grounding layer's
        milliseconds of every request (its calls summed)."""
        import torch

        torch.cuda.synchronize()
        return {"unet_call_ms": [s.elapsed_time(e) for s, e in self.unet_events],
                "grounding_ms": [sum(s.elapsed_time(e) for s, e in req)
                                 for req in self.grounding_events if req]}
