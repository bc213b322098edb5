"""The pipelined completion of the serving micro-batcher, measured
(counterpart of the JAX package's ``tools/bench_serve_overlap.py``): batch
N's copy to the host, its distribution and its PNG encodes should overlap
batch N+1 on the card.

A full-width ``ServingSession`` (SD-1.4 GLIGEN box+text, random de-zeroed
weights, bf16; no HTTP, which adds nothing to throughput) takes
``--clients`` client threads, each sending ``--reqs`` back-to-back
requests of ``--batch`` images at ``--steps`` PLMS steps, in three arms:

  * pipelined (the server's default): the batcher's worker queues batch
    N+1 on the generation stream while a collector waits on batch N's
    event and copies it on the copy stream;
  * serialized: ``MicroBatcher._execute(sync=True)``, the copy and the
    distribution on the worker before the next call is queued;
  * pipelined again, to bracket drift; the gain is the slower pipelined
    arm's img/s over the serialized arm's.

``idle_share`` runs one pipelined pair (one request from each of two
clients) as it is and then traced: the card's idle share is 1 - device
busy / the unprofiled wall.

    python3 gligen_tpu_torch/tools/bench_serve_overlap.py [--clients 2] [--reqs 3]
        [--steps 50] [--batch 8]

It runs on the card; the tests call ``run`` on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path
from typing import Dict

REPO = Path(__file__).resolve().parents[2]

INSTRUCTION = {
    "prompt": "a teddy bear next to a bird",
    "phrases": ["a teddy bear"],
    "locations": [[0.1, 0.2, 0.5, 0.8]],
}
ARMS = ("pipelined", "serialized", "pipelined2")


def build_session(device="cuda", window_ms: int = 5, seed: int = 0):
    """A full-width box+text session on ``device``: random weights,
    de-zeroed as the CLI's ``--dezero`` does, the hash tokenizer and CLIP
    text features."""
    import torch

    from gligen_tpu_torch.data.tokenizer import HashTokenizer
    from gligen_tpu_torch.inference.cli import FeatureExtractor, dezero_
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
    from gligen_tpu_torch.serving.server import ServingSession

    comps = GligenComponents.create(dtype=torch.bfloat16, seed=seed, device=device)
    dezero_(comps.unet)
    pipe = GenerationPipeline(comps)
    pipe.tokenizer, pipe.unet_config = HashTokenizer(), {}
    features = FeatureExtractor(comps.text_encoder, pipe.tokenizer)
    return ServingSession(pipe, pipe.tokenizer, features, batch_window_ms=window_ms)


def drive(session, clients: int, reqs: int, steps: int, batch: int, seed0: int = 1) -> float:
    """``clients`` threads, each sending ``reqs`` requests one after the
    other; the seconds until the last answer.  Raises on any failed or
    short answer."""
    errors = []

    def client(c: int):
        for r in range(reqs):
            try:
                out = session.generate(dict(INSTRUCTION, batch_size=batch, steps=steps,
                                            seed=seed0 + c * reqs + r))
                if len(out["images"]) != batch:
                    raise RuntimeError(f"{len(out['images'])} images for batch {batch}")
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=3600)
    dt = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"bench_serve_overlap: {errors or 'a client did not finish'}")
    return dt


def run(session, clients: int = 2, reqs: int = 3, steps: int = 50, batch: int = 8
        ) -> Dict[str, float]:
    """img/s of each arm of ``ARMS`` and ``gain_pct``, after one warm
    request.  The session must batch (``batch_window_ms`` > 0)."""
    batcher = session.batcher
    if batcher is None:
        raise ValueError("bench_serve_overlap needs a session with batch_window_ms > 0")
    execute = batcher._execute
    drive(session, 1, 1, steps, batch, seed0=0)
    rates = {}
    try:
        for arm in ARMS:
            batcher._execute = (execute if arm != "serialized" else
                                lambda b, take, kw, sync=False: execute(b, take, kw, sync=True))
            rates[arm] = clients * reqs * batch / drive(session, clients, reqs, steps, batch)
    finally:
        batcher._execute = execute
    rates["gain_pct"] = 100 * (min(rates["pipelined"], rates["pipelined2"])
                               / rates["serialized"] - 1)
    return rates


def idle_share(session, steps: int = 50, batch: int = 8):
    """(unprofiled wall ms, profiled wall ms, device busy ms) of a
    pipelined pair: two clients, one request each, run once as it is and
    once traced (card only).  The profiler slows the host, so the idle
    share is 1 - busy over the unprofiled wall, and at most 1 - busy over
    the profiled one."""
    from gligen_tpu_torch.tools.perf_probe import device_breakdown, traced

    plain = drive(session, 2, 1, steps, batch) * 1e3
    wall, trace = traced(lambda: drive(session, 2, 1, steps, batch) * 1e3)
    _, busy, _, _ = device_breakdown(trace)
    return plain, wall, busy


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--reqs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from gligen_tpu_torch.tools.timing import card_setup

    card = card_setup("bench_serve_overlap")
    session = build_session()
    try:
        rates = run(session, args.clients, args.reqs, args.steps, args.batch)
        n = args.clients * args.reqs
        for arm in ARMS:
            print(f"{arm}: {rates[arm]:.4f} img/s ({n} requests of batch {args.batch}, "
                  f"{args.steps} steps, {args.clients} clients) on {card}", flush=True)
        print(f"pipelined vs serialized: {rates['gain_pct']:+.2f}% on {card}")
        plain, wall, busy = idle_share(session, args.steps, args.batch)
    finally:
        session.close()
    print(f"pipelined pair: wall {plain:.1f} ms, traced {wall:.1f} ms with the device busy "
          f"{busy:.1f} ms: idle {1 - busy / plain:.1%} of the unprofiled wall, "
          f"{1 - busy / wall:.1%} of the traced one on {card}")
    return rates


if __name__ == "__main__":
    main()
