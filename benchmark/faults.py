"""Faults planted under the timed path, for the tests that show the check
fails them: each wraps what the program produces, and none is used by a
run of the benchmark."""

from __future__ import annotations

import functools

GENERATION = ("answer_altered", "stale_state", "half_batch")
TRAINING = ("stale_state", "half_batch")


def break_generation(fault: str, pipe) -> None:
    """``answer_altered``: the first image of each request comes out
    brighter; ``stale_state``: the sampler returns its starting latent, as
    if every step returned its state unchanged; ``half_batch``: only the
    first half of a request's rows is generated and returned twice."""
    import torch

    generate = pipe.generate
    if fault == "answer_altered":
        def altered(*a, **k):
            img = generate(*a, **k).clone()
            img[0] = (img[0] + 0.1).clamp(0.0, 1.0)
            return img

        pipe.generate = altered
    elif fault == "stale_state":
        import gligen_tpu_torch.inference.pipeline as pipeline

        pipeline.plms_sample = lambda eps_fn, schedule, x_init, **k: x_init.float()
    elif fault == "half_batch":
        def half(ids, uc, grounding, *, noise, grounding_extra=None, **k):
            h = len(ids) // 2
            cut = lambda x: None if x is None else x[:h]
            img = generate(ids[:h], uc[:h], {n: v[:h] for n, v in grounding.items()},
                           noise=noise[:h], grounding_extra=cut(grounding_extra), **k)
            return torch.cat([img, img])

        pipe.generate = half
    else:
        raise ValueError(f"no generation fault {fault!r}")


def break_training(fault: str, step):
    """``stale_state``: the step leaves the parameters and the optimizer
    as they were; ``half_batch``: half of each batch is left out and the
    mean taken over the rest."""
    if fault == "stale_state":
        @functools.wraps(step)
        def stale(state, batch, **k):
            keep = state.optimizer.step
            state.optimizer.step = lambda *a, **kw: None
            try:
                return step(state, batch, **k)
            finally:
                state.optimizer.step = keep

        return stale
    if fault == "half_batch":
        @functools.wraps(step)
        def half(state, batch, draws, **k):
            h = batch["image"].shape[0] // 2
            cut = lambda x: {n: cut(v) for n, v in x.items()} if isinstance(x, dict) else x[:h]
            draws = {n: (v if v.dim() == 0 else v[:h]) for n, v in draws.items()}
            return step(state, cut(batch), draws=draws, **k)

        return half
    raise ValueError(f"no training fault {fault!r}")
