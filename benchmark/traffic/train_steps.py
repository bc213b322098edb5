"""Back-to-back steps of the program's train step (``make_train_step``,
what ``training/trainer.py`` calls): each step a new batch of ``batch``
rows made on the card from the seed (images uniform in [-1, 1] at
``image_size``^2, a caption of ``prompt_tokens`` token ids a row,
``boxes_per_image`` live boxes of 30 with standard-normal phrase
embeddings) and its draws (posterior noise, timesteps, diffusion noise,
the grounding drop), AdamW at ``lr`` with no warmup (a job past its
warmup), EMA off, remat and the kernels as the configuration states.

Set-up builds the train state once, drives it through the first
``check_steps`` steps (which also warm it up) and hands the same state to
the window.  The window opens at the first step after set-up and closes
when the last step begun before ``seconds`` have passed is complete.
After it the reference follows the first ``check_steps`` steps from the
same weights, batches and draws (``check``)."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from benchmark import program, weights as bench_weights
from benchmark.reference import model as M
from benchmark.reference import train as ref_train

VOCAB_START, VOCAB_END = 49406, 49407
ADAM_BETA1 = 0.9


def step_inputs(cfg: Dict, wl: Dict, seed: int, k: int, device):
    """(batch, draws) of step ``k`` (1 first), made on ``device``."""
    gen = torch.Generator(device=device).manual_seed((seed * 7_919 + 104_729 * k) % 2**63)
    b, size = wl["batch"], wl["image_size"]
    lat = size // 8
    dim = cfg["unet"]["grounding_tokenizer"]["params"].get("in_dim", 768)
    u = lambda *s: torch.rand(s, generator=gen, device=device)
    n = lambda *s: torch.randn(s, generator=gen, device=device)
    lo, hi = wl["prompt_tokens"]
    lens = lo + (u(b) * (hi - lo + 1)).long()
    pos = torch.arange(77, device=device)
    words = 1 + (u(b, 77) * (VOCAB_START - 1)).long()
    ids = torch.where(pos[None] <= lens[:, None], words, VOCAB_END)
    ids[:, 0] = VOCAB_START
    ids = torch.where(pos[None] == lens[:, None] + 1, VOCAB_END, ids)
    blo, bhi = wl["boxes_per_image"]
    live = blo + (u(b, 1) * (bhi - blo + 1)).long()
    corners = torch.sort(u(b, 30, 2, 2), dim=2).values
    boxes = corners.transpose(2, 3).reshape(b, 30, 4)[..., [0, 2, 1, 3]]
    batch = {"image": u(b, size, size, 3) * 2 - 1, "input_ids": ids,
             "grounding": {"boxes": boxes, "masks": (torch.arange(30, device=device)[None] < live).float(),
                           "positive_embeddings": n(b, 30, dim)}}
    draws = {"posterior": n(b, lat, lat, 4), "u_t": u(b), "noise": n(b, lat, lat, 4),
             "u_drop": u()}
    return batch, draws


def run(cell: str, cfg: Dict, wl: Dict, seed: int, seconds: float, trace: bool, device,
        t0: float, fault: Optional[str] = None) -> Dict:
    from benchmark import spans as bench_spans
    from benchmark import trace as bench_trace

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    first = first_steps(cfg, wl, seed, device, fault)
    comps, state, step = first["comps"], first["state"], first["step"]
    setup_s = time.perf_counter() - t0
    setup_parts = {"start_and_weights": first["t_weights"] - t0,
                   "build": first["t_build"] - first["t_weights"],
                   "first_steps": t0 + setup_s - first["t_build"]}

    phases = Phases(comps, state) if (trace and on_card) else None
    spans = bench_spans.Spans() if phases is not None else None
    if spans is not None:
        comps.unet.forward = spans.ranged(comps.unet.forward, "bench.unet_forward")
        comps.vae.encode = spans.ranged(comps.vae.encode, "bench.vae_encode")
        comps.text_encoder.encode = spans.ranged(comps.text_encoder.encode, "bench.text_encode")
        state.optimizer.step = spans.ranged(state.optimizer.step, "bench.optimizer")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    steps: List[Dict] = []
    profile = None
    start = time.perf_counter()
    k = wl["check_steps"] + 1
    while time.perf_counter() - start < seconds:
        batch, draws = step_inputs(cfg, wl, seed, k, device)
        t_step, c_step = time.perf_counter(), time.process_time()
        profiled = trace and on_card and len(steps) == wl["profile_step"]
        ok = True
        try:
            if profiled:
                run_step = spans.ranged(lambda: step(state, batch, draws=draws), "bench.step")
                _, tr, wall = bench_trace.profiled(run_step)
                profile = bench_trace.summarize(tr, wall, spans.host)
                del tr
            else:
                step(state, batch, draws=draws)
                sync()
        except Exception as exc:  # a failed step counts; the loop goes on
            ok = False
            print(f"step {k} failed: {type(exc).__name__}: {exc}", flush=True)
        steps.append({"start": t_step - start, "end": time.perf_counter() - start,
                      "cpu_s": time.process_time() - c_step, "images": wl["batch"], "ok": ok,
                      "profiled": profiled})
        k += 1
    window_s = steps[-1]["end"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    readings = phases.readings() if phases is not None else {}

    del state, step, comps, first["state"], first["comps"], first["step"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check = check_steps(cfg, wl, seed, first["losses"], first["grad1"], first["after"], device)
    return {"kind": "train", "cell": cell, "cfg": cfg, "wl": wl, "setup_s": setup_s,
            "setup_parts": setup_parts, "window_s": window_s, "requests": steps,
            "memory_peak_bytes": peak, "profile": profile, **readings, **check}


def first_steps(cfg: Dict, wl: Dict, seed: int, device, fault: Optional[str] = None) -> Dict:
    """Set-up: the weights, the program's train state and step, and its
    first ``check_steps`` steps (the check's readings, and the warm-up):
    each step's loss, the first step's gradients as the optimizer got them
    (its first moment after one step over 1 - beta1) and the trainable
    parameters after the last step."""
    from gligen_tpu_torch.training.train_step import create_train_state, make_train_step

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    program.apply_env(cfg)
    W = bench_weights.make(program.all_shapes(cfg), seed, device)
    sync()
    t_weights = time.perf_counter()
    comps = program.build(cfg, W, device, use_checkpoint=True)
    del W
    state = create_train_state(comps.unet, base_lr=wl["lr"], weight_decay=0.0, warmup_steps=0,
                               total_steps=wl["total_steps"], scheduler_type="constant")
    step = make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule,
                           grounding_drop_prob=wl["grounding_drop_prob"])
    if fault:
        from benchmark.faults import break_training
        step = break_training(fault, step)
    sync()
    t_build = time.perf_counter()
    losses, grad1 = [], {}
    for k in range(1, wl["check_steps"] + 1):
        batch, draws = step_inputs(cfg, wl, seed, k, device)
        losses.append(step(state, batch, draws=draws)["loss"])
        if k == 1:
            grad1 = {n: (state.optimizer.state[p]["exp_avg"] / (1.0 - ADAM_BETA1)).detach()
                     for n, p in state.params.items() if p in state.optimizer.state}
    after = {n: p.detach().clone() for n, p in state.params.items()}
    losses = [float(x) for x in losses]
    sync()
    return {"comps": comps, "state": state, "step": step, "losses": losses, "grad1": grad1,
            "after": after, "t_weights": t_weights, "t_build": t_build}


class Phases:
    """CUDA events at the end of each step's UNet forward and at the
    optimizer's start: the backward's device time of every step (the
    loss's last few elementwise kernels included), with no profiler."""

    def __init__(self, comps, state):
        self.ends, self.marks = [], []
        unet, opt = comps.unet, state.optimizer
        fwd, opt_step = unet.forward, opt.step

        def forward(*a, **k):
            out = fwd(*a, **k)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.ends.append(ev)
            return out

        def step(*a, **k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((self.ends[-1], ev))
            return opt_step(*a, **k)

        unet.forward = forward
        opt.step = step

    def readings(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {"backward_ms": [a.elapsed_time(b) for a, b in self.marks]}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(want[k].double().norm()) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(_norm(got.get(k)) - norms[k]) / max(norms[k], med) for k in keep)


def _norm(t) -> float:
    """A leaf's norm; a leaf the program never produced reads 0."""
    return 0.0 if t is None else float(t.double().norm())


def check_steps(cfg: Dict, wl: Dict, seed: int, losses, grad1, after, device,
                precision: str = "fp32") -> Dict:
    """The reference (fp32, TF32 off) over the first ``check_steps`` steps
    from the benchmark's weights, batches and draws: each step's loss,
    the first step's gradients (the program's from its Adam state after
    one step) and the change of the trainable parameters after the last
    step, leaf by leaf.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the gradient and change numbers."""
    ref = reference_steps(cfg, wl, seed, device, precision)
    return compare(wl, losses, grad1, after, ref)


def reference_steps(cfg, wl, seed, device, precision: str = "fp32") -> Dict:
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        W = bench_weights.make(program.all_shapes(cfg), seed, device)
        parts = {p: bench_weights.select(W, p) for p in ("unet", "vae", "text")}
        inputs = [step_inputs(cfg, wl, seed, k, device) for k in range(1, wl["check_steps"] + 1)]
        out = ref_train.follow(parts, cfg, [b for b, _ in inputs], [d for _, d in inputs],
                               M.Precision(precision), wl["check"]["block_rows"], wl["lr"])
        out["start"] = {k: v for k, v in parts["unet"].items() if ref_train.trainable(k)}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def compare(wl, losses, grad1, after, ref) -> Dict:
    limits = wl["check"]["limits"]
    norms = {k: float(g.double().norm()) for k, g in ref["grad"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    grad_gap = leaf_gaps(grad1, ref["grad"], keep)
    got_d = {k: after[k].to(ref["start"][k].device) - ref["start"][k] for k in keep}
    want_d = {k: ref["params"][k] - ref["start"][k] for k in keep}
    change_gap = leaf_gaps(got_d, want_d, keep)
    readings = {"loss_gap": (loss_gap, limits["loss_gap"]),
                "grad_gap": (grad_gap, limits["grad_gap"]),
                "change_gap": (change_gap, limits["change_gap"])}
    correct = all(v <= lim for v, lim in readings.values())
    return {"correct": correct, "check": readings,
            "check_detail": {"losses": losses, "ref_losses": ref["losses"],
                             "leaves": len(keep), "left_out": len(norms) - len(keep)}}
