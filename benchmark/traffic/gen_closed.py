"""One client in a closed loop of ``GenerationPipeline.generate`` requests.

Each request: ``batch`` images at ``image_size``^2, PLMS over ``steps`` steps,
classifier-free guidance at ``guidance`` as one 2B-row UNet call, the
configuration's alpha stages; one seeded prompt of ``prompt_tokens``
token ids a request (CLIP's start and end tokens around them, padded
with the end token), and per image the grounding of the configuration's
tokenizer: ``boxes_per_image`` live boxes of 30 with standard-normal
phrase embeddings (text), or a seeded sparse uint8 edge map (hed), which
also feeds the downsampler.  Every seed gives the same sizes; only the
values and their order differ.

The window opens at the first request after set-up and closes when the
last request begun before ``seconds`` have passed is complete.  After it,
a sample of the images, drawn from the seed, is generated again by the
plain reference and compared (``check``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import program, weights as bench_weights
from benchmark.reference import generate as ref_generate
from benchmark.reference import model as M

VOCAB_START, VOCAB_END = 49406, 49407
MAP_POOL = 16
WARMUP_INDEX = 1 << 30


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *stream])


class Inputs:
    """The requests of one seed, made on the host (noise on the card)."""

    def __init__(self, cfg: Dict, wl: Dict, seed: int):
        self.wl, self.seed = wl, seed
        self.tokenizer = cfg["unet"]["grounding_tokenizer"]["target"]
        self.batch = wl["batch"]
        self.phrase_dim = cfg["unet"]["grounding_tokenizer"]["params"].get("in_dim", 768)
        if self.tokenizer == "hed":
            rng = _rng(seed, 2)
            self.maps = []
            for _ in range(MAP_POOL):
                edges = rng.random((512, 512)) < wl["edge_density"]
                gray = (edges * rng.integers(128, 256, (512, 512))).astype(np.uint8)
                self.maps.append(np.repeat(gray[..., None], 3, axis=-1))

    def request(self, i: int) -> Dict:
        rng, b, wl = _rng(self.seed, 1, i), self.batch, self.wl
        lo, hi = wl["prompt_tokens"]
        n = int(rng.integers(lo, hi + 1))
        ids = np.full((77,), VOCAB_END, np.int64)
        ids[0] = VOCAB_START
        ids[1:n + 1] = rng.integers(1, VOCAB_START, n)
        uc = np.full((77,), VOCAB_END, np.int64)
        uc[0] = VOCAB_START
        out = {"ids": np.repeat(ids[None], b, 0), "uc": np.repeat(uc[None], b, 0)}
        if self.tokenizer == "text":
            lo, hi = wl["boxes_per_image"]
            live = rng.integers(lo, hi + 1, size=(b, 1))
            corners = np.sort(rng.random((b, 30, 2, 2)), axis=2).astype(np.float32)
            out["grounding"] = {
                "boxes": corners.transpose(0, 1, 3, 2).reshape(b, 30, 4)[..., [0, 2, 1, 3]],
                "masks": (np.arange(30)[None] < live).astype(np.float32),
                "positive_embeddings": rng.standard_normal((b, 30, self.phrase_dim)).astype(np.float32)}
            out["extra"] = None
        else:
            edge = np.stack([self.maps[k] for k in rng.integers(0, MAP_POOL, b)])
            out["grounding"] = {"hed_edge": edge, "mask": np.ones(b, np.float32)}
            out["extra"] = edge
        return out

    def noise(self, i: int, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed((self.seed * 1_000_003 + i) % 2**63)
        lat = self.wl["image_size"] // 8
        return torch.randn((self.batch, lat, lat, 4), generator=gen, device=device)


class Sample:
    """A uniform sample of ``k`` of the images the window completes, drawn
    from the seed as they come (reservoir sampling), so that only the
    sampled images stay on the card."""

    def __init__(self, seed: int, k: int):
        self.rng, self.k, self.seen = _rng(seed, 7), k, 0
        self.kept: List = []  # [((request, row), image)]

    def offer(self, i: int, images: torch.Tensor) -> None:
        for r in range(images.shape[0]):
            if self.seen < self.k:
                self.kept.append(((i, r), images[r].clone()))
            else:
                j = int(self.rng.integers(0, self.seen + 1))
                if j < self.k:
                    self.kept[j] = ((i, r), images[r].clone())
            self.seen += 1


def _generate(pipe, req: Dict, noise, steps: int, alpha, guidance: float):
    kw = {"grounding_extra": req["extra"]} if req["extra"] is not None else {}
    return pipe.generate(req["ids"], req["uc"], req["grounding"], steps=steps,
                         guidance_scale=guidance, alpha_stages=alpha,
                         latent_size=noise.shape[1], noise=noise, **kw)


def run(cell: str, cfg: Dict, wl: Dict, seed: int, seconds: float, trace: bool, device,
        t0: float, fault: Optional[str] = None) -> Dict:
    """One run of the cell: set-up, the window, the check.  ``fault``
    (tests only) breaks the timed path underneath."""
    from gligen_tpu_torch.inference.pipeline import GenerationPipeline

    from benchmark import spans as bench_spans
    from benchmark import trace as bench_trace

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    program.apply_env(cfg)
    shapes = program.all_shapes(cfg)
    W = bench_weights.make(shapes, seed, device)
    sync()
    t_weights = time.perf_counter()
    comps = program.build(cfg, W, device)
    del W
    pipe = GenerationPipeline(comps)
    sync()
    t_build = time.perf_counter()
    inputs = Inputs(cfg, wl, seed)
    steps, guidance, alpha = wl["steps"], wl["guidance"], cfg["alpha_stages"]
    if fault:
        from benchmark.faults import break_generation
        break_generation(fault, pipe)

    # warm-up: one short request at the cell's batch that runs UNet calls
    # with and without the fusers (and both first convs) and the decode
    _generate(pipe, inputs.request(WARMUP_INDEX), inputs.noise(WARMUP_INDEX, device),
              wl["warmup_steps"], [0.5, 0.0, 0.5], guidance)
    sync()
    setup_s = time.perf_counter() - t0
    setup_parts = {"start_and_weights": t_weights - t0, "build": t_build - t_weights,
                   "warmup": t0 + setup_s - t_build}

    spans = bench_spans.Spans() if trace else None
    if spans is not None:
        spans.install(comps)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    requests: List[Dict] = []
    sample = Sample(seed, wl["check"]["images"])
    profile = None
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        req = inputs.request(i)
        noise = inputs.noise(i, device)
        if spans is not None:
            spans.new_request()
        t_req, c_req = time.perf_counter(), time.process_time()
        ok = True
        try:
            if trace and i == wl["profile_request"] and on_card:
                run_req = spans.ranged(lambda: _generate(pipe, req, noise, steps, alpha, guidance),
                                       "bench.request")
                img, tr, wall = bench_trace.profiled(run_req)
                profile = bench_trace.summarize(tr, wall, spans.host)
                del tr
            else:
                img = _generate(pipe, req, noise, steps, alpha, guidance)
                sync()
            sample.offer(i, img)
            del img
        except Exception as exc:  # a failed request counts; the loop goes on
            ok = False
            print(f"request {i} failed: {type(exc).__name__}: {exc}", flush=True)
        requests.append({"start": t_req - start, "end": time.perf_counter() - start,
                         "cpu_s": time.process_time() - c_req, "images": inputs.batch, "ok": ok,
                         "profiled": trace and i == wl["profile_request"] and on_card})
        i += 1
    window_s = requests[-1]["end"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    readings = spans.readings() if spans is not None else {}

    del pipe, comps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check = check_images(cfg, wl, seed, inputs, sample.kept, device)
    record = {"kind": "gen", "cell": cell, "cfg": cfg, "wl": wl, "setup_s": setup_s,
              "setup_parts": setup_parts,
              "window_s": window_s, "requests": requests, "memory_peak_bytes": peak,
              "profile": profile, **readings, **check}
    return record


def check_images(cfg: Dict, wl: Dict, seed: int, inputs: Inputs, kept, device) -> Dict:
    """The plain reference (fp32, TF32 off) over the ``kept`` images
    (``Sample``: ``wl["check"]["images"]`` of those the window completed,
    drawn from the seed), each compared by its mean absolute pixel
    difference (images in [0, 1]).  Returns the readings, each with its
    limit, and ``correct``."""
    spec = wl["check"]
    if not kept:
        return {"correct": False, "check": {"images_compared": (0, spec["images"])}}
    pick = [slot for slot, _ in kept]
    ref = reference_images(cfg, wl, seed, inputs, pick, device)
    maes, peaks = [], []
    for (_, got), want in zip(kept, ref):
        got = got.float().to(want.device)
        diff = (got - want).abs()
        maes.append(float(diff.mean()))
        peaks.append(float(diff.max()))
    worst = max(maes)
    limit = spec["limits"]["image_mae"]
    readings = {"image_mae": (worst, limit), "images_compared": (len(pick), spec["images"])}
    correct = worst <= limit and len(pick) == spec["images"]
    return {"correct": correct, "check": readings, "check_detail": {"maes": maes, "max_abs": peaks,
                                                                     "picked": pick}}


def reference_images(cfg: Dict, wl: Dict, seed: int, inputs: Inputs, pick, device,
                     precision: str = "fp32") -> List[torch.Tensor]:
    """The reference's images of the ``pick``ed (request, row) slots, from
    the benchmark's own weights and inputs, ``block_rows`` rows at a time."""
    on_card = torch.device(device).type == "cuda"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        W = bench_weights.make(program.all_shapes(cfg), seed, device)
        parts = {p: bench_weights.select(W, p) for p in ("unet", "vae", "text")}
        P = M.Precision(precision)
        out, by_req = [None] * len(pick), {}
        for k, (i, r) in enumerate(pick):
            by_req.setdefault(i, []).append((k, r))
        block = wl["check"]["block_rows"]
        with torch.no_grad():
            for i, rows in by_req.items():
                req = inputs.request(i)
                noise = inputs.noise(i, device)
                for s in range(0, len(rows), block):
                    chunk = rows[s:s + block]
                    sel = [r for _, r in chunk]
                    take = lambda a: torch.as_tensor(np.asarray(a)[sel], device=device)
                    imgs = ref_generate.generate(
                        parts, cfg, take(req["ids"]), take(req["uc"]),
                        {k: take(v) for k, v in req["grounding"].items()}, noise[sel],
                        wl["steps"], wl["guidance"], cfg["alpha_stages"], P,
                        grounding_extra=None if req["extra"] is None else take(req["extra"]))
                    for (k, _), img in zip(chunk, imgs):
                        out[k] = img
        del W, parts
        if on_card:
            torch.cuda.empty_cache()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
