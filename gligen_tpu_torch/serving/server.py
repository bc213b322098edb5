"""Grounded-generation serving over HTTP (counterpart of
``gligen_tpu/serving/server.py``; reference L7: demo/app.py and the legacy
task_grounded_generation pipeline) on the port's pipeline.

    python -m gligen_tpu_torch.serving.server --ckpt random --dezero --warmup 1,2x512
        [--device cuda|cpu] [--batch_window_ms 25] [--port 7860]

The API is the JAX server's, field for field:

  POST /generate
    {"prompt": str, "negative_prompt": str?, "phrases": [...],
     "locations": [[x0,y0,x1,y1]...], "batch_size": n, "guidance_scale": s,
     "steps": 1..500, "seed": int,
     "alpha_type": [a,b,c] | null  (omitted: the demo's [0.3, 0, 0.7], or
        [1, 0, 0] for inpainting; null holds the gate at 1),
     "style_image": b64?, "text_mask"/"image_mask"?  (box+text+image models),
     "task": "generation"|"inpainting", "input_image": b64?,
     "actual_mask": b64?  (the user's inpaint sketch: nonzero = repaint),
     "keypoints": [[[x,y]*17]...]?, "map_image": b64?  (hed, canny, depth,
        normal, sem models), "resolution": 512|1024?}
  -> {"images": [b64 PNG, ...], "latency_sec": t}
  GET /health -> {"status": "ok"}
  GET /ready  -> 200 {"status": "ready"} | 503 {"status": "warming"}
                 | 503 {"status": "warmup_failed", "error": ...}
  GET /metrics -> {"uptime_sec", "requests", "images", "errors", "ready",
                   "latency_p50_sec", "latency_p95_sec", "latency_max_sec"}
  GET /       -> the demo page (``serving/demo_page.py``)
  any failure of a request -> 500 {"error": "<type>: <message>"}

Images in and out go through the port's codecs (``data/png.py``,
``data/jpeg.py``, ``data/transforms.py``), with no PIL: a request image is
PNG or baseline JPEG, anything else a ``ValueError`` naming its format.

On the card a session runs its work on three CUDA streams of its own
(``DeviceStreams``): the pipeline's calls on a generation stream, each
followed by an event; the copies of finished images into pinned memory on
a copy stream that waits for that event only, so the next batch's kernels,
already queued on the generation stream, never hold up a collector; and
the request threads' CLIP features on a stream of higher priority, so that
a phrase encode does not queue behind a batch in flight.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from gligen_tpu_torch.data import png
from gligen_tpu_torch.data.inpaint_masks import draw_masks_from_boxes
from gligen_tpu_torch.inference.cli import (
    DTYPES,
    FEATURE_DIM,
    MAP_SIZE,
    MAX_OBJS,
    FeatureExtractor,
    build_pipeline,
    complete_mask,
    crop_and_resize,
    load_projection_matrix,
    load_vision,
    modality_of,
    prepare_batch_kp,
    prepare_batch_sem,
)
from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.parallel.mesh import padded_rows


def _b64_to_image(data: str, mode: str = "RGB") -> np.ndarray:
    """A base64 PNG or JPEG -> uint8 pixels in ``mode`` ("RGB" or "L"), as
    PIL's ``Image.open(...).convert(mode)`` gives them."""
    return png.decode_image(base64.b64decode(data), mode, "the request's image")


def _image_to_b64(arr: np.ndarray) -> str:
    """An image in [0, 1], (H, W, 3), as base64 PNG bytes of
    ``(clip(arr, 0, 1) * 255).astype(uint8)``."""
    pixels = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return base64.b64encode(png.encode_png(pixels)).decode()


class DeviceStreams:
    """The CUDA streams of a session on ``device``: ``generate`` (the
    pipeline's calls, from the batcher's worker or the direct path),
    ``copy`` (finished images to pinned host memory) and ``features`` (the
    request threads' CLIP features, at a higher priority).  Off the card
    (a CPU pipeline, or a stub with no ``device``) each is a no-op."""

    def __init__(self, device: Any = None):
        self.on_card = device is not None and torch.device(device).type == "cuda"
        if self.on_card:
            current = torch.cuda.current_stream(device)
            self.generate = torch.cuda.Stream(device)
            self.copy = torch.cuda.Stream(device)
            self.features = torch.cuda.Stream(device, priority=-1)
            for stream in (self.generate, self.copy, self.features):
                stream.wait_stream(current)  # the weights were written on it

    def run(self, fn: Callable[[], Any]):
        """``fn()`` on the generation stream -> (its result, an event
        recorded after its work, or None off the card)."""
        if not self.on_card:
            return fn(), None
        with torch.cuda.stream(self.generate):
            out = fn()
            done = torch.cuda.Event()
            done.record(self.generate)
        return out, done

    def for_features(self):
        """The context the request threads' feature extraction runs in."""
        return torch.cuda.stream(self.features) if self.on_card else contextlib.nullcontext()

    def to_host(self, images, done) -> np.ndarray:
        """``images`` (numpy, or a tensor that ``run`` produced) as a numpy
        array.  A card tensor is copied into pinned memory on the copy
        stream once ``done`` has fired; ``record_stream`` keeps the caching
        allocator from handing its memory to the next batch while the copy
        runs.  Blocks until the copy is done."""
        if isinstance(images, np.ndarray):
            return images
        if images.device.type != "cuda":
            return images.numpy()
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(done)
            host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
            host.copy_(images, non_blocking=True)
            images.record_stream(self.copy)
            copied = torch.cuda.Event()
            copied.record(self.copy)
        copied.synchronize()
        return host.numpy()


class _BatchItem:
    """One request's arrays awaiting a fused pipeline call."""

    __slots__ = ("ids", "uc_ids", "grounding", "grounding_extra", "noise",
                 "n", "event", "result", "error")

    def __init__(self, ids, uc_ids, grounding, grounding_extra, noise, n):
        self.ids, self.uc_ids = ids, uc_ids
        self.grounding, self.grounding_extra = grounding, grounding_extra
        self.noise, self.n = noise, n
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Cross-request micro-batching (server.py:87-283).

    Concurrent requests with the same static configuration (steps,
    guidance, alpha stages, resolution, modality) are fused into one padded
    pipeline call: a worker thread collects requests for ``window_ms``
    after the first arrival, drains every pending group, concatenates each
    group's batch axes up to ``max_images`` (the rest wait for the next
    call), pads the total to a bucket by repeating the last row, runs it in
    row chunks of the largest bucket within the resolution's image cap, and
    splits the images back per request.  Each request's starting noise is
    drawn on the host from its own seed, so a fused batch keeps every
    request's seed.  A fused batch that fails is retried item by item, so
    only the faulty request errors.

    Completion is pipelined: the worker hands each call's card tensor and
    its event to a collector thread and goes on to the next call; the
    collector copies on the copy stream after that event alone
    (``DeviceStreams.to_host``), so batch N's copy, its distribution and
    the request threads' PNG encodes overlap batch N+1 on the card.  The
    queue holds one finished call, so at most two are in flight."""

    def __init__(self, pipeline, lock, window_ms: int = 25, max_images: int = 8,
                 buckets=(1, 2, 4, 8), streams: Optional[DeviceStreams] = None):
        self.pipe = pipeline
        self._lock = lock
        self.streams = streams or DeviceStreams(getattr(pipeline, "device", None))
        self.window = window_ms / 1000.0
        # with a mesh every batch pads to a multiple of its size: round each
        # bucket up to one and dedupe, so that every bucket is a real shape
        # (server.py:110-118)
        mesh = getattr(pipeline, "mesh", None)
        buckets = sorted({padded_rows(b, mesh) for b in buckets})
        self.max_images = max(max_images, buckets[-1])
        self.buckets = tuple(buckets)
        self._cv = threading.Condition()
        self._pending: Dict[tuple, list] = {}
        self._closed = False
        self._completions: queue.Queue = queue.Queue(maxsize=1)
        self._collector = threading.Thread(target=self._collect, daemon=True)
        self._collector.start()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, sig: tuple, item: _BatchItem, run_kwargs: Dict[str, Any]):
        key = (sig, _freeze(run_kwargs))
        with self._cv:
            self._pending.setdefault(key, []).append(item)
            self._cv.notify()
        if not item.event.wait(timeout=600):
            # withdraw the abandoned item, so that the worker spends no card
            # time on a request whose waiter has already raised
            with self._cv:
                lst = self._pending.get(key)
                if lst is not None and item in lst:
                    lst.remove(item)
                    if not lst:
                        del self._pending[key]
            raise TimeoutError("batched generation timed out")
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        """Stop the worker and the collector once the calls in flight have
        finished; a request still waiting gets a RuntimeError."""
        with self._cv:
            self._closed = True
            pending, self._pending = self._pending, {}
            self._cv.notify_all()
        for items in pending.values():
            for it in items:
                it.error = RuntimeError("the server closed")
                it.event.set()
        self._worker.join()
        self._completions.put(None)
        self._collector.join()

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
            time.sleep(self.window)  # the collection window after the first arrival
            # drain every pending group before sleeping again: a burst of mixed
            # configurations pays one window, not one per group
            while True:
                with self._cv:
                    if not self._pending:
                        break
                    key = next(iter(self._pending))
                    items = self._pending.pop(key)
                kwargs = dict(key[1])
                if kwargs.get("alpha_stages") is not None:
                    kwargs["alpha_stages"] = list(kwargs["alpha_stages"])
                batch, take = [], 0
                for it in items:
                    if take + it.n > self.max_images and batch:
                        break
                    batch.append(it)
                    take += it.n
                leftover = items[len(batch):]
                if leftover:
                    with self._cv:
                        self._pending.setdefault(key, []).extend(leftover)
                        self._cv.notify()
                try:
                    self._execute(batch, take, kwargs)
                except Exception as batch_err:  # noqa: BLE001 — isolated below
                    self._fail_or_retry(batch, kwargs, batch_err)

    def _fail_or_retry(self, batch, kwargs, batch_err):
        """A failed call's items: a single item gets the error; a fused
        batch is retried one item at a time (synchronously), so only the
        faulty request errors."""
        if len(batch) == 1:
            batch[0].error = batch_err
            batch[0].event.set()
            return
        for it in batch:
            try:
                self._execute([it], it.n, kwargs, sync=True)
            except Exception as e:  # noqa: BLE001 — routed to the waiter
                it.error = e
                it.event.set()

    def _collect(self):
        """The completion side: each call's images to the host after its
        event, then to their requests, while the worker runs the next."""
        while True:
            done = self._completions.get()
            if done is None:  # closed
                return
            batch, parts, kwargs = done
            try:
                self._distribute(batch, [self.streams.to_host(imgs[:n], done)
                                         for imgs, n, done in parts])
            except Exception as err:  # noqa: BLE001 — a failure on the card
                self._fail_or_retry(batch, kwargs, err)

    @staticmethod
    def _distribute(batch, parts):
        images = np.concatenate(parts, 0) if len(parts) > 1 else parts[0]
        off = 0
        for it in batch:
            it.result = images[off:off + it.n]
            off += it.n
            it.event.set()

    def image_cap(self, latent_size) -> int:
        return _image_cap(self.pipe, latent_size)

    def _execute(self, batch, take, kwargs, sync: bool = False):
        def fuse(field):
            arrs = [getattr(it, field) for it in batch]
            if arrs[0] is None:
                return None
            if isinstance(arrs[0], dict):
                return {k: np.concatenate([a[k] for a in arrs], 0) for k in arrs[0]}
            return np.concatenate(arrs, 0)

        fused = {f: fuse(f) for f in ("ids", "uc_ids", "grounding", "grounding_extra", "noise")}
        # chunk by the largest bucket within the image cap, never the cap
        # itself: every call then runs a bucket that warmup ran
        cap = self.image_cap(kwargs.get("latent_size"))
        chunk = max((b for b in self.buckets if b <= cap), default=cap)
        parts = []  # (images, rows to keep, event) per chunk
        for start in range(0, take, chunk):
            n = min(chunk, take - start)
            bucket = next((b for b in self.buckets if n <= b <= chunk), None)
            pad = (bucket - n) if bucket else 0

            def cut(x, start=start, n=n, pad=pad):
                if x is None:
                    return None
                if isinstance(x, dict):
                    return {k: _pad_rows0(v[start:start + n], pad) for k, v in x.items()}
                return _pad_rows0(x[start:start + n], pad)

            # the lock covers the enqueue: generate returns once its kernels
            # are queued; the copy to the host happens in the collector
            with self._lock:
                images, done = self.streams.run(lambda: self.pipe.generate(
                    cut(fused["ids"]), cut(fused["uc_ids"]), cut(fused["grounding"]),
                    grounding_extra=cut(fused["grounding_extra"]), noise=cut(fused["noise"]),
                    generator=None, **kwargs))
            parts.append((images, n, done))
        if sync:
            self._distribute(batch, [self.streams.to_host(imgs[:n], done)
                                     for imgs, n, done in parts])
        else:
            self._completions.put((batch, parts, kwargs))


def _mesh_size(pipeline) -> int:
    """The devices a pipeline call spreads its batch over: its mesh's size,
    1 without one (server.py:286-289)."""
    mesh = getattr(pipeline, "mesh", None)
    return mesh.size if mesh is not None else 1


def _image_cap(pipeline, latent_size) -> int:
    """The most images one pipeline call takes at this resolution: 8 at
    latent 64 (512²), scaled by (64 / latent)² as the denoiser's
    activations grow with the latent's area (2 at 1024²), at least 1, times
    the mesh size.  PERF.md records the card's peak memory at 1024²,
    bucket 2."""
    latent = int(latent_size or 64)
    per_card = max(1, (8 * 64 * 64) // (latent * latent))
    return per_card * _mesh_size(pipeline)


def _pad_rows0(a: np.ndarray, pad: int) -> np.ndarray:
    """Pad the batch axis by repeating the last row (sliced off later)."""
    if pad == 0:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)


def _freeze(d: Dict[str, Any]):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in d.items()))


def chunk_seed(seed: int, chunk: int) -> int:
    """The seed of the direct path's draws for row chunk ``chunk`` of a
    request with ``seed``: a hash of the pair, so that chunk 1 of seed s
    never draws what chunk 0 of seed s + 1 draws (the JAX server's
    ``fold_in(PRNGKey(seed), chunk)``, server.py:613-617)."""
    return int(np.random.SeedSequence((int(seed), int(chunk))).generate_state(1, np.uint64)[0])


class ServingSession:
    """Owns a warm pipeline; ``generate`` is thread-safe (server.py:318-660).

    ``batch_window_ms`` > 0 turns on cross-request micro-batching
    (``MicroBatcher``); inpainting always runs on the direct path."""

    def __init__(self, pipeline, tokenizer, feature_extractor=None, default_steps: int = 50,
                 batch_window_ms: int = 0):
        self.pipe = pipeline
        self.tokenizer = tokenizer
        self.features = feature_extractor
        self.default_steps = default_steps
        self._lock = threading.Lock()
        self.ready = True  # False while a warmup pass runs
        self.warmup_error: Optional[str] = None
        self._metrics_lock = threading.Lock()
        self._started = time.time()
        self._requests = 0
        self._images = 0
        self._errors = 0
        self._latencies: list = []  # the last 512 requests' latencies
        self.streams = DeviceStreams(getattr(pipeline, "device", None))
        self.batcher = (
            MicroBatcher(pipeline, self._lock, window_ms=batch_window_ms, streams=self.streams)
            if batch_window_ms > 0 else None
        )

    def close(self) -> None:
        """Stop the batcher's threads (which hold the pipeline)."""
        if self.batcher is not None:
            self.batcher.close()

    def warmup(self, buckets=(1, 8), resolutions=(512,), background: bool = False):
        """One generation through the standard path per (bucket,
        resolution), so that the first request of each shape finds every
        kernel library built and loaded (``ops/cuda_build.py`` compiles at
        first launch) and the caching allocator grown.  Each bucket is
        rounded up to a multiple of the pipeline's mesh size and clamped to
        what the resolution's calls run: the largest batcher bucket within
        its image cap.  ``background`` runs the pass in a
        daemon thread; ``self.ready`` (GET /ready) turns true only when it
        has finished without an error."""

        def run():
            try:
                for res in resolutions:
                    cap = _image_cap(self.pipe, int(res) // 8)
                    if self.batcher is not None:
                        cap = max((b for b in self.batcher.buckets if b <= cap), default=cap)
                    # the shapes requests run: mesh multiples (server.py:357-359)
                    mesh = getattr(self.pipe, "mesh", None)
                    for b in sorted({min(padded_rows(b, mesh), cap) for b in buckets}):
                        self.generate(self._warmup_request(int(b), int(res)))
                self.ready = True
                self.warmup_error = None
            except Exception as e:  # noqa: BLE001 — /ready reports it
                # stay not ready: a load balancer must not route to a server
                # whose path never ran
                self.warmup_error = f"{type(e).__name__}: {e}"

        self.ready = False
        self.warmup_error = None
        if background:
            threading.Thread(target=run, daemon=True).start()
        else:
            run()

    def _warmup_request(self, batch: int, resolution: int) -> Dict[str, Any]:
        """A minimal valid /generate body for this server's modality: a
        keypoint or spatial model refuses a bare prompt."""
        inst: Dict[str, Any] = {"prompt": "", "batch_size": batch, "resolution": resolution,
                                "seed": 0}
        mod = self._modality()
        if mod == "keypoint":
            inst["keypoints"] = [[[0.5, 0.5]] * 17]
        elif mod not in ("text", "text_image"):
            shape = (MAP_SIZE, MAP_SIZE) if mod == "sem" else (MAP_SIZE, MAP_SIZE, 3)
            inst["map_image"] = base64.b64encode(png.encode_png(np.zeros(shape, np.uint8))).decode()
        return inst

    # ---- modality dispatch -------------------------------------------
    def _modality(self) -> str:
        return modality_of(self.pipe)

    def _grounding_for_modality(self, inst: Dict[str, Any], batch: int):
        """(the grounding tokenizer's inputs, the downsampler's map or None)."""
        mod = self._modality()
        if mod in ("text", "text_image"):
            return self._grounding_from_instruction(inst, batch), None
        if mod == "keypoint":
            if "keypoints" not in inst:
                raise ValueError("keypoint model: POST 'keypoints' = [[[x,y]*17]...]")
            return prepare_batch_kp({"locations": inst["keypoints"]}, batch), None
        # a spatially aligned modality: its condition map rides as b64
        if "map_image" not in inst:
            raise ValueError(f"{mod} model: POST 'map_image' = b64 condition map")
        if mod == "sem":
            # uint8 labels (the one-hot happens on the card), each below the
            # model's 152 classes (the CLI's check)
            key = "sem"
            labels = crop_and_resize(_b64_to_image(inst["map_image"], "L"), MAP_SIZE,
                                     nearest=True)
            grounding = prepare_batch_sem({"sem": labels}, batch)
        else:
            # raw uint8 pixels: the grounding net normalises them on the card
            key = {"hed": "hed_edge", "canny": "canny_edge", "depth": "depth",
                   "normal": "normal"}[mod]
            arr = crop_and_resize(_b64_to_image(inst["map_image"]), MAP_SIZE)
            grounding = {key: np.repeat(arr[None], batch, 0), "mask": np.ones(batch, np.float32)}
        extra = grounding[key] if self.pipe.unet_config.get("grounding_downsampler") else None
        return grounding, extra

    # ---- instruction -> grounding batch (app.py:152-213) --------------
    def _grounding_from_instruction(self, inst: Dict[str, Any], batch: int):
        phrases = list(inst.get("phrases", []))
        locations = [list(map(float, l)) for l in inst.get("locations", [])]
        has_style = bool(inst.get("style_image"))
        if has_style:
            phrases = phrases + ["style"]
            locations = locations + [[0.0, 0.0, 1.0, 0.01]]  # app.py:176-181

        n = len(locations)
        boxes = np.zeros((MAX_OBJS, 4), np.float32)
        masks = np.zeros(MAX_OBJS, np.float32)
        text_masks = np.zeros(MAX_OBJS, np.float32)
        image_masks = np.zeros(MAX_OBJS, np.float32)
        text_emb = np.zeros((MAX_OBJS, FEATURE_DIM), np.float32)
        image_emb = np.zeros((MAX_OBJS, FEATURE_DIM), np.float32)

        for i in range(n):
            boxes[i] = locations[i]
            masks[i] = 1.0
            if i < len(phrases) and phrases[i] and not (has_style and i == n - 1):
                if self.features is not None:
                    text_emb[i] = self.features.text_feature(phrases[i])
                text_masks[i] = 1.0
        if has_style and self.features is not None:
            image_emb[n - 1] = self.features.image_feature_from_array(
                _b64_to_image(inst["style_image"]))
            image_masks[n - 1] = 1.0

        rep = lambda a: np.repeat(a[None], batch, axis=0)
        grounding = {
            "boxes": rep(boxes),
            "masks": rep(masks),
            "text_embeddings": rep(text_emb),
            "text_masks": rep(text_masks) * complete_mask(inst.get("text_mask"), MAX_OBJS),
            "image_embeddings": rep(image_emb),
            "image_masks": rep(image_masks) * complete_mask(inst.get("image_mask"), MAX_OBJS),
        }
        if self._modality() != "text_image":
            grounding = {
                "boxes": grounding["boxes"],
                "masks": grounding["masks"] * grounding["text_masks"],
                "positive_embeddings": grounding["text_embeddings"],
            }
        return grounding

    def _decode_actual_mask(self, data: str, latent_size: int = 64) -> np.ndarray:
        """The user's inpaint sketch -> a latent keep-mask (demo/app.py:276-281):
        center-cropped, NEAREST to latent², kept where the pixel is 0."""
        sketch = crop_and_resize(_b64_to_image(data, "L"), latent_size, nearest=True)
        return (sketch == 0).astype(np.float32)[..., None]  # (h, w, 1)

    def generate(self, inst: Dict[str, Any]) -> Dict[str, Any]:
        batch = int(inst.get("batch_size", 1))
        resolution = int(inst.get("resolution", 512))
        if resolution % 8:
            raise ValueError(f"resolution {resolution} must be a multiple of 8")
        latent = resolution // 8
        with self.streams.for_features():
            grounding, grounding_extra = self._grounding_for_modality(inst, batch)
        ids = self.tokenizer([inst.get("prompt", "")] * batch)
        uc_ids = self.tokenizer([inst.get("negative_prompt", "")] * batch)

        inpaint_image = inpaint_mask = None
        if inst.get("task") == "inpainting" and inst.get("input_image"):
            # the VAE encodes the image to exactly latent²: crop at latent
            # times the VAE's own factor
            size = latent * self.pipe.c.vae.downsample_factor
            img = crop_and_resize(_b64_to_image(inst["input_image"]), size)
            inpaint_image = np.repeat((np.asarray(img, np.float32) / 255.0 * 2 - 1)[None], batch, 0)
            if inst.get("actual_mask"):
                # the user's sketch (task_grounded_generation.py:219-233)
                keep = self._decode_actual_mask(inst["actual_mask"], latent_size=latent)
                inpaint_mask = np.repeat(keep[None], batch, 0)
            else:
                locs = np.asarray(inst.get("locations", []), np.float32)
                inpaint_mask = draw_masks_from_boxes(np.repeat(locs[None], batch, 0), latent)

        t0 = time.time()
        # the demo's defaults (demo/app.py:184,191, tau 0.3): generation
        # [tau, 0, 1 - tau]; inpainting holds the gate at 1
        default_alpha = [1.0, 0.0, 0.0] if inpaint_image is not None else [0.3, 0.0, 0.7]
        steps = int(inst.get("steps", self.default_steps))
        if not 1 <= steps <= 500:
            # past T/2 the c = T // S subset degenerates to c = 1 and runs 999
            # UNet steps whatever S says: refuse it
            raise ValueError(f"steps must be in [1, 500], got {steps}")
        run_kwargs = dict(
            steps=steps,
            guidance_scale=float(inst.get("guidance_scale", 7.5)),
            alpha_stages=inst.get("alpha_type", default_alpha),
            latent_size=latent,
        )
        seed = int(inst.get("seed", 0))
        if self.batcher is not None and inpaint_image is None:
            # each request's starting noise from its own seed on the host
            # (numpy's Philox, as the JAX server draws it), so a fused batch
            # keeps every request's seed
            noise = np.random.default_rng(seed).standard_normal((batch, latent, latent, 4),
                                                                dtype=np.float32)
            item = _BatchItem(
                np.asarray(ids), np.asarray(uc_ids),
                {k: np.asarray(v) for k, v in grounding.items()},
                None if grounding_extra is None else np.asarray(grounding_extra),
                noise, batch,
            )
            images = self.batcher.submit((self._modality(),), item, run_kwargs)
        else:
            # the direct path (no batching, or inpainting): the same image
            # cap, so a large request runs as row chunks in turn
            cap = _image_cap(self.pipe, latent)

            def _sl(x, sl):
                if x is None:
                    return None
                if isinstance(x, dict):
                    return {k: v[sl] for k, v in x.items()}
                return x[sl]

            device = getattr(self.pipe, "device", "cpu")
            parts = []
            # the lock covers the enqueue; the copies below run without it
            with self._lock:
                for ci, start in enumerate(range(0, batch, cap)):
                    sl = slice(start, start + cap)
                    gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, ci))
                    parts.append(self.streams.run(lambda sl=sl, gen=gen: self.pipe.generate(
                        _sl(ids, sl), _sl(uc_ids, sl), _sl(grounding, sl),
                        grounding_extra=_sl(grounding_extra, sl),
                        inpaint_image=_sl(inpaint_image, sl), inpaint_mask=_sl(inpaint_mask, sl),
                        generator=gen, **run_kwargs)))
            parts = [self.streams.to_host(p, done) for p, done in parts]
            images = parts[0] if len(parts) == 1 else np.concatenate(parts, 0)
        self._record(time.time() - t0, batch)
        return {
            "images": [_image_to_b64(img) for img in images],
            "latency_sec": round(time.time() - t0, 3),
        }

    # ---- observability ------------------------------------------------
    def _record(self, latency: float, n_images: int, error: bool = False):
        with self._metrics_lock:
            self._requests += 1
            self._images += n_images
            if error:
                self._errors += 1
            else:
                self._latencies.append(latency)
                if len(self._latencies) > 512:
                    self._latencies = self._latencies[-512:]

    def metrics(self) -> Dict[str, Any]:
        """Operational counters for scrapers (GET /metrics)."""
        with self._metrics_lock:
            lats = sorted(self._latencies)
            out = {
                "uptime_sec": round(time.time() - self._started, 1),
                "requests": self._requests,
                "images": self._images,
                "errors": self._errors,
                "ready": self.ready,
            }
            if lats:
                pick = lambda q: lats[min(len(lats) - 1, int(q * len(lats)))]
                out["latency_p50_sec"] = round(pick(0.50), 3)
                out["latency_p95_sec"] = round(pick(0.95), 3)
                out["latency_max_sec"] = round(lats[-1], 3)
            return out


def make_server(session: ServingSession, host: str = "0.0.0.0", port: int = 7860):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            elif self.path == "/metrics":
                self._send(200, session.metrics())
            elif self.path == "/ready":
                # unlike /health: ready only once warmup has run every shape
                if session.ready:
                    self._send(200, {"status": "ready"})
                elif session.warmup_error:
                    self._send(503, {"status": "warmup_failed", "error": session.warmup_error})
                else:
                    self._send(503, {"status": "warming"})
            elif self.path in ("/", "/index.html"):
                from gligen_tpu_torch.serving.demo_page import PAGE

                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                inst = json.loads(self.rfile.read(length))
                self._send(200, session.generate(inst))
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                session._record(0.0, 0, error=True)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


# flags of the JAX server that only shorten XLA's compile step
NO_EFFECT = {
    "aot_dir": "--aot_dir has no effect in the port: it caches XLA's compiled serving "
               "programs, and the port compiles none (PyTorch runs eagerly; the CUDA kernels "
               "are built once into build/kernels/)",
    "split_programs": "--split_programs has no effect in the port: it splits XLA programs to "
                      "cut their compile time, and the port compiles none",
}


def parser() -> argparse.ArgumentParser:
    """The JAX server's flags (server.py:718-774), with the port's CLI's
    ``--device``, ``--dezero`` and ``--allow_hash_tokenizer``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", type=str, default="random")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--vocab_path", type=str, default=None)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", type=str, default="cuda",
                   help="the card (default) or 'cpu' (the kernels' plain versions)")
    p.add_argument("--sd_input_conv", type=str, default="SD_input_conv_weight_bias.pth")
    p.add_argument("--projection_matrix", type=str, default="projection_matrix")
    p.add_argument("--clip_vision_ckpt", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="permit the hash-fallback tokenizer even with real weights (smoke only)")
    p.add_argument("--dezero", action="store_true",
                   help="de-zero a random-init model's zero-init tensors and fuser gates, so "
                   "that random weights exercise every path")
    p.add_argument("--train_ckpt", type=str, default=None,
                   help="a native training checkpoint whose trainable tensors overlay --ckpt's")
    p.add_argument("--use_ema", action="store_true",
                   help="serve the EMA shadow of the trainable tensors")
    p.add_argument("--warmup", type=str, default=None, metavar="BUCKETSxRESOLUTIONS",
                   help="run one request per shape at boot, e.g. '1,8x512' or '1,2,4,8x512,1024'; "
                   "/ready answers 503 until it is done (requests are taken at once: the warmup "
                   "runs in the background)")
    p.add_argument("--batch_window_ms", type=int, default=25,
                   help="the micro-batching window (0 turns batching off): concurrent requests "
                   "of one configuration fuse into one padded batch")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each call's batch over every card (one replica each), where the "
                   "machine has more than one; buckets and warmup shapes round up to "
                   "multiples of the cards")
    p.add_argument("--aot_dir", type=str, default=None, help=NO_EFFECT["aot_dir"])
    p.add_argument("--split_programs", action="store_true", help=NO_EFFECT["split_programs"])
    return p


def build_session(args, create: Callable[..., GligenComponents] = GligenComponents.create
                  ) -> ServingSession:
    """The session of ``parser()``'s arguments: the CLI's ``build_pipeline``
    (``create`` builds random components; a test passes a smaller model) and
    its feature extractor (CLIP vision and the projection where given; on
    random weights a pseudo-feature of the image in their place)."""
    for flag, why in NO_EFFECT.items():
        if getattr(args, flag):
            print(why, flush=True)
    pipe = build_pipeline(args.ckpt, args, create)
    projection = vision = None
    if args.projection_matrix and os.path.exists(args.projection_matrix):
        projection = load_projection_matrix(args.projection_matrix)
    if args.clip_vision_ckpt and os.path.exists(args.clip_vision_ckpt):
        vision = load_vision(args.clip_vision_ckpt, pipe.device)
    features = FeatureExtractor(pipe.c.text_encoder, pipe.tokenizer, vision=vision,
                                projection_matrix=projection,
                                allow_random=args.ckpt.startswith("random"))
    return ServingSession(pipe, pipe.tokenizer, features, batch_window_ms=args.batch_window_ms)


def main(argv=None):
    args = parser().parse_args(argv)
    session = build_session(args)
    if args.warmup:
        buckets_s, _, res_s = args.warmup.partition("x")
        session.warmup(
            buckets=[int(v) for v in buckets_s.split(",") if v],
            resolutions=[int(v) for v in res_s.split(",") if v] or (512,),
            background=True,
        )
    server = make_server(session, port=args.port)
    print(f"serving on :{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
