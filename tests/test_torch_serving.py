"""The port's HTTP server (``gligen_tpu_torch/serving/server.py``) on the
CPU, against the JAX server (``gligen_tpu/serving/server.py``).

  * A counterpart of each of ``tests/test_serving.py``'s 24 tests on the
    port's session with a stub pipeline (``test_port_*``): instruction
    mapping, HTTP round trips, every modality, inpainting, the
    micro-batcher (fusing, buckets, chunks, fault isolation, draining),
    warmup and /ready, /metrics.
  * Parity: for each modality and for inpainting with a drawn sketch, the
    port's and the JAX session hand ``generate`` equal arrays and keywords
    given the same instruction and image bytes (the random draws aside:
    the direct path draws from a generator, the JAX one from a key); and
    the batched path end to end at a small width, weights carried across
    by ``convert/from_jax.py``: the same images within atol 1e-4 (the
    pipeline parity tests' tolerance).
  * The image codecs against PIL's on the same bytes, pixel for pixel.
  * The direct path's draws per (seed, chunk): repeatable, and chunk 1 of
    seed s is not chunk 0 of seed s + 1.
  * The command line: ``--data_parallel`` raises naming M12; ``--aot_dir``
    and ``--split_programs`` print their line and set no variable.
  * The launch counters under many threads.
"""

import base64
import io
import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import gligen_tpu.serving.server as jsrv
from gligen_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from gligen_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from gligen_tpu.inference.pipeline import GenerationPipeline as JaxPipeline
from gligen_tpu.inference.pipeline import GligenComponents as JaxComponents
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE

import gligen_tpu_torch.serving.server as srv
from gligen_tpu_torch.convert.from_jax import load_jax_params
from gligen_tpu_torch.data import png
from gligen_tpu_torch.data.tokenizer import HashTokenizer
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.serving.server import ServingSession, make_server

from test_serving import _StubPipeline as _JaxStubPipeline
from test_torch_cli import small_create
from test_torch_modules import CTX, random_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubUNet:
    pass


class _StubVAE:
    downsample_factor = 8  # x8, like SD's: the server crops the inpaint image by it


class _StubComponents:
    def __init__(self):
        self.unet = _StubUNet()
        self.vae = _StubVAE()


class _StubPipeline:
    """The port's pipeline as the server sees it: components, the UNet's
    keywords (``unet_config``, as ``build_pipeline`` sets them) and a
    ``generate`` that records its arguments."""

    def __init__(self, tokenizer_target="text", downsampler=None):
        self.c = _StubComponents()
        self.unet_config = {"grounding_tokenizer": {"target": tokenizer_target}}
        if downsampler is not None:
            self.unet_config["grounding_downsampler"] = downsampler
        self.last_kwargs = None

    def generate(self, ids, uc_ids, grounding, **kw):
        self.last_kwargs = dict(kw, grounding=grounding, ids=ids)
        b = ids.shape[0]
        return np.full((b, 16, 16, 3), 0.5, np.float32)


def _session(tokenizer_target="text", downsampler=None):
    return ServingSession(_StubPipeline(tokenizer_target, downsampler), HashTokenizer())


def _b64_png(arr_or_size, mode="RGB"):
    """PNG bytes written by PIL (the clients' encoder), base64."""
    buf = io.BytesIO()
    if isinstance(arr_or_size, tuple):
        Image.new(mode, arr_or_size).save(buf, "PNG")
    else:
        Image.fromarray(arr_or_size, mode).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64):
    """A response image by the port's PNG decoder."""
    pixels, mode = png.decode_png(base64.b64decode(b64))
    return pixels


def _serve(session):
    server = make_server(session, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"{url}/generate", data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _join(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------- test_serving.py counterparts

def test_port_instruction_to_grounding_text_mode():
    g = _session()._grounding_from_instruction(
        {"phrases": ["a cat", "a dog"], "locations": [[0, 0, 0.5, 0.5], [0.5, 0.5, 1, 1]]},
        batch=2)
    assert set(g) == {"boxes", "masks", "positive_embeddings"}
    assert g["boxes"].shape == (2, 30, 4)
    assert g["masks"][0, :2].tolist() == [1, 1] and g["masks"][0, 2:].sum() == 0


def test_port_style_image_appends_slot():
    g = _session()._grounding_from_instruction(
        {"phrases": ["a house"], "locations": [[0.2, 0.2, 0.8, 0.8]],
         "style_image": _b64_png((32, 32))}, batch=1)
    np.testing.assert_allclose(g["boxes"][0, 1], [0, 0, 1, 0.01])


def test_port_http_generate_roundtrip():
    session = _session()
    server, url = _serve(session)
    try:
        with urllib.request.urlopen(f"{url}/health") as r:
            assert json.load(r)["status"] == "ok"
        code, out = _post(url, {
            "prompt": "a teddy bear sitting next to a bird",
            "phrases": ["a teddy bear", "a bird"],
            "locations": [[0.0, 0.09, 0.33, 0.76], [0.55, 0.11, 1.0, 0.8]],
            "batch_size": 2, "alpha_type": [0.3, 0.0, 0.7]})
        assert code == 200 and len(out["images"]) == 2
        assert _decode(out["images"][0]).shape == (16, 16, 3)
        assert session.pipe.last_kwargs["alpha_stages"] == [0.3, 0.0, 0.7]
        # a malformed body -> a structured 500, and the server lives on
        code, err = _post(url, b"{not json")
        assert code == 500 and err["error"].startswith("JSONDecodeError")
        with urllib.request.urlopen(f"{url}/health") as r:
            assert json.load(r)["status"] == "ok"
    finally:
        server.shutdown()


def test_port_actual_mask_user_drawn_inpaint():
    session = _session()
    sketch = np.zeros((128, 128), np.uint8)
    sketch[32:64, :] = 255  # the user paints the second quarter of the rows
    out = session.generate({
        "prompt": "a corgi", "phrases": ["corgi"], "locations": [[0.1, 0.1, 0.5, 0.5]],
        "task": "inpainting", "input_image": _b64_png((128, 128)),
        "actual_mask": _b64_png(sketch, mode="L"), "batch_size": 2})
    assert len(out["images"]) == 2
    mask = session.pipe.last_kwargs["inpaint_mask"]
    assert mask.shape == (2, 64, 64, 1)
    assert mask[0, 16:32, :, 0].max() == 0.0
    assert mask[0, :16, :, 0].min() == 1.0 and mask[0, 32:, :, 0].min() == 1.0
    assert session.pipe.last_kwargs["inpaint_image"].shape == (2, 512, 512, 3)


def test_port_keypoint_modality_over_http():
    session = _session("keypoint")
    server, url = _serve(session)
    try:
        code, out = _post(url, {"prompt": "two people",
                                "keypoints": [[[0.5, 0.2]] * 17, [[0.1, 0.8]] * 17],
                                "batch_size": 1})
        assert code == 200 and len(out["images"]) == 1
        g = session.pipe.last_kwargs["grounding"]
        assert g["points"].shape == (1, 8 * 17, 2)
        assert g["masks"][0, :2 * 17].all() and not g["masks"][0, 2 * 17:].any()
    finally:
        server.shutdown()


def test_port_spatial_modality_over_http():
    session = _session("hed", downsampler={"target": "hed"})
    server, url = _serve(session)
    try:
        code, out = _post(url, {"prompt": "a living room", "map_image": _b64_png((64, 64)),
                                "batch_size": 2})
        assert code == 200 and len(out["images"]) == 2
        g = session.pipe.last_kwargs["grounding"]
        assert g["hed_edge"].shape == (2, 512, 512, 3) and g["hed_edge"].dtype == np.uint8
        assert g["mask"].tolist() == [1.0, 1.0]
        assert session.pipe.last_kwargs["grounding_extra"].shape == (2, 512, 512, 3)
        code, err = _post(url, {"prompt": "x"})
        assert code == 500 and "map_image" in err["error"]
    finally:
        server.shutdown()


def test_port_sem_modality_labels_over_http():
    session = _session("sem", downsampler={"target": "sem"})
    lab = np.random.default_rng(0).integers(0, 151, (96, 96), np.uint8)
    out = session.generate({"prompt": "a park", "map_image": _b64_png(lab, mode="L"),
                            "batch_size": 1})
    assert len(out["images"]) == 1
    g = session.pipe.last_kwargs["grounding"]
    assert g["sem"].shape == (1, 512, 512) and g["sem"].dtype == np.uint8
    assert int(g["sem"].max()) < 152
    assert session.pipe.last_kwargs["grounding_extra"].shape == (1, 512, 512)
    # a label the model has no class for: the CLI's check, a 500 naming it
    lab[5, 7] = 152
    server, url = _serve(session)
    try:
        code, err = _post(url, {"prompt": "a park", "map_image": _b64_png(lab, mode="L")})
        assert code == 500 and err["error"].startswith("ValueError") and "152" in err["error"]
    finally:
        server.shutdown()


def test_port_demo_page_served():
    server, url = _serve(_session())
    try:
        with urllib.request.urlopen(f"{url}/") as r:
            html = r.read().decode()
        assert "grounded generation" in html and "canvas" in html
    finally:
        server.shutdown()


class _CountingPipeline(_StubPipeline):
    def __init__(self):
        super().__init__()
        self.calls = []

    def generate(self, ids, uc_ids, grounding, **kw):
        self.calls.append(ids.shape[0])
        b = ids.shape[0]
        # each image filled with its row, so that the routing shows
        out = np.zeros((b, 16, 16, 3), np.float32)
        return out + np.arange(b, dtype=np.float32)[:, None, None, None] / 255.0


def _box(name, n=1, seed=0, **kw):
    return dict({"prompt": name, "phrases": ["x"], "locations": [[0, 0, 1, 1]],
                 "batch_size": n, "seed": seed}, **kw)


def test_port_microbatcher_fuses_concurrent_requests():
    pipe = _CountingPipeline()
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=400)
    results = {}

    def worker(name, n, seed):
        results[name] = session.generate(_box(name, n, seed))

    _join([threading.Thread(target=worker, args=a) for a in (("a", 1, 1), ("b", 2, 2),
                                                               ("c", 1, 3))])
    assert pipe.calls == [4], pipe.calls  # one fused call, bucket 4, no padding
    assert [len(results[k]["images"]) for k in "abc"] == [1, 2, 1]
    markers = {int(_decode(results[k]["images"][0])[0, 0, 0]) for k in "abc"}
    assert len(markers) == 3  # disjoint batch rows


def test_port_microbatcher_separates_incompatible_configs():
    pipe = _CountingPipeline()
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=60)
    results = {}

    def worker(name, steps):
        results[name] = session.generate(_box(name, steps=steps))

    _join([threading.Thread(target=worker, args=a) for a in (("a", 50), ("b", 20))])
    assert sorted(pipe.calls) == [1, 1], pipe.calls
    assert len(results["a"]["images"]) == 1 and len(results["b"]["images"]) == 1


def test_port_microbatcher_pads_to_bucket():
    pipe = _CountingPipeline()
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=60)
    out = session.generate(_box("p", 3))
    assert pipe.calls == [4] and len(out["images"]) == 3


def test_port_microbatcher_chunks_high_res_batches():
    pipe = _CountingPipeline()
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=400)
    results = {}

    def worker(name, n, seed):
        results[name] = session.generate(_box(name, n, seed, resolution=1024))

    _join([threading.Thread(target=worker, args=a) for a in (("a", 2, 1), ("b", 1, 2))])
    assert pipe.calls == [2, 1], pipe.calls
    assert len(results["a"]["images"]) == 2 and len(results["b"]["images"]) == 1
    assert session.batcher.image_cap(128) == 2 and session.batcher.image_cap(64) == 8


def test_port_microbatcher_chunks_align_to_buckets():
    pipe = _CountingPipeline()
    assert srv._image_cap(pipe, 96) == 3  # a cap that is no bucket
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=60)
    out = session.generate(_box("p", 5, resolution=768))
    assert len(out["images"]) == 5
    assert pipe.calls == [2, 2, 1], pipe.calls
    assert set(pipe.calls) <= set(session.batcher.buckets)


def test_port_warmup_runs_exact_runtime_chunk_shapes():
    pipe = _CountingPipeline()
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=60)
    session.warmup(buckets=(1, 8), resolutions=(768,))
    assert session.ready and session.warmup_error is None
    warmed = set(pipe.calls)
    assert warmed == {1, 2}, pipe.calls
    pipe.calls.clear()
    session.generate(_box("p", 7, resolution=768))
    assert set(pipe.calls) <= warmed, (pipe.calls, warmed)


def test_port_direct_path_chunks_high_res():
    pipe = _CountingPipeline()
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=0)
    out = session.generate(_box("p", 5, resolution=1024))
    assert pipe.calls == [2, 2, 1] and len(out["images"]) == 5


def test_port_image_cap_has_no_mesh():
    """The JAX test scales the cap by a mesh; the port has none (M12), so
    the cap is the per-card rule whatever the pipeline carries."""
    pipe = _StubPipeline()
    assert [srv._image_cap(pipe, lat) for lat in (64, 128, None, 32, 512)] == [8, 2, 8, 32, 1]
    pipe.mesh = object()
    assert srv._mesh_size(pipe) == 1 and srv._image_cap(pipe, 64) == 8


def test_port_resolution_field_sets_latent_size():
    pipe = _StubPipeline()
    ServingSession(pipe, HashTokenizer()).generate(_box("p", resolution=1024))
    assert pipe.last_kwargs["latent_size"] == 128
    p3 = _StubPipeline()
    ServingSession(p3, HashTokenizer(), batch_window_ms=50).generate(_box("p", resolution=1024))
    assert p3.last_kwargs["latent_size"] == 128
    assert p3.last_kwargs["noise"].shape == (1, 128, 128, 4)
    assert p3.last_kwargs["generator"] is None


def test_port_microbatcher_fault_isolation():
    class _FaultyOnMarker(_CountingPipeline):
        def generate(self, ids, uc_ids, grounding, **kw):
            # the poison request grounds 2 boxes; the good ones 1
            if float(np.asarray(grounding["masks"]).sum(-1).max()) >= 2:
                self.calls.append(-ids.shape[0])
                raise RuntimeError("poison request")
            return super().generate(ids, uc_ids, grounding, **kw)

    pipe = _FaultyOnMarker()
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=300)
    results, errors = {}, {}

    def worker(name, locations):
        try:
            results[name] = session.generate(
                {"prompt": name, "phrases": ["x"] * len(locations), "locations": locations,
                 "batch_size": 1})
        except Exception as e:  # noqa: BLE001
            errors[name] = str(e)

    _join([threading.Thread(target=worker, args=a) for a in (
        ("good1", [[0, 0, 1, 1]]), ("bad", [[0, 0, 1, 1], [0, 0, 0.5, 0.5]]),
        ("good2", [[0.1, 0.1, 0.9, 0.9]]))])
    assert "bad" in errors and "poison" in errors["bad"]
    assert len(results["good1"]["images"]) == 1 and len(results["good2"]["images"]) == 1
    assert any(c < 0 for c in pipe.calls), pipe.calls


def test_port_microbatcher_drains_all_groups_per_window():
    pipe = _CountingPipeline()
    window_ms = 250
    session = ServingSession(pipe, HashTokenizer(), batch_window_ms=window_ms)
    done = {}

    def worker(name, steps):
        t0 = time.monotonic()
        session.generate(_box(name, steps=steps))
        done[name] = time.monotonic() - t0

    _join([threading.Thread(target=worker, args=(f"g{i}", 10 + i)) for i in range(4)])
    assert sorted(pipe.calls) == [1, 1, 1, 1]
    assert max(done.values()) < 3 * window_ms / 1000.0, done


def test_port_warmup_and_ready_endpoint():
    session = _session()
    pipe = session.pipe
    calls = []
    orig = pipe.generate

    def tracking(ids, uc_ids, grounding, **kw):
        calls.append((ids.shape[0], kw.get("latent_size")))
        return orig(ids, uc_ids, grounding, **kw)

    release = threading.Event()

    def blocking(*a, **kw):
        release.wait(timeout=10)
        return tracking(*a, **kw)

    pipe.generate = blocking
    server, url = _serve(session)
    try:
        session.warmup(buckets=(1, 2), resolutions=(512, 1024), background=True)
        try:
            urllib.request.urlopen(f"{url}/ready")
            code = 200
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        assert code == 503 and body["status"] == "warming"
        release.set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not session.ready:
            time.sleep(0.02)
        with urllib.request.urlopen(f"{url}/ready") as r:
            assert r.status == 200 and json.load(r)["status"] == "ready"
    finally:
        server.shutdown()
    assert {(1, 64), (2, 64), (1, 128), (2, 128)} <= set(calls), calls


@pytest.mark.parametrize("mod", ["keypoint", "hed", "sem", "depth"])
def test_port_warmup_builds_valid_request_per_modality(mod):
    session = _session(mod)
    session.warmup(buckets=(1,), resolutions=(512,))
    assert session.ready and session.warmup_error is None, session.warmup_error
    assert session.pipe.last_kwargs is not None


def test_port_warmup_failure_reports_not_ready():
    session = _session()

    def boom(*a, **kw):
        raise RuntimeError("build exploded")

    session.pipe.generate = boom
    session.warmup(buckets=(1,), resolutions=(512,))
    assert not session.ready and "build exploded" in session.warmup_error
    server, url = _serve(session)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/ready")
        assert e.value.code == 503 and json.loads(e.value.read())["status"] == "warmup_failed"
    finally:
        server.shutdown()


def test_port_steps_over_500_rejected():
    session = _session()
    with pytest.raises(ValueError, match=r"\[1, 500\]"):
        session.generate({"prompt": "x", "steps": 600})
    session.generate({"prompt": "x", "steps": 500})
    assert session.pipe.last_kwargs["steps"] == 500


def test_port_metrics_endpoint_counts_and_percentiles():
    session = _session()
    server, url = _serve(session)
    try:
        assert _post(url, {"prompt": "a", "batch_size": 2})[0] == 200
        assert _post(url, {"prompt": "b"})[0] == 200
        assert _post(url, {"prompt": "c", "steps": 9999})[0] == 500
        with urllib.request.urlopen(f"{url}/metrics") as r:
            m = json.load(r)
    finally:
        server.shutdown()
    assert m["requests"] == 3 and m["images"] == 3 and m["errors"] == 1
    assert 0 <= m["latency_p50_sec"] <= m["latency_p95_sec"] <= m["latency_max_sec"]
    assert m["uptime_sec"] >= 0 and m["ready"] is True and "aot_cache" not in m


# ------------------------------------------------------------ parity with JAX

class _JaxFeatures:
    """Features of both servers computed from the decoded pixels, so that
    equal features mean equal decodes."""

    def text_feature(self, phrase):
        return np.full(768, len(phrase), np.float32)

    def image_feature_from_pil(self, pil):
        return np.resize(np.asarray(pil, np.float32).ravel(), 768)


class _PortFeatures(_JaxFeatures):
    def image_feature_from_array(self, pixels):
        return np.resize(np.asarray(pixels, np.float32).ravel(), 768)


def _rand_png(rng, h, w, mode="RGB"):
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    return _b64_png(rng.integers(0, 256, shape, np.uint8), mode)


def _parity_cases():
    rng = np.random.default_rng(5)
    boxes = {"phrases": ["a cat", "a dog"], "locations": [[0, 0.1, 0.5, 0.6], [0.4, 0.3, 1, 1]]}
    sketch = np.zeros((90, 100), np.uint8)
    sketch[20:50, 30:70] = 200
    with open(os.path.join(REPO, "inference_images", "beach.jpg"), "rb") as f:
        beach = base64.b64encode(f.read()).decode()
    return {
        "text": ("text", None, dict(boxes, text_mask=[1, 0])),
        "text_image": ("text_image", None, dict(boxes, style_image=_rand_png(rng, 48, 64),
                                                image_mask=[0, 1, 1], alpha_type=[1, 0, 0])),
        "keypoint": ("keypoint", None, {"keypoints": [[[0.5, 0.2]] * 17, [[0.1, 0.8]] * 17]}),
        "hed": ("hed", {"target": "hed"}, {"map_image": _rand_png(rng, 96, 80)}),
        "sem": ("sem", {"target": "sem"}, {"map_image": _b64_png(
            rng.integers(0, 152, (70, 90), np.uint8), "L")}),
        "inpaint": ("text", None, dict(boxes, task="inpainting", input_image=_rand_png(
            rng, 300, 200), actual_mask=_b64_png(sketch, "L"))),
        "inpaint_jpeg": ("text", None, dict(boxes, task="inpainting", input_image=beach)),
    }


PARITY = _parity_cases()


@pytest.mark.parametrize("case", sorted(PARITY))
def test_port_session_hands_generate_what_the_jax_session_does(case):
    """Both sessions get the same instruction and image bytes; ``generate``
    gets equal token ids, grounding arrays, downsampler map, noise (the
    batcher's numpy draws), inpaint image and mask, and keywords."""
    target, down, inst = PARITY[case]
    inst = dict(inst, prompt="a quiet street", batch_size=2, seed=7, steps=12)
    window = 0 if "inpaint" in case else 5
    jpipe = _JaxStubPipeline(target, down)
    jsess = jsrv.ServingSession(jpipe, JaxHashTokenizer(), _JaxFeatures(), batch_window_ms=window)
    pipe = _StubPipeline(target, down)
    sess = ServingSession(pipe, HashTokenizer(), _PortFeatures(), batch_window_ms=window)
    jsess.generate(dict(inst))
    sess.generate(dict(inst))
    want, got = dict(jpipe.last_kwargs), dict(pipe.last_kwargs)
    assert "rng" in want and "generator" in got
    del want["rng"], got["generator"]  # the random draws: a key against a generator
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = want[key], got[key]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), key
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=f"{key}.{k}")
                assert g[k].dtype == np.asarray(w[k]).dtype, f"{key}.{k}"
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
            assert g.dtype == w.dtype, key
        else:
            assert g == w, key


def test_direct_path_draws_per_seed_and_chunk():
    """At 1024² (cap 2) a 4-image request runs two chunks, each with its
    own generator: the same (seed, chunk) draws the same, and chunk 1 of
    seed s draws other numbers than chunk 0 of seed s + 1 (an additive key
    would collide there)."""
    draws = {}

    class _Draws(_StubPipeline):
        def generate(self, ids, uc_ids, grounding, generator=None, **kw):
            draws.setdefault(self.seed, []).append(
                torch.randn(8, generator=generator, device="cpu"))
            return super().generate(ids, uc_ids, grounding, **kw)

    for seed in (3, 4, 3):
        pipe = _Draws()
        pipe.seed = seed
        ServingSession(pipe, HashTokenizer()).generate(_box("p", 4, seed, resolution=1024))
    d3, d4 = draws[3], draws[4]
    assert len(d4) == 2 and len(d3) == 4
    assert torch.equal(d3[0], d3[2]) and torch.equal(d3[1], d3[3])  # repeatable
    assert not torch.equal(d3[1], d4[0])  # chunk 1 of seed 3 vs chunk 0 of seed 4
    assert not torch.equal(d3[0], d3[1])
    assert srv.chunk_seed(3, 1) != srv.chunk_seed(4, 0)


# the small model served end to end: 768-wide features into a CTX-wide UNet
SMALL_UNET = dict(
    in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
    attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=2, context_dim=CTX,
    grounding_tokenizer={"target": "text", "params": {"in_dim": 768, "out_dim": CTX}},
)
SMALL_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16)
SMALL_CLIP = dict(vocab_size=64, hidden_size=CTX, layers=2, heads=2)
LATENT = 8


class _SmallTokenizer(HashTokenizer):
    """The hash tokenizer folded into the small CLIP's 64 ids."""

    def __call__(self, texts, max_length=77):
        return super().__call__(texts, max_length) % 64


def test_batched_path_matches_the_jax_server(monkeypatch):
    """Two concurrent requests fused into one batch-2 call of a small real
    pipeline on each side (weights carried across by ``from_jax``; the
    batcher's numpy noise from each seed): the same images within 1e-4."""
    unet, vae, clip = JaxUNet(**SMALL_UNET, use_checkpoint=False), JaxVAE(**SMALL_VAE), \
        JaxCLIP(**SMALL_CLIP)
    g1 = {"boxes": jnp.zeros((1, 30, 4)), "masks": jnp.zeros((1, 30)),
          "positive_embeddings": jnp.zeros((1, 30, 768))}
    params = {
        "model": random_params(unet, jnp.zeros((1, LATENT, LATENT, 4)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, CTX)), g1, seed=1),
        "autoencoder": random_params(vae, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0),
                                     seed=2),
        "text_encoder": random_params(clip, jnp.zeros((1, 77), jnp.int32), seed=3),
    }
    sched = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    jpipe = JaxPipeline(JaxComponents(unet, vae, clip, JaxSchedule.create(**sched), params))
    comps = GligenComponents.create(unet_config=SMALL_UNET, dtype=torch.float32, device="cpu",
                                    vae_config=SMALL_VAE, text_config=SMALL_CLIP)
    load_jax_params(comps, params)
    pipe = GenerationPipeline(comps)
    pipe.unet_config = SMALL_UNET
    # keep the images as floats: the comparison is of the pipelines, not of PNG rounding
    monkeypatch.setattr(jsrv, "_image_to_b64", lambda a: a)
    monkeypatch.setattr(srv, "_image_to_b64", lambda a: a)
    outs = {}
    for name, session in (
            ("jax", jsrv.ServingSession(jpipe, _SmallTokenizer(), _JaxFeatures(),
                                        batch_window_ms=400)),
            ("port", ServingSession(pipe, _SmallTokenizer(), _PortFeatures(),
                                    batch_window_ms=400))):
        got = {}

        def client(seed, session=session, got=got):
            got[seed] = session.generate({
                "prompt": "a cat and a dog", "phrases": ["a cat", "a dog"],
                "locations": [[0, 0.1, 0.5, 0.6], [0.4, 0.3, 1, 1]], "batch_size": 1,
                "steps": 3, "seed": seed, "resolution": 8 * LATENT})["images"]

        _join([threading.Thread(target=client, args=(s,)) for s in (1, 2)])
        outs[name] = got
    for seed in (1, 2):
        want, got = np.stack(outs["jax"][seed]), np.stack(outs["port"][seed])
        assert got.shape == want.shape == (1, 16, 16, 3)
        assert float(got.std()) > 1e-2
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert not np.allclose(outs["port"][1], outs["port"][2])


# --------------------------------------------------------------- image codecs

def _pil_b64(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return base64.b64encode(buf.getvalue()).decode()


def test_image_codecs_match_pil():
    """``_b64_to_image`` gives PIL's ``open().convert(mode)`` pixels for
    PNG (RGB, L, RGBA, palette) and baseline JPEG (colour, grayscale);
    ``_image_to_b64`` decodes to the JAX server's pixels."""
    rng = np.random.default_rng(1)
    rgb = Image.fromarray(rng.integers(0, 256, (37, 53, 3), np.uint8))
    images = [
        _pil_b64(rgb, "PNG"),
        _pil_b64(rgb.convert("L"), "PNG"),
        _pil_b64(Image.fromarray(rng.integers(0, 256, (20, 30, 4), np.uint8), "RGBA"), "PNG"),
        _pil_b64(rgb.convert("P", palette=Image.ADAPTIVE, colors=16), "PNG"),
        _pil_b64(rgb, "JPEG", quality=90),
        _pil_b64(rgb.convert("L"), "JPEG", quality=75),
    ]
    with open(os.path.join(REPO, "inference_images", "style_golden.jpg"), "rb") as f:
        images.append(base64.b64encode(f.read()).decode())
    for b64 in images:
        for mode in ("RGB", "L"):
            want = np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert(mode))
            np.testing.assert_array_equal(srv._b64_to_image(b64, mode), want)
    arr = rng.random((9, 11, 3)).astype(np.float32) * 1.2 - 0.1
    want = np.asarray(Image.open(io.BytesIO(base64.b64decode(jsrv._image_to_b64(arr)))))
    np.testing.assert_array_equal(_decode(srv._image_to_b64(arr)), want)


@pytest.mark.parametrize("fmt,name", [("GIF", "GIF"), ("BMP", "BMP"), ("TIFF", "TIFF")])
def test_other_formats_raise_naming_them(fmt, name):
    b64 = _pil_b64(Image.new("RGB", (8, 8)), fmt)
    with pytest.raises(ValueError, match=name):
        srv._b64_to_image(b64)


def test_progressive_jpeg_raises():
    b64 = _pil_b64(Image.new("RGB", (16, 16), (40, 90, 200)), "JPEG", progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        srv._b64_to_image(b64)


# ---------------------------------------------------------------- command line

def _args(*extra):
    return srv.parser().parse_args(["--device", "cpu", "--dezero", *extra])


def test_data_parallel_raises_naming_m12():
    with pytest.raises(NotImplementedError, match="M12"):
        srv.build_session(_args("--data_parallel"), create=small_create)


def test_xla_only_flags_print_their_line_and_set_nothing(capsys, tmp_path):
    before = dict(os.environ)
    session = srv.build_session(_args("--aot_dir", str(tmp_path), "--split_programs",
                                      "--batch_window_ms", "0"), create=small_create)
    out = capsys.readouterr().out.splitlines()
    assert out == [srv.NO_EFFECT["aot_dir"], srv.NO_EFFECT["split_programs"]]
    assert dict(os.environ) == before and not os.listdir(tmp_path)
    assert session.batcher is None and session.features.allow_random
    assert session._modality() == "text" and srv.parser().parse_args([]).device == "cuda"


def test_device_streams_off_the_card():
    streams = srv.DeviceStreams(torch.device("cpu"))
    assert not streams.on_card and not srv.DeviceStreams(None).on_card
    out, done = streams.run(lambda: torch.ones(2, 3))
    assert done is None
    assert streams.to_host(out[:1], done).tolist() == [[1.0, 1.0, 1.0]]
    with streams.for_features():
        pass


def test_launch_counters_under_threads(monkeypatch):
    """Sixteen threads launching at once through a flash wrapper's and a
    ctypes wrapper's counters (the C entry stubbed), the interpreter
    switching every microsecond: no launch is lost."""
    from gligen_tpu_torch.ops import launch
    from gligen_tpu_torch.ops.flash_attention import Counted

    class _Kernel(launch.Kernel):
        ROUTES = ("bf16",)

    monkeypatch.setattr(launch, "c_entry", lambda library, entry, argtypes: lambda *a: 0)
    monkeypatch.setattr(launch.torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    flash, kernel = Counted(), _Kernel()
    n, each = 16, 2000

    def count():
        for _ in range(each):
            flash._count("tma")
            kernel._launch(None, route="bf16")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _join([threading.Thread(target=count) for _ in range(n)])
    finally:
        sys.setswitchinterval(interval)
    assert flash.launches == flash.routes["tma"] == n * each
    assert kernel.launches == kernel.routes["bf16"] == n * each


def test_port_session_close_stops_the_batcher():
    """``close`` ends the worker and the collector (which hold the
    pipeline), after the calls in flight."""
    session = ServingSession(_CountingPipeline(), HashTokenizer(), batch_window_ms=5)
    assert len(session.generate(_box("p", 2))["images"]) == 2
    session.close()
    assert not session.batcher._worker.is_alive() and not session.batcher._collector.is_alive()
