"""Real-data training throughput of the port (counterpart of the JAX
package's ``tools/bench_train_realdata.py``): the host input pipeline
(base64 JPEG decode, embedding parse, center crop and box re-projection of
each 512^2 item) measured on the grounding-TSV format itself, in three modes:

  --make         write a grounding TSV in the JAX row schema: seeded fp32
                 embeddings, boxes and captions.  The port has no JPEG
                 encoder, so the image payloads are the unchanged bytes of
                 the repository's three 512^2 JPEGs
                 (inference_images/{beach,bigben,dalle2_museum}.jpg),
                 cycled: every row is a real JPEG decode.
  --input_only   the host's decode + collate rate through the Trainer's
                 ``batches`` (no card work) at ``--workers`` fork workers,
                 with the cores' worth of CPU time the decode took
                 (this process and its workers) and the serial decode ms
                 of one batch
  --train        ``Trainer.start_training`` on the card: the flagship
                 configs/flickr_text.yaml at full width, random weights,
                 the TSV dataset, sustained img/s over the logged steps

  python3 gligen_tpu_torch/tools/bench_train_realdata.py --make --rows 512
  python3 gligen_tpu_torch/tools/bench_train_realdata.py --input_only --workers 2
  python3 gligen_tpu_torch/tools/bench_train_realdata.py --train --steps 60 --workers 4

Each mode prints one JSON line.  ``main(argv, device=...)`` runs it in
process (the tests: ``--make`` and ``--input_only`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
DEFAULT_TSV = REPO / "build" / "bench_realdata" / "grounding_512.tsv"
JPEGS = tuple(REPO / "inference_images" / f"{n}.jpg" for n in ("beach", "bigben",
                                                                 "dalle2_museum"))


def make_tsv(path: str, rows: int, seed: int = 0, image_size: int = 512) -> dict:
    """``rows`` rows: the JPEGs' bytes cycled, 1 to 8 boxes each with the
    four 768-d embeddings, a caption."""
    import base64

    from gligen_tpu_torch.data.tsv import TSVWriter, encode_base64_fp32

    os.makedirs(os.path.dirname(path), exist_ok=True)
    payloads = [base64.b64encode(p.read_bytes()).decode() for p in JPEGS]
    rng = np.random.default_rng(seed)
    writer = TSVWriter(path)
    t0 = time.time()
    for i in range(rows):
        annos = []
        for _ in range(int(rng.integers(1, 9))):
            x0, y0 = rng.uniform(0, image_size * 0.6, 2)
            bw, bh = rng.uniform(image_size * 0.1, image_size * 0.4, 2)
            anno = {"bbox": [float(x0), float(y0), float(min(x0 + bw, image_size)),
                             float(min(y0 + bh, image_size))]}
            for key in ("text_embedding_before", "text_embedding_after",
                        "image_embedding_before", "image_embedding_after"):
                anno[key] = encode_base64_fp32(rng.standard_normal(768).astype(np.float32))
            annos.append(anno)
        item = {"data_id": i, "caption": f"a benchmark scene number {i}", "annos": annos,
                "image": payloads[i % len(payloads)]}
        writer.write([i, json.dumps(item)])
    writer.close()
    return {"rows": rows, "path": str(path), "mb": round(os.path.getsize(path) / 1e6, 1),
            "build_sec": round(time.time() - t0, 1),
            "images": "the bytes of inference_images/{beach,bigben,dalle2_museum}.jpg, cycled"}


def dataset(path: str):
    from gligen_tpu_torch.data.box_dataset import TSVBoxDataset

    return TSVBoxDataset(path, which_layer_text="before", which_layer_image="after",
                         image_size=512, max_boxes_per_data=30, random_flip=True,
                         prob_use_caption=0.5)


def input_shim(workers: int, batch: int = 4, modality: str = "text"):
    """The parts of ``Trainer`` that ``batches`` and ``collate`` read for
    ``modality``'s adapter, without building the model."""
    from types import SimpleNamespace

    from gligen_tpu_torch.data.tokenizer import load_tokenizer
    from gligen_tpu_torch.inference.adapters import get_adapter
    from gligen_tpu_torch.training.trainer import Trainer, TrainerConfig

    class Shim:
        run = TrainerConfig(workers=workers, batch_size=batch)
        global_batch = batch
        adapter = get_adapter(modality)
        tokenizer = staticmethod(load_tokenizer(None))
        latent_size = 64
        text_encoder = SimpleNamespace(token_embedding=SimpleNamespace(num_embeddings=49408))
        _mask_rng = np.random.default_rng(0)
        collate = Trainer.collate
        batches = Trainer.batches

    return Shim()


def _cpu_seconds() -> float:
    own, kids = resource.getrusage(resource.RUSAGE_SELF), resource.getrusage(
        resource.RUSAGE_CHILDREN)
    return own.ru_utime + own.ru_stime + kids.ru_utime + kids.ru_stime


def bench_input(path: str, workers: int, n_batches: int = 24, batch: int = 4) -> dict:
    """Batches/s through ``Trainer.batches`` after one warm batch;
    ``host_cores_busy`` is the CPU seconds of this process and its fork
    workers (reaped when the generator closes) over the wall, warm batch
    included; ``serial_decode_ms_per_batch``: ``batch`` items decoded in
    this process, one after another."""
    ds = dataset(path)
    t0 = time.perf_counter()
    for i in range(batch):
        ds[i % len(ds)]
    serial_ms = (time.perf_counter() - t0) * 1e3
    shim = input_shim(workers, batch)
    cpu0, wall0 = _cpu_seconds(), time.perf_counter()
    gen = shim.batches(ds, prefetch=2)
    next(gen)  # the pool and the page cache warm
    t0 = time.perf_counter()
    for _ in range(n_batches):
        b = next(gen)
    dt = time.perf_counter() - t0
    gen.close()
    busy = (_cpu_seconds() - cpu0) / (time.perf_counter() - wall0)
    return {"metric": "input_pipeline_images_per_sec",
            "value": round(n_batches * batch / dt, 2), "unit": "img/s",
            "batches_per_sec": round(n_batches / dt, 3), "workers": workers,
            "batch": int(b["image"].shape[0]), "host_cores_busy": round(busy, 2),
            "host_cores": os.cpu_count(), "serial_decode_ms_per_batch": round(serial_ms, 1)}


def bench_train(path: str, workers: int, steps: int, batch: int, device="cuda") -> dict:
    import shutil

    import torch

    from gligen_tpu_torch.config import load_yaml_config, normalize_model_config
    from gligen_tpu_torch.training.trainer import Trainer, TrainerConfig

    config = normalize_model_config(load_yaml_config(str(REPO / "configs" / "flickr_text.yaml")))
    out_root = os.path.join(os.path.dirname(path), "out")
    shutil.rmtree(out_root, ignore_errors=True)  # a leftover tag would resume past the end
    run = TrainerConfig(name="bench_realdata", output_root=out_root, batch_size=batch,
                        workers=workers, warmup_steps=10, total_iters=10_000,
                        save_every_iters=10_000, log_every_iters=10, dtype="bfloat16",
                        preview_samples=False)
    tr = Trainer(config, run, device=device)
    t0 = time.time()
    tr.start_training(max_iters=steps, dataset=dataset(path))
    total = time.time() - t0
    with open(tr._metrics_path) as f:
        recs = [json.loads(line) for line in f]
    recs = [r for r in recs if "sec" in r and r["iter"] >= 20]
    sec_per_step = (float(np.median([r["sec"] for r in recs])) / run.log_every_iters if recs
                    else total / max(steps, 1))
    return {"metric": "train_realdata_images_per_sec_per_chip",
            "value": round(tr.global_batch / sec_per_step, 3), "unit": "img/s",
            "workers": workers, "global_batch": tr.global_batch,
            "sec_per_step": round(sec_per_step, 4), "total_sec": round(total, 1),
            "steps": steps, "device": torch.cuda.get_device_name(0)
            if tr.device.type == "cuda" else "cpu"}


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> list:
    """Run the modes the flags ask for; returns their JSON records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tsv", default=str(DEFAULT_TSV))
    ap.add_argument("--make", action="store_true")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--input_only", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4, help="train batch")
    ap.add_argument("--batches", type=int, default=24, help="input_only batch count")
    args = ap.parse_args(argv)
    out = []
    if args.make:
        out.append(make_tsv(args.tsv, args.rows))
    if args.input_only:
        out.append(bench_input(args.tsv, args.workers, args.batches, args.batch))
    if args.train:
        out.append(bench_train(args.tsv, args.workers, args.steps, args.batch, device))
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
