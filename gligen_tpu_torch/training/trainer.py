"""Training orchestration (counterpart of ``gligen_tpu/training/trainer.py``,
the reference's trainer.py Trainer).

Builds the four components from a reference-style config, overlays the
official SD checkpoint and a GLIGEN checkpoint (the widened first conv
zero-extended), applies the selective-freeze optimizer, feeds host-side
batches from the dataset catalog through the grounding adapters, and runs
the train step on the card: loss logging every 10 iters
(trainer.py:394-396), periodic checkpoints and PLMS preview grids
(save_ckpt_and_result, trainer.py:412-484), tagXX auto-resume
(trainer.py:126-153), and a checkpoint at the step boundary on SIGTERM.

The global batch is ``batch_size`` times the processes of the group
(``parallel/mesh.py``; one card, one process: ``batch_size``), as the JAX
package's per-device batch times its devices.  Every process takes the
same permutation of the data and decodes only its rows of each global
batch; the step averages the gradients over the group.  Only process zero
logs, saves, previews and writes the preemption checkpoint; every process
resumes from the checkpoint process zero finds.  The step's draws come
from a ``torch.Generator`` on the card seeded from ``run.seed`` (the same
on every process: each keeps its rows of the global draws); the data
order and augmentation from numpy generators seeded from it, as in the
JAX package, and, past process zero, from the process's rank.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import queue
import signal
import threading
import time
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from gligen_tpu_torch.convert.widen import FIRST_CONV, add_additional_channels
from gligen_tpu_torch.data import png
from gligen_tpu_torch.data.catalog import dataset_catalog
from gligen_tpu_torch.data.concat import ConCatDataset
from gligen_tpu_torch.data.inpaint_masks import draw_masks_from_boxes
from gligen_tpu_torch.data.tokenizer import load_tokenizer
from gligen_tpu_torch.inference.adapters import get_adapter
from gligen_tpu_torch.inference.cli import DTYPES
from gligen_tpu_torch.inference.pipeline import GenerationPipeline, GligenComponents
from gligen_tpu_torch.parallel import mesh as dp
from gligen_tpu_torch.training import checkpoints as ckpt_io
from gligen_tpu_torch.training.train_step import create_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    """Run hyperparameters (reference main.py:16-50 argparse flags)."""

    name: str = "test"
    output_root: str = "OUTPUT"
    data_root: str = "DATA"
    base_learning_rate: float = 5e-5
    weight_decay: float = 0.0
    warmup_steps: int = 10_000
    scheduler_type: str = "constant"
    total_iters: int = 500_000
    batch_size: int = 2  # per process (one card each), the reference's per-GPU batch
    save_every_iters: int = 5_000
    log_every_iters: int = 10
    enable_ema: bool = False
    ema_rate: float = 0.9999
    inpaint_mode: bool = False
    randomize_fg_mask: bool = False
    random_add_bg_mask: bool = False
    official_ckpt_name: Optional[str] = None  # path to sd-v1-4.ckpt
    ckpt: Optional[str] = None  # GLIGEN ckpt to start from (inpaint training)
    grounding_modality: str = "text"
    dtype: str = "bfloat16"
    seed: int = 123
    workers: int = 1  # host decode processes (reference DataLoader workers)
    preview_samples: bool = False  # PLMS preview grids at save points
    preview_steps: int = 50
    preview_guidance: float = 5.0  # trainer.py:463 uses scale 5 for previews
    preview_use_ema: bool = False  # sample previews from the EMA shadow
    vocab_path: Optional[str] = None
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 10..12
    # Directory of <tsv-stem>.latents.npy posterior-moment caches
    # (tools/prepare_latents.py): the frozen VAE encode drops out of the
    # train step, the same loss for the same draws.
    cached_latents: Optional[str] = None


class Trainer:
    def __init__(self, model_config: Dict[str, Any], run: TrainerConfig, device: Any = "cuda"):
        """Components of ``model_config`` on ``device`` (the card unless the
        caller asks for the CPU), resumed from the newest checkpoint of
        ``<output_root>/<name>/tagNN`` if one exists."""
        self.run = run
        self.model_config = model_config
        self.device = torch.device(device)
        # Persistent host RNG for per-batch stroke masks: the reference
        # resamples masks every batch (trainer.py:340-344).
        self._mask_rng = np.random.default_rng(run.seed + 0x5EED)

        # ---- components (trainer.py:181-184) ----
        unet_config = dict(model_config["model"]["params"])
        unet_config.pop("image_size", None)
        unet_config["use_checkpoint"] = True
        unet_config["inpaint_mode"] = run.inpaint_mode
        self.latent_size = model_config["model"]["params"].get("image_size", 64)
        diff = model_config.get("diffusion", {}).get("params", {})
        self.components = GligenComponents.create(
            unet_config=unet_config, dtype=DTYPES[run.dtype], seed=run.seed, device=self.device,
            vae_config=model_config.get("autoencoder", {}).get("params", {}),
            text_config=model_config.get("text_encoder", {}).get("params", {}),
            schedule_config={k: diff[k] for k in ("timesteps", "linear_start", "linear_end")
                             if k in diff})
        self.unet, self.vae = self.components.unet, self.components.vae
        self.text_encoder, self.schedule = self.components.text_encoder, self.components.schedule
        self.adapter = get_adapter(run.grounding_modality)
        self.tokenizer = load_tokenizer(run.vocab_path)
        self.rank = dp.process_index()
        self.global_batch = run.batch_size * dp.world_size()

        # ---- weights: official SD / GLIGEN ckpt / random ----
        if run.official_ckpt_name:
            loaded = ckpt_io.load_official_sd_checkpoint(run.official_ckpt_name)
            for key, module in (("model", self.unet), ("autoencoder", self.vae),
                                ("text_encoder", self.text_encoder)):
                merge_loaded(module, loaded[key])
        if run.ckpt:
            merge_loaded(self.unet, ckpt_io.load_gligen_torch_checkpoint(run.ckpt)[0]["model"])

        # ---- optimizer + selective freeze (trainer.py:217-245) ----
        input_conv_train = run.inpaint_mode or (
            model_config["model"]["params"].get("grounding_downsampler") is not None)
        self.state = create_train_state(
            self.unet, input_conv_train=input_conv_train, enable_ema=run.enable_ema,
            base_lr=run.base_learning_rate, weight_decay=run.weight_decay,
            warmup_steps=run.warmup_steps, total_steps=run.total_iters,
            scheduler_type=run.scheduler_type)

        # ---- auto resume (trainer.py:126-153,291-304): process zero picks
        # the tag and the checkpoint, every process loads it ----
        found = ckpt_io.find_resume_dir(run.output_root, run.name) if self.rank == 0 else None
        self.tag_dir, resume_path = dp.broadcast_object(found)
        self.starting_iter = 0
        if resume_path:
            load_state(self.state, ckpt_io.restore_training_checkpoint(resume_path))
            self.starting_iter = self.state.step
            print(f"resumed from {resume_path} at iter {self.starting_iter}", flush=True)

        self._train_step = make_train_step(self.unet, self.vae, self.text_encoder, self.schedule,
                                           ema_rate=run.ema_rate)
        self._metrics_path = os.path.join(self.tag_dir, "metrics.jsonl")
        # process zero's TensorBoard scalars (trainer.py:151,394-396), only
        # where it imports; metrics.jsonl is the record
        self._tb = None
        if self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(self.tag_dir, "tb"))

    # -------------------------------------------------------------- data
    def build_dataset(self):
        names = self.model_config.get("train_dataset_names", {})
        ds = ConCatDataset.from_catalog(names, dataset_catalog(self.run.data_root))
        if self.run.cached_latents:
            self.attach_latent_caches(ds)
        return ds

    def attach_latent_caches(self, concat_ds) -> None:
        """Attach a LatentCache to every member dataset (a missing cache
        raises: a half-cached mixture would collate batches with other
        keys), built from THIS run's VAE weights by the params digest."""
        from gligen_tpu_torch.data.latent_cache import LatentCache, cache_path_for, params_digest

        digest = params_digest(self.vae)
        for member in concat_ds.datasets:
            tsv = getattr(getattr(member, "tsv_file", None), "tsv_file", None)
            if tsv is None or not hasattr(member, "latent_cache"):
                raise ValueError(f"cached_latents: {type(member).__name__} has no latent-cache "
                                 "support (only TSV box datasets do)")
            path = cache_path_for(tsv, self.run.cached_latents)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no latent cache for {tsv}; build it with `python3 "
                    f"gligen_tpu_torch/tools/prepare_latents.py --tsv {tsv} --out_dir "
                    f"{self.run.cached_latents}`")
            cache = LatentCache(path, expect_image_size=member.image_size)
            got = cache.meta.get("params_digest")
            if got is not None and got != digest:
                raise ValueError(f"latent cache {path} was built from different VAE weights "
                                 f"(digest {got} != {digest}); rebuild it")
            member.latent_cache = cache

    def batches(self, dataset, prefetch: int = 2) -> Iterator[Dict[str, Any]]:
        """Infinite epoch-shuffled host batches (trainer.py:103-106), made
        by a background thread so that decode and collate overlap the
        step; with ``workers > 1`` each batch's items decode in a fork pool
        (the reference's DataLoader workers), or with
        ``GLIGEN_TPU_DECODE_POOL=thread`` a thread pool.  In a process group
        each process decodes its rows (``process_batch_slice``) of each
        global batch of the one permutation; past process zero its
        augmentation seeds (in process, and each fork worker's) add
        ``RANK_SEED_STRIDE`` times its rank.  Closing the generator
        releases the pool."""
        pool = tpool = None
        rank = dp.process_index()
        seed = self.run.seed + RANK_SEED_STRIDE * rank
        if rank:
            _reseed(dataset, seed)
        if self.run.workers > 1:
            if os.environ.get("GLIGEN_TPU_DECODE_POOL", "fork") == "thread":
                from concurrent.futures import ThreadPoolExecutor

                tpool = ThreadPoolExecutor(self.run.workers)
            else:
                # fork: the dataset rides into the workers by address space;
                # TSVFile reopens per PID, the native reader preads
                pool = mp.get_context("fork").Pool(
                    self.run.workers, initializer=_decode_worker_init,
                    initargs=(dataset, seed))

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        closing = threading.Event()
        failure = []

        def decode(idx):
            """The items of ``idx``, or None once the consumer closes."""
            if pool is None:
                return (list(tpool.map(dataset.__getitem__, idx)) if tpool is not None
                        else [dataset[j] for j in idx])
            pending = pool.map_async(_decode_one, idx)
            while not closing.is_set():  # a terminated pool never answers a blocking map
                try:
                    return pending.get(timeout=0.1)
                except mp.TimeoutError:
                    continue
            return None

        def worker():
            try:
                rng = np.random.default_rng(self.run.seed)
                bs = self.global_batch
                rows = dp.process_batch_slice(bs)
                while not closing.is_set():
                    order = rng.permutation(len(dataset))
                    for i in range(0, len(order) - bs + 1, bs):
                        items = decode([int(j) for j in order[i : i + bs][rows]])
                        if items is None:
                            return
                        batch = self.collate(items)
                        while not closing.is_set():
                            try:
                                q.put(batch, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if closing.is_set():
                            return
            except Exception as e:  # surfaced to the consumer, unless it is closing
                if not closing.is_set():
                    failure.append(e)
                    q.put(None)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    raise failure[0]
                yield batch
        finally:
            # close/GC must not leak the pools: each fork worker holds a
            # copy-on-write image of this process
            closing.set()
            thread.join(timeout=10)
            if pool is not None:
                pool.terminate()
                pool.join()
            if tpool is not None:
                tpool.shutdown(wait=False, cancel_futures=True)

    def collate(self, items) -> Dict[str, Any]:
        captions = [it["caption"] for it in items]
        # fold into the model's vocab (a no-op for the real 49408 CLIP vocab;
        # guards small test configs fed by the hash fallback tokenizer)
        input_ids = self.tokenizer(captions) % self.text_encoder.token_embedding.num_embeddings
        batch: Dict[str, Any] = {
            "image": np.stack([it["image"] for it in items]),
            "input_ids": input_ids,
        }
        if "latent_moments" in items[0]:
            batch["latent_moments"] = np.stack([it["latent_moments"] for it in items])
        raw = {k: np.stack([np.asarray(it[k]) for it in items])
               for k in items[0] if k not in ("image", "caption", "id", "latent_moments")}
        batch["grounding"] = self.adapter.prepare(raw)
        extra = self.adapter.prepare_extra(raw)
        if extra is not None:
            batch["grounding_extra"] = extra
        if self.run.inpaint_mode:
            batch["inpainting_mask"] = draw_masks_from_boxes(
                raw["boxes"], self.latent_size, randomize_fg_mask=self.run.randomize_fg_mask,
                random_add_bg_mask=self.run.random_add_bg_mask, rng=self._mask_rng)
        return batch

    # -------------------------------------------------------------- loop
    def start_training(self, max_iters: Optional[int] = None, dataset=None):
        """Train from ``starting_iter`` to ``total_iters`` (or
        ``max_iters``); returns the ``TrainState``."""
        run = self.run
        dataset = dataset if dataset is not None else self.build_dataset()
        total = min(run.total_iters, max_iters or run.total_iters)

        # Preemption (absent in the reference): a SIGTERM checkpoints at the
        # next step boundary and returns, so tagXX resume continues from
        # the exact step.
        preempted = threading.Event()
        try:
            prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: preempted.set())
        except ValueError:  # not the main thread
            prev_handler = None

        # the same seed on every process: each keeps its rows of the global draws
        generator = torch.Generator(device=self.device).manual_seed(run.seed + 7)
        loader = self.batches(dataset)
        profiler = None
        t_last = time.time()
        try:
            for it in range(self.starting_iter, total):
                if run.profile_dir and it == self.starting_iter + 10:
                    profiler = _start_profile(self.device)
                host_batch = next(loader)
                batch = host_batch
                if "latent_moments" in batch:  # cached latents: no pixels to the card
                    batch = {k: v for k, v in host_batch.items() if k != "image"}
                metrics = self._train_step(self.state, batch, generator=generator)
                if profiler is not None and it == self.starting_iter + 12:
                    _stop_profile(profiler, run.profile_dir, self.device)
                    profiler = None

                lead = dp.is_process_zero()
                if lead and it % run.log_every_iters == 0:
                    loss = float(metrics["loss"])  # the global batch's
                    dt = time.time() - t_last
                    t_last = time.time()
                    self._log({"iter": it, "loss": loss, "sec": round(dt, 3)})
                if lead and (it == total - 1
                             or (it > self.starting_iter and it % run.save_every_iters == 0)):
                    self._save()
                    if run.preview_samples:
                        self.save_preview(host_batch, it)
                # a SIGTERM on any process stops every one at this boundary
                if dp.host_any(preempted.is_set()):
                    if lead:
                        self._save()
                        self._log({"iter": it, "event": "preempted, checkpointed"})
                    break
        finally:
            loader.close()
            if self._tb is not None:
                self._tb.flush()
            if profiler is not None:
                profiler.__exit__(None, None, None)
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        # return once process zero's checkpoint is written, on every process
        dp.barrier()
        return self.state

    def _log(self, rec: Dict[str, Any]):
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None and "loss" in rec:
            self._tb.add_scalar("loss", rec["loss"], rec["iter"])
        print(rec, flush=True)

    def _save(self) -> str:
        return ckpt_io.save_training_checkpoint(
            self.tag_dir, self.state.step, state_dict_of(self.state),
            config={"model": _jsonable(self.model_config), "run": dataclasses.asdict(self.run)})

    @torch.no_grad()
    def save_preview(self, host_batch: Mapping[str, Any], it: int) -> str:
        """In-training PLMS sample grid (trainer.py:419-470): samples from
        the batch's conditioning (guidance ``preview_guidance``, draws from
        a generator seeded 1000 + it) above the batch's real images, as
        ``preview_<it>.png``, and the captions in ``captions.txt``.  An
        inpaint model samples as the JAX preview does (trainer.py:522-530):
        plain PLMS, no blend of a known region; the batch's own latents,
        encoded by the VAE at its dtype, reach the UNet only as
        ``inpainting_extra`` = concat(z * m, m)."""
        swapped = self._swap_ema() if self.run.preview_use_ema else None
        try:
            b = host_batch["image"].shape[0]
            generator = torch.Generator(device=self.device).manual_seed(1000 + it)
            extra = None
            if "inpainting_mask" in host_batch:
                extra = self.preview_inpainting_extra(host_batch, generator)
            images = GenerationPipeline(self.components).generate(
                host_batch["input_ids"], np.zeros_like(host_batch["input_ids"]),
                host_batch["grounding"], steps=self.run.preview_steps,
                guidance_scale=self.run.preview_guidance, sampler="plms",
                grounding_extra=host_batch.get("grounding_extra"), inpainting_extra=extra,
                latent_size=self.latent_size, generator=generator)
        finally:
            if swapped is not None:
                self._swap_ema(swapped)
        fake = images.cpu().numpy()
        real = np.asarray(host_batch["image"]) * 0.5 + 0.5
        grid = np.concatenate([np.concatenate(list(fake), axis=1),
                               np.concatenate(list(real), axis=1)], axis=0)
        out = os.path.join(self.tag_dir, f"preview_{it:08d}.png")
        png.write_png(out, (grid * 255).astype(np.uint8))
        captions = [str(c) for c in host_batch.get("captions", [])] or ["<tokenized>"] * b
        with open(os.path.join(self.tag_dir, "captions.txt"), "a") as f:
            f.write(f"iter {it}: " + " | ".join(captions) + "\n")
        return out

    def preview_inpainting_extra(self, host_batch: Mapping[str, Any],
                                 generator: torch.Generator) -> torch.Tensor:
        """concat(z * m, m) of the batch: z its images' posterior sample by
        the VAE at the VAE's own dtype (noise drawn first from
        ``generator``), m its inpainting mask."""
        vae_dtype = next(self.vae.parameters()).dtype
        image = torch.as_tensor(host_batch["image"], device=self.device).to(vae_dtype)
        m = torch.as_tensor(host_batch["inpainting_mask"], device=self.device).float()
        noise = torch.randn(m.shape[:3] + (4,), generator=generator, device=self.device)
        z = self.vae.encode(image, noise).float()
        return torch.cat([z * m, m], dim=-1)

    def _swap_ema(self, saved: Optional[Dict[str, torch.Tensor]] = None):
        """Load the EMA shadow into the trainable parameters and return
        their values, or (``saved``) put those values back."""
        if self.state.ema_params is None:
            raise ValueError("preview_use_ema=True but training ran without enable_ema")
        with torch.no_grad():
            if saved is not None:
                for n, p in self.state.params.items():
                    p.copy_(saved[n])
                return None
            live = {n: p.detach().clone() for n, p in self.state.params.items()}
            for n, p in self.state.params.items():
                p.copy_(self.state.ema_params[n])
            return live

    def model_params(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """Every UNet tensor by name, the trainable ones live or (``use_ema``)
        their EMA shadow (trainer.py:121-123,252-257)."""
        out = {n: t.detach() for n, t in self.unet.state_dict().items()}
        if use_ema:
            if self.state.ema_params is None:
                raise ValueError("use_ema=True but training ran without enable_ema")
            out.update(self.state.ema_params)
        return out


def state_dict_of(state) -> Dict[str, Any]:
    """A ``TrainState`` as the checkpoint holds it."""
    out = {
        "step": state.step,
        "train_params": {n: p.detach() for n, p in state.params.items()},
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
    }
    if state.ema_params is not None:
        out["ema_params"] = dict(state.ema_params)
    return out


def load_state(state, saved: Mapping[str, Any]) -> None:
    """Restore ``saved`` (``state_dict_of``) into ``state`` in place: the
    trainable tensors and EMA copied, the optimizer's and schedule's state
    loaded.  A trainable name the checkpoint lacks, or one it has that the
    state lacks, raises."""
    if set(saved["train_params"]) != set(state.params):
        raise ValueError("the checkpoint's trainable tensors are not this model's: "
                         f"{sorted(set(saved['train_params']) ^ set(state.params))[:4]}")
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(saved["train_params"][n])
        if state.ema_params is not None:
            if saved.get("ema_params") is None:
                raise ValueError("enable_ema is on but the checkpoint has no EMA shadow")
            for n, e in state.ema_params.items():
                e.copy_(saved["ema_params"][n])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])


def merge_loaded(module: nn.Module, loaded: Mapping[str, torch.Tensor]) -> None:
    """Overlay a checkpoint's tensors on ``module`` in place, keeping the
    initial values of names the checkpoint lacks (the fusers atop official
    SD) and skipping names the module lacks.  A first conv narrower than
    the module's is zero-extended (convert_ckpt.py add_additional_channels,
    trainer.py:189-194); any other shape mismatch raises."""
    current = module.state_dict()
    with torch.no_grad():
        for name, val in loaded.items():
            if name not in current:
                continue
            if current[name].shape != val.shape:
                if name != FIRST_CONV or val.shape[1] > current[name].shape[1]:
                    raise ValueError(f"{name}: checkpoint {tuple(val.shape)}, "
                                     f"model {tuple(current[name].shape)}")
                val = add_additional_channels({FIRST_CONV: val},
                                              current[name].shape[1] - val.shape[1])[FIRST_CONV]
            current[name].copy_(val)


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * (device.type == "cuda")
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, directory: str, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


_WORKER_DATASET = None
# the augmentation seeds of process r add r times this (``Trainer.batches``)
RANK_SEED_STRIDE = 1_000_003


def _decode_worker_init(dataset, seed: int) -> None:
    """Pool initializer (fork): pin the dataset and de-correlate its
    per-worker augmentation RNG (the DataLoader worker_init_fn contract):
    forked workers otherwise share the parent's RNG state and would draw
    the same flips and drops for different items."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    import multiprocessing as mp

    rank = mp.current_process()._identity[0] if mp.current_process()._identity else 0
    _reseed(dataset, seed + 1000 * rank)


def _reseed(dataset, seed: int) -> None:
    """Re-draw ``dataset``'s augmentation RNG from ``seed``."""
    if hasattr(dataset, "reseed"):
        dataset.reseed(seed)
    elif hasattr(dataset, "rng"):
        dataset.rng = np.random.default_rng(seed)


def _decode_one(index: int):
    return _WORKER_DATASET[index]


def _jsonable(obj):
    return json.loads(json.dumps(obj, default=str))
