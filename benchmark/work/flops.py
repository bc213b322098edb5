"""The work of a request or a train step, counted from the reference's
own shapes: the reference's functions run on the meta device under
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions, 2 FLOPs a multiply-add; norms and elementwise work are not
counted), and every attention product it makes is listed with its shape
for the flash kernels' least time.  The H100's published peaks are here
too."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import model as M

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def meta_weights(cfg: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    from benchmark.program import all_shapes
    from benchmark.weights import select

    shapes = {k: torch.empty(v, device="meta") for k, v in all_shapes(cfg).items()}
    return {p: select(shapes, p) for p in ("unet", "vae", "text")}


def counted(fn) -> Tuple[float, List[tuple]]:
    """(FLOPs of ``fn()`` on meta tensors, its attention sites)."""
    from torch.utils.flop_counter import FlopCounterMode

    sites: List[tuple] = []
    M.ATTENTION_SITES[0] = sites
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
    finally:
        M.ATTENTION_SITES[0] = None
    return float(fc.get_total_flops()), sites


def grounding_inputs_meta(cfg: Dict, rows: int) -> Dict[str, torch.Tensor]:
    tok = cfg["unet"]["grounding_tokenizer"]["target"]
    if tok == "text":
        return {"boxes": torch.empty(rows, 30, 4, device="meta"),
                "masks": torch.empty(rows, 30, device="meta"),
                "positive_embeddings": torch.empty(rows, 30, 768, device="meta")}
    return {"hed_edge": torch.empty(rows, 512, 512, 3, dtype=torch.uint8, device="meta"),
            "mask": torch.empty(rows, device="meta")}


def unet_call(cfg: Dict, rows: int, fusers: bool, latent: int = 64) -> Tuple[float, List[tuple]]:
    W = meta_weights(cfg)["unet"]
    P = M.Precision("fp32")
    x = torch.empty(rows, latent, latent, 4, device="meta")
    ctx = torch.empty(rows, 77, cfg["unet"]["context_dim"], device="meta")
    t = torch.zeros(rows, dtype=torch.long, device="meta")
    n_tok = 30 if cfg["unet"]["grounding_tokenizer"]["target"] == "text" else 196
    objs = torch.empty(rows, n_tok, 768, device="meta") if fusers else None
    ds = cfg["unet"].get("grounding_downsampler")
    extra = torch.empty(rows, latent, latent, ds["params"]["out_dim"], device="meta") if ds else None
    return counted(lambda: M.unet(W, cfg["unet"], x, t, ctx, objs, 1.0, not fusers, P,
                                  extra=extra if fusers else None))


def generation_request(cfg: Dict, batch: int, steps: int, alpha, latent: int = 64) -> Dict:
    """FLOPs of one CFG request of ``batch`` images, by part, and the
    attention sites the flash kernels run (UNet calls and VAE decode)."""
    W = meta_weights(cfg)
    P = M.Precision("fp32")
    n_on = sum(1 for g in M.alpha_gates(steps, alpha) if g != 0.0)
    fuser_calls = n_on + 1 if n_on else 0    # PLMS's Heun bootstrap calls step 0 twice
    free_calls = steps + 1 - fuser_calls
    f_on, s_on = unet_call(cfg, 2 * batch, True, latent)
    f_off, s_off = unet_call(cfg, 2 * batch, False, latent)
    f_dec, s_dec = counted(lambda: M.vae_decode(W["vae"], torch.empty(batch, latent, latent, 4,
                                                                     device="meta"), P,
                                                cfg.get("vae", M.VAE)))
    ids = torch.zeros(2 * batch, 77, dtype=torch.long, device="meta")
    text = cfg.get("text", M.TEXT)
    f_text, _ = counted(lambda: M.clip_text(W["text"], ids, P, text["layers"], text["heads"]))
    f_tok, _ = counted(lambda: M.tokens_for(W["unet"], cfg["unet"],
                                            grounding_inputs_meta(cfg, 2 * batch), P))
    parts = {"unet_fusers": fuser_calls * f_on, "unet_plain": free_calls * f_off,
             "vae_decode": f_dec, "text": f_text, "grounding": f_tok}
    sites = s_on * fuser_calls + s_off * free_calls + s_dec
    return {"flops": sum(parts.values()), "parts": parts, "fuser_calls": fuser_calls,
            "free_calls": free_calls, "per_row_fusers": f_on / (2 * batch),
            "per_row_plain": f_off / (2 * batch), "attention_sites": sites}


def attention_least_s(site: tuple, elem_bytes: int = 2) -> float:
    """The least time of one flash forward at (rows, heads, queries, keys,
    head dim): its two products (4 n m d FLOPs a head) at the bf16 peak,
    or reading q, k, v and writing o once at the HBM rate, the longer."""
    b, h, n, m, d = site[:5]
    ops = 4.0 * b * h * n * m * d
    nbytes = elem_bytes * b * h * d * (2 * n + 2 * m)
    return max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def attention_bwd_least_s(site: tuple, elem_bytes: int = 2) -> float:
    """The least time of the flash backward at a forward site of the
    train step, for the gradients the step needs there: the products S =
    Q K^T again and dP = dO V^T, then dQ = dS K where q needs a gradient
    and dV = P^T dO, dK = dS^T Q where k/v do (2 n m d FLOPs a head each),
    or reading q, k, v, o, dO and writing the gradients once, the longer.
    A site where neither needs one costs nothing."""
    b, h, n, m, d, q_grad, kv_grad = site
    if not (q_grad or kv_grad):
        return 0.0
    products = 2 + int(q_grad) + 2 * int(kv_grad)
    ops = 2.0 * products * b * h * n * m * d
    nbytes = elem_bytes * b * h * d * (n * (3 + int(q_grad)) + m * (2 + 2 * int(kv_grad)))
    return max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def train_step(cfg: Dict, batch: int, size: int) -> Dict:
    """FLOPs of one train step of ``batch`` rows at ``size``^2, forward and
    backward with no recompute (the VAE encode and CLIP without
    gradients; the UNet's backward for the gradients of the trainable
    set, ``reference.train.trainable``), and the UNet's attention sites."""
    from benchmark.reference.train import trainable

    W = meta_weights(cfg)
    P = M.Precision("fp32")
    for k, v in W["unet"].items():
        if trainable(k):
            v.requires_grad_(True)
    lat = size // 8
    text = cfg.get("text", M.TEXT)

    def step():
        with torch.no_grad():
            z = M.vae_encode(W["vae"], torch.empty(batch, size, size, 3, device="meta"),
                             torch.empty(batch, lat, lat, 4, device="meta"), P,
                             cfg.get("vae", M.VAE))
            ctx = M.clip_text(W["text"], torch.zeros(batch, 77, dtype=torch.long, device="meta"),
                              P, text["layers"], text["heads"])
        objs = M.tokens_for(W["unet"], cfg["unet"], grounding_inputs_meta(cfg, batch), P)
        t = torch.zeros(batch, dtype=torch.long, device="meta")
        eps = M.unet(W["unet"], cfg["unet"], z, t, ctx, objs, 1.0, False, P)
        ((eps - z) ** 2).mean().backward()

    total, sites = counted(step)
    return {"flops": total, "attention_sites": sites}


def train_work(record: Dict) -> Dict:
    """``train_step`` of a run's cell, kept in the record."""
    if "work" not in record:
        wl = record["wl"]
        record["work"] = train_step(record["cfg"], wl["batch"], wl["image_size"])
    return record["work"]


def request_work(record: Dict) -> Dict:
    """``generation_request`` of a run's cell, kept in the record."""
    if "work" not in record:
        wl = record["wl"]
        record["work"] = generation_request(record["cfg"], wl["batch"], wl["steps"],
                                            record["cfg"]["alpha_stages"], wl["image_size"] // 8)
    return record["work"]
