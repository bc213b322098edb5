"""Plain reference of one GLIGEN generation request: CLIP text, the
grounding tokens (CFG's null grounding included), the grounding
downsampler's channels, PLMS (the Heun bootstrap, then Adams-Bashforth)
with classifier-free guidance, the alpha schedule's fuser gate and SD
first conv, and the VAE decode (ldm's plms.py, GLIGEN's
gligen_inference.py and plms.py)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import model as M


def ddpm_alphas_cumprod(timesteps: int = 1000, linear_start: float = 0.00085,
                        linear_end: float = 0.012) -> np.ndarray:
    """ldm's "linear" schedule: betas linear in sqrt space (float64)."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def plms_tables(steps: int, schedule: Dict) -> Dict[str, np.ndarray]:
    """The DDIM sub-sequence (c = T // S, +1 shift) in sampling order, with
    alpha_t and alpha_prev as float32 (ldm's ddim tables)."""
    acp = ddpm_alphas_cumprod(**schedule).astype(np.float32)
    total = len(acp)
    ts = np.arange(0, total - 1, total // steps) + 1
    a_t = acp[ts]
    a_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
    order = np.arange(len(ts))[::-1]
    return {"ts": ts[order], "ts_next": np.concatenate([ts[order][1:], ts[order][-1:]]),
            "a_t": a_t[order], "a_prev": a_prev[order]}


AB = ((1.0, 0.0, 0.0, 0.0), (1.5, -0.5, 0.0, 0.0), (23 / 12, -16 / 12, 5 / 12, 0.0),
      (55 / 24, -59 / 24, 37 / 24, -9 / 24))


def generate(W: Dict[str, Dict], cfg: Dict, ids: torch.Tensor, uc_ids: torch.Tensor, grounding: Dict[str, torch.Tensor],
             noise: torch.Tensor, steps: int, guidance: float, alpha: Sequence[float],
             P: M.Precision, grounding_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Images in [0, 1], (B, 8h, 8w, 3) fp32, of rows ``ids`` (B, 77)
    starting from ``noise`` (B, h, w, 4); ``W`` holds the ``unet``,
    ``vae`` and ``text`` weights.  Each step's CFG pair is one
    2B-row UNet call, as GLIGEN batches it."""
    unet_cfg, sched = cfg["unet"], cfg["schedule"]
    tables = plms_tables(steps, sched)
    n = len(tables["ts"])
    gates = M.alpha_gates(n, alpha)
    fuser_on = [g != 0.0 for g in gates]
    last_on = max([i for i in range(n) if fuser_on[i]], default=-1)
    text = cfg.get("text", M.TEXT)
    ctx = torch.cat([M.clip_text(W["text"], i, P, text["layers"], text["heads"])
                     for i in (ids, uc_ids)])
    objs = torch.cat([M.tokens_for(W["unet"], unet_cfg, grounding, P),
                      M.tokens_for(W["unet"], unet_cfg, M.null_grounding(grounding), P)])
    extra = M.downsampler_features(unet_cfg, grounding_extra)
    extra = None if extra is None else torch.cat([extra, extra])
    b = ids.shape[0]

    def eps(x, t, i):
        gate = float(gates[i])
        # gate 0 from step ``last_on + 1`` to the end: no fuser, SD's first conv
        tail = i > last_on
        tt = torch.full((2 * b,), int(t), device=x.device)
        e = M.unet(W["unet"], unet_cfg, torch.cat([x, x]), tt, ctx, None if tail else objs, gate, tail, P,
                   extra=None if tail else extra)
        e_c, e_u = e.chunk(2)
        return e_u + guidance * (e_c - e_u)

    def update(x, e, i):
        a_t, a_prev = float(tables["a_t"][i]), float(tables["a_prev"][i])
        pred_x0 = (x - np.sqrt(1.0 - a_t) * e) / np.sqrt(a_t)
        return np.sqrt(a_prev) * pred_x0 + np.sqrt(1.0 - a_prev) * e

    x = noise.float()
    e_t = eps(x, tables["ts"][0], 0)
    e_next = eps(update(x, e_t, 0), tables["ts_next"][0], 0)
    x = update(x, (e_t + e_next) / 2.0, 0)
    hist = [e_t]
    for i in range(1, n):
        e_t = eps(x, tables["ts"][i], i)
        c = AB[min(i, 3)]
        e_prime = c[0] * e_t + sum(c[k + 1] * hist[k] for k in range(min(i, 3)))
        x = update(x, e_prime, i)
        hist = [e_t] + hist[:2]
    return M.image_from(M.vae_decode(W["vae"], x, P, cfg.get("vae", M.VAE)))
