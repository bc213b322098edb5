"""Plain reference of the GLIGEN train step: the eps-MSE loss over the
VAE-encoded image (posterior sample), CLIP's text, ``q_sample`` at a
uniform timestep, the whole-batch grounding drop of classifier-free
guidance and the UNet with every fuser at gate 1 (GLIGEN's
ldm/models/diffusion/ddpm.py and trainer.py), the gradients of the
trainable set (the fusers and the position net), and AdamW (Loshchilov and
Hutter, decoupled weight decay), all in fp32.  The batch's rows are taken
in blocks whose gradients are summed, each block's UNet recomputed block
by block in the backward (``torch.utils.checkpoint``) so that it fits."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.utils.checkpoint

from benchmark.reference import model as M
from benchmark.reference.generate import ddpm_alphas_cumprod


def trainable(name: str) -> bool:
    """GLIGEN's trainable set: the gated fusers of the transformer blocks
    and the grounding tokenizer."""
    return ("transformer_blocks" in name and "fuser" in name) or name.startswith("position_net")


def loss_and_grads(W: Dict[str, Dict], cfg: Dict, batch: Dict, draws: Dict, P: M.Precision,
                   block_rows: int, drop_prob: float = 0.1):
    """(loss, {trainable name: gradient}) of one step on ``batch`` with
    the step's ``draws`` (posterior, u_t, noise, u_drop)."""
    Wu = dict(W["unet"])
    params = {k: v.detach().clone().requires_grad_(True) for k, v in Wu.items() if trainable(k)}
    Wu.update(params)
    acp = ddpm_alphas_cumprod(**cfg["schedule"])
    sa = torch.tensor(np.sqrt(acp).astype(np.float32), device=batch["image"].device)
    sb = torch.tensor(np.sqrt(1.0 - acp).astype(np.float32), device=batch["image"].device)
    steps = len(acp)
    b = batch["image"].shape[0]
    drop = bool(draws["u_drop"] < drop_prob)
    text = cfg.get("text", M.TEXT)
    total = 0.0
    for s in range(0, b, block_rows):
        rows = slice(s, min(s + block_rows, b))
        with torch.no_grad():
            z = M.vae_encode(W["vae"], batch["image"][rows].float(), draws["posterior"][rows],
                             P, cfg.get("vae", M.VAE))
            ctx = M.clip_text(W["text"], batch["input_ids"][rows], P, text["layers"], text["heads"])
        t = torch.clamp((draws["u_t"][rows].float() * steps).long(), max=steps - 1)
        noise = draws["noise"][rows].float()
        x = sa[t].reshape(-1, 1, 1, 1) * z + sb[t].reshape(-1, 1, 1, 1) * noise
        grounding = {k: (torch.zeros_like(v) if drop else v)[rows]
                     for k, v in batch["grounding"].items()}
        objs = M.tokens_for(Wu, cfg["unet"], grounding, P)
        eps = M.unet(Wu, cfg["unet"], x, t, ctx, objs, 1.0, False, P, checkpoint=True)
        loss = ((eps - noise) ** 2).sum() / float(b * noise[0].numel())
        loss.backward()
        total += float(loss.detach())
        del eps, loss, objs, x, z, ctx
    return total, {k: v.grad for k, v in params.items()}


class AdamW:
    """AdamW with bias correction: m, v, then p -= lr * (m_hat / (sqrt(v_hat) + eps))
    after p *= 1 - lr * weight_decay."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, betas[0], betas[1], eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p = params[k]
            p.mul_(1.0 - self.lr * self.wd)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def follow(W: Dict[str, Dict], cfg: Dict, batches: List[Dict], draws: List[Dict], P: M.Precision,
           block_rows: int, lr: float) -> Dict:
    """The reference's first ``len(batches)`` steps from ``W``: each
    step's loss, the first step's gradients, and the trainable
    parameters after the last step."""
    Wu = {k: v.detach().clone() for k, v in W["unet"].items()}
    opt = AdamW(lr)
    losses, first = [], None
    for batch, d in zip(batches, draws):
        loss, grads = loss_and_grads({**W, "unet": Wu}, cfg, batch, d, P, block_rows)
        losses.append(loss)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            opt.step(Wu, grads)
    return {"losses": losses, "grad": first, "params": {k: v for k, v in Wu.items() if trainable(k)}}
