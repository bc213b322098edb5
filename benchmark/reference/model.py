"""Plain PyTorch reference of SD-1.4 GLIGEN generation and training.

Functions over a flat state dict (``W``: parameter name -> tensor, the
names of the port's ``state_dict``), NHWC tensors, every product in the
precision of a ``Precision`` (fp32 with TF32 off for the reference; the
control rounds each product's operands to fp8 first).  It follows the
published SD-1.4 / GLIGEN equations (ldm's openaimodel.py, attention.py,
GLIGEN's text and hed grounding nets, ConvNeXt-tiny, the SD AutoencoderKL,
CLIP ViT-L/14's text tower) and imports nothing of the program.

Departures from the published models, shared with the program: GroupNorm
and LayerNorm statistics in fp32; the gate-0 steps of the alpha schedule
run no fuser (exact: both fuser terms are multiplied by 0).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Tensor = torch.Tensor

def fp8_round(t: Tensor, dtype=torch.float8_e4m3fn) -> Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale that takes its
    largest magnitude to the format's largest, back in fp32."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """fp8 training's operands: e4m3 in the forward, and the gradient
    that reaches the operand rounded to e5m2 in the backward (each with
    its own per-tensor scale), as fp8 GEMMs take them."""

    @staticmethod
    def forward(ctx, t):
        return fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g.float(), torch.float8_e5m2)


class Precision:
    """The arithmetic of every product of the reference: ``fp32`` leaves
    its operands as they are (fp32; the caller turns TF32 off), ``fp8``
    rounds each operand to float8_e4m3fn with a per-tensor scale (its
    largest magnitude to the format's largest) and computes the product of
    the rounded values in fp32, as an fp8 GEMM with fp32 accumulation does;
    in a backward the gradients reaching the operands are rounded to
    e5m2 likewise."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: Tensor) -> Tensor:
        t = t.float()
        if self.name == "fp32":
            return t
        return _Fp8.apply(t) if t.requires_grad else fp8_round(t)


def lin(W, name: str, x: Tensor, P: Precision, bias: bool = True) -> Tensor:
    w = W[f"{name}.weight"]
    b = W.get(f"{name}.bias") if bias else None
    return F.linear(P.q(x), P.q(w), None if b is None else b.float())


def conv(W, name: str, x: Tensor, P: Precision, stride: int = 1, padding: Optional[int] = None,
         groups: int = 1) -> Tensor:
    """NHWC conv; SAME-padded (k // 2) unless ``padding`` is given."""
    w = W[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    y = F.conv2d(P.q(x).permute(0, 3, 1, 2), P.q(w), W[f"{name}.bias"].float(), stride, pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def group_norm(W, name: str, x: Tensor, eps: float, silu: bool = False, groups: int = 32) -> Tensor:
    b, c = x.shape[0], x.shape[-1]
    g = x.float().reshape(b, -1, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    y = y * W[f"{name}.weight"] + W[f"{name}.bias"]
    return F.silu(y) if silu else y


def layer_norm(W, name: str, x: Tensor, eps: float = 1e-5) -> Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], eps)


# every attention product the reference computes: (rows, heads, queries,
# keys, head dim, whether q and whether k/v need a gradient), appended by
# ``attention`` while a list is installed here
ATTENTION_SITES: List[Optional[list]] = [None]


def attention(q: Tensor, k: Tensor, v: Tensor, heads: int, P: Precision,
              causal: bool = False) -> Tensor:
    """softmax(q k^T / sqrt(d)) v per head; q (B, N, H*d), k/v (B, M, H*d)."""
    b, n, hd = q.shape
    m, d = k.shape[1], hd // heads
    if ATTENTION_SITES[0] is not None:
        ATTENTION_SITES[0].append((b, heads, n, m, d, q.requires_grad,
                                   k.requires_grad or v.requires_grad))
    qh = P.q(q).reshape(b, n, heads, d).transpose(1, 2)
    kh = P.q(k).reshape(b, m, heads, d).transpose(1, 2)
    vh = P.q(v).reshape(b, m, heads, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * d ** -0.5
    if causal:
        s = s + torch.full((n, m), float("-inf"), device=s.device).triu(1)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(P.q(p), vh)
    return out.transpose(1, 2).reshape(b, n, hd)


def self_attn(W, name: str, x: Tensor, P: Precision, heads: int, kv: Optional[Tensor] = None,
              context: Optional[Tensor] = None) -> Tensor:
    """to_out(attention(to_q x, to_k/to_v of kv or context or x))."""
    src = context if context is not None else (x if kv is None else kv)
    out = attention(lin(W, f"{name}.to_q", x, P, bias=False), lin(W, f"{name}.to_k", src, P, bias=False),
                    lin(W, f"{name}.to_v", src, P, bias=False), heads, P)
    return lin(W, f"{name}.to_out", out, P)


def feed_forward(W, name: str, x: Tensor, P: Precision) -> Tensor:
    h, gate = lin(W, f"{name}.net_0.proj", x, P).chunk(2, dim=-1)
    return lin(W, f"{name}.net_2", h * F.gelu(gate), P)


# ----------------------------------------------------------------- the UNet


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float64,
                                                           device=t.device) / half)
    args = t.double()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


def res_block(W, name: str, x: Tensor, emb: Tensor, P: Precision) -> Tensor:
    h = conv(W, f"{name}.in_layers_2", group_norm(W, f"{name}.in_layers_0", x, 1e-5, True), P)
    h = h + lin(W, f"{name}.emb_layers_1", F.silu(emb), P)[:, None, None, :]
    h = conv(W, f"{name}.out_layers_3", group_norm(W, f"{name}.out_layers_0", h, 1e-5, True), P)
    skip = conv(W, f"{name}.skip_connection", x, P) if f"{name}.skip_connection.weight" in W else x
    return skip + h


def gated_self_attention(W, name: str, x: Tensor, objs: Tensor, gate: float, P: Precision,
                         heads: int) -> Tensor:
    """GLIGEN's gatedSA fuser: the visual tokens attend over [x, W objs]."""
    n = x.shape[1]
    normed = layer_norm(W, f"{name}.norm1", torch.cat([x, lin(W, f"{name}.linear", objs, P)], 1))
    g1 = gate * torch.tanh(W[f"{name}.alpha_attn"])
    x = x + g1 * self_attn(W, f"{name}.attn", normed[:, :n], P, heads, kv=normed)
    g2 = gate * torch.tanh(W[f"{name}.alpha_dense"])
    return x + g2 * feed_forward(W, f"{name}.ff", layer_norm(W, f"{name}.norm2", x), P)


def transformer_block(W, name: str, x: Tensor, ctx: Tensor, objs: Optional[Tensor], gate: float,
                      P: Precision, heads: int) -> Tensor:
    x = x + self_attn(W, f"{name}.attn1", layer_norm(W, f"{name}.norm1", x), P, heads)
    if objs is not None:
        x = gated_self_attention(W, f"{name}.fuser", x, objs, gate, P, heads)
    x = x + self_attn(W, f"{name}.attn2", layer_norm(W, f"{name}.norm2", x), P, heads, context=ctx)
    return x + feed_forward(W, f"{name}.ff", layer_norm(W, f"{name}.norm3", x), P)


def spatial_transformer(W, name: str, x: Tensor, ctx: Tensor, objs: Optional[Tensor], gate: float,
                        P: Precision, heads: int) -> Tensor:
    b, h, w, c = x.shape
    y = lin(W, f"{name}.proj_in", group_norm(W, f"{name}.norm", x, 1e-6), P).reshape(b, h * w, -1)
    y = transformer_block(W, f"{name}.transformer_blocks_0", y, ctx, objs, gate, P, heads)
    return lin(W, f"{name}.proj_out", y.reshape(b, h, w, -1), P) + x


def unet_layout(cfg: Dict) -> Dict[str, list]:
    """The ldm UNet's blocks as lists of (kind, module name):
    ``input``, ``middle`` and ``output`` (openaimodel.py's construction)."""
    mc, mult, nres = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    attn_res = cfg["attention_resolutions"]
    inputs, chans, ds, idx = [], [mc], 1, 1
    for level, m in enumerate(mult):
        for _ in range(nres):
            block = [("res", f"input_blocks_{idx}_0")]
            if ds in attn_res:
                block.append(("st", f"input_blocks_{idx}_1"))
            inputs.append(block)
            chans.append(m * mc)
            idx += 1
        if level != len(mult) - 1:
            inputs.append([("down", f"input_blocks_{idx}_0")])
            chans.append(m * mc)
            ds *= 2
            idx += 1
    middle = [("res", "middle_block_0"), ("st", "middle_block_1"), ("res", "middle_block_2")]
    outputs, idx = [], 0
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nres + 1):
            block, j = [("res", f"output_blocks_{idx}_0")], 1
            if ds in attn_res:
                block.append(("st", f"output_blocks_{idx}_{j}"))
                j += 1
            if level and i == nres:
                block.append(("up", f"output_blocks_{idx}_{j}"))
                ds //= 2
            outputs.append(block)
            idx += 1
    return {"input": inputs, "middle": middle, "output": outputs}


def unet(W, cfg: Dict, x: Tensor, t: Tensor, ctx: Tensor, objs: Optional[Tensor], gate: float,
         use_sd: bool, P: Precision, extra: Optional[Tensor] = None,
         checkpoint: bool = False) -> Tensor:
    """eps(x_t, t | ctx, grounding tokens ``objs``) of the GLIGEN UNet;
    ``objs`` None runs no fuser; ``use_sd`` runs the SD first conv, else
    GLIGEN's over [x, ``extra``] (a grounding downsampler's channels).
    ``checkpoint`` recomputes each block in the backward (memory only)."""
    heads = cfg["num_heads"]
    emb = timestep_embedding(t, cfg["model_channels"])
    emb = lin(W, "time_embed_2", F.silu(lin(W, "time_embed_0", emb, P)), P)
    if use_sd:
        h = conv(W, "first_conv_sd", x, P)
    else:
        h = conv(W, "input_blocks_0_0", x if extra is None else torch.cat([x, extra], -1), P)

    def run(block, h):
        for kind, name in block:
            if kind == "res":
                h = res_block(W, name, h, emb, P)
            elif kind == "st":
                h = spatial_transformer(W, name, h, ctx, objs, gate, P, heads)
            elif kind == "down":
                h = conv(W, f"{name}.op", h, P, stride=2)
            else:
                h = conv(W, f"{name}.conv", h.repeat_interleave(2, 1).repeat_interleave(2, 2), P)
        return h

    if checkpoint:
        plain = run

        def run(block, h):
            return torch.utils.checkpoint.checkpoint(plain, block, h, use_reentrant=False)

    layout = unet_layout(cfg)
    hs = [h]
    for block in layout["input"]:
        h = run(block, h)
        hs.append(h)
    h = run(layout["middle"], h)
    for block in layout["output"]:
        h = run(block, torch.cat([h, hs.pop()], -1))
    return conv(W, "out_2", group_norm(W, "out_0", h, 1e-5, True), P)


# ------------------------------------------------------- grounding tokenizers


def fourier_embed(x: Tensor, num_freqs: int = 8, temperature: float = 100.0) -> Tensor:
    """GLIGEN's FourierEmbedder: for each frequency, sin of every
    coordinate, then cos of every coordinate."""
    out = []
    for f in range(num_freqs):
        freq = temperature ** (f / num_freqs)
        out += [torch.sin(freq * x), torch.cos(freq * x)]
    return torch.cat(out, -1)


def text_position_net(W, boxes: Tensor, masks: Tensor, embeddings: Tensor, P: Precision) -> Tensor:
    """GLIGEN's text grounding net (text_grounding_net.py)."""
    p = "position_net"
    m = masks[..., None].float()
    xyxy = fourier_embed(boxes.float())
    emb = embeddings.float() * m + (1 - m) * W[f"{p}.null_positive_feature"]
    xyxy = xyxy * m + (1 - m) * W[f"{p}.null_position_feature"]
    h = F.silu(lin(W, f"{p}.linears_0", torch.cat([emb, xyxy], -1), P))
    return lin(W, f"{p}.linears_4", F.silu(lin(W, f"{p}.linears_2", h, P)), P)


def convnext_tiny(W, name: str, x: Tensor, P: Precision, depths=(3, 3, 9, 3)) -> Tensor:
    """ConvNeXt-tiny's four stages over an NHWC map (no head)."""
    for i, depth in enumerate(depths):
        if i == 0:
            x = conv(W, f"{name}.downsample_layers_0_0", x, P, stride=4, padding=0)
            x = layer_norm(W, f"{name}.downsample_layers_0_1", x, 1e-6)
        else:
            x = layer_norm(W, f"{name}.downsample_layers_{i}_0", x, 1e-6)
            x = conv(W, f"{name}.downsample_layers_{i}_1", x, P, stride=2, padding=0)
        for j in range(depth):
            s = f"{name}.stages_{i}_{j}"
            h = conv(W, f"{s}.dwconv", x, P, padding=3, groups=x.shape[-1])
            h = lin(W, f"{s}.pwconv2", F.gelu(lin(W, f"{s}.pwconv1", layer_norm(W, f"{s}.norm", h, 1e-6),
                                                  P)), P)
            x = x + W[f"{s}.gamma"] * h
    return x


def map_to_unit(edge: Tensor) -> Tensor:
    """uint8 pixels -> [-1, 1] fp32."""
    return edge.float() / 255.0 * 2.0 - 1.0


def hed_position_net(W, edge: Tensor, mask: Tensor, P: Precision, resize: int = 448) -> Tensor:
    """GLIGEN's hed grounding net: the map resized to ``resize``^2 by
    nearest, ConvNeXt-tiny, the null feature where ``mask`` is 0, the
    position embedding, a 3-layer SiLU MLP."""
    p = "position_net"
    b, h = edge.shape[0], edge.shape[1]
    idx = torch.arange(resize, device=edge.device) * h // resize
    x = map_to_unit(edge)[:, idx][:, :, idx]
    feats = convnext_tiny(W, f"{p}.convnext_tiny_backbone", x, P)
    feats = feats.reshape(b, -1, feats.shape[-1])
    m = mask.reshape(-1, 1, 1).float()
    feats = feats * m + (1 - m) * W[f"{p}.null_feature"] + W[f"{p}.pos_embedding"]
    h1 = F.silu(lin(W, f"{p}.linears_0", feats, P))
    return lin(W, f"{p}.linears_4", F.silu(lin(W, f"{p}.linears_2", h1, P)), P)


def hed_downsampler(edge: Tensor, size: int = 64) -> Tensor:
    """GLIGEN's hed grounding downsampler: channel 0 of the map, bicubic
    (A = -0.75, align_corners False) to ``size``^2."""
    x = map_to_unit(edge[..., :1]).permute(0, 3, 1, 2)
    y = F.interpolate(x.double(), size=(size, size), mode="bicubic", align_corners=False)
    return y.float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------- CLIP text


def clip_text(W, ids: Tensor, P: Precision, layers: int = 12, heads: int = 12) -> Tensor:
    """CLIP ViT-L/14's text tower: last hidden state after the final LN."""
    n = ids.shape[1]
    x = W["token_embedding.weight"][ids] + W["position_embedding.weight"][:n][None]
    for i in range(layers):
        p = f"layers_{i}"
        h = layer_norm(W, f"{p}.layer_norm1", x)
        q, k, v = (lin(W, f"{p}.self_attn.{s}_proj", h, P) for s in "qkv")
        x = x + lin(W, f"{p}.self_attn.out_proj", attention(q, k, v, heads, P, causal=True), P)
        h = lin(W, f"{p}.mlp_fc1", layer_norm(W, f"{p}.layer_norm2", x), P)
        x = x + lin(W, f"{p}.mlp_fc2", h * torch.sigmoid(1.702 * h), P)
    return layer_norm(W, "final_layer_norm", x)


# ---------------------------------------------------------------------- VAE


def vae_resnet(W, name: str, x: Tensor, P: Precision) -> Tensor:
    h = conv(W, f"{name}.conv1", group_norm(W, f"{name}.norm1", x, 1e-6, True), P)
    h = conv(W, f"{name}.conv2", group_norm(W, f"{name}.norm2", h, 1e-6, True), P)
    skip = conv(W, f"{name}.nin_shortcut", x, P) if f"{name}.nin_shortcut.weight" in W else x
    return skip + h


def vae_attn(W, name: str, x: Tensor, P: Precision) -> Tensor:
    b, h, w, c = x.shape
    hn = group_norm(W, f"{name}.norm", x, 1e-6).reshape(b, h * w, c)
    out = attention(lin(W, f"{name}.q", hn, P), lin(W, f"{name}.k", hn, P), lin(W, f"{name}.v", hn, P),
                    1, P)
    return x + lin(W, f"{name}.proj_out", out, P).reshape(b, h, w, c)


VAE = {"ch": 128, "ch_mult": (1, 2, 4, 4), "num_res_blocks": 2}
TEXT = {"hidden_size": 768, "layers": 12, "heads": 12}
VAE_SCALE = 0.18215


def vae_decode(W, z: Tensor, P: Precision, vae: Dict = VAE) -> Tensor:
    """Latent (B, h, w, 4) -> image (B, 8h, 8w, 3), roughly in [-1, 1]."""
    d = "decoder"
    mult = vae["ch_mult"]
    h = conv(W, "post_quant_conv", z / VAE_SCALE, P)
    h = conv(W, f"{d}.conv_in", h, P)
    h = vae_resnet(W, f"{d}.mid_block_2", vae_attn(W, f"{d}.mid_attn_1",
                                                    vae_resnet(W, f"{d}.mid_block_1", h, P), P), P)
    for level in reversed(range(len(mult))):
        for j in range(vae["num_res_blocks"] + 1):
            h = vae_resnet(W, f"{d}.up_{level}_block_{j}", h, P)
        if level:
            h = conv(W, f"{d}.up_{level}_upsample.conv",
                     h.repeat_interleave(2, 1).repeat_interleave(2, 2), P)
    return conv(W, f"{d}.conv_out", group_norm(W, f"{d}.norm_out", h, 1e-6, True), P)


def vae_encode(W, image: Tensor, noise: Tensor, P: Precision, vae: Dict = VAE) -> Tensor:
    """Image (B, H, W, 3) in [-1, 1] -> a posterior sample * scale factor."""
    e = "encoder"
    mult = vae["ch_mult"]
    h = conv(W, f"{e}.conv_in", image, P)
    for level in range(len(mult)):
        for j in range(vae["num_res_blocks"]):
            h = vae_resnet(W, f"{e}.down_{level}_block_{j}", h, P)
        if level != len(mult) - 1:
            h = conv(W, f"{e}.down_{level}_downsample.conv", F.pad(h, (0, 0, 0, 1, 0, 1)), P,
                     stride=2, padding=0)
    h = vae_resnet(W, f"{e}.mid_block_2", vae_attn(W, f"{e}.mid_attn_1",
                                                    vae_resnet(W, f"{e}.mid_block_1", h, P), P), P)
    h = conv(W, f"{e}.conv_out", group_norm(W, f"{e}.norm_out", h, 1e-6, True), P)
    mean, logvar = conv(W, "quant_conv", h, P).chunk(2, -1)
    return (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise) * VAE_SCALE


def image_from(decoded: Tensor) -> Tensor:
    return decoded.float().clamp(-1.0, 1.0) * 0.5 + 0.5


def tokens_for(W, cfg: Dict, grounding: Dict[str, Tensor], P: Precision) -> Tensor:
    """The grounding tokens of the config's tokenizer."""
    kind = cfg["grounding_tokenizer"]["target"]
    if kind == "text":
        return text_position_net(W, grounding["boxes"], grounding["masks"],
                                 grounding["positive_embeddings"], P)
    if kind == "hed":
        return hed_position_net(W, grounding["hed_edge"], grounding["mask"], P,
                                cfg["grounding_tokenizer"]["params"].get("resize_input", 448))
    raise ValueError(f"the reference has no tokenizer {kind!r}")


def null_grounding(grounding: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Classifier-free guidance's null grounding input: zeros of every input."""
    return {k: torch.zeros_like(v) for k, v in grounding.items()}


def downsampler_features(cfg: Dict, grounding_extra: Optional[Tensor]) -> Optional[Tensor]:
    ds = cfg.get("grounding_downsampler")
    if ds is None:
        return None
    if ds["target"] != "hed":
        raise ValueError(f"the reference has no downsampler {ds['target']!r}")
    return hed_downsampler(grounding_extra)


def alpha_gates(steps: int, stages: Sequence[float]) -> List[float]:
    """GLIGEN's alpha schedule: stage fractions of gate 1, a linear decay and 0."""
    n0, n1 = int(stages[0] * steps), int(stages[1] * steps)
    decay = [(n1 - 1 - k) / n1 for k in range(n1)] if n1 else []
    return [1.0] * n0 + decay + [0.0] * (steps - n0 - n1)
