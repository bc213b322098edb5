"""The parameter names and shapes of SD-1.4 GLIGEN (the UNet with its
grounding tokenizer, the SD AutoencoderKL, CLIP ViT-L/14's text tower),
worked out from a configuration alone; the names are the program's
``state_dict`` keys (torch layouts: Linear (out, in), Conv (O, I, kh, kw)),
so the harness can load one set of weights into both sides and refuse a
program whose parameters differ."""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference.model import VAE, unet_layout

Shapes = Dict[str, Tuple[int, ...]]


def _dense(out: Shapes, name: str, cin: int, cout: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = (cout, cin)
    if bias:
        out[f"{name}.bias"] = (cout,)


def _conv(out: Shapes, name: str, cin: int, cout: int, k: int, groups: int = 1) -> None:
    out[f"{name}.weight"] = (cout, cin // groups, k, k)
    out[f"{name}.bias"] = (cout,)


def _norm(out: Shapes, name: str, c: int) -> None:
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)


def _attn(out: Shapes, name: str, c: int, ctx: int) -> None:
    for p in ("to_q",):
        _dense(out, f"{name}.{p}", c, c, bias=False)
    _dense(out, f"{name}.to_k", ctx, c, bias=False)
    _dense(out, f"{name}.to_v", ctx, c, bias=False)
    _dense(out, f"{name}.to_out", c, c)


def _ff(out: Shapes, name: str, c: int) -> None:
    _dense(out, f"{name}.net_0.proj", c, 8 * c)
    _dense(out, f"{name}.net_2", 4 * c, c)


def _convnext(out: Shapes, name: str, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)) -> None:
    _conv(out, f"{name}.downsample_layers_0_0", 3, dims[0], 4)
    _norm(out, f"{name}.downsample_layers_0_1", dims[0])
    for i in range(1, 4):
        _norm(out, f"{name}.downsample_layers_{i}_0", dims[i - 1])
        _conv(out, f"{name}.downsample_layers_{i}_1", dims[i - 1], dims[i], 2)
    for i, depth in enumerate(depths):
        d = dims[i]
        for j in range(depth):
            s = f"{name}.stages_{i}_{j}"
            _conv(out, f"{s}.dwconv", d, d, 7, groups=d)
            _norm(out, f"{s}.norm", d)
            _dense(out, f"{s}.pwconv1", d, 4 * d)
            _dense(out, f"{s}.pwconv2", 4 * d, d)
            out[f"{s}.gamma"] = (d,)


def position_net(cfg: Dict) -> Tuple[Shapes, int]:
    """(shapes under ``position_net.``, the grounding tokens' width)."""
    tok = cfg["grounding_tokenizer"]
    params, out = tok.get("params", {}), {}
    out_dim = params.get("out_dim", 768)
    p = "position_net"
    if tok["target"] == "text":
        in_dim = params.get("in_dim", 768)
        out[f"{p}.null_positive_feature"] = (in_dim,)
        out[f"{p}.null_position_feature"] = (64,)
        _dense(out, f"{p}.linears_0", in_dim + 64, 512)
    elif tok["target"] == "hed":
        tokens = (params.get("resize_input", 448) // 32) ** 2
        _convnext(out, f"{p}.convnext_tiny_backbone")
        out[f"{p}.null_feature"] = (768,)
        out[f"{p}.pos_embedding"] = (1, tokens, 768)
        _dense(out, f"{p}.linears_0", 768, 512)
    else:
        raise ValueError(f"no tokenizer {tok['target']!r}")
    _dense(out, f"{p}.linears_2", 512, 512)
    _dense(out, f"{p}.linears_4", 512, out_dim)
    return out, out_dim


def unet_shapes(cfg: Dict) -> Shapes:
    out, objs_dim = position_net(cfg)
    mc, ctx = cfg["model_channels"], cfg["context_dim"]
    emb = 4 * mc
    _dense(out, "time_embed_0", mc, emb)
    _dense(out, "time_embed_2", emb, emb)
    ds = cfg.get("grounding_downsampler")
    extra = 0 if ds is None else ds.get("params", {}).get("out_dim", 8)
    _conv(out, "input_blocks_0_0", cfg["in_channels"] + extra, mc, 3)
    _conv(out, "first_conv_sd", cfg["in_channels"], mc, 3)
    layout = unet_layout(cfg)
    mult = cfg["channel_mult"]
    # channels after each block of the down branch, and the walk back up
    ch, chans = mc, [mc]

    def res(name, cin, cout):
        _norm(out, f"{name}.in_layers_0", cin)
        _conv(out, f"{name}.in_layers_2", cin, cout, 3)
        _dense(out, f"{name}.emb_layers_1", emb, cout)
        _norm(out, f"{name}.out_layers_0", cout)
        _conv(out, f"{name}.out_layers_3", cout, cout, 3)
        if cin != cout:
            _conv(out, f"{name}.skip_connection", cin, cout, 1)

    def st(name, c):
        _norm(out, f"{name}.norm", c)
        _dense(out, f"{name}.proj_in", c, c)
        b = f"{name}.transformer_blocks_0"
        _norm(out, f"{b}.norm1", c)
        _attn(out, f"{b}.attn1", c, c)
        f = f"{b}.fuser"
        out[f"{f}.alpha_attn"] = ()
        out[f"{f}.alpha_dense"] = ()
        _norm(out, f"{f}.norm1", c)
        _norm(out, f"{f}.norm2", c)
        _ff(out, f"{f}.ff", c)
        _dense(out, f"{f}.linear", objs_dim, c)
        _attn(out, f"{f}.attn", c, c)
        _norm(out, f"{b}.norm2", c)
        _attn(out, f"{b}.attn2", c, ctx)
        _norm(out, f"{b}.norm3", c)
        _ff(out, f"{b}.ff", c)
        _dense(out, f"{name}.proj_out", c, c)

    level_of = []  # the channel width of each down block, in order
    for level, m in enumerate(mult):
        level_of += [m * mc] * cfg["num_res_blocks"] + ([m * mc] if level != len(mult) - 1 else [])
    for block, cout in zip(layout["input"], level_of):
        for kind, name in block:
            if kind == "res":
                res(name, ch, cout)
                ch = cout
            elif kind == "st":
                st(name, ch)
            else:
                _conv(out, f"{name}.op", ch, ch, 3)
        chans.append(ch)
    res("middle_block_0", ch, ch)
    st("middle_block_1", ch)
    res("middle_block_2", ch, ch)
    outs = [m * mc for m in reversed(mult) for _ in range(cfg["num_res_blocks"] + 1)]
    for block, cout in zip(layout["output"], outs):
        for kind, name in block:
            if kind == "res":
                res(name, ch + chans.pop(), cout)
                ch = cout
            elif kind == "st":
                st(name, ch)
            else:
                _conv(out, f"{name}.conv", ch, ch, 3)
    _norm(out, "out_0", ch)
    _conv(out, "out_2", ch, cfg["out_channels"], 3)
    return out


def vae_shapes(vae: Dict = VAE) -> Shapes:
    out: Shapes = {}
    ch, mult, nres = vae["ch"], vae["ch_mult"], vae["num_res_blocks"]

    def resnet(name, cin, cout):
        _norm(out, f"{name}.norm1", cin)
        _conv(out, f"{name}.conv1", cin, cout, 3)
        _norm(out, f"{name}.norm2", cout)
        _conv(out, f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            _conv(out, f"{name}.nin_shortcut", cin, cout, 1)

    def mid(p, c):
        resnet(f"{p}.mid_block_1", c, c)
        _norm(out, f"{p}.mid_attn_1.norm", c)
        for s in ("q", "k", "v", "proj_out"):
            _dense(out, f"{p}.mid_attn_1.{s}", c, c)
        resnet(f"{p}.mid_block_2", c, c)

    _conv(out, "encoder.conv_in", 3, ch, 3)
    c = ch
    for level, m in enumerate(mult):
        for j in range(nres):
            resnet(f"encoder.down_{level}_block_{j}", c, ch * m)
            c = ch * m
        if level != len(mult) - 1:
            _conv(out, f"encoder.down_{level}_downsample.conv", c, c, 3)
    mid("encoder", c)
    _norm(out, "encoder.norm_out", c)
    _conv(out, "encoder.conv_out", c, 8, 3)
    _conv(out, "quant_conv", 8, 8, 1)
    _conv(out, "post_quant_conv", 4, 4, 1)
    c = ch * mult[-1]
    _conv(out, "decoder.conv_in", 4, c, 3)
    mid("decoder", c)
    for level in reversed(range(len(mult))):
        for j in range(nres + 1):
            resnet(f"decoder.up_{level}_block_{j}", c, ch * mult[level])
            c = ch * mult[level]
        if level:
            _conv(out, f"decoder.up_{level}_upsample.conv", c, c, 3)
    _norm(out, "decoder.norm_out", c)
    _conv(out, "decoder.conv_out", c, 3, 3)
    return out


def clip_shapes(vocab: int = 49408, d: int = 768, layers: int = 12, positions: int = 77) -> Shapes:
    out: Shapes = {"token_embedding.weight": (vocab, d), "position_embedding.weight": (positions, d)}
    for i in range(layers):
        p = f"layers_{i}"
        _norm(out, f"{p}.layer_norm1", d)
        for s in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{p}.self_attn.{s}", d, d)
        _norm(out, f"{p}.layer_norm2", d)
        _dense(out, f"{p}.mlp_fc1", d, 4 * d)
        _dense(out, f"{p}.mlp_fc2", 4 * d, d)
    _norm(out, "final_layer_norm", d)
    return out
