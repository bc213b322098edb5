"""Transformer blocks with the GLIGEN gated fusers (counterpart of
``gligen_tpu/models/layers.py``).

Two paths compute the same blocks, picked as in the JAX package by
``GLIGEN_TPU_FUSED_PROJ`` (default ``"1"``, read at call time):

  * the fused path (``_fused_proj_ok``): every LayerNorm -> projection,
    projection -> gated residual and LayerNorm -> GEGLU chain is one
    kernel of ``ops/fused_proj.py``, but inside the gatedSA2 and gatedCA
    fusers, which take the module path as in the JAX package;
  * the module path (``GLIGEN_TPU_FUSED_PROJ=0``, or fewer tokens than
    the floor): LayerNorm and Dense modules, one op at a time.

Both read the same parameters, so the state dict does not depend on it.
Every kernel output is differentiable, so both paths train.  Under
``use_checkpoint`` (training) a ``SpatialTransformer`` recomputes each
block in the backward (``GLIGEN_TPU_REMAT_POLICY``: all of it, or, under
``dots``, all but its 2-D products) and its blocks take the fused path
only from 1024 tokens (``small_n=False``).
``Normalize`` and ``LayerNorm`` go through ``ops/basic.py``'s dispatchers:
under ``GLIGEN_TPU_FUSED_NORM`` ('gn' by default) a CUDA tensor takes the
GroupNorm or LayerNorm kernel of ``ops/fused_norm.py``.

Layout: token rows are (B, N, C) and images NHWC, as in the JAX package.
Submodule and parameter names mirror the JAX parameter tree (``to_q``,
``net_0``, ``transformer_blocks_0``...), so ``convert/from_jax.py`` is a
mechanical key map.  Convolutions take NHWC and hand cuDNN a
``channels_last`` NCHW view of it (a permute, no copy).

Every module has a compute ``dtype``: fp32 parameters are cast to it at
each call (the JAX modules' ``dtype`` semantics).

Tensor parallelism (``parallel/sharding.py:shard_unet_``) gives a sharded
``SelfAttention``, ``CrossAttention`` or ``FeedForward`` its TP group
(``tp``; None unsharded): it then holds this rank's heads or GEGLU columns
and returns its partial output, the bias after its in-sharded projection
added on TP rank 0 only.  Its caller reads the region's input through
``mesh.copy_in`` and sums the partials with ``mesh.reduce_out`` after its
gate (the module path), or passes ``matmul_residual`` a zero residual and
bias on the other ranks and reduces its output (the fused path), so a
gate's and a norm's gradient are partial sums on both paths.  Unsharded,
both collectives are the identity and the blocks compute what they did.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from gligen_tpu_torch.ops.attention import multi_head_attention
from gligen_tpu_torch.ops.basic import group_norm, layer_norm
from gligen_tpu_torch.ops.fused_proj import ln_geglu, ln_matmuls, matmul_residual
from gligen_tpu_torch.ops.interpolate import resize_2d
from gligen_tpu_torch.parallel.mesh import copy_in, reduce_out


class Dense(nn.Linear):
    """nn.Linear computing in ``dtype`` over fp32 parameters."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
        """``with_bias=False`` leaves the bias out (a TP partial on a rank
        other than 0)."""
        dt = self.compute_dtype
        bias = None if self.bias is None or not with_bias else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """A conv over an NHWC tensor, computing in ``dtype``: SAME-padded
    (``kernel // 2`` on each side) unless ``padding`` says otherwise (0 is
    VALID); ``groups`` as ``nn.Conv2d``'s (the depthwise conv's is the
    channel count)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False,
                 padding: Optional[int] = None, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding, groups=groups)
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
        """``with_bias=False`` leaves the bias out (a TP partial on a rank
        other than 0)."""
        dt = self.compute_dtype
        w = self.weight.to(dt, memory_format=torch.channels_last)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, self.bias.to(dt) if with_bias else None,
                     self.stride, self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


def first_rank(tp) -> bool:
    """Whether this process adds a TP region's replicated terms (the bias
    after an in-sharded weight, the residual): TP rank 0, or any process
    of an unsharded module."""
    return tp is None or tp.rank == 0


@contextlib.contextmanager
def computing_in(root: nn.Module, dtype: torch.dtype) -> Iterator[nn.Module]:
    """Every module under ``root`` computes in ``dtype`` inside the block
    (its ``compute_dtype`` or ``dtype``), then goes back to its own: the
    JAX modules' ``clone(dtype=...)`` over the same fp32 parameters."""
    saved = [(m, attr, getattr(m, attr)) for m in root.modules()
             for attr in ("compute_dtype", "dtype")
             if isinstance(getattr(m, attr, None), torch.dtype)]
    for m, attr, _ in saved:
        setattr(m, attr, dtype)
    try:
        yield root
    finally:
        for m, attr, old in saved:
            setattr(m, attr, old)


class Normalize(nn.Module):
    """GroupNorm(32) over the channel axis, fp32 statistics; eps 1e-6 is
    the attention/VAE ``Normalize``, ``act='silu'`` folds the SiLU.  The
    GroupNorm kernel under GLIGEN_TPU_FUSED_NORM 'gn' (the default) or
    'both'.  A TP shard of 1/tp of the channels keeps its 32/tp groups
    (``num_groups``)."""

    def __init__(self, channels: int, eps: float = 1e-6, act: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps
        self.act = act
        self.num_groups = 32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps,
                          act=self.act)


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-5, fp32 statistics, affine); returns x's dtype.
    The LayerNorm kernel under GLIGEN_TPU_FUSED_NORM 'ln' or 'both'."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class SelfAttention(nn.Module):
    """Queries from ``x``; keys and values from ``kv`` (default ``x``).
    Under TP (``tp``) this rank's heads and its partial output."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.tp = None
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        out = multi_head_attention(self.to_q(x), self.to_k(kv), self.to_v(kv), self.heads)
        return self.to_out(out, with_bias=first_rank(self.tp))


class CrossAttention(nn.Module):
    """Queries from ``x``; keys and values from the text context.  Under
    TP (``tp``) this rank's heads and its partial output."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.tp = None
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        out = multi_head_attention(self.to_q(x), self.to_k(context), self.to_v(context), self.heads)
        return self.to_out(out, with_bias=first_rank(self.tp))


class GEGLU(nn.Module):
    """h * gelu(gate) with the exact (erf) GELU."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (the only variant GLIGEN uses).  Under TP
    (``tp``) this rank's GEGLU columns and its partial output."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.tp = None
        self.net_0 = GEGLU(dim, dim * mult, dtype=dtype)
        self.net_2 = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net_2(self.net_0(x), with_bias=first_rank(self.tp))


def _fused_proj_ok(n: int, small_n: bool = True) -> bool:
    """Whether a block of ``n`` tokens takes the fused projection kernels
    (gligen_tpu layers.py:180-191): never unless ``GLIGEN_TPU_FUSED_PROJ``
    is "1"; from 64 tokens when ``small_n`` (inference), else from 1024
    (training, where the JAX package measured the small towers' fused
    backward slower).  On the CPU the kernels' plain versions run."""
    if os.environ.get("GLIGEN_TPU_FUSED_PROJ", "1") != "1":
        return False
    return n >= (64 if small_n else 1024)


def _row_residual(h, dense: Dense, xi, gate, tp):
    """xi + gate * (h @ W + b) through ``matmul_residual``, summed over the
    TP group: on a rank other than 0 its partial gate * h @ W (a zero
    residual and bias; the gate is linear)."""
    bias, residual = ((dense.bias, xi) if first_rank(tp) else
                      (torch.zeros_like(dense.bias), torch.zeros_like(xi)))
    return reduce_out(matmul_residual(h, dense.weight, bias, residual, gate=gate), tp)


def _fused_self_attn(x, kv, norm: LayerNorm, attn: SelfAttention, gate=None, xi=None):
    """x + gate * to_out(attention(LN -> q/k/v)) through the fused kernels;
    keys and values over ``kv`` (the fuser's [x, grounding] rows) or over x
    when it is None.  Every row is normalised on its own, so the visual
    rows of LN(kv) are LN(x): q needs LN(x) alone.  ``xi`` is x through
    ``copy_in`` where the caller built kv from it."""
    tp = attn.tp
    xi = copy_in(x, tp) if xi is None else xi
    s, b = norm.weight, norm.bias
    if kv is None:
        q, k, v = ln_matmuls(xi, s, b, (attn.to_q.weight, attn.to_k.weight, attn.to_v.weight))
    else:
        (q,) = ln_matmuls(xi, s, b, (attn.to_q.weight,))
        # the N+T rows as they are: the flash kernel masks a ragged key tile
        k, v = ln_matmuls(kv, s, b, (attn.to_k.weight, attn.to_v.weight))
    out = multi_head_attention(q, k, v, attn.heads)
    return _row_residual(out, attn.to_out, xi, gate, tp)


def _fused_cross_attn(x, context, norm: LayerNorm, attn: CrossAttention):
    """x + to_out(attention(LN(x) q, context k/v)).  The 77-token k/v
    products stay plain matmuls, as the JAX package leaves them to XLA."""
    tp = attn.tp
    xi, ci = copy_in(x, tp), copy_in(context, tp)
    (q,) = ln_matmuls(xi, norm.weight, norm.bias, (attn.to_q.weight,))
    out = multi_head_attention(q, attn.to_k(ci), attn.to_v(ci), attn.heads)
    return _row_residual(out, attn.to_out, xi, None, tp)


def _fused_ff(x, norm: LayerNorm, ff: FeedForward, gate=None):
    """x + gate * net_2(GEGLU(LN(x)))."""
    tp = ff.tp
    xi = copy_in(x, tp)
    proj = ff.net_0.proj
    h = ln_geglu(xi, norm.weight, norm.bias, proj.weight, proj.bias)
    return _row_residual(h, ff.net_2, xi, gate, tp)


class GatedFuser(nn.Module):
    """What the three gated fusers share: the zero-initialised gates
    ``alpha_attn`` and ``alpha_dense``, ``norm1``, ``norm2`` and the gated
    GEGLU feed-forward.  Each term is scaled by gate_scale * tanh(alpha)."""

    # {sharded child: this module's parameters it reads inside its TP
    # region (between ``copy_in`` and ``reduce_out``)}: their gradients are
    # partial sums over the TP ranks (``parallel/sharding.py:tp_plan``)
    TP_REGIONS = {"attn": ("norm1", "alpha_attn", "linear"), "ff": ("norm2", "alpha_dense")}

    def __init__(self, query_dim: int, dtype=torch.float32):
        super().__init__()
        self.alpha_attn = nn.Parameter(torch.zeros(()))
        self.alpha_dense = nn.Parameter(torch.zeros(()))
        self.norm1 = LayerNorm(query_dim)
        self.norm2 = LayerNorm(query_dim)
        self.ff = FeedForward(query_dim, dtype=dtype)

    def _gated_attn(self, x: torch.Tensor, attn_out: torch.Tensor, gate_scale) -> torch.Tensor:
        """x + gate * attn_out, ``attn_out`` the attention's partial under TP."""
        g1 = (gate_scale * torch.tanh(self.alpha_attn)).to(x.dtype)
        return x + reduce_out(g1 * attn_out, self.attn.tp)

    def _gated_ff(self, x: torch.Tensor, gate_scale) -> torch.Tensor:
        g2 = (gate_scale * torch.tanh(self.alpha_dense)).to(x.dtype)
        tp = self.ff.tp
        return x + reduce_out(g2 * self.ff(self.norm2(copy_in(x, tp))), tp)


class GatedSelfAttentionDense(GatedFuser):
    """The GLIGEN fuser: x += gate*tanh(alpha_attn) * SelfAttn over
    [x, W objs] for the visual rows, then the gated GEGLU feed-forward.
    Queries are computed for the visual rows only (the same result as
    attending all N+T rows and slicing, with less work).  ``small_fused``
    is ``_fused_proj_ok``'s ``small_n``."""

    def __init__(self, query_dim: int, objs_dim: int, heads: int, dim_head: int,
                 dtype=torch.float32, small_fused: bool = True):
        super().__init__(query_dim, dtype=dtype)
        self.small_fused = small_fused
        self.linear = Dense(objs_dim, query_dim, dtype=dtype)
        self.attn = SelfAttention(query_dim, heads, dim_head, dtype=dtype)

    def forward(self, x: torch.Tensor, objs: torch.Tensor, gate_scale: float = 1.0) -> torch.Tensor:
        tp = self.attn.tp
        xi = copy_in(x, tp)
        cat = torch.cat([xi, self.linear(copy_in(objs, tp))], dim=1)
        if _fused_proj_ok(x.shape[1], self.small_fused):
            # fp32 device gates, read by the kernel: no host synchronisation
            x = _fused_self_attn(x, cat, self.norm1, self.attn,
                                 gate=gate_scale * torch.tanh(self.alpha_attn), xi=xi)
            return _fused_ff(x, self.norm2, self.ff, gate=gate_scale * torch.tanh(self.alpha_dense))
        n_visual = x.shape[1]
        normed = self.norm1(cat)
        x = self._gated_attn(x, self.attn(normed[:, :n_visual], kv=normed), gate_scale)
        return self._gated_ff(x, gate_scale)


class GatedSelfAttentionDense2(GatedFuser):
    """The reference's second self-attention fuser (attention.py:251-297):
    self-attention over [x, W objs] with queries from the grounding rows
    only; their (B, g, g, C) output, resized bicubically onto the visual
    grid, is the gated residual; then the gated feed-forward.  Both token
    counts must be perfect squares.  The module path alone, as in the JAX
    package: its attention is the flash kernel on the card, its LayerNorms
    ``ops/basic.py:layer_norm``'s."""

    def __init__(self, query_dim: int, objs_dim: int, heads: int, dim_head: int,
                 dtype=torch.float32):
        super().__init__(query_dim, dtype=dtype)
        self.linear = Dense(objs_dim, query_dim, dtype=dtype)
        self.attn = SelfAttention(query_dim, heads, dim_head, dtype=dtype)

    def forward(self, x: torch.Tensor, objs: torch.Tensor, gate_scale: float = 1.0) -> torch.Tensor:
        b, n_visual, _ = x.shape
        n_ground = objs.shape[1]
        size_v, size_g = round(n_visual**0.5), round(n_ground**0.5)
        if size_v * size_v != n_visual or size_g * size_g != n_ground:
            raise ValueError(f"gatedSA2 needs square token counts, got {n_visual} visual and "
                             f"{n_ground} grounding tokens")
        tp = self.attn.tp
        normed = self.norm1(torch.cat([copy_in(x, tp), self.linear(copy_in(objs, tp))], dim=1))
        out = self.attn(normed[:, n_visual:], kv=normed).reshape(b, size_g, size_g, -1)
        residual = resize_2d(out, (size_v, size_v), mode="bicubic").reshape(b, n_visual, -1)
        return self._gated_ff(self._gated_attn(x, residual, gate_scale), gate_scale)


class GatedCrossAttentionDense(GatedFuser):
    """The reference's cross-attention fuser (attention.py:190-212): LN(x)
    attends over the grounding tokens (to_k/to_v from ``objs_dim``), as a
    gated residual; then the gated feed-forward.  The module path alone,
    as in the JAX package."""

    TP_REGIONS = {"attn": ("norm1", "alpha_attn"), "ff": ("norm2", "alpha_dense")}

    def __init__(self, query_dim: int, objs_dim: int, heads: int, dim_head: int,
                 dtype=torch.float32):
        super().__init__(query_dim, dtype=dtype)
        self.attn = CrossAttention(query_dim, objs_dim, heads, dim_head, dtype=dtype)

    def forward(self, x: torch.Tensor, objs: torch.Tensor, gate_scale: float = 1.0) -> torch.Tensor:
        tp = self.attn.tp
        x = self._gated_attn(x, self.attn(self.norm1(copy_in(x, tp)), copy_in(objs, tp)),
                             gate_scale)
        return self._gated_ff(x, gate_scale)


FUSERS = {
    "gatedSA": GatedSelfAttentionDense,
    "gatedSA2": GatedSelfAttentionDense2,
    "gatedCA": GatedCrossAttentionDense,
}


class BasicTransformerBlock(nn.Module):
    """self-attention -> gated fuser (``FUSERS[fuser_type]``) ->
    cross-attention -> feed-forward.

    ``skip_fuser`` omits the fuser; that is exact when the sampler's
    alpha gate is 0 for the step, since both fuser terms are then
    multiplied by zero.  gatedSA2 never gets the alpha schedule (its gate
    stays 1), so it refuses ``skip_fuser``.  ``small_fused`` is
    ``_fused_proj_ok``'s ``small_n``."""

    # the LayerNorm each sharded child reads inside its TP region
    # (``GatedFuser.TP_REGIONS``)
    TP_REGIONS = {"attn1": ("norm1",), "attn2": ("norm2",), "ff": ("norm3",)}

    def __init__(self, dim: int, context_dim: int, objs_dim: int, heads: int, dim_head: int,
                 fuser_type: str = "gatedSA", dtype=torch.float32, small_fused: bool = True):
        super().__init__()
        if fuser_type not in FUSERS:
            raise ValueError(f"unknown fuser {fuser_type!r}; have {sorted(FUSERS)}")
        self.fuser_type = fuser_type
        self.small_fused = small_fused
        self.norm1 = LayerNorm(dim)
        self.attn1 = SelfAttention(dim, heads, dim_head, dtype=dtype)
        extra = {"small_fused": small_fused} if fuser_type == "gatedSA" else {}
        self.fuser = FUSERS[fuser_type](dim, objs_dim, heads, dim_head, dtype=dtype, **extra)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype=dtype)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor, objs: Optional[torch.Tensor],
                gate_scale: float = 1.0, skip_fuser: bool = False) -> torch.Tensor:
        if skip_fuser and self.fuser_type == "gatedSA2":
            raise ValueError("skip_fuser with gatedSA2: it is not alpha-scheduled and never "
                             "reduces to the identity")
        fused = _fused_proj_ok(x.shape[1], self.small_fused)
        if fused:
            x = _fused_self_attn(x, None, self.norm1, self.attn1)
        else:
            tp = self.attn1.tp
            x = x + reduce_out(self.attn1(self.norm1(copy_in(x, tp))), tp)
        # the alpha schedule reaches gatedSA/gatedCA only; gatedSA2 keeps gate 1
        fuser_gate = 1.0 if self.fuser_type == "gatedSA2" else gate_scale
        if not skip_fuser:
            x = self.fuser(x, objs, fuser_gate)
        if fused:
            x = _fused_cross_attn(x, context, self.norm2, self.attn2)
            return _fused_ff(x, self.norm3, self.ff)
        tp = self.attn2.tp
        x = x + reduce_out(self.attn2(self.norm2(copy_in(x, tp)), copy_in(context, tp)), tp)
        tp = self.ff.tp
        return x + reduce_out(self.ff(self.norm3(copy_in(x, tp))), tp)


def _remat_policy() -> str:
    """GLIGEN_TPU_REMAT_POLICY, read at call time (gligen_tpu layers.py:
    669-684): 'none' stores every activation of a block, 'dots' stores
    only its 2-D products' outputs (``dots_policy``), anything else
    ('full', the default) recomputes the whole block in the backward."""
    policy = os.environ.get("GLIGEN_TPU_REMAT_POLICY", "full")
    return policy if policy in ("none", "dots") else "full"


# What ``nn.remat(policy=dots_with_no_batch_dims_saveable)`` saves: the
# ``dot_general``s without batch dimensions, the Dense projections and the
# context k/v einsum, which reach dispatch as ``mm`` (F.linear without a
# bias, matmul of a (B, N, C) by a weight) or ``addmm`` (with a bias).
DOT_OPS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The 'dots' policy of selective checkpointing: save the outputs of
    ``DOT_OPS``, recompute everything else: attention's ``bmm`` (the
    products with batch dimensions), the norms, GEGLU, the residuals, the
    collectives of tensor parallelism and FSDP's gathers (a saved gathered
    weight would undo ZeRO-3).  A hand-written kernel is launched through
    ctypes, below the dispatcher: its wrapper's Python runs again in the
    recompute and launches it again, as JAX recomputes a ``pallas_call``.
    Every kernel writes a fresh output, so none writes into a saved one."""
    if op.overloadpacket in DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.MUST_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, dots_policy)


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> transformer blocks -> proj_out, + input (NHWC).

    ``use_checkpoint`` (training): each block is recomputed in the
    backward under the 'full' and 'dots' remat policies
    (``torch.utils.checkpoint``, non-reentrant; 'dots' selectively, with
    ``dots_policy``), and its projections take the fused kernels only from
    1024 tokens."""

    def __init__(self, channels: int, context_dim: int, objs_dim: int, heads: int,
                 dim_head: int, depth: int = 1, fuser_type: str = "gatedSA",
                 dtype=torch.float32, use_checkpoint: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        self.norm = Normalize(channels)
        self.proj_in = Dense(channels, inner, dtype=dtype)
        for d in range(depth):
            self.add_module(
                f"transformer_blocks_{d}",
                BasicTransformerBlock(inner, context_dim, objs_dim, heads, dim_head,
                                      fuser_type, dtype=dtype, small_fused=not use_checkpoint),
            )
        self.proj_out = Dense(inner, channels, dtype=dtype, zero_init=True)

    def forward(self, x: torch.Tensor, context: torch.Tensor, objs: Optional[torch.Tensor],
                gate_scale: float = 1.0, skip_fuser: bool = False) -> torch.Tensor:
        b, h, w, _ = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, -1)
        policy = _remat_policy() if self.use_checkpoint else "none"
        extra = {"context_fn": _DOTS_CONTEXT} if policy == "dots" else {}
        for d in range(self.depth):
            block = getattr(self, f"transformer_blocks_{d}")
            if policy != "none":
                y = torch.utils.checkpoint.checkpoint(
                    block, y, context, objs, gate_scale, skip_fuser,
                    use_reentrant=False, preserve_rng_state=False, **extra)
            else:
                y = block(y, context, objs, gate_scale, skip_fuser)
        return self.proj_out(y.reshape(b, h, w, -1)) + x
