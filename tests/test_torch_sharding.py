"""Tensor parallelism and FSDP of the port (``gligen_tpu_torch/parallel/
sharding.py``, ``parallel/fsdp.py``) on the CPU, against ``gligen_tpu``:

  * the port's ``tp_spec`` and ``fsdp_spec`` agree with the JAX rules on
    which parameters of the tiny UNet (``tests/test_tp_sharding.py``'s
    configuration) are sharded and on which dim, through the layout map
    (Dense (I, O) -> (O, I), HWIO -> OIHW); the per-pair plan agrees with
    them but for the two named placements (``PLACEMENT_EXCEPTIONS``);
  * ``shard_state_dict`` then ``gather_state_dict`` gives the full state
    back bit for bit, and the JAX parameters load straight into a rank's
    shards;
  * over two gloo processes (one launch): the FSDP train step, and the
    TP = 2 forward under ``GLIGEN_TPU_FUSED_PROJ=1``, ``=0`` and
    ``GLIGEN_TPU_FUSED_CONV=1``, and of the gatedSA2 and gatedCA UNets,
    against the JAX unsharded ``unet.apply`` (atol 2e-5, rtol 1e-5,
    ``test_tp_sharding.py:151-153``'s);
  * over four processes (one launch): the dp2 x tp2 train step.

Each step runs at a latent of 32^2 (1024 tokens, so the training step's
blocks reach the fused helpers, which the workers count) on the global
batch of 2 with the JAX draws, and is held to the one-process step: the
loss within ``LOSS_RTOL`` of it and of the JAX loss, every gathered
trainable gradient within ``GRAD_RTOL`` of its tensor's largest entry, the
ranks bit for bit.  After the step (AdamW at lr 1e-4, whose first update
is lr * g / (|g| + 1e-8)) every gathered trainable tensor equals its
one-process value to 1e-2 * lr + 1e-6 |p| wherever the one-process
gradient exceeds max(2 GRAD_RTOL of its largest entry, 1e-6): there the
two gradients have one sign and the two updates differ by at most
lr * 1e-8 / 1e-6; elsewhere by at most the 2 lr of a flipped sign.

The workers (``tests/torch_dp_worker.py shard``) import no JAX.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from gligen_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.unet import UNetModel as JaxUNet
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE
from gligen_tpu.parallel import sharding as jsh
from gligen_tpu.training import train_step as jts

from gligen_tpu_torch.convert.from_jax import load_jax_params, load_module_from_jax
from gligen_tpu_torch.inference.pipeline import GligenComponents
from gligen_tpu_torch.models.unet import UNetModel
from gligen_tpu_torch.parallel import sharding
from gligen_tpu_torch.parallel.mesh import TensorParallel
from gligen_tpu_torch.training import train_step as tts

from test_torch_modules import grounding_inputs, rand, random_params, t
from test_torch_parallel import launch
from test_torch_train_step import GRAD_RTOL, LOSS_RTOL, TINY_CLIP, TINY_UNET, port_name

torch.set_num_threads(1)

CTX, B, IMAGE, LR = 32, 2, 64, 1e-4
LATENT = IMAGE // 2
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=IMAGE)
FWD_LATENT = 8
PROJ1 = {"GLIGEN_TPU_FUSED_PROJ": "1", "GLIGEN_TPU_FUSED_CONV": "0"}
# the TP forward's cases: (fuser, switches); 16 boxes, a square count for gatedSA2
FORWARDS = {
    "proj1": ("gatedSA", PROJ1),
    "proj0": ("gatedSA", {"GLIGEN_TPU_FUSED_PROJ": "0", "GLIGEN_TPU_FUSED_CONV": "0"}),
    "conv1": ("gatedSA", {"GLIGEN_TPU_FUSED_PROJ": "1", "GLIGEN_TPU_FUSED_CONV": "1"}),
    "gatedSA2": ("gatedSA2", PROJ1),
    "gatedCA": ("gatedCA", PROJ1),
}


def jax_layout(path, ndim):
    """The port dim of each JAX dim of a leaf (convert/from_jax.py)."""
    if path[-1] == "kernel":
        return [1, 0] if ndim == 2 else [2, 3, 1, 0]
    return list(range(ndim))


def jax_dim(spec, path, ndim):
    """The port dim a JAX PartitionSpec shards (None: replicated)."""
    dims = [i for i, ax in enumerate(tuple(spec)) if ax is not None]
    assert len(dims) <= 1, spec
    return jax_layout(path, ndim)[dims[0]] if dims else None


@pytest.fixture(scope="module")
def unet_shapes():
    """The tiny UNet's JAX leaf shapes by path, and the port's UNet."""
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    model = JaxUNet(**TINY_UNET, use_checkpoint=False)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, CTX)), g)["params"]
    return traverse_util.flatten_dict(shapes), UNetModel(**TINY_UNET)


def test_rules_agree_with_jax(unet_shapes):
    """At tp = 2 every pair divides; tp = 4 would split two heads, which
    the plan refuses per pair (``test_a_pair_that_does_not_divide_stays_replicated``)."""
    flat, unet = unet_shapes
    tp = 2
    ports = dict(unet.named_parameters())
    assert set(ports) == {port_name(p) for p in flat}
    plan = sharding.tp_plan(unet, tp)
    sharded = exceptions = 0
    for path, leaf in flat.items():
        name, shape = port_name(path), tuple(ports[port_name(path)].shape)
        want = jax_dim(jsh.tp_spec("/".join(path), leaf.shape, tp), path, len(leaf.shape))
        assert sharding.tp_spec(name, shape, tp) == want, name
        for n in (2, 4, 8):
            want_f = jax_dim(jsh.fsdp_spec("/".join(path), leaf.shape, n), path, len(leaf.shape))
            assert sharding.fsdp_spec(name, shape, n) == want_f, (name, n)
        placement = plan[name]
        sharded += want is not None
        if any(re.search(rx, name) for rx in sharding.PLACEMENT_EXCEPTIONS):
            exceptions += 1
            if "net_0" in name:  # out-sharded per half: the same dim
                assert placement == sharding.Placement(dim=want, halves=True), name
            else:  # skip_connection: replicated, applied on rank 0
                assert want == 0 and placement == sharding.Placement(tp_sum=True), name
        else:
            assert placement.dim == want and not placement.halves, name
    # qkv/out of attn1/attn2/fuser + the FF pairs + the ResBlock pairs
    assert sharded >= 30 and exceptions >= 8, (sharded, exceptions)
    # every trainable tensor read inside a sharded region sums over the TP group
    rules = {n: sharding.gradient_rule(p) for n, p in plan.items()}
    fuser = "input_blocks_1_1.transformer_blocks_0.fuser"
    for leaf in ("norm1.weight", "norm2.bias", "alpha_attn", "alpha_dense", "linear.weight",
                 "attn.to_out.bias", "ff.net_2.bias"):
        assert rules[f"{fuser}.{leaf}"] == "tp_sum", leaf
    for leaf in ("attn.to_q.weight", "attn.to_out.weight", "ff.net_0.proj.bias"):
        assert rules[f"{fuser}.{leaf}"] == "dp", leaf
    assert rules["position_net.linears_0.weight"] == "dp"


def test_a_pair_that_does_not_divide_stays_replicated():
    """Three heads do not split over two ranks: the attention pairs stay
    whole (q/k/v divide, but heads do not), the ResBlocks still shard."""
    unet = UNetModel(**dict(TINY_UNET, num_heads=3, model_channels=48))
    plan = sharding.tp_plan(unet, 2)
    blk = "input_blocks_1_1.transformer_blocks_0"
    for leaf in ("attn1.to_q.weight", "attn1.to_out.weight", "attn1.to_out.bias"):
        assert plan[f"{blk}.{leaf}"] == sharding.REPLICATED, leaf
    assert plan[f"{blk}.norm1.weight"] == sharding.REPLICATED
    assert plan[f"{blk}.ff.net_2.weight"].dim == 1
    assert plan["input_blocks_1_0.in_layers_2.weight"].dim == 0


def test_shard_and_gather_state_dict_round_trip(unet_shapes):
    """Full -> two ranks' shards -> full, bit for bit; the GEGLU shard of
    rank r is its value rows over its gate rows; the JAX tree loads into a
    sharded UNet as exactly its rank's shards."""
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    model = JaxUNet(**TINY_UNET, use_checkpoint=False)
    params = random_params(model, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 8, CTX)), g, seed=4)
    full = UNetModel(**TINY_UNET)
    load_module_from_jax(full, params)
    state = full.state_dict()
    plan = sharding.tp_plan(full, 2)
    shards = [sharding.shard_state_dict(state, plan, r, 2) for r in range(2)]
    back = sharding.gather_state_dict(shards, plan)
    assert set(back) == set(state)
    for name, tensor in state.items():
        assert torch.equal(back[name], tensor), name
    name = "input_blocks_1_1.transformer_blocks_0.ff.net_0.proj.weight"
    value, gate = state[name].chunk(2)
    f = value.shape[0] // 2
    assert torch.equal(shards[1][name], torch.cat([value[f:], gate[f:]]))
    for rank in range(2):
        unet = UNetModel(**TINY_UNET)
        sharding.shard_unet_(unet, TensorParallel(None, rank, 2))
        load_module_from_jax(unet, params)
        for name, tensor in unet.state_dict().items():
            assert torch.equal(tensor, shards[rank][name]), name
        assert unet.input_blocks_1_1.transformer_blocks_0.attn1.heads == 1
        assert unet.input_blocks_1_0.out_layers_0.num_groups == 16
        with pytest.raises(RuntimeError, match="already sharded"):
            sharding.shard_unet_(unet, TensorParallel(None, rank, 2))


# ---------------------------------------------------------------- processes

@pytest.fixture(scope="module")
def step_setup():
    """The JAX loss, gradients and draws of one train step on the global
    batch at a latent of 32^2, and the one-process port step on the same
    parameters and draws (its loss, gradients and trainable tensors)."""
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1).items()}
    unet = JaxUNet(**TINY_UNET, use_checkpoint=True)
    vae, text = JaxVAE(**TINY_VAE), JaxCLIP(**TINY_CLIP)
    params = {
        "model": random_params(unet, jnp.zeros((1, LATENT, LATENT, 4)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, CTX)), g, seed=1),
        "autoencoder": random_params(vae, jnp.zeros((1, IMAGE, IMAGE, 3)),
                                     jax.random.PRNGKey(1), seed=2),
        "text_encoder": random_params(text, jnp.zeros((1, 8), jnp.int32), seed=3),
    }
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(5)
    batch = {"image": np.clip(rand(rng, B, IMAGE, IMAGE, 3), -1.0, 1.0),
             "input_ids": rng.integers(1, 63, size=(B, 8)).astype(np.int32),
             "grounding": grounding_inputs(rng, B, n=6, dim=CTX)}
    schedule = JaxSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    train, frozen = jts.partition(params["model"], jts.trainable_mask(params["model"]))
    aux = {"autoencoder": params["autoencoder"], "text_encoder": params["text_encoder"]}
    loss_fn = jts.make_loss_fn(unet, vae, text, schedule, grounding_drop_prob=0.1)
    key = jax.random.PRNGKey(7)
    jax_loss, _ = jax.jit(jax.value_and_grad(loss_fn))(train, frozen, aux,
                                                        jax.tree.map(jnp.asarray, batch), key)
    k_vae, k_t, k_noise, k_drop = jax.random.split(key, 4)
    shape = (B, LATENT, LATENT, 4)
    draws = {"posterior": jax.random.normal(k_vae, shape, jnp.float32),
             "u_t": jax.random.uniform(k_t, (B,)),
             "noise": jax.random.normal(k_noise, shape, jnp.float32),
             "u_drop": jax.random.uniform(k_drop, ())}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    port_batch = {k: ({g: t(v) for g, v in x.items()} if k == "grounding" else t(x))
                  for k, x in batch.items()}
    unet_config = dict(TINY_UNET, use_checkpoint=True)
    comps = GligenComponents.create(unet_config=unet_config, dtype=torch.float32,
                                    vae_config=TINY_VAE, text_config=TINY_CLIP, device="cpu")
    load_jax_params(comps, params)
    state = tts.create_train_state(comps.unet, base_lr=LR, warmup_steps=0, total_steps=10)
    step = tts.make_train_step(comps.unet, comps.vae, comps.text_encoder, comps.schedule)
    loss = float(step(state, port_batch, draws=draws)["loss"])
    one = {"loss": loss, "grads": {n: p.grad.clone() for n, p in state.params.items()},
           "params": {n: p.detach().clone() for n, p in state.params.items()},
           "numel": sum(p.numel() for p in comps.unet.parameters())}
    setup = {"unet_config": unet_config, "vae_config": TINY_VAE, "text_config": TINY_CLIP,
             "params": params, "batch": port_batch, "draws": draws, "lr": LR}
    return setup, float(jax_loss), one


def check_step(ranks, key, one, jax_loss):
    """A sharded step's ranks against the one-process step (module
    docstring)."""
    got = [r[key] for r in ranks]
    assert len({g["loss"] for g in got}) == 1
    np.testing.assert_allclose(got[0]["loss"], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0]["loss"], jax_loss, rtol=LOSS_RTOL)
    for rank in got:
        # the training step's 1024-token blocks took the fused helpers
        assert {"_fused_self_attn", "_fused_cross_attn", "_fused_ff"} <= set(rank["counts"])
    assert set(got[0]["grads"]) == set(one["grads"])
    for name, want in one["grads"].items():
        for rank in got[1:]:
            assert torch.equal(rank["grads"][name], got[0]["grads"][name]), name
            assert torch.equal(rank["params"][name], got[0]["params"][name]), name
        scale = float(want.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(got[0]["grads"][name].numpy(), want.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
        p, q = got[0]["params"][name], one["params"][name]
        settled = want.abs() > max(2 * GRAD_RTOL * scale, 1e-6)
        diff = (p - q).abs()
        assert bool((diff[settled] <= 1e-2 * LR + 1e-6 * q.abs()[settled]).all()), name
        assert bool((diff <= 2 * LR + 1e-6 * q.abs()).all()), name


def test_fsdp_step_and_tp_forward_over_two_processes(step_setup, tmp_path):
    """The FSDP step, then the TP = 2 forward of the gatedSA UNet under each
    switch setting and of the gatedSA2 and gatedCA UNets (their fusers on
    the module path) against the JAX forward."""
    setup, jax_loss, one = step_setup
    g = {k: jnp.asarray(v) for k, v in grounding_inputs(np.random.default_rng(0), 1, n=16).items()}
    rng = np.random.default_rng(8)
    x, ctx = rand(rng, 2, FWD_LATENT, FWD_LATENT, 4), rand(rng, 2, 77, CTX)
    ts = np.array([981, 401], np.int32)
    ground = grounding_inputs(rng, 2, n=16)
    jargs = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
             {k: jnp.asarray(v) for k, v in ground.items()})
    models, cases, want = {}, {}, {}
    for name, (fuser, switches) in FORWARDS.items():
        if fuser not in models:
            model = JaxUNet(**TINY_UNET, fuser_type=fuser, use_checkpoint=False)
            params = jax.tree.map(np.asarray, random_params(
                model, jnp.zeros((1, FWD_LATENT, FWD_LATENT, 4)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, 77, CTX)), g, seed=6))
            apply = jax.jit(lambda p, *a, m=model: m.apply({"params": p}, *a, gate_scale=0.6))
            models[fuser] = params, np.asarray(apply(params, *jargs))
        params, want[name] = models[fuser]
        cases[name] = {"model": fuser, "unet_config": dict(TINY_UNET, fuser_type=fuser),
                       "params": params, "switches": switches, "args": (t(x), t(ts), t(ctx)),
                       "grounding": {k: t(v) for k, v in ground.items()}}
    torch.save({"fsdp": setup, "tp": 2, "forward": cases}, tmp_path / "setup.pt")
    launch(["shard", str(tmp_path / "setup.pt"), str(tmp_path)], world=2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    check_step(ranks, "fsdp", one, jax_loss)
    # each rank holds at most half of the UNet, and the replicated tensors
    # under 2^16 elements
    small = sum(p.numel() for n, p in UNetModel(**TINY_UNET).named_parameters()
                if p.numel() < 2**16)
    for rank in ranks:
        assert rank["fsdp"]["resident"] <= one["numel"] / 2 + small, rank["fsdp"]["resident"]
    for name, (_, switches) in FORWARDS.items():
        assert float(np.abs(want[name]).max()) > 0.1
        outs = [r["forward"][name] for r in ranks]
        assert torch.equal(outs[0]["out"], outs[1]["out"]), name
        np.testing.assert_allclose(outs[0]["out"].numpy(), want[name], atol=2e-5, rtol=1e-5,
                                   err_msg=name)
        counts = outs[0]["counts"]
        proj, conv = switches["GLIGEN_TPU_FUSED_PROJ"], switches["GLIGEN_TPU_FUSED_CONV"]
        assert ("_fused_self_attn" in counts) == (proj == "1"), (name, counts)
        assert ("conv" in counts) == (conv == "1"), (name, counts)


def test_dp2_tp2_step_over_four_processes(step_setup, tmp_path):
    setup, jax_loss, one = step_setup
    torch.save({"tp": 2, "tp_step": setup}, tmp_path / "setup.pt")
    launch(["shard", str(tmp_path / "setup.pt"), str(tmp_path)], world=4)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    check_step(ranks, "tp_step", one, jax_loss)
