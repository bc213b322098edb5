"""The flash-attention kernel's plain version (gligen_tpu_torch
ops/flash_attention.py) against the Pallas kernels it ports, run in
interpret mode on the CPU, and against the XLA attention path.

Inputs are fp32 from a numpy seed.  Tolerance 2e-5: the Pallas kernels
and the plain version both take fp32 scores and softmax; they differ in
summation order and in the online (Pallas) vs one-pass (plain) softmax,
which agree to a few fp32 ulps at O(1) outputs.  The kernel itself runs
only on the card: tests/test_torch_flash_cuda.py and chip_smoke.py hold
it to this plain version there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gligen_tpu.ops.attention import multi_head_attention as jax_mha
from gligen_tpu.ops.pallas_attention import flash_attention as jax_flash
from gligen_tpu.ops.pallas_attention import flash_attention_packed as jax_flash_packed

from gligen_tpu_torch.ops.attention import multi_head_attention
from gligen_tpu_torch.ops.flash_attention import (
    LOG2E,
    NEG_INF,
    _check_inputs,
    flash_attention,
    flash_attention_packed,
    FWD_TILES,
    flash_attention_plain,
    flash_fwd,
    fwd_route,
    fwd_tiles,
    tma_ok,
)

torch.set_num_threads(1)

ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "b,h,n,m,c",
    [
        (2, 2, 64, 64, 40),   # attn1 head dim at ds1
        (2, 2, 64, 94, 80),   # fuser: N + 30 keys, ds2 head dim
        (1, 3, 40, 77, 40),   # cross-attention over 77 text tokens, ragged N
    ],
)
def test_plain_matches_pallas_packed(b, h, n, m, c):
    rng = np.random.default_rng(b * 1000 + m)
    q, k, v = rand(rng, b, n, h * c), rand(rng, b, m, h * c), rand(rng, b, m, h * c)
    want = jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True)
    got = flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_padded_key_tail_equals_ragged_keys():
    """The TPU's fuser form (N+30 keys padded to a multiple of 128, masked
    by a bias row) equals the port's unpadded N+30 keys."""
    rng = np.random.default_rng(3)
    b, h, n, c, m_real, m_pad = 2, 2, 64, 40, 94, 128
    q = rand(rng, b, n, h * c)
    k, v = np.zeros((2, b, m_pad, h * c), np.float32)
    k[:, :m_real], v[:, :m_real] = rand(rng, b, m_real, h * c), rand(rng, b, m_real, h * c)
    mask = np.arange(m_pad)[None, :].repeat(b, 0) < m_real
    want = jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                            key_mask=jnp.asarray(mask), interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    padded = flash_attention_packed(tq, tk, tv, h, key_mask=torch.from_numpy(mask))
    ragged = flash_attention_packed(tq, tk[:, :m_real], tv[:, :m_real], h)
    np.testing.assert_allclose(padded.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ragged.numpy(), padded.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bh,n,m,d,with_bias", [(2, 128, 128, 512, False), (2, 96, 160, 64, True)])
def test_plain_matches_pallas_streamed(bh, n, m, d, with_bias):
    """block_kv below M forces the streamed (online-softmax) Pallas kernel;
    d = 512 is the VAE mid-attention's single head."""
    rng = np.random.default_rng(n + d)
    q, k, v = rand(rng, bh, n, d), rand(rng, bh, m, d), rand(rng, bh, m, d)
    bias = (rand(rng, bh, 1, m) * 0.5) if with_bias else None
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=None if bias is None else jnp.asarray(bias),
                     block_q=64, block_kv=64, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,n,m,c", [(2, 2, 64, 64, 40), (2, 1, 64, 64, 512), (2, 8, 16, 77, 80)])
def test_multi_head_attention_matches_xla_path(b, h, n, m, c):
    rng = np.random.default_rng(h * 100 + c)
    q, k, v = rand(rng, b, n, h * c), rand(rng, b, m, h * c), rand(rng, b, m, h * c)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, implementation="xla")
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_lse_is_log2_logsumexp_with_bias():
    rng = np.random.default_rng(5)
    b, h, n, m, c = 2, 2, 8, 13, 16
    q, k, v = rand(rng, b, n, h * c), rand(rng, b, m, h * c), rand(rng, b, m, h * c)
    bias = rand(rng, b, m)
    bias[:, -3:] = NEG_INF
    _, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), h,
                                   bias=torch.from_numpy(bias))
    s = np.einsum("bnhc,bmhc->bhnm", q.reshape(b, n, h, c).astype(np.float64),
                  k.reshape(b, m, h, c)) * c**-0.5 + bias[:, None, None, :]
    top = s.max(-1, keepdims=True)
    want = (np.log(np.exp(s - top).sum(-1)) + top[..., 0]) * LOG2E
    assert lse.shape == (b, h, n)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rand(rng, 1, 8, 32)) for _ in range(3))
    before = flash_fwd.launches
    out, _ = flash_fwd(q, k, v, 2)
    want, _ = flash_attention_plain(q, k, v, 2)
    assert torch.equal(out, want)
    assert flash_fwd.launches == before


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(dtype=torch.float32), TypeError),        # the kernel takes bf16 only
        (dict(m_k=9), ValueError),                      # k and v lengths differ
        (dict(c=520), ValueError),                      # head dim above 512
        (dict(bias=torch.float16), TypeError),          # bias must be fp32
        (dict(transposed=True), ValueError),            # last stride must be 1
    ],
)
def test_kernel_input_checks(change, error):
    """What the kernel does not take raises before any launch."""
    b, n, m, h, c = 2, 8, 8, 2, change.get("c", 16)
    dt = change.get("dtype", torch.bfloat16)
    q = torch.zeros((b, n, h * c), dtype=dt)
    k = torch.zeros((b, m, h * c), dtype=dt)
    v = torch.zeros((b, change.get("m_k", m), h * c), dtype=dt)
    if change.get("transposed"):
        q = torch.zeros((b, h * c, n), dtype=dt).transpose(1, 2)
    bias = torch.zeros((b, m), dtype=change["bias"]) if "bias" in change else None
    with pytest.raises(error):
        _check_inputs(q, k, v, h, bias)


@pytest.mark.parametrize("change,error", [(dict(c=6), ValueError), (dict(row_pad=2), ValueError),
                                          (dict(dtype=torch.bfloat16), TypeError), ({}, None)])
def test_fp32_route_input_checks(change, error):
    """The fp32 route takes fp32 q/k/v whose head dim, bases and strides are
    multiples of 4 elements; anything else raises before a launch."""
    from gligen_tpu_torch.ops.flash_attention import _check_f32

    b, n, h, c = 2, 8, 2, change.get("c", 16)
    pad = change.get("row_pad", 0)
    q = torch.zeros((b, n, h * c + pad), dtype=change.get("dtype", torch.float32))[:, :, :h * c]
    if error is None:
        _check_f32(q, q, q, h, None)
    else:
        with pytest.raises(error):
            _check_f32(q, q, q, h, None)


def test_port_imports_without_jax_or_nvcc():
    """Every module of the port (the training package and the tools
    included) imports, and a CPU call, its backward, an optimizer step, the
    projection budget tool, the tokenizer on non-ASCII text, the PNG codec,
    the CLI's image reader, the YAML reader on every config, the training
    command line's parser, the crop and the TSV image codec, the JPEG
    decoder on the repository's JPEGs (built by g++, linked with nothing),
    the keypoint and spatial datasets from files the data writer made, the
    TSV split and merge, ``prepare_grounding``'s rows, the real-data
    bench's ``--make`` run, the server's image codecs and a warmup of a
    session, PSNR, SSIM and the LPIPS proxy, the eval datasets over the eval
    data tool's files, a mesh's row split, in a Python where jax, flax,
    gligen_tpu, regex, PIL and yaml cannot be imported (the GPU machine has
    none of the last three) and no nvcc is on the PATH; only a kernel build
    asks for nvcc."""
    code = """
import importlib, pkgutil, sys, tempfile
for name in ("jax", "flax", "gligen_tpu", "regex", "PIL", "yaml"):
    sys.modules[name] = None
import gligen_tpu_torch, torch
for mod in pkgutil.walk_packages(gligen_tpu_torch.__path__, "gligen_tpu_torch."):
    importlib.import_module(mod.name)
for name in ("training.train_step", "training.checkpoints", "convert.from_reference",
             "convert.widen", "inference.cli", "utils.registry", "data.inpaint_masks",
             "tools.reference_ckpt", "ops.interpolate", "models.clip_vision",
             "models.grounding.text_image", "models.grounding.keypoint", "inference.adapters",
             "models.grounding.convnext", "models.grounding.spatial",
             "models.grounding.downsamplers", "data.tokenizer", "data.png",
             "tools.bench_matrix", "config", "main", "data.tsv", "data.native", "data.jpeg",
             "data.transforms", "data.catalog", "data.concat", "data.box_dataset",
             "data.latent_cache", "training.trainer", "tools.prepare_latents",
             "data.spatial_datasets", "data.keypoint_dataset", "data.prepare_grounding",
             "data.tsv_split_merge", "tools.modality_data", "tools.bench_train_realdata",
             "serving.server", "serving.demo_page", "eval.metrics", "eval.lpips",
             "tools.fidelity_gate", "tools.bench_serve_overlap", "eval.evaluator",
             "eval.datasets", "eval.create_meta", "parallel.mesh", "tools.eval_data"):
    assert f"gligen_tpu_torch.{name}" in sys.modules, name
import numpy as np
from gligen_tpu_torch.data import png, tokenizer
assert tokenizer.pre_tokenize("café it's ²") == ["café", "it", "'s", "²"]
assert tokenizer.HashTokenizer()(["a teddy bear"]).shape == (1, 77)
with tempfile.TemporaryDirectory() as d:
    png.write_png(d + "/x.png", np.arange(48, dtype=np.uint8).reshape(4, 4, 3))
    assert png.read_png(d + "/x.png")[0].tolist() == np.arange(48).reshape(4, 4, 3).tolist()
from gligen_tpu_torch.inference import cli
assert cli.load_image_pm1("inference_images/hed.png").shape == (512, 512, 3)
assert cli.prepare_batch_sem({"sem": "inference_images/sem.png"}, 1)["sem"].shape == (1, 512, 512)
from gligen_tpu_torch.tools import bench_matrix
assert bench_matrix._grounding("sem", 1)[1].shape == (1, 512, 512)
import glob
from gligen_tpu_torch import config, main
for path in glob.glob("configs/*.yaml"):
    assert config.load_yaml_config(path)["model"]["params"]["model_channels"] == 320, path
assert main.parse_args([]).device == "cuda"
from gligen_tpu_torch.data import transforms, tsv
img = np.arange(40 * 30 * 3, dtype=np.uint8).reshape(40, 30, 3)
assert transforms.center_crop_arr(img, 16)[0].shape == (16, 16, 3)
assert (tsv.decode_base64_image(tsv.encode_base64_image(img)) == img).all()
from gligen_tpu_torch.training.trainer import TrainerConfig
assert TrainerConfig().seed == 123
from gligen_tpu_torch.models.clip_vision import clip_preprocess
assert clip_preprocess(torch.zeros((1, 30, 20, 3), dtype=torch.uint8)).shape == (1, 224, 224, 3)
from gligen_tpu_torch.utils.registry import GROUNDING_NETS, INPUT_ADAPTERS
assert all(n in GROUNDING_NETS and n in INPUT_ADAPTERS for n in ("text", "text_image", "keypoint"))
from gligen_tpu_torch.utils.registry import DOWNSAMPLERS
spatial = ("hed", "canny", "depth", "normal", "sem")
assert all(n in GROUNDING_NETS and n in DOWNSAMPLERS and n in INPUT_ADAPTERS for n in spatial)
from gligen_tpu_torch.models.grounding.spatial import prepare_spatial_map
assert prepare_spatial_map(torch.zeros((1, 8, 8), dtype=torch.uint8), 32, "nearest",
                           num_classes=152).shape == (1, 32, 32, 152)
for tool in ("timing", "perf_probe", "bench_proj", "bench_block", "bench_resblock",
             "bench_sweep_attn"):
    assert f"gligen_tpu_torch.tools.{tool}" in sys.modules, tool
from gligen_tpu_torch.tools import bench_proj
assert len(bench_proj.run(batch=1, n=8, iters=1, device="cpu", channels=16)) == 8
from gligen_tpu_torch.data import jpeg, keypoint_dataset, prepare_grounding, spatial_datasets
from gligen_tpu_torch.data import tsv_split_merge
from gligen_tpu_torch.tools import bench_train_realdata, modality_data
assert png.open_image("inference_images/beach.jpg", "RGB").shape == (512, 512, 3)
assert jpeg.decode(open("inference_images/style_golden.jpg", "rb").read())[1] == "RGB"
with tempfile.TemporaryDirectory() as d:
    rng = np.random.default_rng(0)
    imgs = modality_data.images_from_files(["inference_images/style_golden.jpg"])
    kp = keypoint_dataset.KeypointDataset(image_size=32, **modality_data.write_keypoint_tree(
        d, imgs, rng))
    assert kp[0]["points"].shape == (8 * 17, 2)
    hed = spatial_datasets.HedDataset(image_size=32, **modality_data.write_paired_tsvs(
        d, imgs, rng)["hed"])
    assert hed[0]["hed_edge"].shape == (32, 32, 3)
    sem = spatial_datasets.SemanticDataset(image_size=32, **modality_data.write_sem_tree(
        d, imgs, rng))
    assert sem[0]["sem"].shape == (32, 32)
    shards = tsv_split_merge.split_tsv(d + "/GROUNDING/CC3M/tsv/train-00.tsv", 1, d)
    assert tsv_split_merge.merge_tsv(shards, d + "/m.tsv") == 1
    row = prepare_grounding.item_to_row({"data_id": 0, "annos": [{"bbox": [1, 2, 20, 30]}]}, img)
    assert row[0] == 0
    assert bench_train_realdata.main(["--tsv", d + "/r.tsv", "--make", "--rows", "2"],
                                     device="cpu")[0]["rows"] == 2
import base64
from gligen_tpu_torch.serving import server
from gligen_tpu_torch.eval import lpips, metrics
from gligen_tpu_torch.tools import fidelity_gate
jpg = base64.b64encode(open("inference_images/beach.jpg", "rb").read()).decode()
assert server._b64_to_image(jpg, "L").shape == (512, 512)
out = server._b64_to_image(server._image_to_b64(np.full((4, 4, 3), 0.5, np.float32)))
assert out.shape == (4, 4, 3) and int(out[0, 0, 0]) == 127
class Pipe:
    unet_config = {"grounding_tokenizer": {"target": "sem"}, "grounding_downsampler": {}}
    def generate(self, ids, uc_ids, grounding, **kw):
        return torch.full((ids.shape[0], 8, 8, 3), 0.5)
session = server.ServingSession(Pipe(), tokenizer.HashTokenizer(), batch_window_ms=1)
session.warmup(buckets=(1, 2))
assert session.ready, session.warmup_error
assert fidelity_gate.SCENARIOS[-1] == "keypoint"
a = np.random.default_rng(0).random((1, 16, 16, 3)).astype(np.float32)
assert float(metrics.psnr(a, a * 0.5)[0]) > 0 and float(metrics.ssim(a, a)[0]) > 0.99
stack = lpips.PerceptualConvStack(features=(8, 16))
assert lpips.make_lpips_fn(module=stack, device="cpu")(a, a * 0.5)[0] > 0
from gligen_tpu_torch.eval import create_meta, datasets, evaluator
from gligen_tpu_torch.parallel import mesh
from gligen_tpu_torch.tools import eval_data
with tempfile.TemporaryDirectory() as d:
    files = eval_data.write_eval_data(d)
    coco = datasets.COCOEvalDataset(files["image_root"], files["instances"], files["captions"],
                                    image_size=32)
    assert coco[0]["image"].shape == (32, 32, 3) and len(create_meta.metas_from_dataset(coco, "c"))
    layout = datasets.LayoutEvalDataset(files["image_root"], files["instances"], files["stuff"],
                                        files["category_embeddings"], image_size=32,
                                        min_boxes_per_image=1)
    assert layout[0]["text_embeddings"].shape == (8, 768)
assert evaluator.ckpt_to_folder_name("checkpoint_00000012.pth") == "tag000000012"
assert mesh.shard_batch(mesh.make_mesh(["cpu", "cpu"]), {"x": torch.zeros(4, 2)})[1]["x"].shape == (2, 2)
from gligen_tpu_torch.ops import cuda_build
from gligen_tpu_torch.ops.attention import multi_head_attention
from gligen_tpu_torch.training.train_step import lr_multiplier, make_optimizer
x = torch.randn(1, 4, 16, requires_grad=True)
out = multi_head_attention(x, x, x, 2)
assert out.shape == (1, 4, 16)
out.sum().backward()  # the flash Function's plain backward on the CPU
opt, sched = make_optimizer([x], warmup_steps=2)
opt.step()
assert lr_multiplier(2, 10)(1) == 0.5
cuda_build.NVCC_CANDIDATES = ()
try:
    cuda_build.find_nvcc()
except RuntimeError as e:
    print("nvcc:", e)
else:
    raise SystemExit("found an nvcc")
print("ok")
"""
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize(
    "d,want",
    [(1, (128, 128, 3)), (20, (128, 128, 3)), (40, (128, 128, 3)), (41, (128, 128, 2)),
     (80, (128, 128, 2)), (81, (128, 64, 2)), (160, (128, 64, 2)), (161, (64, 32, 2)),
     (512, (64, 32, 2))],
)
def test_forward_tile_table(d, want):
    """(BQ, BK, stages) by head-dim class, as csrc/flash_fwd.cu:fwd_tiles
    has them (chip_smoke.py holds the built table to this one): 128 query
    rows (two consumer warpgroups) up to d = 160, 64 rows and 32-key
    stages at the VAE's 512."""
    assert fwd_tiles(d) == want
    assert [top for top, *_ in FWD_TILES] == [40, 80, 160, 512]


def test_forward_tile_table_stops_at_512():
    with pytest.raises(ValueError):
        fwd_tiles(513)


ALIGNED = (4096, 8 * 320, 320)  # (data_ptr, batch stride, row stride) of a packed tensor


@pytest.mark.parametrize(
    "d,layouts,want",
    [
        (40, [ALIGNED] * 3, True),                      # every UNet and VAE site
        (512, [(0, 4096 * 512, 512)] * 3, True),        # the VAE head, one head
        (20, [ALIGNED] * 3, False),                     # d not a multiple of 8
        (40, [(4098, 2560, 320)] + [ALIGNED] * 2, False),  # q 2 bytes off 16
        (40, [ALIGNED, (4096, 2560, 326), ALIGNED], False),  # k row stride 326
        (40, [ALIGNED, ALIGNED, (4096, 2564, 320)], False),  # v batch stride
        (40, [ALIGNED, (4096, 0, 320), ALIGNED], False),  # an expanded batch
        (40, [ALIGNED, (4096 + 640, 2 * 2560, 640), (4096 + 1280, 2 * 2560, 640)], True),
    ],
)
def test_tma_route_rule(d, layouts, want):
    """(d, alignment) -> route: TMA needs d and every batch and row stride
    a multiple of 8 elements and 16-byte aligned bases
    (csrc/flash_fwd.cu:tma_ok); the last case is k and v as column slices
    of one fused projection output."""
    assert tma_ok(d, layouts) is want


def test_route_of_real_layouts():
    """The layouts the port's callers give the kernel: packed q/k/v, k and
    v sliced from one (B, M, 2*H*C) projection, and the VAE's (B*H, N, D)."""
    def t(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    q, kv = t(2, 64, 320), t(2, 94, 640)
    assert fwd_route(q, kv[..., :320], kv[..., 320:], 8) == "tma"
    assert fwd_route(t(2, 64, 512), t(2, 64, 512), t(2, 64, 512), 1) == "tma"
    assert fwd_route(t(2, 64, 60), t(2, 70, 60), t(2, 70, 60), 3) == "copy"  # d = 20
    assert fwd_route(q[:, 1:], q[:, 1:], q[:, 1:], 8) == "tma"  # row offsets keep alignment
    odd = t(2, 64, 330)[..., 3:323]
    assert fwd_route(odd, odd, odd, 8) == "copy"


def test_wgmma_header_is_generated():
    """csrc/wgmma.cuh is exactly what csrc/gen_wgmma.py writes."""
    sys.path.insert(0, os.path.join(REPO, "gligen_tpu_torch", "csrc"))
    try:
        import gen_wgmma
    finally:
        sys.path.pop(0)
    with open(gen_wgmma.HEADER) as f:
        assert f.read() == gen_wgmma.render()


def test_bench_sweep_attn_on_the_cpu():
    """The sweep tool at a tiny size: per key count, the table's row then
    one per configuration, each held against flash_attention_plain on every
    query row, 8 rows at a time (on the CPU every row is the plain version
    itself, so exactly); the products' FLOPs and the bound from the
    shapes."""
    from gligen_tpu_torch.tools import bench_sweep_attn, timing

    configs = ((64, 64, 2), (128, 128, 3))
    b, n, h, d = 1, 24, 2, 8
    rows = bench_sweep_attn.run(batch=b, n=n, ms_keys=(24, 31), configs=configs, iters=1,
                                device="cpu", heads=h, dim=d, check_rows=8)
    assert [(r["m"], r["tiles"]) for r in rows] == [
        (m, c) for m in (24, 31) for c in (None, *configs)]
    for r in rows:
        flops = 4 * b * h * n * r["m"] * d
        nbytes = 2 * (2 * b * n + 2 * b * r["m"]) * h * d + 4 * b * h * n
        assert (r["bound_ms"], r["bound_by"]) == timing.bound(nbytes, flops)
        assert r["tflops"] == pytest.approx(flops / r["ms"] / 1e9)
        assert r["ok"] and r["max_abs_err"] == 0.0 and r["lse_err"] == 0.0
        assert r["bound_share"] is None and r["sdpa_ms"] > 0
        assert r["table"] == (fwd_tiles(d) if r["tiles"] is None else None)
    out = bench_sweep_attn.lines(rows)
    assert len(out) == 1 + len(rows) and out[1].split()[2] == "table"
    assert bench_sweep_attn.parse_configs("128x64x3,64x64x2") == ((128, 64, 3), (64, 64, 2))


@pytest.mark.parametrize("chunk", [1, 7, 24, 100])
def test_plain_by_rows_covers_every_row(chunk):
    """The sweep tool's (and chip_smoke.py's) reference at large N: the
    plain version over query-row chunks is the plain version, on every
    row, with a bias row."""
    from gligen_tpu_torch.tools.bench_sweep_attn import plain_by_rows

    rng = np.random.default_rng(chunk)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, L, 16), dtype=np.float32))
               for L in (24, 19, 19))
    bias = torch.from_numpy(rng.standard_normal((2, 19), dtype=np.float32))
    out, lse = plain_by_rows(q, k, v, 2, bias=bias, rows=chunk)
    want, want_lse = flash_attention_plain(q, k, v, 2, bias=bias)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "want_max,err,ok",
    [(0.2, 3.9e-3, True), (0.2, 4.1e-3, False), (5.0, 1.9e-2, True), (5.0, 2.1e-2, False)],
)
def test_sweep_output_limit_is_relative(want_max, err, ok):
    """A row's output passes within 2e-2 of the plain output's largest
    magnitude, and never beyond 2e-2 absolute: an all-zero output fails
    where the outputs are small."""
    from gligen_tpu_torch.tools.bench_sweep_attn import out_ok

    want = torch.full((1, 4, 8), want_max)
    lse = torch.zeros((1, 1, 4))
    assert out_ok(want - err, lse, want, lse)[2] is ok
    assert out_ok(torch.zeros_like(want), lse, want, lse)[2] is False


# ---- the fp32 route's arithmetic: 3xTF32 (csrc/flash_fwd.cu, flash_fwd_f32)

FP32_REL_TOL = 1e-4  # chip_smoke.FP32_REL_TOL: the fp32 route vs plain, of max |plain|


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: half a TF32 ulp (bit 12) added to the
    magnitude's bits, then the low 13 bits cleared (a carry moves into the
    exponent, as it should)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) with hi = rna(x) and lo = rna(x - hi), the kernel's split:
    x - hi is exact in fp32, and lo is rounded too because wgmma reads
    only a TF32 operand's top 19 bits (an unrounded lo would truncate)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores compute it from TF32 operands: products
    exact, sums in fp32 (here in fp64, then rounded once).  passes=3 is
    hi.hi + hi.lo + lo.hi (3xTF32), passes=1 one TF32 product."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def tf32_attention(q, k, v, passes: int) -> torch.Tensor:
    """One head's softmax(q k^T / sqrt(d)) v with both products in TF32
    (3 passes or 1) and the softmax in fp32, as the kernel splits S's
    operands and P."""
    s = tf32_matmul(q, k.T, passes) * q.shape[-1] ** -0.5
    return tf32_matmul(torch.softmax(s, dim=-1), v, passes)


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-12, -(1 + 2**-11), 1 + 2**-12, 2 - 2**-12],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1 + 2**-10, -(1 + 2**-10), 1.0, 2.0])
    assert torch.equal(tf32_rna(x), want)
    assert not (tf32_rna(x).view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_recovers_fp32(seed):
    """hi + lo is x to 2^-21 relative (the dropped part is lo's own
    rounding, 2^-11 of a lo below 2^-11 |x|), and hi, lo are TF32 values."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert ((hi + lo - x).abs() <= 2**-21 * x.abs()).all()
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_3xtf32_attention_is_fp32_accurate_and_1xtf32_is_not(scale):
    """At (1, 64, 1x32), 64 keys: the 3xTF32 attention is within
    FP32_REL_TOL of the plain fp32 version's largest output, and one TF32
    pass is not, on unit inputs and with q, k scaled x4 (the card's
    discriminating case: sharper scores)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rand(rng, 1, 64, 32)) for _ in range(3))
    q, k = q * scale, k * scale
    want, _ = flash_attention_plain(q, k, v, 1)
    limit = FP32_REL_TOL * want.abs().max().item()
    three = tf32_attention(q[0], k[0], v[0], passes=3)
    one = tf32_attention(q[0], k[0], v[0], passes=1)
    assert (three - want[0]).abs().max().item() <= limit
    assert (one - want[0]).abs().max().item() > limit
