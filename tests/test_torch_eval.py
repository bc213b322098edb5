"""The port's eval metrics (``gligen_tpu_torch/eval/``) and fidelity gate
(``gligen_tpu_torch/tools/fidelity_gate.py``) against ``gligen_tpu.eval``
and the JAX gate, on the CPU.

PSNR, SSIM, the LPIPS aggregation, the FID pieces and the "conv" LPIPS
proxy (the JAX module's flax parameters carried across by
``convert/from_jax.py``) within 1e-5 relative: fp32 on both sides (JAX at
its highest matmul precision), the sums taken in another order.  The
gate's ``score`` on two folders of PNGs the port wrote, its arms'
environments and command lines.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gligen_tpu.eval import lpips as jlpips
from gligen_tpu.eval import metrics as jmetrics

from gligen_tpu_torch.convert.from_jax import state_dict_from_jax
from gligen_tpu_torch.data import png
from gligen_tpu_torch.eval import lpips, metrics
from gligen_tpu_torch.models.clip_vision import CLIPVisionModel
from gligen_tpu_torch.tools import bench_serve_overlap, fidelity_gate

torch.set_num_threads(1)
RTOL = 1e-5


def _images(seed, *shape, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_and_ssim_match_jax():
    a, b = _images(0, 3, 24, 20, 3)
    np.testing.assert_allclose(metrics.psnr(a, b).numpy(), np.asarray(jmetrics.psnr(a, b)),
                               rtol=RTOL)
    np.testing.assert_allclose(metrics.psnr(a, b, 2.0).numpy(),
                               np.asarray(jmetrics.psnr(a, b, 2.0)), rtol=RTOL)
    np.testing.assert_allclose(metrics.ssim(a, b).numpy(), np.asarray(jmetrics.ssim(a, b)),
                               rtol=RTOL)
    np.testing.assert_allclose(metrics.ssim(a, a).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(metrics.psnr(np.zeros((1, 8, 8, 3)),
                                                  np.full((1, 8, 8, 3), 0.1))), 20.0, atol=1e-4)


def test_lpips_distance_matches_jax():
    rng = np.random.default_rng(1)
    fa = [rng.standard_normal((2, 6, 5, c)).astype(np.float32) for c in (4, 16)]
    fb = [f + rng.normal(0, 0.3, f.shape).astype(np.float32) for f in fa]
    want = np.asarray(jmetrics.lpips_distance([jnp.asarray(f) for f in fa],
                                              [jnp.asarray(f) for f in fb]))
    got = metrics.lpips_distance([torch.from_numpy(f) for f in fa],
                                 [torch.from_numpy(f) for f in fb]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    same = metrics.lpips_distance([torch.from_numpy(fa[0])], [torch.from_numpy(fa[0])])
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-10)


def test_fid_pieces_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    real, fake = rng.standard_normal((300, 12)), rng.standard_normal((300, 12)) * 1.3 + 0.4
    for got, want in zip(metrics.gaussian_stats(real), jmetrics.gaussian_stats(real)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    sym = real.T @ real / 300
    np.testing.assert_allclose(metrics._sqrtm_psd(sym), jmetrics._sqrtm_psd(sym), rtol=RTOL,
                               atol=1e-12)
    assert metrics.frechet_distance(*metrics.gaussian_stats(real),
                                    *metrics.gaussian_stats(fake)) == pytest.approx(
        jmetrics.frechet_distance(*jmetrics.gaussian_stats(real),
                                  *jmetrics.gaussian_stats(fake)), rel=RTOL)
    assert metrics.fid_from_features(real, fake) == pytest.approx(
        jmetrics.fid_from_features(real, fake), rel=RTOL)
    # folders read by the port's PNG decoder, against the JAX function on the same images
    imgs = {}
    for folder, seed in (("a", 3), ("b", 4)):
        os.makedirs(tmp_path / folder)
        imgs[folder] = []
        for i in range(7):
            pixels = np.random.default_rng(seed * 10 + i).integers(0, 256, (8, 8, 3), np.uint8)
            png.write_png(tmp_path / folder / f"{i}.png", pixels)
            imgs[folder].append(pixels.astype(np.float32) / 255.0)
    feature_fn = lambda x: x.reshape(len(x), -1)[:, :10] * np.arange(1, 11)
    got = metrics.fid_from_folders(str(tmp_path / "a"), str(tmp_path / "b"), feature_fn,
                                   batch_size=3)
    want = jmetrics.fid_from_folders(iter(imgs["a"]), iter(imgs["b"]), feature_fn, batch_size=3)
    assert got == pytest.approx(want, rel=RTOL)


@pytest.fixture(scope="module")
def conv_pair():
    """The JAX proxy's flax parameters (seeded init) and the port's
    ``PerceptualConvStack`` holding them."""
    model = jlpips.PerceptualConvStack()
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    stack = lpips.PerceptualConvStack()
    stack.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, stack


def test_conv_proxy_matches_jax(conv_pair):
    params, stack = conv_pair
    a, b = _images(5, 2, 32, 32, 3, noise=0.15)
    want = jlpips.make_lpips_fn("conv", params=params)(a, b)
    got = lpips.make_lpips_fn("conv", module=stack, device="cpu")(a, b)
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    x = torch.from_numpy(a)
    for f_port, f_jax in zip(stack(x), model_feats(params, a)):
        np.testing.assert_allclose(f_port.detach().numpy(), f_jax, rtol=1e-4, atol=1e-5)


def model_feats(params, x):
    return [np.asarray(f) for f in jlpips.PerceptualConvStack().apply({"params": params},
                                                                      jnp.asarray(x))]


def test_conv_proxy_seeded_and_monotone():
    """The port's own seeded filters: the same seed gives the same stack;
    the distance is 0 for equal images and grows with the noise."""
    s1, s2 = lpips.PerceptualConvStack(seed=3), lpips.PerceptualConvStack(seed=3)
    assert all(torch.equal(p, q) for p, q in zip(s1.parameters(), s2.parameters()))
    assert not torch.equal(s1.conv_0a.weight, lpips.PerceptualConvStack(seed=4).conv_0a.weight)
    fn = lpips.make_lpips_fn(module=s1, device="cpu")
    rng = np.random.default_rng(0)
    base = rng.random((1, 32, 32, 3)).astype(np.float32)
    dists = [float(fn(base, np.clip(base + rng.normal(0, s, base.shape), 0, 1)
                      .astype(np.float32))[0]) for s in (0.0, 0.05, 0.2, 0.4)]
    assert dists[0] < 1e-6 and all(b > a for a, b in zip(dists, dists[1:])), dists


def test_clip_backbone_and_features():
    torch.manual_seed(0)
    vision = CLIPVisionModel(image_size=56, patch_size=14, hidden_size=32, layers=3, heads=2,
                             projection_dim=16).eval()
    for p in vision.parameters():
        torch.nn.init.normal_(p, std=0.2)
    fn = lpips.make_lpips_fn("clip", module=vision, clip_layers=(0, 1, 2))
    a, b = _images(6, 1, 56, 56, 3, noise=0.3)
    assert float(fn(a, a)[0]) < 1e-6 and float(fn(a, b)[0]) > 1e-4
    feats = metrics.clip_feature_fn(vision)(np.concatenate([a, b]))
    assert feats.shape == (2, 16) and np.isfinite(feats).all()


def _write_arms(root, scenarios, delta):
    """``fp32/<sc>`` and ``bf16/<sc>`` folders of two PNGs each (the
    port's writer), bf16's off by ``delta`` levels in one block."""
    rng = np.random.default_rng(7)
    for sc in scenarios:
        for i in range(2):
            a = rng.integers(20, 230, (32, 32, 3), np.uint8)
            b = a.copy()
            b[4:12, 4:12] += np.uint8(delta)
            for arm, img in (("fp32", a), ("bf16", b)):
                os.makedirs(root / arm / sc, exist_ok=True)
                png.write_png(root / arm / sc / f"{i}.png", img)


def test_gate_scores_folders_of_port_pngs(tmp_path):
    scored = fidelity_gate.SCENARIOS[:2]
    _write_arms(tmp_path, scored, 8)
    results = fidelity_gate.score(str(tmp_path), device="cpu")
    mse = (8 / 255) ** 2 * 64 / 1024
    for sc in scored:
        r = results[sc]
        assert r["images"] == 2
        assert r["psnr"] == pytest.approx(10 * np.log10(1 / mse), rel=1e-5)
        assert r["max_abs_pixel_delta"] == pytest.approx(8 / 255, rel=1e-6)
        assert 0 < r["lpips"]
    assert results[fidelity_gate.SCENARIOS[2]] == {"status": "missing"}
    assert results["_meta"]["lpips_backbone"] == "conv(random)"
    over = fidelity_gate.over_budget(results)
    assert fidelity_gate.SCENARIOS[2] in over
    assert all((results[s]["lpips"] > fidelity_gate.LPIPS_MAX) == (s in over) for s in scored)
    # equal images: distance 0, PSNR at the 1e-12 floor of the MSE
    _write_arms(tmp_path / "same", scored, 0)
    same = fidelity_gate.score(str(tmp_path / "same"), device="cpu")
    assert same[scored[0]]["lpips"] < 1e-6 and same[scored[0]]["psnr"] == pytest.approx(120.0)
    assert fidelity_gate.over_budget(same, scored) == []


def test_gate_arms_pin_their_switches(monkeypatch, tmp_path):
    """Each arm's subprocess gets its switches whatever the caller's shell
    exported, the CLI's flags, and emptied scenario folders; the JSON goes
    under ``--out``, never to the repository's FIDELITY.json."""
    monkeypatch.setenv("NVIDIA_TF32_OVERRIDE", "0")
    monkeypatch.setenv("GLIGEN_TPU_FUSED_PROJ", "0")
    runs = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, env, cwd, check: runs.append((cmd, env)))
    (tmp_path / "fp32" / "hed").mkdir(parents=True)
    (tmp_path / "fp32" / "hed" / "0.png").write_bytes(b"stale")
    monkeypatch.setattr(fidelity_gate, "score", lambda out, clip, device: {
        "_meta": {"lpips_backbone": "conv(random)"},
        **{sc: {"status": "missing"} for sc in fidelity_gate.SCENARIOS}})
    fidelity_gate.main(["--out", str(tmp_path), "--steps", "10", "--batch", "1",
                        "--scenarios", "hed,sem", "--device", "cpu"])
    (cmd_a, env_a), (cmd_b, env_b) = runs
    assert env_a["NVIDIA_TF32_OVERRIDE"] == "0" and "NVIDIA_TF32_OVERRIDE" not in env_b
    assert (env_a["GLIGEN_TPU_FUSED_PROJ"], env_b["GLIGEN_TPU_FUSED_PROJ"]) == ("0", "1")
    assert (env_a["GLIGEN_TPU_FUSED_NORM"], env_b["GLIGEN_TPU_FUSED_NORM"]) == ("none", "gn")
    assert cmd_a[2] == "gligen_tpu_torch.inference.cli" and "--dezero" in cmd_a
    for cmd, dtype in ((cmd_a, "float32"), (cmd_b, "bfloat16")):
        assert cmd[cmd.index("--dtype") + 1] == dtype
        assert cmd[cmd.index("--scenarios") + 1] == "hed,sem"
        assert cmd[cmd.index("--steps") + 1] == "10" and cmd[cmd.index("--device") + 1] == "cpu"
    assert not (tmp_path / "fp32" / "hed").exists()
    assert (tmp_path / "fidelity.json").exists()
    with pytest.raises(SystemExit):
        fidelity_gate.main(["--out", str(fidelity_gate.REPO), "--arm", "none"])


class _Pipe:
    unet_config = {}

    def generate(self, ids, uc_ids, grounding, **kw):
        return np.full((ids.shape[0], 8, 8, 3), 0.25, np.float32)


def test_bench_serve_overlap_runs_each_arm():
    from gligen_tpu_torch.data.tokenizer import HashTokenizer
    from gligen_tpu_torch.serving.server import ServingSession

    session = ServingSession(_Pipe(), HashTokenizer(), batch_window_ms=1)
    execute = session.batcher._execute
    rates = bench_serve_overlap.run(session, clients=2, reqs=2, steps=1, batch=2)
    assert set(rates) == {*bench_serve_overlap.ARMS, "gain_pct"}
    assert all(rates[arm] > 0 for arm in bench_serve_overlap.ARMS)
    assert session.batcher._execute == execute
    with pytest.raises(ValueError):
        bench_serve_overlap.run(ServingSession(_Pipe(), HashTokenizer()))
