"""The port's offline data tools against the JAX package's, on the CPU:
``data/tsv_split_merge.py`` (shards and merges byte for byte the JAX
package's files, its command line too) and ``data/prepare_grounding.py``
(``item_to_row`` and ``write_grounding_tsv`` rows equal to the JAX rows in
every field but ``image``, with small CLIP towers loaded into both
packages through ``convert/from_jax.py``; the port's PNG ``image`` decodes
back to the source pixels).

Tolerances: the files and every non-feature field exact; the features
within 1e-5 of their largest magnitude (fp32 towers of two frameworks;
the crops themselves are equal, PIL's resize bit for bit).
"""

import base64
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gligen_tpu.data import prepare_grounding as jprep
from gligen_tpu.data import tokenizer as jtokenizer
from gligen_tpu.data import tsv_split_merge as jsplit
from gligen_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from gligen_tpu.models.clip_vision import CLIPVisionModel as JaxVision

from gligen_tpu_torch.convert.from_jax import load_clip_vision_params
from gligen_tpu_torch.data import prepare_grounding, tsv, tsv_split_merge
from gligen_tpu_torch.data.tokenizer import load_tokenizer
from gligen_tpu_torch.models.clip_text import CLIPTextModel
from gligen_tpu_torch.models.clip_vision import CLIPVisionModel

from test_torch_modules import CLIP, port, random_params

torch.set_num_threads(1)

FEATURE_TOL = 1e-5
# a 224^2 tower (clip_preprocess's size) in 56^2 patches: a 4 x 4 grid
VISION = dict(image_size=224, patch_size=56, hidden_size=64, layers=2, heads=4,
              projection_dim=32)


def _ascii_rows(rng, n):
    return [[f"id{i}", json.dumps({"k": "x" * int(rng.integers(1, 40)), "i": i}), f"t{i}"]
            for i in range(n)]


def _write(path, rows, writer_cls):
    w = writer_cls(path)
    for r in rows:
        w.write(r)
    w.close()


@pytest.mark.parametrize("rows_per_shard", [1, 3, 7, 50])
def test_split_and_merge_equal_the_jax_packages_files(tmp_path, rows_per_shard):
    rows = _ascii_rows(np.random.default_rng(rows_per_shard), 11)
    files = {}
    for name, mod in (("jax", jsplit), ("port", tsv_split_merge)):
        d = tmp_path / name
        d.mkdir()
        _write(str(d / "big.tsv"), rows, tsv.TSVWriter)
        shards = mod.split_tsv(str(d / "big.tsv"), rows_per_shard, str(d))
        n = mod.merge_tsv(shards, str(d / "merged.tsv"))
        assert n == len(rows) and len(shards) == -(-len(rows) // rows_per_shard)
        files[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files["port"] == files["jax"]
    assert files["port"]["merged.tsv"] == files["port"]["big.tsv"]
    assert files["port"]["merged.lineidx"] == files["port"]["big.lineidx"]


def test_split_merge_command_line(tmp_path, capsys):
    rows = _ascii_rows(np.random.default_rng(0), 5)
    src = tmp_path / "a.tsv"
    _write(str(src), rows, tsv.TSVWriter)
    out = tmp_path / "shards"
    out.mkdir()
    tsv_split_merge.main(["split", str(src), "--rows-per-shard", "2", "--out-dir", str(out)])
    shards = capsys.readouterr().out.split()
    assert shards == tsv_split_merge.shard_paths(str(out / "a.tsv"), 3)
    tsv_split_merge.main(["merge", *shards, "--out", str(tmp_path / "m.tsv")])
    assert capsys.readouterr().out.strip() == "5"
    assert (tmp_path / "m.tsv").read_bytes() == src.read_bytes()


@pytest.fixture(scope="module")
def featurizers():
    """The JAX and the port's featurizer on the same small towers and
    projection, with the hash tokenizers folded into the small vocab."""
    text = JaxCLIP(**CLIP)
    text_params = random_params(text, jnp.zeros((1, 77), jnp.int32), seed=21)
    vision = JaxVision(**VISION)
    vision_params = random_params(vision, jnp.zeros((1, 224, 224, 3)), seed=22)
    proj = (np.random.default_rng(23).standard_normal((CLIP["hidden_size"],) * 2)
            / np.sqrt(CLIP["hidden_size"])).astype(np.float32)
    jtok, ptok = jtokenizer.load_tokenizer(None), load_tokenizer(None)
    want = jprep.CLIPFeaturizer(text, text_params, vision, vision_params, proj,
                                lambda p: jtok(p) % CLIP["vocab_size"])
    text_port = port(CLIPTextModel(**CLIP), text_params)
    vision_port = CLIPVisionModel(**VISION)
    load_clip_vision_params(vision_port, vision_params)
    got = prepare_grounding.CLIPFeaturizer(text_port, vision_port, proj,
                                           lambda p: ptok(p) % CLIP["vocab_size"], device="cpu")
    return got, want


def _items(rng, n):
    shapes = [(60, 80), (45, 45), (90, 50)]
    items, images = [], []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        images.append(rng.integers(0, 256, (h, w, 3), np.uint8))
        annos = []
        for k in range(1 + i % 3):
            x, y = rng.uniform(-5, 0.6 * w), rng.uniform(-5, 0.6 * h)
            anno = {"bbox": [x, y, rng.uniform(5, 0.6 * w), rng.uniform(5, 0.6 * h)]}
            anno["caption" if k % 2 else "category_name"] = f"thing {i} {k}"
            annos.append(anno)
        items.append({"data_id": f"d{i}", "caption": f"a picture {i}", "is_det": bool(i % 2),
                      "annos": annos})
    return items, images


def _assert_rows_equal(got, want, pixels):
    assert got[0] == want[0]
    g, w = json.loads(got[1]), json.loads(want[1])
    assert sorted(g) == sorted(w)
    for key in w:
        if key not in ("image", "annos"):
            assert g[key] == w[key], key
    assert np.array_equal(tsv.decode_base64_image(g["image"]), pixels)
    assert len(g["annos"]) == len(w["annos"])
    for ga, wa in zip(g["annos"], w["annos"]):
        assert sorted(ga) == sorted(wa)
        for key, value in wa.items():
            if key.endswith(("_before", "_after")):
                a, b = tsv.decode_base64_fp32(ga[key]), tsv.decode_base64_fp32(value)
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= FEATURE_TOL * max(np.abs(b).max(), 1e-30), key
            else:
                assert ga[key] == value, key


@pytest.mark.parametrize("with_features", [False, True])
def test_item_to_row_equals_the_jax_packages(featurizers, with_features):
    got_f, want_f = featurizers if with_features else (None, None)
    items, images = _items(np.random.default_rng(31), 3)
    for item, pixels in zip(items, images):
        got = prepare_grounding.item_to_row(item, pixels, got_f)
        want = jprep.item_to_row(item, Image.fromarray(pixels), want_f)
        _assert_rows_equal(got, want, pixels)


def test_write_grounding_tsv_equals_the_jax_packages(tmp_path, featurizers):
    got_f, want_f = featurizers
    items, images = _items(np.random.default_rng(32), 4)
    n_got = prepare_grounding.write_grounding_tsv(items, images, str(tmp_path / "p.tsv"), got_f)
    n_want = jprep.write_grounding_tsv(items, [Image.fromarray(p) for p in images],
                                       str(tmp_path / "j.tsv"), want_f)
    assert n_got == n_want == 4
    got_rows, want_rows = tsv.TSVFile(str(tmp_path / "p.tsv")), tsv.TSVFile(str(tmp_path / "j.tsv"))
    for i in range(4):
        _assert_rows_equal(got_rows[i], want_rows[i], images[i])
        # the JAX package reads the port's PNG row too
        payload = json.loads(got_rows[i][1])["image"]
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(base64.b64decode(payload)))),
                              images[i])


def test_crop_box_is_pils_crop_and_resize():
    rng = np.random.default_rng(33)
    pixels = rng.integers(0, 256, (50, 70, 3), np.uint8)
    pil = Image.fromarray(pixels)
    for bbox in ([3.7, 2.2, 20.9, 30.1], [-4.0, -3.0, 90.0, 70.0], [60.5, 40.5, 30.0, 30.0]):
        x, y, bw, bh = bbox
        want = np.asarray(pil.crop((max(int(x), 0), max(int(y), 0), min(int(x + bw), 70),
                                    min(int(y + bh), 50))).resize((224, 224)), np.float32)
        assert np.array_equal(prepare_grounding.crop_box(pixels, bbox), want)
    with pytest.raises(ValueError, match="no pixel"):
        prepare_grounding.crop_box(pixels, [80.0, 10.0, 5.0, 5.0])


def test_project_and_inverse_equal_the_jax_packages():
    rng = np.random.default_rng(34)
    m = rng.standard_normal((8, 8)).astype(np.float32) + 4 * np.eye(8, dtype=np.float32)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    assert np.array_equal(prepare_grounding.project(x, m), jprep.project(x, m))
    assert np.array_equal(prepare_grounding.inv_project(x, m), jprep.inv_project(x, m))
