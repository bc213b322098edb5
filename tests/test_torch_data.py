"""The port's training data path against the JAX package's, on the CPU:
the TSV engine and its native reader, the payload codecs (PNG without PIL,
JPEG through the port's own decoder), the PIL-exact resizes of the crop,
the box dataset item for item (the same numpy RNG draws), the catalog, the concatenation,
and the latent cache with its VAE weight digest.

Tolerances: everything is exact (bytes, uint8 pixels, float32 items, the
digest string) except the latent cache's moments, computed by two
implementations of the VAE in fp32 (atol 1e-4, measured ~1e-6).
"""

import base64
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from gligen_tpu.data import box_dataset as jbox
from gligen_tpu.data import catalog as jcatalog
from gligen_tpu.data import jpeg as jjpeg
from gligen_tpu.data import latent_cache as jlatent
from gligen_tpu.data import transforms as jtransforms
from gligen_tpu.data import tsv as jtsv
from gligen_tpu.models.vae import AutoencoderKL as JaxVAE

from gligen_tpu_torch.convert.from_jax import state_dict_from_jax
from gligen_tpu_torch.data import box_dataset, catalog, jpeg, latent_cache, native, png
from gligen_tpu_torch.data import transforms, tsv
from gligen_tpu_torch.data.concat import ConCatDataset
from gligen_tpu_torch.models.vae import AutoencoderKL

from test_torch_modules import VAE, random_params

torch.set_num_threads(1)


def _rows(rng, n, text="u"):
    return [[f"id{i}", "x" * int(rng.integers(1, 50)), f"{text}{i}"] for i in range(n)]


def test_tsv_writer_bytes_and_lineidx_equal_the_jax_packages(tmp_path):
    rows = _rows(np.random.default_rng(0), 12)
    for mod, name in ((tsv, "port"), (jtsv, "jax")):
        w = mod.TSVWriter(str(tmp_path / f"{name}.tsv"))
        for r in rows:
            w.write(r)
        w.close()
    for ext in (".tsv", ".lineidx"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    tsv.generate_lineidx(str(tmp_path / "jax.tsv"), str(tmp_path / "gen.lineidx"))
    assert (tmp_path / "gen.lineidx").read_bytes() == (tmp_path / "jax.lineidx").read_bytes()
    assert native.generate_lineidx_native(str(tmp_path / "jax.tsv"),
                                          str(tmp_path / "nat.lineidx")) == len(rows)
    assert (tmp_path / "nat.lineidx").read_bytes() == (tmp_path / "jax.lineidx").read_bytes()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("filtering", ["none", "linelist", "chunks"])
def test_tsv_file_reads_jax_written_tsvs(tmp_path, monkeypatch, use_native, filtering):
    rows = _rows(np.random.default_rng(1), 10)
    path = str(tmp_path / "d.tsv")
    w = jtsv.TSVWriter(path)
    for r in rows:
        w.write(r)
    w.close()
    selector = None
    if filtering in ("linelist", "chunks"):
        (tmp_path / "d.linelist").write_text("7\n1\n4\n6\n1\n")
    if filtering == "chunks":
        (tmp_path / "d.chunks").write_text(json.dumps({"a": [0, 3], "b": [4, 9]}))
        selector = ["b"]
    want = jtsv.TSVFile(path, class_selector=selector)
    got = tsv.TSVFile(path, class_selector=selector)
    if not use_native:
        monkeypatch.setattr(got, "_ensure_native", lambda: None)
    assert len(got) == len(want) > 0
    assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]
    assert got.get_class_boundaries() == want.get_class_boundaries()
    assert (got._ensure_native() is not None) == use_native


def test_tsv_writer_offsets_count_bytes(tmp_path):
    """Fault F6: the JAX writer's offsets count characters, so a row after
    a non-ASCII one is misplaced; the port's are the file's byte offsets."""
    rows = _rows(np.random.default_rng(0), 5, text="\u00fc")
    for mod, name in ((tsv, "port"), (jtsv, "jax")):
        w = mod.TSVWriter(str(tmp_path / f"{name}.tsv"))
        for r in rows:
            w.write(r)
        w.close()
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    tsv.generate_lineidx(str(tmp_path / "port.tsv"), str(tmp_path / "gen.lineidx"))
    assert (tmp_path / "port.lineidx").read_bytes() == (tmp_path / "gen.lineidx").read_bytes()
    assert (tmp_path / "jax.lineidx").read_bytes() != (tmp_path / "gen.lineidx").read_bytes()
    got = tsv.TSVFile(str(tmp_path / "port.tsv"))
    assert [got[i] for i in range(len(got))] == rows


def test_native_reader_rows_are_the_files_lines(tmp_path):
    path = str(tmp_path / "d.tsv")
    w = tsv.TSVWriter(path)
    big = "y" * (3 << 20)
    for r in _rows(np.random.default_rng(2), 3) + [["big", big]]:
        w.write(r)
    w.close()
    reader = native.NativeTSV(path, str(tmp_path / "d.lineidx"))
    with open(path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    assert len(reader) == len(lines)
    assert [reader.read_row(i) for i in range(len(lines))] == lines
    with pytest.raises(IndexError):
        reader.read_row(len(lines))
    reader.close()


def test_native_library_is_built_from_the_checkout():
    lib = native.library_path("tsv_reader")
    native.tsv_library()
    assert lib.exists() and lib.parent.parent == native.BUILD_DIR
    assert "native/libtsv_reader.so" not in str(lib)


def _jpeg_b64(rng, h, w, quality=90, mode="RGB"):
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    img = Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_decode_equals_the_jax_packages_and_pils(mode):
    rng = np.random.default_rng(3)
    for h, w in ((17, 23), (64, 48)):
        b64 = _jpeg_b64(rng, h, w, mode=mode)
        raw = base64.b64decode(b64)
        got = tsv.decode_base64_image(b64)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        assert np.array_equal(got, jjpeg.decode_rgb(raw))
        assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")))


def test_png_payload_roundtrips_and_pil_reads_it():
    rng = np.random.default_rng(4)
    pixels = rng.integers(0, 256, (9, 13, 3), np.uint8)
    b64 = tsv.encode_base64_image(pixels)
    assert np.array_equal(tsv.decode_base64_image(b64), pixels)
    pil = np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))
    assert np.array_equal(pil, pixels)
    assert np.array_equal(np.asarray(jtsv.decode_base64_image(b64)), pixels)


def test_other_payloads_raise():
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        tsv.decode_base64_image(base64.b64encode(b"GIF89a....").decode())


def test_jpeg_decoder_links_no_library():
    source = jpeg.SOURCE.read_text()
    assert "jpeglib.h" not in source and "#include <j" not in source
    jpeg.jpeg_library()
    lib = native.library_path("jpeg_baseline", (), native.CSRC)
    assert lib.exists() and lib.parent.parent == native.BUILD_DIR
    # the shared object names no libjpeg among the libraries it needs
    assert b"libjpeg" not in lib.read_bytes()


# (H, W) of seeded images and the crop size: downscaled by more than 2x
# (the BOX halvings, then bicubic), between 1x and 2x (bicubic down),
# upscaled (bicubic up), already at size (a copy), odd sizes
CROP_CASES = [
    ((1100, 1200), 512), ((800, 1100), 512), ((256, 320), 512), ((512, 640), 512),
    ((300, 260), 64), ((100, 80), 64), ((40, 50), 64), ((37, 201), 64), ((1030, 1025), 256),
]


@pytest.mark.parametrize("shape,size", CROP_CASES)
def test_center_crop_and_transform_equal_the_jax_pil_path(shape, size):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    pixels = rng.integers(0, 256, shape + (3,), np.uint8)
    got, got_info = transforms.center_crop_arr(pixels, size)
    want, want_info = jtransforms.center_crop_arr(Image.fromarray(pixels, "RGB"), size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    assert np.array_equal(got, want) and got_info == want_info
    for seed in (0, 1, 2):
        g, gi = transforms.transform_image(pixels, size, True, np.random.default_rng(seed))
        w, wi = jtransforms.transform_image(Image.fromarray(pixels, "RGB"), size, True,
                                            np.random.default_rng(seed))
        assert g.dtype == np.float32 and np.array_equal(g, w) and gi == wi


@pytest.mark.parametrize("kind,resample", [("box", Image.BOX), ("bicubic", Image.BICUBIC)])
def test_resize_equals_pils(kind, resample):
    rng = np.random.default_rng(6)
    pixels = rng.integers(0, 256, (45, 61, 3), np.uint8)
    for size in ((30, 22), (61, 20), (122, 45), (7, 90), (61, 45)):
        want = np.asarray(Image.fromarray(pixels, "RGB").resize(size, resample=resample))
        assert np.array_equal(transforms.resize(pixels, size, kind), want), size


def test_random_crop_arr_equals_the_jax_packages():
    pixels = np.random.default_rng(7).integers(0, 256, (90, 130, 3), np.uint8)
    got = transforms.random_crop_arr(pixels, 64, np.random.default_rng(8))
    want = jtransforms.random_crop_arr(Image.fromarray(pixels, "RGB"), 64,
                                       np.random.default_rng(8))
    assert np.array_equal(got, want)


def test_box_helpers_equal_the_jax_packages():
    info = {"performed_scale": 0.75, "crop_x": 10, "crop_y": 3, "performed_flip": True}
    for box in ((5, 7, 40, 30), (-20, -20, 15, 15), (200, 5, 10, 10), (0, 0, 1, 1)):
        assert transforms.recalculate_box_and_verify_if_valid(*box, info, 64, 0.01) == \
            jtransforms.recalculate_box_and_verify_if_valid(*box, info, 64, 0.01)
    assert transforms.xyhw2xyxy([1, 2, 3, 4]) == jtransforms.xyhw2xyxy([1, 2, 3, 4])
    names = ["cat", "rug-other", "dog"]
    for clean in (False, True):
        assert transforms.make_a_sentence(names, clean) == \
            jtransforms.make_a_sentence(names, clean)


def write_box_tsv(path, rng, shapes, image_format="JPEG", is_det=False):
    """A grounding TSV in the item format of the JAX package's data tests:
    seeded images of ``shapes``, 1 to 6 boxes each with 768-d
    embeddings, written by the JAX package's writer."""
    w = jtsv.TSVWriter(path)
    for i, (h, wd) in enumerate(shapes):
        annos = []
        for k in range(1 + i % 6):
            x, y = rng.uniform(0, wd * 0.8), rng.uniform(0, h * 0.8)
            anno = {"bbox": [float(x), float(y), float(rng.uniform(1, wd - x)),
                             float(rng.uniform(1, h - y))]}
            for key in tsv.EMBEDDING_KEYS:
                anno[key] = jtsv.encode_base64_fp32(rng.standard_normal(768))
            if is_det:
                anno["category_name"] = f"thing{k}"
            annos.append(anno)
        pixels = rng.integers(0, 256, (h, wd, 3), np.uint8)
        image = (jtsv.encode_base64_image(Image.fromarray(pixels, "RGB"))
                 if image_format == "JPEG" else tsv.encode_base64_image(pixels))
        item = {"data_id": i, "caption": f"a scene number {i}", "annos": annos,
                "image": image, "is_det": is_det}
        w.write([i, json.dumps(item)])
    w.close()


def _item_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
        else:
            assert got[key] == value, key


DATASET_CASES = [
    dict(),
    dict(random_drop_embedding="both", which_layer_text="after", prob_use_caption=0.5),
    dict(random_drop_embedding="image", which_layer_image="after_renorm", random_flip=False),
    dict(which_layer_image="after", max_boxes_per_data=3, min_box_size=0.05),
]


@pytest.mark.parametrize("kwargs", DATASET_CASES)
@pytest.mark.parametrize("image_format,is_det", [("JPEG", False), ("PNG", True)])
def test_box_dataset_items_equal_the_jax_packages(tmp_path, kwargs, image_format, is_det):
    rng = np.random.default_rng(9)
    path = str(tmp_path / "g.tsv")
    write_box_tsv(path, rng, [(40, 50), (100, 80), (300, 260), (64, 64), (70, 130)],
                  image_format, is_det)
    proj = str(tmp_path / "proj.npy")
    np.save(proj, rng.standard_normal((768, 768)).astype(np.float32))
    common = dict(image_size=64, projection_matrix_path=proj, seed=11, **kwargs)
    got = box_dataset.TSVBoxDataset(path, **common)
    want = jbox.TSVBoxDataset(path, **common)
    assert len(got) == len(want) == 5
    for _ in range(2):  # the RNG carries on across epochs
        for i in range(len(got)):
            _item_equal(got[i], want[i])


def test_box_dataset_projection_matrix_from_a_torch_file(tmp_path):
    proj = torch.randn(768, 768, generator=torch.Generator().manual_seed(0))
    torch.save(proj, tmp_path / "projection_matrix")
    got = box_dataset._load_projection_matrix(str(tmp_path / "projection_matrix"))
    assert got.dtype == np.float32 and np.array_equal(got, proj.numpy())
    assert np.array_equal(got, jbox._load_projection_matrix(str(tmp_path / "projection_matrix")))


def test_reproject_without_a_matrix_raises_even_for_text_configs(tmp_path, monkeypatch):
    monkeypatch.delenv("GLIGEN_TPU_PROJECTION_MATRIX", raising=False)
    path = str(tmp_path / "g.tsv")
    write_box_tsv(path, np.random.default_rng(10), [(40, 40)])
    with pytest.raises(FileNotFoundError, match="projection"):
        box_dataset.TSVBoxDataset(path)
    assert len(box_dataset.TSVBoxDataset(path, which_layer_image="after")) == 1


def test_box_dataset_rejects_bad_options(tmp_path):
    path = str(tmp_path / "g.tsv")
    write_box_tsv(path, np.random.default_rng(10), [(40, 40)])
    for bad in (dict(which_layer_text="middle"), dict(random_crop=True),
                dict(max_boxes_per_data=100)):
        with pytest.raises(ValueError):
            box_dataset.TSVBoxDataset(path, which_layer_image="after", **bad)


def test_catalog_equals_the_jax_packages():
    assert catalog.dataset_catalog("ROOT") == jcatalog.dataset_catalog("ROOT")


def test_concat_from_catalog_and_repeats(tmp_path):
    root = str(tmp_path)
    entry = catalog.dataset_catalog(root)["FlickrGrounding"]["train_params"]["tsv_path"]
    os.makedirs(os.path.dirname(entry))
    write_box_tsv(entry, np.random.default_rng(12), [(40, 40), (48, 40)])
    names = {"FlickrGrounding": {"which_layer_image": "after", "image_size": 32,
                                 "repeat": 2}}
    ds = ConCatDataset.from_catalog(names, catalog.dataset_catalog(root))
    assert len(ds) == 4 and names["FlickrGrounding"]["repeat"] == 2
    assert ds[1]["image"].shape == ds[3]["image"].shape == (32, 32, 3)
    with pytest.raises(KeyError, match="unknown target"):
        ConCatDataset.from_catalog({"X": {}}, {"X": {"target": "dataset.no_such.Dataset"}})
    # every catalog name resolves now; this one's files are absent
    with pytest.raises(FileNotFoundError, match="CC3M/tsv/train-00"):
        ConCatDataset.from_catalog({"CC3MGroundingHed": {}}, catalog.dataset_catalog(root))
    ds.reseed(5)
    assert ds.datasets[0].rng.bit_generator.state == \
        np.random.default_rng(5).bit_generator.state


def _vaes():
    jvae = JaxVAE(**VAE)
    params = random_params(jvae, jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(0), seed=2)
    vae = AutoencoderKL(**VAE)
    vae.load_state_dict(state_dict_from_jax(params), strict=True)
    return jvae, params, vae.eval()


def test_params_digest_equals_the_jax_packages():
    _, params, vae = _vaes()
    assert latent_cache.params_digest(vae) == jlatent.params_digest(params)
    with torch.no_grad():
        vae.encoder.conv_in.weight[0, 0, 0, 0] += 1.0
    assert latent_cache.params_digest(vae) != jlatent.params_digest(params)


def test_latent_cache_equals_the_jax_packages(tmp_path):
    jvae, params, vae = _vaes()
    path = str(tmp_path / "g.tsv")
    write_box_tsv(path, np.random.default_rng(13), [(20, 24), (40, 30), (16, 16)])
    got_path = latent_cache.write_latent_cache(path, str(tmp_path / "port.npy"), vae,
                                               image_size=16, batch=2)
    want_path = jlatent.write_latent_cache(path, str(tmp_path / "jax.npy"), jvae, params,
                                           image_size=16, batch=2)
    got, want = np.load(got_path), np.load(want_path)
    assert got.shape == want.shape == (3, 2, 8, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with open(str(tmp_path / "port.json")) as f, open(str(tmp_path / "jax.json")) as g:
        assert json.load(f) == {**json.load(g), "tsv": "g.tsv"}
    cache = latent_cache.LatentCache(got_path, expect_image_size=16)
    assert np.array_equal(cache.get(1, True), got[1, 1])
    with pytest.raises(ValueError, match="image_size"):
        latent_cache.LatentCache(got_path, expect_image_size=32)
    assert latent_cache.cache_path_for("/a/train-00.tsv", "/c") == \
        jlatent.cache_path_for("/a/train-00.tsv", "/c")


def test_png_decode_rejects_a_non_png():
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8\xff\xe0")
