"""The port's keypoint and spatial training datasets against the JAX
package's, on the CPU: the same files on disk (``tools/modality_data.py``,
the reference's formats at the catalog's paths), the same seed, flip on and
off, every item's arrays ``np.array_equal`` and every other field equal.
Also the pieces they are built from: NEAREST resizes and ``to_luma``
against PIL, the keypoint helpers, the catalog resolving all twelve
datasets, and the sem label check (a ``ValueError`` naming the file).

Tolerances: none; everything is exact.
"""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from gligen_tpu.data import catalog as jcatalog
from gligen_tpu.data import keypoint_dataset as jkp
from gligen_tpu.data import spatial_datasets as jspatial

from gligen_tpu_torch.data import catalog, keypoint_dataset, png, spatial_datasets, transforms
from gligen_tpu_torch.tools import modality_data
from gligen_tpu_torch.utils.registry import DATASETS

SHAPES = [(40, 50), (70, 30), (33, 33), (20, 64)]


def seeded_images(rng, shapes=SHAPES, fmt="JPEG", stem="img"):
    """(name, bytes, (H, W)) of seeded photo-like images, saved by PIL."""
    out = []
    for i, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 128 + 90 * np.sin(xx / rng.uniform(3, 9)) * np.cos(yy / rng.uniform(3, 9))
        pixels = np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, format=fmt)
        ext = "jpg" if fmt == "JPEG" else "png"
        out.append((f"{stem}{i:02d}.{ext}", buf.getvalue(), (h, w)))
    return out


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, (np.ndarray, np.generic)):
            value = np.asarray(value)
            assert np.asarray(got[key]).dtype == value.dtype, key
            assert np.array_equal(got[key], value), key
        else:
            assert got[key] == value, key


def _both(port_cls, jax_cls, **kw):
    return port_cls(**kw), jax_cls(**kw)


def _items(port, jax_ds):
    for i in list(range(len(jax_ds))) * 2:  # a second pass: the draws carry on
        assert_items_equal(port[i], jax_ds[i])


@pytest.mark.parametrize("modality", ["hed", "canny", "depth"])
@pytest.mark.parametrize("flip", [False, True])
def test_paired_tsv_items_equal_the_jax_packages(tmp_path, modality, flip):
    rng = np.random.default_rng(1)
    root = str(tmp_path)
    params = modality_data.write_paired_tsvs(root, seeded_images(rng), rng)[modality]
    port_cls = DATASETS.get(f"dataset.dataset_{modality}.{modality.capitalize()}Dataset")
    jax_cls = {"hed": jspatial.HedDataset, "canny": jspatial.CannyDataset,
               "depth": jspatial.DepthDataset}[modality]
    port, jax_ds = _both(port_cls, jax_cls, image_size=32, random_flip=flip,
                         prob_use_caption=0.5, seed=7, **params)
    assert len(port) == len(jax_ds) == len(SHAPES)
    _items(port, jax_ds)


@pytest.mark.parametrize("flip", [False, True])
def test_normal_items_equal_the_jax_packages(tmp_path, flip):
    rng = np.random.default_rng(2)
    images = seeded_images(rng, SHAPES[:2]) + seeded_images(rng, SHAPES[2:], "PNG", "png")
    params = modality_data.write_normal_tree(str(tmp_path), images, rng)
    port, jax_ds = _both(spatial_datasets.NormalDataset, jspatial.NormalDataset, image_size=32,
                         random_flip=flip, prob_use_caption=0.5, seed=8, **params)
    _items(port, jax_ds)


@pytest.mark.parametrize("flip", [False, True])
def test_sem_items_equal_the_jax_packages(tmp_path, flip):
    rng = np.random.default_rng(3)
    params = modality_data.write_sem_tree(str(tmp_path), seeded_images(rng), rng)
    port, jax_ds = _both(spatial_datasets.SemanticDataset, jspatial.SemanticDataset,
                         image_size=32, random_flip=flip, prob_use_caption=0.5, seed=9,
                         **params)
    _items(port, jax_ds)
    assert port[0]["sem"].shape == (32, 32) and port[0]["sem"].dtype == np.uint8


def test_sem_reads_rgb_and_palette_labels_as_pils_convert_l(tmp_path):
    rng = np.random.default_rng(4)
    params = modality_data.write_sem_tree(str(tmp_path), seeded_images(rng, SHAPES[:2]), rng)
    files = sorted(os.listdir(params["sem_rootdir"]))
    # an RGB label map and a palette one in place of the grayscale PNGs
    for name, kind in zip(files, ("RGB", "P")):
        path = os.path.join(params["sem_rootdir"], name)
        labels = np.asarray(Image.open(path))
        img = Image.fromarray(np.stack([labels // 2] * 3, -1))
        (img.convert("P", palette=Image.ADAPTIVE, colors=64) if kind == "P" else img).save(path)
    port, jax_ds = _both(spatial_datasets.SemanticDataset, jspatial.SemanticDataset,
                         image_size=16, seed=1, **params)
    _items(port, jax_ds)


def test_a_sem_label_past_the_classes_raises_naming_its_file(tmp_path):
    rng = np.random.default_rng(5)
    params = modality_data.write_sem_tree(str(tmp_path), seeded_images(rng, SHAPES[:1]), rng)
    name = sorted(os.listdir(params["sem_rootdir"]))[0]
    path = os.path.join(params["sem_rootdir"], name)
    labels, _ = png.read_png(path)
    labels[labels.shape[0] // 2, labels.shape[1] // 2] = 152
    png.write_png(path, labels)
    ds = spatial_datasets.SemanticDataset(image_size=labels.shape[0], **params)
    with pytest.raises(ValueError, match=f"{name}: label 152"):
        ds[0]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("max_persons,min_box", [(8, 0.0), (2, 0.0), (8, 2.0)])
def test_keypoint_items_equal_the_jax_packages(tmp_path, flip, max_persons, min_box):
    """``max_persons`` 2 truncates images of 3 persons by box area;
    ``min_box`` 2.0 drops every person (all points and masks zero)."""
    rng = np.random.default_rng(6)
    images = seeded_images(rng) + seeded_images(rng, [(52, 31)], "PNG", "png")
    params = modality_data.write_keypoint_tree(str(tmp_path), images, rng)
    port, jax_ds = _both(keypoint_dataset.KeypointDataset, jkp.KeypointDataset, image_size=32,
                         random_flip=flip, prob_real_caption=0.5, seed=10,
                         max_persons_per_image=max_persons, min_box_size=min_box, **params)
    _items(port, jax_ds)
    if min_box:
        assert not any(port[i]["masks"].any() for i in range(len(port)))
    if max_persons == 2:
        assert port[0]["points"].shape == (34, 2)


def test_keypoint_helpers_equal_the_jax_packages():
    rng = np.random.default_rng(7)
    for _ in range(20):
        kps = []
        for _ in range(17):
            kps += [float(rng.uniform(-20, 80)), float(rng.uniform(-20, 80)), int(rng.integers(3))]
        info = {"performed_scale": float(rng.uniform(0.3, 2)), "crop_x": int(rng.integers(0, 9)),
                "crop_y": int(rng.integers(0, 9)), "performed_flip": bool(rng.integers(2))}
        box = [float(v) for v in rng.uniform(-10, 60, 4)]
        args = (*box, None, info, 64, float(rng.uniform(0, 0.2)))
        got = keypoint_dataset.recalculate_box_kps_and_verify_if_valid(
            *args[:4], keypoint_dataset.clean_kps(kps), *args[5:])
        want = jkp.recalculate_box_kps_and_verify_if_valid(*args[:4], jkp.clean_kps(kps),
                                                           *args[5:])
        assert got == want
    with pytest.raises(ValueError, match="51"):
        keypoint_dataset.clean_kps([0.0] * 50)


@pytest.mark.parametrize("shape,size", [((600, 512), 512), ((333, 217), 64), ((37, 201), 16),
                                        ((512, 512), 512), ((5, 3), 300)])
def test_nearest_resize_crop_and_luma_equal_pils(shape, size):
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 152, shape, np.uint8)
    pil = Image.fromarray(labels)
    w, h = pil.size
    crop = min(w, h)
    left, top = (w - crop) // 2, (h - crop) // 2
    want = np.asarray(pil.crop((left, top, left + crop, top + crop)).resize(
        (size, size), Image.NEAREST))
    got = transforms.resize(transforms.center_crop_square(labels), (size, size), "nearest")
    assert np.array_equal(got, want)
    rgb = rng.integers(0, 256, shape + (3,), np.uint8)
    assert np.array_equal(transforms.to_luma(rgb), np.asarray(Image.fromarray(rgb).convert("L")))
    assert np.array_equal(transforms.resize(rgb, (size, size // 2 + 1), "nearest"),
                          np.asarray(Image.fromarray(rgb).resize((size, size // 2 + 1),
                                                                 Image.NEAREST)))


def test_catalog_resolves_every_dataset_under_the_jax_names():
    cat = catalog.dataset_catalog("/data")
    assert cat == jcatalog.dataset_catalog("/data")
    for name, entry in cat.items():
        assert entry["target"] in DATASETS, name
    for short, cls in (("hed", spatial_datasets.HedDataset),
                       ("canny", spatial_datasets.CannyDataset),
                       ("depth", spatial_datasets.DepthDataset),
                       ("normal", spatial_datasets.NormalDataset),
                       ("sem", spatial_datasets.SemanticDataset),
                       ("keypoint", keypoint_dataset.KeypointDataset)):
        assert DATASETS.get(short) is cls


def test_recursively_read_equals_the_jax_packages(tmp_path):
    for rel in ("a/x.jpg", "a/b/y.png", "c/z.npy", "c/w.txt", "d/v.jpg.bak"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
    for kw in ({}, {"exts": ["jpg"]}, {"must_contain": "/b/"}):
        assert sorted(spatial_datasets.recursively_read(str(tmp_path), **kw)) == \
            sorted(jspatial.recursively_read(str(tmp_path), **kw))


def test_paired_rows_that_do_not_pair_raise(tmp_path):
    rng = np.random.default_rng(9)
    params = modality_data.write_paired_tsvs(str(tmp_path), seeded_images(rng, SHAPES[:2]), rng,
                                             ("hed",))["hed"]
    with open(params["hed_tsv_path"]) as f:
        rows = f.read().splitlines()
    first = json.loads(rows[0].split("\t")[1])
    first["data_id"] = 99
    rows[0] = "0\t" + json.dumps(first)
    from gligen_tpu_torch.data.tsv import TSVWriter

    writer = TSVWriter(params["hed_tsv_path"])
    for row in rows:
        writer.write(row.split("\t"))
    writer.close()
    ds = spatial_datasets.HedDataset(image_size=16, **params)
    with pytest.raises(ValueError, match="data_id"):
        ds[0]
