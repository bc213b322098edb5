"""The port's PNG codec (``gligen_tpu_torch/data/png.py``, zlib and numpy)
against PIL: every ``inference_images/*.png`` reads equal to PIL's
``convert("RGB")`` and ``convert("L")``; each colour type's conversion on
seeded images equals PIL's; every scanline filter decodes; what it writes
reads back equal through PIL; what it does not take raises, naming PIL.
All comparisons are exact (uint8).
"""

import glob
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gligen_tpu_torch.data import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_PNGS = sorted(glob.glob(os.path.join(REPO, "inference_images", "*.png")))


def test_the_repository_has_pngs():
    assert len(REPO_PNGS) == 7


@pytest.mark.parametrize("path", REPO_PNGS, ids=os.path.basename)
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_repository_pngs_read_as_pil(path, mode):
    got = png.open_image(path, mode)
    want = np.asarray(Image.open(path).convert(mode))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("to", ["RGB", "L"])
def test_conversions_equal_pil(tmp_path, mode, to):
    rng = np.random.default_rng(len(mode) + len(to))
    shape = (37, 53) if mode == "L" else (37, 53, len(mode))
    pixels = rng.integers(0, 256, size=shape).astype(np.uint8)
    path = tmp_path / "x.png"
    Image.fromarray(pixels, mode).save(path)
    got, got_mode = png.read_png(path)
    assert got_mode == mode and np.array_equal(got, pixels)
    want = np.asarray(Image.fromarray(pixels, mode).convert(to))
    assert np.array_equal(png.convert(got, mode, to), want)


def _encode(pixels: np.ndarray, filters) -> bytes:
    """A PNG whose row y uses filter ``filters[y % len(filters)]``."""
    h, w = pixels.shape[:2]
    bpp = 1 if pixels.ndim == 2 else pixels.shape[2]
    rows = pixels.reshape(h, w * bpp).astype(np.int32)
    raw = bytearray()
    for y in range(h):
        kind, cur = filters[y % len(filters)], rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
            ">I", zlib.crc32(kind + payload))

    colour = {1: 0, 3: 2, 4: 6}[bpp]
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"tEXt", b"Comment\0ancillary") + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_every_filter_decodes(tmp_path, channels, filters):
    rng = np.random.default_rng(channels)
    shape = (11, 9) if channels == 1 else (11, 9, channels)
    pixels = rng.integers(0, 256, size=shape).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(pixels, filters))
    got, _ = png.read_png(path)
    assert np.array_equal(got, pixels)
    assert np.array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("shape", [(16, 24, 3), (16, 24), (1, 1, 3), (512, 512, 3)])
def test_written_pngs_read_back_through_pil(tmp_path, shape):
    pixels = np.random.default_rng(sum(shape)).integers(0, 256, size=shape).astype(np.uint8)
    path = tmp_path / "w.png"
    png.write_png(path, pixels)
    img = Image.open(path)
    assert img.mode == ("L" if len(shape) == 2 else "RGB")
    assert np.array_equal(np.asarray(img), pixels)
    assert np.array_equal(png.read_png(path)[0], pixels)


def test_what_it_does_not_take_raises_naming_pil(tmp_path):
    palette = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(palette)
    with pytest.raises(ValueError, match="PIL"):
        png.read_png(palette)
    deep = tmp_path / "d.png"
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(deep)
    with pytest.raises(ValueError, match="PIL"):
        png.read_png(deep)
    with pytest.raises(ValueError, match="PIL"):
        png.write_png(tmp_path / "f.png", np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="PIL"):
        png.convert(np.zeros((4, 4, 3), np.uint8), "RGB", "CMYK")
    broken = tmp_path / "b.png"
    with open(REPO_PNGS[0], "rb") as f:
        data = bytearray(f.read())
    data[40] ^= 0xFF  # a byte of the first IDAT chunk
    broken.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(broken)


def test_jpegs_go_through_pil():
    path = os.path.join(REPO, "inference_images", "beach.jpg")
    assert np.array_equal(png.open_image(path, "RGB"), np.asarray(Image.open(path).convert("RGB")))
