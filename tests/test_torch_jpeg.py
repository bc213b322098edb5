"""The port's baseline JPEG decoder (``gligen_tpu_torch/data/jpeg.py``,
``csrc/jpeg_baseline.cpp``) against PIL and the JAX package's libjpeg
loader (``gligen_tpu/data/jpeg.py``), both libjpeg-turbo with the
accurate integer IDCT and fancy upsampling: every case must be bit for bit
equal (``np.array_equal`` on uint8 pixels).

The streams: the repository's four JPEGs; seeded arrays saved by PIL at
4:4:4, 4:2:2 and 4:2:0 over quality and size (sides of 1, 7, 17 x 9 and
333 x 217), grayscale, optimized Huffman tables, restart markers and 16-bit
quantization tables (SOF1); and streams from a small baseline encoder
written here for what PIL does not write: 4:4:0 (h1v2), an Adobe APP14 RGB
frame, component ids 'R', 'G', 'B' with no JFIF, and one scan a component.
"""

import hashlib
import io
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gligen_tpu.data import jpeg as jjpeg

from gligen_tpu_torch.data import jpeg, png

import chip_smoke

REPO = Path(__file__).resolve().parents[1]
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _smooth(rng, h, w, channels=3):
    """Photo-like content: smooth waves plus noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 80 * np.sin(xx / rng.uniform(5, 40) + rng.uniform(0, 6)) \
        + 60 * np.cos(yy / rng.uniform(5, 40))
    img = np.stack([base + rng.normal(0, 12, base.shape) for _ in range(channels)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pil(pixels, **kw):
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", **kw)
    return buf.getvalue()


# ---- a small baseline encoder (T.81) for the streams PIL does not write ----
# One quantization table; a DC Huffman table of 12 four-bit codes (symbol s
# is code s) and an AC table of 162 eight-bit codes (symbol i of AC_SYMBOLS
# is code i): valid canonical tables, no code all ones.
AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
AC_CODE = {sym: i for i, sym in enumerate(AC_SYMBOLS)}
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                   48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                   22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                   47, 55, 62, 63])
_U = np.arange(8)
DCT = np.where(_U[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8)) * np.cos(
    (2 * _U[None, :] + 1) * _U[:, None] * np.pi / 16)


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _encode(planes, size, factors, *, ids=(1, 2, 3), app="jfif", quant=None, restart=0,
            interleaved=True):
    """A baseline JPEG of component ``planes`` (uint8, each at its own
    sampling ``factors`` (h, v)) for an image of ``size`` (H, W)."""
    hgt, wid = size
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    quant = np.arange(1, 65).reshape(8, 8) if quant is None else quant
    q16 = int(quant.max()) > 255
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    coefs = []
    for plane, (h, v) in zip(planes, factors):
        by, bx = (mcuy * v, mcux * h) if interleaved else (-(-plane.shape[0] // 8),
                                                             -(-plane.shape[1] // 8))
        p = np.pad(plane.astype(np.float64) - 128,
                   ((0, by * 8 - plane.shape[0]), (0, bx * 8 - plane.shape[1])), mode="edge")
        blocks = p.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
        f = DCT @ blocks @ DCT.T
        coefs.append(np.round(f / quant).astype(np.int64).reshape(by, bx, 64)[..., ZIGZAG])

    def put_block(bits, coef, pred):
        diff = int(coef[0]) - pred
        s = abs(diff).bit_length()
        bits.put(s, 4)
        bits.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        last = max((k for k in range(1, 64) if coef[k]), default=0)
        for k in range(1, last + 1):
            c = int(coef[k])
            if c == 0:
                run += 1
                continue
            while run > 15:
                bits.put(AC_CODE[0xF0], 8)
                run -= 16
            s = abs(c).bit_length()
            bits.put(AC_CODE[(run << 4) | s], 8)
            bits.put(c if c >= 0 else c + (1 << s) - 1, s)
            run = 0
        if last < 63:
            bits.put(AC_CODE[0x00], 8)
        return int(coef[0])

    def scan(comps):
        bits, data = _Bits(), bytearray()
        preds = [0] * len(comps)
        if len(comps) == 1:  # one block an MCU, over the component's real size
            by, bx = (-(-n // 8) for n in planes[comps[0]].shape)
            mcus = [[(comps[0], y, x)] for y in range(by) for x in range(bx)]
        else:
            mcus = [[(ci, my * factors[ci][1] + y, mx * factors[ci][0] + x) for ci in comps
                     for y in range(factors[ci][1]) for x in range(factors[ci][0])]
                    for my in range(mcuy) for mx in range(mcux)]
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                bits.flush()
                data += bits.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                bits.out = bytearray()
                preds = [0] * len(comps)
            for ci, y, x in mcu:
                k = comps.index(ci)
                preds[k] = put_block(bits, coefs[ci][y, x], preds[k])
        bits.flush()
        data += bits.out
        header = bytes([len(comps)]) + b"".join(bytes([ids[c], 0x00]) for c in comps)
        return _segment(0xDA, header + bytes([0, 63, 0])) + bytes(data)

    out = b"\xff\xd8"
    if app == "jfif":
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif app == "adobe_rgb":
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    qbytes = b"".join(int(q).to_bytes(2 if q16 else 1, "big") for q in quant.reshape(64)[ZIGZAG])
    out += _segment(0xDB, bytes([0x10 if q16 else 0x00]) + qbytes)
    frame = bytes([8]) + hgt.to_bytes(2, "big") + wid.to_bytes(2, "big") + bytes([len(planes)])
    frame += b"".join(bytes([ids[i], (h << 4) | v, 0]) for i, (h, v) in enumerate(factors))
    out += _segment(0xC1 if q16 else 0xC0, frame)
    out += _segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12)))
    out += _segment(0xC4, bytes([0x10]) + bytes([0] * 7 + [162] + [0] * 8) + bytes(AC_SYMBOLS))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    if interleaved or len(planes) == 1:
        out += scan(list(range(len(planes))))
    else:
        for ci in range(len(planes)):
            out += scan([ci])
    return out + b"\xff\xd9"


def _planes(rng, size, factors):
    hgt, wid = size
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    return [_smooth(rng, -(-hgt * v // vmax), -(-wid * h // hmax), 1) for h, v in factors]


def _crafted(kind, size, seed, **kw):
    rng = np.random.default_rng(seed)
    factors = {"440": ((1, 2), (1, 1), (1, 1)), "420": ((2, 2), (1, 1), (1, 1)),
               "444": ((1, 1),) * 3, "422": ((2, 1), (1, 1), (1, 1))}[kind]
    return _encode(_planes(rng, size, factors), size, factors, **kw)


def _case(name):
    kind, _, rest = name.partition(":")
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big"))
    if kind == "repo":
        return (REPO / "inference_images" / f"{rest}.jpg").read_bytes()
    if kind == "quality":
        sub, q = rest.split("-")
        return _pil(_smooth(rng, 64, 80), subsampling=SUBSAMPLING[sub], quality=int(q))
    if kind == "size":
        sub, hw = rest.split("-")
        h, w = map(int, hw.split("x"))
        return _pil(_smooth(rng, h, w), subsampling=SUBSAMPLING[sub], quality=80)
    if kind == "gray":
        h, w = map(int, rest.split("x"))
        return _pil(_smooth(rng, h, w, 1), quality=85)
    if kind == "optimize":
        return _pil(_smooth(rng, 217, 333), optimize=True, subsampling=2)
    if kind == "restart":
        unit, n = rest.split("-")
        return _pil(_smooth(rng, 217, 333), subsampling=2, **{f"restart_marker_{unit}": int(n)})
    if kind == "dqt16":  # quantization values above 255: 16-bit DQT, SOF1
        q = rng.integers(200, 400, 64).tolist()
        return _pil(_smooth(rng, 64, 80), qtables=[q, q])
    if kind == "crafted":
        sub, hw, *opts = rest.split("-")
        h, w = map(int, hw.split("x"))
        kw = {}
        for o in opts:
            if o == "adobe":
                kw.update(app="adobe_rgb")
            elif o == "rgbids":
                kw.update(app=None, ids=(ord("R"), ord("G"), ord("B")))
            elif o == "noapp":
                kw.update(app=None)
            elif o == "scans":
                kw.update(interleaved=False)
            elif o.startswith("rst"):
                kw.update(restart=int(o[3:]))
            elif o == "q16":
                kw.update(quant=np.random.default_rng(5).integers(100, 600, (8, 8)))
        return _crafted(sub, (h, w), int(rng.integers(1 << 30)), **kw)
    raise KeyError(name)


CASES = (
    [f"repo:{n}" for n in ("beach", "bigben", "dalle2_museum", "style_golden")]
    + [f"quality:{s}-{q}" for s in SUBSAMPLING for q in (50, 75, 95)]
    + [f"size:{s}-{hw}" for s in SUBSAMPLING for hw in ("1x1", "7x7", "17x9", "333x217")]
    + ["gray:17x9", "gray:217x333", "optimize:", "restart:blocks-3", "restart:rows-1", "dqt16:"]
    + ["crafted:440-333x217", "crafted:440-7x7", "crafted:440-1x5-rst2",
       "crafted:444-40x24-adobe", "crafted:444-17x9-rgbids", "crafted:420-45x37-noapp",
       "crafted:420-45x37-scans", "crafted:422-33x50-scans-rst5", "crafted:420-64x48-q16"]
)


@pytest.mark.parametrize("name", CASES)
def test_decode_is_bit_for_bit_pils_and_the_jax_packages(name):
    raw = _case(name)
    pil = Image.open(io.BytesIO(raw))
    want = np.asarray(pil)
    got, mode = jpeg.decode(raw)
    assert mode == pil.mode
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    rgb = jpeg.decode_rgb(raw)
    assert np.array_equal(rgb, np.asarray(pil.convert("RGB")))
    assert np.array_equal(rgb, jjpeg.decode_rgb(raw))


def _patched(raw, old, new):
    i = raw.index(old)
    return raw[:i] + new + raw[i + len(new):]


def _unsupported_cases():
    rng = np.random.default_rng(11)
    base = _pil(_smooth(rng, 24, 40), quality=80)
    sof = base.index(b"\xff\xc0")
    cmyk = io.BytesIO()
    Image.fromarray(_smooth(rng, 16, 16)).convert("CMYK").save(cmyk, format="JPEG")
    return {
        "progressive": (_pil(_smooth(rng, 24, 40), progressive=True), "progressive"),
        "lossless": (_patched(base, b"\xff\xc0", b"\xff\xc3"), "lossless"),
        "arithmetic": (_patched(base, b"\xff\xc0", b"\xff\xc9"), "arithmetic"),
        "12-bit": (base[:sof + 4] + bytes([12]) + base[sof + 5:], "12-bit"),
        "cmyk": (cmyk.getvalue(), "CMYK"),
        "truncated": (base[:len(base) // 2], "truncated"),
        "not a jpeg": (png.encode_png(_smooth(rng, 4, 4)), "not a JPEG"),
    }


@pytest.mark.parametrize("name", ["progressive", "lossless", "arithmetic", "12-bit", "cmyk",
                                  "truncated", "not a jpeg"])
def test_unsupported_and_broken_streams_raise_naming_why(name):
    raw, words = _unsupported_cases()[name]
    with pytest.raises(ValueError, match=words):
        jpeg.decode_rgb(raw)


def test_threads_decode_at_once():
    raws = [_case(n) for n in ("repo:bigben", "repo:style_golden", "size:420-333x217",
                               "crafted:440-333x217")] * 2
    want = [jpeg.decode_rgb(r) for r in raws]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(jpeg.decode_rgb, raws))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_open_image_decodes_jpeg_files_without_pil(tmp_path, monkeypatch):
    import builtins

    path = REPO / "inference_images" / "style_golden.jpg"
    want_rgb = np.asarray(Image.open(path).convert("RGB"))
    want_l = np.asarray(Image.open(path).convert("L"))
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert np.array_equal(png.open_image(path, "RGB"), want_rgb)
    assert np.array_equal(png.open_image(path, "L"), want_l)
    gray = tmp_path / "gray.jpg"
    gray.write_bytes(_case("gray:17x9"))
    monkeypatch.setattr(builtins, "__import__", real_import)
    want_gray = np.asarray(Image.open(gray))
    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert np.array_equal(png.open_image(gray, "L"), want_gray)


def test_chip_smokes_digests_are_pils_decodes():
    assert set(chip_smoke.JPEG_DIGESTS) == {"beach", "bigben", "dalle2_museum", "style_golden"}
    for name, digest in chip_smoke.JPEG_DIGESTS.items():
        pixels = np.asarray(Image.open(REPO / "inference_images" / f"{name}.jpg").convert("RGB"))
        assert hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest() == digest
