"""A PNG reader and writer on the standard library (zlib, struct) and numpy.

The port reads the repository's PNG inputs (``inference_images/*.png``:
8-bit RGB or grayscale) and writes its generated images without PIL, which
the GPU machine lacks.  What it takes, and what raises (naming PIL, for a
caller that has it):

  * reading: 8-bit samples, no interlace, colour types 0 (L), 2 (RGB),
    3 (palette, at 1, 2, 4 or 8 bits an index, read as the RGB of its PLTE
    entries, which is what PIL's ``convert`` to "RGB" or "L" works from)
    and 6 (RGBA), every scanline filter (None, Sub, Up, Average, Paeth);
    other ancillary chunks are skipped, CRCs checked;
  * ``convert`` to "RGB" or "L" as PIL's ``Image.convert`` does: L -> RGB
    by replication, RGBA -> RGB by dropping alpha, RGB (or RGBA) -> L as
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16, PIL's ITU-R 601-2 luma in
    16-bit fixed point;
  * writing: uint8 (H, W, 3) RGB or (H, W) L, filter None, zlib level 6;
  * both to and from bytes in memory (``decode_png``, ``encode_png``): the
    training TSVs carry images as base64 payloads.

``open_image`` reads JPEG files through the port's own decoder
(``data/jpeg.py``); only a file that is neither PNG nor JPEG goes to PIL,
imported there, so that call raises where PIL is missing.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

from gligen_tpu_torch.data.transforms import to_luma

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}  # colour type -> samples a pixel
MODES = {0: "L", 2: "RGB", 3: "RGB", 6: "RGBA"}


def _unsupported(what: str) -> ValueError:
    return ValueError(f"png: {what} is not supported here; read the file with PIL")


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("png: not a PNG file (bad signature)")
    i = 8
    while i + 12 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind, payload = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"png: bad CRC in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        i += 12 + n
    raise ValueError("png: truncated file (no IEND)")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """The (h, w * bpp) samples from the filtered scanlines."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"png: image data is {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per sample lane, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint64)
            cur = (cur % 256).astype(np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before it
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"png: unknown filter type {kind} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _palette(palette, idx: np.ndarray, what: str) -> np.ndarray:
    if palette is None or int(idx.max(initial=0)) >= len(palette):
        raise ValueError(f"png: {what} has a palette index past its PLTE")
    return palette[idx]


def decode_png(data: bytes, what: str = "the PNG") -> Tuple[np.ndarray, str]:
    """(pixels, mode) of PNG bytes: uint8 (H, W) for "L", (H, W, 3) for
    "RGB", (H, W, 4) for "RGBA"."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"png: {what} is not a PNG")
    header, idat, palette = None, [], None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
    if header is None:
        raise ValueError(f"png: {what} has no IHDR")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour == 3 and depth in (1, 2, 4) and not (compression or filtering or interlace):
        # packed palette indices: unfilter the packed bytes, then unpack
        packed = _unfilter(zlib.decompress(b"".join(idat)), h, -(-w * depth // 8), 1)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        idx = ((packed[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        return _palette(palette, idx, what), "RGB"
    if depth != 8 or colour not in CHANNELS or compression or filtering or interlace:
        raise _unsupported(f"{what}: bit depth {depth}, colour type {colour}, interlace "
                           f"{interlace}")
    bpp = CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    if colour == 3:
        return _palette(palette, pixels, what), "RGB"
    shape = (h, w) if bpp == 1 else (h, w, bpp)
    return pixels.reshape(shape), MODES[colour]


def read_png(path) -> Tuple[np.ndarray, str]:
    """``decode_png`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), os.fspath(path))


def convert(pixels: np.ndarray, mode: str, to: str) -> np.ndarray:
    """``pixels`` in ``mode`` ("L", "RGB", "RGBA") as ``to`` ("L" or "RGB"),
    as PIL's ``convert``."""
    if to not in ("L", "RGB") or mode not in MODES.values():
        raise _unsupported(f"converting {mode} to {to}")
    if mode == to:
        return pixels
    if to == "RGB":
        return np.repeat(pixels[..., None], 3, axis=-1) if mode == "L" else pixels[..., :3].copy()
    return to_luma(pixels[..., :3])


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) L pixels as PNG bytes."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or not (pixels.ndim == 2 or (pixels.ndim == 3
                                                             and pixels.shape[2] == 3)):
        raise _unsupported(f"writing {pixels.dtype} {pixels.shape} (only uint8 RGB or L)")
    h, w = pixels.shape[:2]
    colour = 0 if pixels.ndim == 2 else 2
    rows = np.ascontiguousarray(pixels).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path, pixels: np.ndarray) -> None:
    """Write uint8 (H, W, 3) RGB or (H, W) L pixels as a PNG."""
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)


# magic bytes of formats neither decoder here reads, to name them in an error
OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                 (b"\x00\x00\x01\x00", "ICO"))
JPEG_SOI = b"\xff\xd8"


def decode_image(data: bytes, mode: str, what: str = "the image") -> np.ndarray:
    """PNG or JPEG bytes (``data/jpeg.py``) as uint8 pixels in ``mode``
    ("RGB" or "L"), as PIL's ``Image.open(...).convert(mode)`` gives them;
    another format raises ``ValueError`` naming it."""
    if data[:8] == SIGNATURE:
        return convert(*decode_png(data, what), mode)
    if data[:2] == JPEG_SOI:
        from gligen_tpu_torch.data import jpeg

        return convert(*jpeg.decode(data), mode)
    name = "WebP" if data[:4] == b"RIFF" and data[8:12] == b"WEBP" else next(
        (n for magic, n in OTHER_FORMATS if data.startswith(magic)), "an unknown format")
    raise ValueError(f"{what}: {name} is not supported (PNG or baseline JPEG)")


def open_image(path, mode: str) -> np.ndarray:
    """The image at ``path`` as uint8 pixels in ``mode`` ("RGB" or "L"): a
    PNG or a JPEG through ``decode_image`` (a file either does not read
    raises), anything else through PIL (imported here)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == SIGNATURE or data[:2] == JPEG_SOI:
        return decode_image(data, mode, os.fspath(path))
    from PIL import Image

    return np.asarray(Image.open(os.fspath(path)).convert(mode), np.uint8)
