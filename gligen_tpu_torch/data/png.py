"""A PNG reader and writer on the standard library (zlib, struct) and numpy.

The port reads the repository's PNG inputs (``inference_images/*.png``:
8-bit RGB or grayscale) and writes its generated images without PIL, which
the GPU machine lacks.  What it takes, and what raises (naming PIL, for a
caller that has it):

  * reading: 8-bit samples, no interlace, colour types 0 (L), 2 (RGB) and
    6 (RGBA), every scanline filter (None, Sub, Up, Average, Paeth);
    ancillary chunks are skipped, CRCs checked;
  * ``convert`` to "RGB" or "L" as PIL's ``Image.convert`` does: L -> RGB
    by replication, RGBA -> RGB by dropping alpha, RGB (or RGBA) -> L as
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16, PIL's ITU-R 601-2 luma in
    16-bit fixed point;
  * writing: uint8 (H, W, 3) RGB or (H, W) L, filter None, zlib level 6.

JPEG, any other PNG, and any resize go through PIL, imported where they
are used (``open_image``), so those calls raise where PIL is missing.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel
MODES = {0: "L", 2: "RGB", 6: "RGBA"}


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


def read_png(path) -> Tuple[np.ndarray, str]:
    """(pixels, mode) of the PNG at ``path``: uint8 (H, W) for "L", (H, W, 3)
    for "RGB", (H, W, 4) for "RGBA"."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"png: {path} has no IHDR")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in CHANNELS or compression or filtering or interlace:
        raise _unsupported(f"{path}: bit depth {depth}, colour type {colour}, interlace "
                           f"{interlace}")
    bpp = CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    shape = (h, w) if bpp == 1 else (h, w, bpp)
    return pixels.reshape(shape), MODES[colour]


def convert(pixels: np.ndarray, mode: str, to: str) -> np.ndarray:
    """``pixels`` in ``mode`` ("L", "RGB", "RGBA") as ``to`` ("L" or "RGB"),
    as PIL's ``convert``."""
    if to not in ("L", "RGB") or mode not in MODES.values():
        raise _unsupported(f"converting {mode} to {to}")
    if mode == to:
        return pixels
    if to == "RGB":
        return np.repeat(pixels[..., None], 3, axis=-1) if mode == "L" else pixels[..., :3].copy()
    rgb = pixels[..., :3].astype(np.uint32)
    luma = (19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000) >> 16
    return luma.astype(np.uint8)


def write_png(path, pixels: np.ndarray) -> None:
    """Write uint8 (H, W, 3) RGB or (H, W) L pixels as a PNG."""
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

    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def open_image(path, mode: str) -> np.ndarray:
    """The image at ``path`` as uint8 pixels in ``mode`` ("RGB" or "L"): a
    PNG through this module (one it does not read raises), anything else
    through PIL (imported here)."""
    with open(path, "rb") as f:
        if f.read(8) == SIGNATURE:
            return convert(*read_png(path), mode)
    from PIL import Image

    return np.asarray(Image.open(os.fspath(path)).convert(mode), np.uint8)
