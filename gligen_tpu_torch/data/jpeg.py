"""Baseline JPEG decoding with no library behind it (the port's counterpart
of ``gligen_tpu/data/jpeg.py``, which links libjpeg).

``csrc/jpeg_baseline.cpp``, built by ``data/native.py`` at first use with
``g++`` and linked with nothing, decodes SOF0/SOF1 streams of one or three
components to the pixels libjpeg-turbo gives PIL (the accurate integer
IDCT, fancy upsampling, the same YCbCr tables), bit for bit.  A stream it
does not take (progressive, lossless, arithmetic-coded, 12-bit, CMYK/YCCK)
or a corrupt or truncated one raises ``ValueError`` naming why; there is
no fallback to another decoder.  Each call owns its decoder and releases
the GIL, so thread pools and forked workers decode at once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from gligen_tpu_torch.data.native import CSRC, build_library

SOURCE = CSRC / "jpeg_baseline.cpp"
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_ERR_LEN = 256


@functools.lru_cache(maxsize=None)
def jpeg_library() -> ctypes.CDLL:
    lib = build_library("jpeg_baseline", (), CSRC)
    lib.jpeg_baseline_info.restype = ctypes.c_int32
    lib.jpeg_baseline_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I32P, ctypes.c_char_p,
                                       ctypes.c_int32]
    lib.jpeg_baseline_decode.restype = ctypes.c_int32
    lib.jpeg_baseline_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8P, ctypes.c_int64,
                                         ctypes.c_char_p, ctypes.c_int32]
    return lib


def decode(data: bytes) -> Tuple[np.ndarray, str]:
    """(pixels, mode) of one JPEG: uint8 (H, W) "L" for one component,
    (H, W, 3) "RGB" for three.  Raises ``ValueError`` on a stream the
    decoder does not take."""
    lib = jpeg_library()
    data = bytes(data)
    info = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_baseline_info(data, len(data), info, err, _ERR_LEN):
        raise ValueError(f"jpeg: {err.value.decode()}")
    w, h, c = info
    out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
    if lib.jpeg_baseline_decode(data, len(data), out.ctypes.data_as(_U8P), out.size, err,
                                _ERR_LEN):
        raise ValueError(f"jpeg: {err.value.decode()}")
    return out, "L" if c == 1 else "RGB"


def decode_rgb(data: bytes) -> np.ndarray:
    """One JPEG -> (H, W, 3) uint8, a grayscale one replicated to RGB (as
    PIL's ``convert("RGB")``)."""
    pixels, mode = decode(data)
    return np.repeat(pixels[..., None], 3, axis=-1) if mode == "L" else pixels
