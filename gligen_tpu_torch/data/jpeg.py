"""JPEG decode through the system's libjpeg (counterpart of
``gligen_tpu/data/jpeg.py``): ``native/jpeg_decode.cpp``, built by
``data/native.py`` at first use, with the accurate integer IDCT, the
default of PIL too, so both give the same pixels.

There is no fallback: where libjpeg (its header or its library) is
missing, ``decode_rgb`` raises an ``OSError`` that names it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from gligen_tpu_torch.data.native import build_library

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def jpeg_library() -> ctypes.CDLL:
    try:
        lib = build_library("jpeg_decode", ("-ljpeg", "-lpthread"))
    except OSError as e:
        raise OSError(f"JPEG decoding needs libjpeg (jpeglib.h and libjpeg.so) to build "
                      f"native/jpeg_decode.cpp: {e}") from e
    lib.jpeg_probe_dims.restype = ctypes.c_int32
    lib.jpeg_probe_dims.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I32P, _I32P]
    lib.jpeg_decode_to_rgb.restype = ctypes.c_int32
    lib.jpeg_decode_to_rgb.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8P, ctypes.c_int64,
                                       _I32P, _I32P]
    return lib


def decode_rgb(data: bytes) -> np.ndarray:
    """One JPEG -> (H, W, 3) uint8 (grayscale expanded to RGB).  Raises
    ``OSError`` without libjpeg and ``ValueError`` on a corrupt stream."""
    lib = jpeg_library()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.jpeg_probe_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)):
        raise ValueError("not a decodable JPEG header")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode_to_rgb(data, len(data), out.ctypes.data_as(_U8P), out.size,
                                ctypes.byref(w), ctypes.byref(h))
    if rc:
        raise ValueError(f"libjpeg failed to decode the stream (code {rc})")
    return out
