"""The C++ host readers of the data path, built with ``g++`` at first use
and bound with ``ctypes`` (counterpart of ``gligen_tpu/data/native.py``).

``native/tsv_reader.cpp`` reads TSV rows by their ``.lineidx`` offsets
with ``pread`` (no shared file position, so one handle serves every thread
and forked worker); ``gligen_tpu_torch/csrc/jpeg_baseline.cpp``
(``data/jpeg.py``) decodes baseline JPEG with no library behind it.  Each
source is compiled into ``build/native/<name>-<hash>/lib<name>.so`` at the
repository root, keyed by the source's bytes and the flags; the ``.so``
files committed under ``native/`` are not loaded.  Nothing is built when
the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

REPO = Path(__file__).resolve().parents[2]
NATIVE_SRC = REPO / "native"
CSRC = REPO / "gligen_tpu_torch" / "csrc"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str, libs: Sequence[str] = (), src_dir: Path = NATIVE_SRC) -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    digest.update((src_dir / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


@functools.lru_cache(maxsize=None)
def build_library(name: str, libs: Sequence[str] = (), src_dir: Path = NATIVE_SRC) -> ctypes.CDLL:
    """Compile ``<src_dir>/<name>.cpp`` (linked with ``libs``) if its
    library is missing, then load it.  Raises ``OSError`` with the
    compiler's message when there is no ``g++`` or the build fails."""
    lib = library_path(name, libs, src_dir)
    src = src_dir / f"{name}.cpp"
    if not lib.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise OSError(f"g++ not found: {src.name} is built at first use")
        lib.parent.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: concurrent builds
        # (forked decode workers, test processes) never load a partial file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, str(src), "-o", tmp, *libs],
                capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise OSError(f"g++ failed on {src}:\n{proc.stderr.strip()}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def tsv_library() -> ctypes.CDLL:
    lib = build_library("tsv_reader")
    lib.tsv_open.restype = ctypes.c_void_p
    lib.tsv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tsv_num_rows.restype = ctypes.c_int64
    lib.tsv_num_rows.argtypes = [ctypes.c_void_p]
    lib.tsv_row_size.restype = ctypes.c_int64
    lib.tsv_row_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tsv_read_row.restype = ctypes.c_int64
    lib.tsv_read_row.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.tsv_close.restype = None
    lib.tsv_close.argtypes = [ctypes.c_void_p]
    lib.tsv_generate_lineidx.restype = ctypes.c_int64
    lib.tsv_generate_lineidx.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    return lib


class NativeTSV:
    """A TSV opened by the native reader; raises ``OSError`` when the
    library cannot be built or the files cannot be opened."""

    def __init__(self, tsv_path: str, lineidx_path: str):
        self._h = None
        self._lib = tsv_library()
        self._h = self._lib.tsv_open(tsv_path.encode(), lineidx_path.encode())
        if not self._h:
            raise OSError(f"tsv_open failed for {tsv_path}")

    def __len__(self) -> int:
        return self._lib.tsv_num_rows(self._h)

    def read_row(self, idx: int) -> bytes:
        """Row ``idx``'s bytes, its newline included.  Each call reads into
        a buffer of its own: the call releases the GIL, and a thread pool's
        workers read rows at once."""
        size = self._lib.tsv_row_size(self._h, idx)
        if size < 0:
            raise IndexError(idx)
        buf = ctypes.create_string_buffer(int(size))
        n = self._lib.tsv_read_row(self._h, idx, buf, size)
        if n < 0:
            raise OSError(f"tsv_read_row({idx}) failed")
        return buf.raw[:n]

    def close(self) -> None:
        if self._h:
            self._lib.tsv_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def generate_lineidx_native(tsv_path: str, idx_path: str) -> int:
    """The ``.lineidx`` of ``tsv_path`` by the native reader: its row count."""
    n = tsv_library().tsv_generate_lineidx(tsv_path.encode(), idx_path.encode())
    if n < 0:
        raise OSError(f"tsv_generate_lineidx failed for {tsv_path}")
    return int(n)
