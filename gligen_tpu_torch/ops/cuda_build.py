"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` (route: a plain C entry
point, bound with ``ctypes``) into
``build/kernels/<name>-<hash>/lib<name>.so`` at the repository root, where
``<hash>`` covers the source, the ``csrc/*.cuh`` headers it includes and
the compiler flags.  A library that
exists is reused.  Nothing is built when a module is imported, so the
package imports on a machine with no ``nvcc``; only a kernel launch needs
one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_CANDIDATES = ("nvcc", "/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in NVCC_CANDIDATES:
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at their first launch and "
        f"need the CUDA toolkit (looked for {', '.join(NVCC_CANDIDATES)})"
    )


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    transitively, in the order first reached."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> Path:
    """The library's path, keyed by the bytes of the source, of the headers
    it includes and of the compiler flags: a changed header rebuilds it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``ptxas.txt``."""
    lib = library_path(name)
    if not lib.exists():
        nvcc = find_nvcc()
        lib.parent.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        (lib.parent / "ptxas.txt").write_text(res.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
