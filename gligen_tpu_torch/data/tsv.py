"""The TSV storage of the training data (counterpart of
``gligen_tpu/data/tsv.py``, the reference's dataset/tsv.py).

Random-access TSV with ``.lineidx`` byte offsets, optional ``.linelist``
row filtering and ``.chunks`` class-boundary filtering (tsv.py:40-188), the
matching ``TSVWriter`` (tsv.py:190-213), and the row payload codecs: a row
is a JSON object whose ``image`` is a base64 PNG or JPEG and whose boxes'
CLIP embeddings are base64 fp32 (tsv_dataset.py:22-40).

Images decode without PIL: a PNG through ``data/png.py``, a JPEG through
libjpeg (``data/jpeg.py``), to uint8 (H, W, 3).  ``encode_base64_image``
writes PNG, which PIL reads too.  Rows are read by the native reader
(``data/native.py``) where ``g++`` builds it, else by Python seeks.
"""

from __future__ import annotations

import base64
import json
import os
import os.path as op
import threading
from typing import List, Optional, Sequence

import numpy as np

from gligen_tpu_torch.data import png

EMBEDDING_KEYS = ("image_embedding_before", "text_embedding_before",
                  "image_embedding_after", "text_embedding_after")


def generate_lineidx(filein: str, idxout: str) -> None:
    """Byte offset of each line (tsv.py:15-24)."""
    tmp = idxout + ".tmp"
    with open(filein, "rb") as fin, open(tmp, "w") as fout:
        fsize = os.fstat(fin.fileno()).st_size
        fpos = 0
        while fpos != fsize:
            fout.write(f"{fpos}\n")
            fin.readline()
            fpos = fin.tell()
    os.rename(tmp, idxout)


class TSVFile:
    """Seekable TSV (tsv.py:40-188)."""

    def __init__(
        self,
        tsv_file: str,
        if_generate_lineidx: bool = False,
        lineidx: Optional[str] = None,
        class_selector: Optional[List[str]] = None,
    ):
        self.tsv_file = tsv_file
        self.lineidx = lineidx or op.splitext(tsv_file)[0] + ".lineidx"
        self.linelist = op.splitext(tsv_file)[0] + ".linelist"
        self.chunks = op.splitext(tsv_file)[0] + ".chunks"
        self._class_selector = class_selector
        self._fp = None
        self._lineidx: Optional[np.ndarray] = None
        self._sample_indices: Optional[np.ndarray] = None
        self._class_boundaries = None
        self.pid: Optional[int] = None
        self._native = None
        self._native_tried = False
        # a thread pool's workers share this file: one at a time opens the
        # native reader or seeks the Python one
        self._lock = threading.Lock()
        if not op.isfile(self.lineidx) and if_generate_lineidx:
            generate_lineidx(self.tsv_file, self.lineidx)

    def _ensure_lineidx_loaded(self):
        if self._lineidx is not None:
            return
        with open(self.lineidx) as f:
            self._lineidx = np.array([int(l) for l in f if l.strip()], dtype=np.int64)

        linelist = None
        if op.isfile(self.linelist):
            with open(self.linelist) as f:
                linelist = sorted({int(l) for l in f if l.strip()})

        if op.isfile(self.chunks):
            sample_indices: List[int] = []
            boundaries = []
            with open(self.chunks) as f:
                class_boundaries = json.load(f)
            selector = set(self._class_selector or [])
            lset = set(linelist) if linelist else None
            for class_name, (lo, hi) in class_boundaries.items():
                start = len(sample_indices)
                if class_name in selector:
                    for idx in range(lo, hi + 1):
                        if lset is not None and idx not in lset:
                            continue
                        sample_indices.append(idx)
                boundaries.append((start, len(sample_indices)))
            self._sample_indices = np.asarray(sample_indices, dtype=np.int64)
            self._class_boundaries = boundaries
        elif linelist:
            self._sample_indices = np.asarray(linelist, dtype=np.int64)
        else:
            self._sample_indices = np.arange(len(self._lineidx), dtype=np.int64)

    def get_class_boundaries(self):
        self._ensure_lineidx_loaded()
        return self._class_boundaries

    def num_rows(self) -> int:
        self._ensure_lineidx_loaded()
        return len(self._sample_indices)

    def _ensure_native(self):
        with self._lock:
            if not self._native_tried:
                try:
                    from gligen_tpu_torch.data.native import NativeTSV

                    self._native = NativeTSV(self.tsv_file, self.lineidx)
                except OSError:
                    self._native = None  # no g++: the Python reader gives the same rows
                self._native_tried = True
        return self._native

    def seek(self, idx: int) -> List[str]:
        self._ensure_lineidx_loaded()
        row = int(self._sample_indices[idx])
        native = self._ensure_native()
        if native is not None:  # pread: no shared file position
            line = native.read_row(row).decode("utf-8")
            return [s.strip() for s in line.split("\t")]
        with self._lock:
            if self._fp is None or self.pid != os.getpid():
                # per-PID reopen: forked decode workers must not share file
                # positions (tsv.py:176-188)
                self._fp = open(self.tsv_file, "rb")
                self.pid = os.getpid()
            self._fp.seek(int(self._lineidx[row]))
            line = self._fp.readline().decode("utf-8")
        return [s.strip() for s in line.split("\t")]

    def __getitem__(self, index: int) -> List[str]:
        return self.seek(index)

    def __len__(self) -> int:
        return self.num_rows()


class TSVWriter:
    """tsv.py:190-213: atomic TSV + lineidx writing.  The offsets count the
    UTF-8 bytes of each row; the JAX package's writer (and the
    reference's) count characters, which misplaces every row after a
    non-ASCII one (ROADMAP fault F6; rows of ``json.dumps`` are ASCII, so
    the training TSVs come out the same)."""

    def __init__(self, tsv_file: str):
        self.tsv_file = tsv_file
        self.lineidx_file = op.splitext(tsv_file)[0] + ".lineidx"
        self._tsv_tmp = tsv_file + ".tmp"
        self._idx_tmp = self.lineidx_file + ".tmp"
        self.tsv_fp = open(self._tsv_tmp, "w", encoding="utf-8")
        self.idx_fp = open(self._idx_tmp, "w")
        self.idx = 0

    def write(self, values: Sequence, sep: str = "\t"):
        v = sep.join(map(str, values)) + "\n"
        self.tsv_fp.write(v)
        self.idx_fp.write(f"{self.idx}\n")
        self.idx += len(v.encode("utf-8"))

    def close(self):
        self.tsv_fp.close()
        self.idx_fp.close()
        os.rename(self._tsv_tmp, self.tsv_file)
        os.rename(self._idx_tmp, self.lineidx_file)


def decode_base64_image(image_b64: str) -> np.ndarray:
    """A base64 PNG or JPEG -> uint8 (H, W, 3); any other payload raises."""
    raw = base64.b64decode(image_b64)
    if raw[:8] == png.SIGNATURE:
        return png.convert(*png.decode_png(raw, "the row's image"), "RGB")
    if raw[:2] == b"\xff\xd8":
        from gligen_tpu_torch.data.jpeg import decode_rgb

        return decode_rgb(raw)
    raise ValueError(f"image payload is neither PNG nor JPEG (starts {raw[:8]!r})")


def decode_base64_fp32(arr_str: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(arr_str), dtype=np.float32).copy()


def encode_base64_fp32(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr, dtype=np.float32).tobytes()).decode()


def encode_base64_image(pixels: np.ndarray) -> str:
    """uint8 (H, W, 3) pixels as a base64 PNG."""
    return base64.b64encode(png.encode_png(pixels)).decode()


def decode_item(item_json: str) -> dict:
    """One grounding-TSV row -> dict with a uint8 image + numpy embeddings."""
    item = json.loads(item_json)
    item["image"] = decode_base64_image(item["image"])
    for anno in item.get("annos", []):
        for key in EMBEDDING_KEYS:
            if key in anno:
                anno[key] = decode_base64_fp32(anno[key])
    return item
