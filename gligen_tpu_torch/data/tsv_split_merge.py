"""Split a TSV into shards and merge shards back (counterpart of
``gligen_tpu/data/tsv_split_merge.py``, the reference's
tsv_split_merge.py), each written with its ``.lineidx`` in byte offsets.

  python -m gligen_tpu_torch.data.tsv_split_merge split big.tsv --rows-per-shard 1000 \\
      [--out-dir DIR]
  python -m gligen_tpu_torch.data.tsv_split_merge merge a-00000.tsv a-00001.tsv --out all.tsv
"""

from __future__ import annotations

import argparse
import os.path as op
from typing import List, Optional

from gligen_tpu_torch.data.tsv import TSVFile, TSVWriter


def shard_paths(base_tsv: str, num_shards: int) -> List[str]:
    stem, ext = op.splitext(base_tsv)
    return [f"{stem}-{i:05d}{ext}" for i in range(num_shards)]


def split_tsv(tsv_path: str, rows_per_shard: int, out_dir: Optional[str] = None) -> List[str]:
    """ceil(N / rows_per_shard) shards of the rows in order; their paths."""
    src = TSVFile(tsv_path)
    n = len(src)
    num_shards = (n + rows_per_shard - 1) // rows_per_shard
    base = tsv_path if out_dir is None else op.join(out_dir, op.basename(tsv_path))
    paths = shard_paths(base, num_shards)
    for si, path in enumerate(paths):
        writer = TSVWriter(path)
        for i in range(si * rows_per_shard, min((si + 1) * rows_per_shard, n)):
            writer.write(src[i])
        writer.close()
    return paths


def merge_tsv(shard_list: List[str], out_path: str) -> int:
    """The shards' rows in order as one TSV; the row count."""
    writer = TSVWriter(out_path)
    total = 0
    for path in shard_list:
        src = TSVFile(path)
        for i in range(len(src)):
            writer.write(src[i])
            total += 1
    writer.close()
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("split")
    sp.add_argument("tsv")
    sp.add_argument("--rows-per-shard", type=int, required=True)
    sp.add_argument("--out-dir", default=None)
    mp = sub.add_parser("merge")
    mp.add_argument("shards", nargs="+")
    mp.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "split":
        for path in split_tsv(args.tsv, args.rows_per_shard, args.out_dir):
            print(path)
    else:
        print(merge_tsv(args.shards, args.out))


if __name__ == "__main__":
    main()
