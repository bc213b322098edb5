"""ConCatDataset (counterpart of ``gligen_tpu/data/concat.py``, the
reference's dataset/concat_dataset.py:8-60): merges catalog datasets with
integer repeat factors via offset maps."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from gligen_tpu_torch.data import catalog  # noqa: F401  (registers every dataset)
from gligen_tpu_torch.utils.registry import DATASETS


class ConCatDataset:
    def __init__(self, datasets: Sequence, repeats: Optional[Sequence[int]] = None):
        repeats = list(repeats or [1] * len(datasets))
        if len(repeats) != len(datasets):
            raise ValueError(f"{len(repeats)} repeats for {len(datasets)} datasets")
        self.datasets = list(datasets)
        self._index: List[tuple] = []
        for ds_idx, (ds, rep) in enumerate(zip(self.datasets, repeats)):
            for _ in range(rep):
                self._index.extend((ds_idx, i) for i in range(len(ds)))

    @classmethod
    def from_catalog(cls, dataset_names: Dict[str, Dict], catalog: Dict[str, Dict], **common):
        """Build from config train_dataset_names + the DatasetCatalog
        (trainer.py:274, catalog.py)."""
        datasets, repeats = [], []
        for name, params in dataset_names.items():
            entry = dict(catalog[name])
            train_params = dict(entry.get("train_params", {}))
            params = dict(params or {})
            repeats.append(int(params.pop("which_layer_repeat", params.pop("repeat", 1))))
            train_params.update(params)
            train_params.update(common)
            datasets.append(DATASETS.get(entry["target"])(**train_params))
        return cls(datasets, repeats)

    def reseed(self, seed: int) -> None:
        """Re-draw every member dataset's augmentation RNG: forked decode
        workers must not share RNG state."""
        for i, ds in enumerate(self.datasets):
            if hasattr(ds, "reseed"):
                ds.reseed(seed + i)
            elif hasattr(ds, "rng"):
                ds.rng = np.random.default_rng(seed + i)

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int):
        ds_idx, inner = self._index[idx]
        return self.datasets[ds_idx][inner]
