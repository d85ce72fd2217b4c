"""Dataset factory and batch loader (``vts_tpu/data/__init__.py``).

``create_dataset(opt)`` wraps the ``--dataset_mode`` dataset in a loader
that yields batch dicts of stacked numpy arrays (leading batch axis), in
order: the serial, single-process, batch-1 loading of ``vts_torch.test``.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from .singleskit import SingleSkitDataset

DATASETS = {"singleskit": SingleSkitDataset}


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack sample dicts on a new leading batch axis (shared keys only)."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0) for k in keys}


class DataLoader:
    """In-order batch iterator over a map-style dataset."""

    def __init__(self, dataset, batch_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        for i in range(0, n, self.batch_size):
            yield collate([self.dataset[j] for j in range(i, min(i + self.batch_size, n))])


def create_dataset(opt) -> DataLoader:
    if opt.dataset_mode not in DATASETS:
        raise NotImplementedError(f"dataset_mode {opt.dataset_mode!r} is not ported yet")
    return DataLoader(DATASETS[opt.dataset_mode](opt))
