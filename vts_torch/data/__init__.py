"""Dataset factory and batch loader (``vts_tpu/data/__init__.py``).

``create_dataset(opt)`` wraps the ``--dataset_mode`` dataset (``singleskit``,
one garment; ``skit``, several; ``patchskit``, one garment's touch squares
as paired patches, for pix2pix; the legacy ``single``, ``unaligned``,
``singleimage`` and ``template``, :mod:`vts_torch.data.legacy`) in a loader
that yields batch dicts of stacked numpy arrays (leading batch axis).  As in
the reference, training shuffles with a generator seeded by ``seed + epoch``
(``set_epoch``) and drops the last partial batch; the test loader
(``serial_batches``) goes in order and keeps it; ``--max_dataset_size`` caps
the samples an epoch visits.  Loading is single-process.  Dataset names are
looked up lowercased, as the reference's registry does.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from .legacy import LEGACY_DATASETS
from .patchskit import PatchSkitDataset
from .singleskit import SingleSkitDataset
from .skit import SkitDataset

DATASETS = {"singleskit": SingleSkitDataset, "skit": SkitDataset,
            "patchskit": PatchSkitDataset, **LEGACY_DATASETS}


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack sample dicts on a new leading batch axis (shared keys only)."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0) for k in keys}


class DataLoader:
    """Batch iterator over a map-style dataset: shuffled per epoch or in order."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, max_dataset_size: int = None):
        self.dataset = dataset
        self.n = min(len(dataset), max_dataset_size) if max_dataset_size else len(dataset)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = self.n
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield collate([self.dataset[int(j)] for j in idx])


def create_dataset(opt) -> DataLoader:
    name = opt.dataset_mode.lower()
    if name not in DATASETS:
        raise NotImplementedError(f"dataset_mode {opt.dataset_mode!r} is not ported yet")
    return DataLoader(DATASETS[name](opt), batch_size=int(opt.batch_size),
                      shuffle=not opt.serial_batches, drop_last=bool(opt.isTrain),
                      seed=int(opt.seed), max_dataset_size=opt.max_dataset_size)
