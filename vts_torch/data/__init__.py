"""Dataset factory and batch loader (``vts_tpu/data/__init__.py``).

``create_dataset(opt)`` wraps the ``--dataset_mode`` dataset (``singleskit``,
one garment; ``skit``, several; ``patchskit``, one garment's touch squares
as paired patches, for pix2pix; the legacy ``single``, ``unaligned``,
``singleimage`` and ``template``, :mod:`vts_torch.data.legacy`) in a loader
that yields batch dicts of stacked numpy arrays (leading batch axis).  As in
the reference, training shuffles with a generator seeded by ``seed + epoch``
(``set_epoch``) and drops the last partial batch; the test loader
(``serial_batches``) goes in order and keeps it; ``--max_dataset_size`` caps
the samples an epoch visits.  Dataset names are looked up lowercased, as
the reference's registry does.

``--num_threads`` n > 0 builds the batches in a pool of n host threads with
at most max(2, 2·n) batches in flight ahead of the consumer (the
reference's bounded submit-ahead window); the batches come out in the same
order and with the same bits whatever n is, since every sample is drawn
from a generator seeded per (seed, index).  ``--cache_data_device`` keeps
each sample on the device after its first visit, keyed per sample (not per
batch), so that a shuffled batch above 1 stays bounded by the dataset and
a batch that changes size (``--anneal_set batch_size=...``) is assembled
from the cache with no new upload; its numeric arrays are then tensors on
the device (``sample_idx`` stays a host array, as the model reads it).
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device
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
    """Batch iterator over a map-style dataset: shuffled per epoch or in order,
    built by ``num_workers`` threads, optionally cached per sample on
    ``device``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, max_dataset_size: int = None,
                 num_workers: int = 0, cache_on_device: bool = False, device=None):
        self.dataset = dataset
        self.n = min(len(dataset), max_dataset_size) if max_dataset_size else len(dataset)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = int(num_workers)
        self.device = torch.device(device or "cpu")
        # --cache_data_device: sample index → its arrays on the device
        self.dev_cache = {} if cache_on_device else None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = self.n
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _on_device(self, index: int) -> Dict:
        """Sample ``index`` as a batch of one on the device (cached)."""
        if index not in self.dev_cache:
            one = collate([self.dataset[index]])
            self.dev_cache[index] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                if k != "sample_idx" and v.dtype.kind in "fiub" else v
                for k, v in one.items()}
        return self.dev_cache[index]

    def _fetch(self, idx) -> Dict:
        """The batch of the sample indices ``idx``."""
        if self.dev_cache is None:
            return collate([self.dataset[int(j)] for j in idx])
        per = [self._on_device(int(j)) for j in idx]
        if len(per) == 1:
            return dict(per[0])
        return {k: torch.cat([p[k] for p in per]) if torch.is_tensor(per[0][k])
                else np.concatenate([p[k] for p in per]) for k in per[0]}

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers <= 0:
            for b in batches:
                yield self._fetch(b)
            return
        window = max(2, 2 * self.num_workers)
        with futures.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight = collections.deque()
            it = iter(batches)
            for b in it:
                inflight.append(pool.submit(self._fetch, b))
                if len(inflight) >= window:
                    break
            for b in it:
                yield inflight.popleft().result()
                inflight.append(pool.submit(self._fetch, b))
            while inflight:
                yield inflight.popleft().result()


def create_dataset(opt) -> DataLoader:
    name = opt.dataset_mode.lower()
    if name not in DATASETS:
        raise NotImplementedError(f"dataset_mode {opt.dataset_mode!r} is not ported yet")
    cache = bool(getattr(opt, "cache_data_device", False))
    return DataLoader(DATASETS[name](opt), batch_size=int(opt.batch_size),
                      shuffle=not opt.serial_batches, drop_last=bool(opt.isTrain),
                      seed=int(opt.seed), max_dataset_size=opt.max_dataset_size,
                      num_workers=int(getattr(opt, "num_threads", 0)), cache_on_device=cache,
                      device=resolve_device(opt.device) if cache else None)
