"""The legacy CycleGAN-heritage datasets (``vts_tpu/data/legacy.py``):
``single`` (one image directory, domain A), ``unaligned`` (``<phase>A`` and
``<phase>B``, B drawn at random unless ``--serial_batches``),
``singleimage`` (one image a domain, each item a random view of it, an epoch
of ``--data_len`` items) and ``template`` (the example to start a dataset
from; ``--new_dataset_option`` is its flag).  Their samples hold ``A``
(``B``, or ``data_A``/``data_B``), not a sketch, so no model of the port
trains or tests on them, as in the reference (its models fail reading
``S`` at setup; the port refuses at model creation); they serve the library
and :func:`vts_torch.data.create_dataset`.  Each draws from a
``numpy.random.Generator`` seeded by ``--seed`` in the reference's order,
so a seed gives the reference's samples exactly.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from PIL import Image

from .base_transforms import apply_transform, get_params
from .npz import list_images


def _images(directory: str, max_size=None) -> List[str]:
    paths = list_images(directory)
    return paths[:max_size] if max_size else paths


class _LegacyBase:
    def __len__(self):
        return self._len

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class SingleDataset(_LegacyBase):
    """The images under ``--dataroot``: ``{"A", "A_paths_idx"}``."""

    def __init__(self, opt):
        self.opt = opt
        self.paths = _images(opt.dataroot, getattr(opt, "max_dataset_size", None))
        if not self.paths:
            raise ValueError(f"no images under {opt.dataroot}")
        self._len = len(self.paths)
        self.rng = np.random.default_rng(getattr(opt, "seed", 0))

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        img = Image.open(self.paths[index % len(self.paths)]).convert("RGB")
        params = get_params(self.opt, img.size, self.rng)
        return {"A": apply_transform(self.opt, img, params), "A_paths_idx": np.int32(index)}


class UnalignedDataset(_LegacyBase):
    """``<dataroot>/<phase>A`` and ``<phase>B``, unpaired: ``{"A", "B"}``."""

    def __init__(self, opt):
        self.opt = opt
        phase = getattr(opt, "phase", "train")
        self.A_paths = _images(os.path.join(opt.dataroot, phase + "A"))
        self.B_paths = _images(os.path.join(opt.dataroot, phase + "B"))
        if not (self.A_paths and self.B_paths):
            raise ValueError(f"unaligned needs images under {opt.dataroot}/{phase}A and "
                             f"{phase}B")
        self._len = max(len(self.A_paths), len(self.B_paths))
        self.rng = np.random.default_rng(getattr(opt, "seed", 0))

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        a_path = self.A_paths[index % len(self.A_paths)]
        if getattr(self.opt, "serial_batches", False):
            b_path = self.B_paths[index % len(self.B_paths)]
        else:
            b_path = self.B_paths[int(self.rng.integers(0, len(self.B_paths)))]
        a = Image.open(a_path).convert("RGB")
        b = Image.open(b_path).convert("RGB")
        pa = get_params(self.opt, a.size, self.rng)
        pb = get_params(self.opt, b.size, self.rng)
        return {"A": apply_transform(self.opt, a, pa), "B": apply_transform(self.opt, b, pb)}


class SingleImageDataset(_LegacyBase):
    """The one image of ``<dataroot>/<phase>A`` (and of ``<phase>B`` when
    present), a random view each item: ``{"A"[, "B"]}``."""

    def __init__(self, opt):
        self.opt = opt
        phase = getattr(opt, "phase", "train")
        a = _images(os.path.join(opt.dataroot, phase + "A"))
        b_dir = os.path.join(opt.dataroot, phase + "B")
        b = _images(b_dir) if os.path.isdir(b_dir) else []
        if len(a) != 1:
            raise ValueError(f"singleimage expects exactly one A image, found {len(a)}")
        self.A_img = Image.open(a[0]).convert("RGB")
        self.B_img = Image.open(b[0]).convert("RGB") if b else None
        self._len = int(getattr(opt, "data_len", 1000))
        self.rng = np.random.default_rng(getattr(opt, "seed", 0))

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        pa = get_params(self.opt, self.A_img.size, self.rng)
        out = {"A": apply_transform(self.opt, self.A_img, pa)}
        if self.B_img is not None:
            pb = get_params(self.opt, self.B_img.size, self.rng)
            out["B"] = apply_transform(self.opt, self.B_img, pb)
        return out


class TemplateDataset(_LegacyBase):
    """The images under ``--dataroot`` (one blank ``--crop_size``² item when
    there are none): ``{"data_A", "data_B"}``, B a copy of A."""

    def __init__(self, opt):
        self.opt = opt
        self.paths = list_images(opt.dataroot) if os.path.isdir(opt.dataroot) else []
        self._len = max(len(self.paths), 1)
        self.rng = np.random.default_rng(getattr(opt, "seed", 0))

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        if self.paths:
            img = Image.open(self.paths[index % len(self.paths)]).convert("RGB")
            data = apply_transform(self.opt, img, get_params(self.opt, img.size, self.rng))
        else:
            data = np.zeros((self.opt.crop_size, self.opt.crop_size, 3), np.float32)
        return {"data_A": data, "data_B": data.copy()}


LEGACY_DATASETS = {"single": SingleDataset, "unaligned": UnalignedDataset,
                   "singleimage": SingleImageDataset, "template": TemplateDataset}
