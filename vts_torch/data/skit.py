"""Multi-garment SKIT dataset (``vts_tpu/data/skit.py``), the skitG data.

One :class:`~vts_torch.data.singleskit.SingleSkitDataset` per material of
``--material_list`` (``synthA`` and ``synthB`` for a ``synthetic://``
dataroot when the list is empty).  Item ``index`` is material ``index % n``,
its sample ``index // n`` (round-robin), so a run holds ``data_len × n``
items.  A material's dataroot is ``<dataroot_prefix><material>
<dataroot_suffix>`` beside ``--dataroot``, or for ``synthetic://`` the
dataroot with its garment name replaced by the material's.

Each item also carries ``material_index`` (int32) and ``style_image``, the
style encoder's input: the next image of ``--style_image_dir`` when it
holds any, else the garment's own visual image as uint8 (``((I·0.5 + 0.5)
·255)``, truncated); either resized to ``--style_image_size``² by PIL's
``Image.resize`` at its default resampling, then mapped to [-1, 1].  An
edited sketch's item (no I) without ``--style_image_dir`` has no
``style_image``, as in the reference.  Under ``--cache_dir`` each garment
keeps its disk cache in ``<cache_dir>/<material>`` (the reference puts all
in one directory under one key, where the garments' samples collide).  For
the same reason an item's ``sample_idx``, the key of the model's
per-sample caches, is its own ``index`` here, where the reference's is the
garment's sample index, which every garment numbers from 0.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List

import numpy as np

from .npz import list_images
from .singleskit import SingleSkitDataset
from .transforms import to_array

SYNTHETIC_MATERIALS = ("synthA", "synthB")


class SkitDataset:

    def __init__(self, opt):
        self.opt = opt
        synthetic = opt.dataroot.startswith("synthetic://")
        materials = [m for m in opt.material_list.split(",") if m]
        if not materials and synthetic:
            materials = list(SYNTHETIC_MATERIALS)
        if not materials:
            raise ValueError("the skit dataset needs --material_list")
        self.materials = materials
        self.datasets: List[SingleSkitDataset] = []
        base = os.path.dirname(opt.dataroot.rstrip("/"))
        for m in materials:
            sub_opt = copy.copy(opt)
            if synthetic:
                netloc = opt.dataroot.split("//")[1].split("?")[0]
                sub_opt.dataroot = (opt.dataroot.replace(netloc, m, 1) if "?" in opt.dataroot
                                    else f"synthetic://{m}?size=1800")
            else:
                sub_opt.dataroot = os.path.join(
                    base, f"{opt.dataroot_prefix}{m}{opt.dataroot_suffix}")
            if getattr(opt, "cache_dir", ""):
                # a garment's own directory: the reference's sample key
                # names no garment, so one --cache_dir would serve every
                # garment the first one's samples
                sub_opt.cache_dir = os.path.join(opt.cache_dir, m)
            self.datasets.append(SingleSkitDataset(sub_opt))
        self.data_len = int(opt.data_len) * len(materials)
        style_dir = opt.style_image_dir
        self.style_paths = list_images(style_dir) if style_dir and os.path.isdir(style_dir) \
            else []

    @property
    def name(self) -> str:
        return "+".join(self.materials)

    def __len__(self) -> int:
        return self.data_len

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image
        n = len(self.materials)
        mat, inner = index % n, index // n
        sample = dict(self.datasets[mat][inner % len(self.datasets[mat])])
        sample["material_index"] = np.int32(mat)
        sample["sample_idx"] = np.int64(index)
        size = int(self.opt.style_image_size)
        if self.style_paths:
            img = Image.open(self.style_paths[index % len(self.style_paths)]).convert("RGB")
        elif "I" in sample:
            img = Image.fromarray(((sample["I"] * 0.5 + 0.5) * 255).astype(np.uint8).squeeze())
        else:                                   # an edited sketch: no style source
            return sample
        sample["style_image"] = to_array(img.resize((size, size)), normalize=True)
        return sample
