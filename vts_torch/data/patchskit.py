"""Paired patch dataset of the pix2pix baseline (``vts_tpu/data/patchskit.py``).

One augmented view of the garment, :meth:`SingleSkitDataset.build_sample`
of index 0 (the same for every index), then every valid touch square of
that view becomes one item: the 32² windows of S, I and M at the square's
offsets (:func:`~vts_torch.data.coords.patch_offsets` of its coords), its
touch patch ``T_images`` (1, 32, 32, 2) and object mask ``I_masks`` (1, 32,
32, 1), ``T_valid`` = (1,), and the view's ``augmentation_params``; the
dataset holds as many items as valid squares.  With ``--return_patch``
false (the test phase, and the training run's full-image validation) every
item is the whole view, as the single-garment dataset gives it, and the
dataset holds ``--data_len`` of them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .coords import patch_offsets
from .singleskit import SingleSkitDataset


class PatchSkitDataset(SingleSkitDataset):

    def __init__(self, opt):
        self.return_patch = bool(getattr(opt, "return_patch", True))
        super().__init__(opt)
        self._full = super().build_sample(0)
        if self.return_patch:
            valid = self._full["T_valid"] > 0
            self._patches = self._extract_sim_patches(self._full, valid)
            self.data_len = int(valid.sum())

    @staticmethod
    def _extract_sim_patches(full: Dict[str, np.ndarray], valid) -> Dict[str, np.ndarray]:
        off_x, off_y, _ = patch_offsets(full["T_coords"][valid], 1)
        windows = [np.s_[oy:oy + 32, ox:ox + 32] for ox, oy in zip(off_x, off_y)]
        out = {k: np.stack([full[k][w] for w in windows]) for k in ("S", "I", "M")}
        out["T_images"] = full["T_images"][valid]
        out["I_masks"] = full["I_masks"][valid]
        return out

    def build_sample(self, index: int) -> Dict[str, np.ndarray]:
        return super().build_sample(0)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if not self.return_patch:
            return self._full
        p = self._patches
        return {"S": p["S"][index], "I": p["I"][index], "M": p["M"][index],
                "T_images": p["T_images"][index][None], "I_masks": p["I_masks"][index][None],
                "T_valid": np.ones((1,), np.float32),
                "augmentation_params": self._full["augmentation_params"]}
