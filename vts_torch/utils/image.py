"""Array → image utilities, NHWC: the port's copy of ``vts_tpu/utils/image.py``
(numpy and PIL only).

``tensor2im`` maps a [-1, 1] float array to uint8 RGB; single-channel inputs
are tiled to gray RGB."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def tensor2im(arr) -> np.ndarray:
    """(N,H,W,C)|(H,W,C)|(H,W) float in [-1,1] → (H,W,3) uint8."""
    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 2:
        a = a[:, :, None]
    if a.dtype in (np.uint8,):
        return a
    a = (np.clip(a.astype(np.float64), -1, 1) + 1) / 2.0 * 255.0
    if a.shape[-1] == 1:
        a = np.tile(a, (1, 1, 3))
    return a.astype(np.uint8)


def save_image(image_numpy: np.ndarray, image_path: str) -> None:
    os.makedirs(os.path.dirname(image_path) or ".", exist_ok=True)
    Image.fromarray(image_numpy).save(image_path)
