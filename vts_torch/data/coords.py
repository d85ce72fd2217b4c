"""Analytic ROI propagation through the augmentation pipeline and the
8-field patch-coordinate codec — the port's copy of ``vts_tpu/data/coords.py``
(the parts the data pipeline and the gallery's box overlays use).

ROI = (x, y, h, w); the coordinate record is
``(ROI_x, ROI_y, ROI_h, ROI_w, patch_crop_size, resize_ratio, crop_pos_x,
crop_pos_y)`` (reference data/singleskit_dataset.py:843-864).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

N_COORD_FIELDS = 8


class ROI(NamedTuple):
    x: float
    y: float
    h: float
    w: float


def zoom_roi(roi: ROI, scale_h: float = 1.0, scale_w: float = 1.0) -> ROI:
    return ROI(roi.x * scale_w, roi.y * scale_h, roi.h * scale_h, roi.w * scale_w)


def crop_roi(roi: ROI, crop_size_h: float, crop_size_w: float, resize_ratio: float,
             crop_pos_x: float, crop_pos_y: float) -> Tuple[bool, ROI]:
    """Resize-then-crop; valid iff the ROI lies fully inside the crop."""
    x = roi.x * resize_ratio - crop_pos_x
    y = roi.y * resize_ratio - crop_pos_y
    h = roi.h * resize_ratio
    w = roi.w * resize_ratio
    valid = not (x < 0 or x + w > crop_size_w or y < 0 or y + h > crop_size_h)
    return valid, ROI(x, y, h, w)


def make_power_2_roi(roi: ROI, ratio_w: float, ratio_h: float) -> ROI:
    return ROI(roi.x * ratio_w, roi.y * ratio_h, roi.h * ratio_h, roi.w * ratio_w)


def pad_roi(roi: ROI, org_w: int = 1280, org_h: int = 960, padded_size: int = 1600) -> ROI:
    return ROI(roi.x + (padded_size - org_w) // 2, roi.y + (padded_size - org_h) // 2,
               roi.h, roi.w)


def crop_window(img_h: int, img_w: int, crop_h: int, crop_w: int, center_h: int = 0,
                center_w: int = 0, center_crop: bool = False,
                rng: np.random.Generator | None = None) -> Tuple[int, int]:
    """Crop origin (x, y); random origins keep the protected center inside."""
    assert img_w >= crop_w and img_h >= crop_h, "image smaller than crop size"
    assert crop_h >= center_h and crop_w >= center_w, "crop cannot cover center region"
    if center_crop:
        return (img_w - crop_w) // 2, (img_h - crop_h) // 2
    rng = rng or np.random.default_rng()
    if center_w > 0 or center_h > 0:
        buffer = min(max(0, (img_w - center_w) // 2), max(0, (img_h - center_h) // 2),
                     img_h - crop_h, img_w - crop_w)
        x = int(rng.integers(0, buffer + 1))
        y = int(rng.integers(0, buffer + 1))
    else:
        x = int(rng.integers(0, max(0, img_w - crop_w) + 1))
        y = int(rng.integers(0, max(0, img_h - crop_h) + 1))
    return x, y


def pack_patch_coords(roi: ROI, patch_crop_size: float, resize_ratio: float,
                      crop_pos_x: float, crop_pos_y: float) -> np.ndarray:
    return np.array([roi.x, roi.y, roi.h, roi.w, patch_crop_size, resize_ratio,
                     crop_pos_x, crop_pos_y], dtype=np.float32)


def patch_offsets(coords: np.ndarray, scale_multiplier: int = 1):
    """Packed coords (..., 8) → int32 (offset_x, offset_y, cutout) on the host,
    in float64 as the reference's: offset = (ROI origin + crop_pos /
    resize_ratio) · scale_multiplier, cutout = patch_crop_size / resize_ratio
    · scale_multiplier, each rounded half to even."""
    coords = np.asarray(coords, dtype=np.float64)
    rr = coords[..., 5]
    off_x = np.round((coords[..., 0] + coords[..., 6] / rr) * scale_multiplier).astype(np.int32)
    off_y = np.round((coords[..., 1] + coords[..., 7] / rr) * scale_multiplier).astype(np.int32)
    cutout = np.round(coords[..., 4] / rr * scale_multiplier).astype(np.int32)
    return off_x, off_y, cutout
