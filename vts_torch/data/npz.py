"""GelSight touch-record io (the port's copy of ``vts_tpu/data/npz.py``):
one ``.npz`` per touch with gx_raw/gy_raw, the ROI rectangle
(vision_mask_x/y/h/w) and the contact / contact-center masks."""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class TouchRecord:
    gx: np.ndarray
    gy: np.ndarray
    roi_x: float
    roi_y: float
    roi_h: float
    roi_w: float
    touch_mask: Optional[np.ndarray]
    touch_center_mask: Optional[np.ndarray]
    path: str = ""


def _unit_mask(m) -> np.ndarray:
    m = np.asarray(m, np.float32)
    return m / 255.0 if m.max() > 1 else m


def make_touch_record(gx, gy, roi_x, roi_y, roi_h, roi_w, touch_mask,
                      touch_center_mask, path: str = "") -> TouchRecord:
    """A record with the same dtypes a ``.npz`` round trip gives."""
    return TouchRecord(gx=np.asarray(gx, np.float32), gy=np.asarray(gy, np.float32),
                       roi_x=float(roi_x), roi_y=float(roi_y), roi_h=float(roi_h),
                       roi_w=float(roi_w), touch_mask=_unit_mask(touch_mask),
                       touch_center_mask=_unit_mask(touch_center_mask), path=path)


def load_touch_npz(path: str) -> TouchRecord:
    data = np.load(path)
    for key in ("touch_thresh", "touch_center_thresh"):
        if key not in data.files:
            raise KeyError(f"{key} not found in {path}")
    return make_touch_record(data["gx_raw"], data["gy_raw"], data["vision_mask_x"],
                             data["vision_mask_y"], data["vision_mask_h"],
                             data["vision_mask_w"], data["touch_thresh"],
                             data["touch_center_thresh"], path)


def save_touch_npz(path: str, rec: TouchRecord) -> None:
    """Write ``rec`` in the on-disk format :func:`load_touch_npz` reads."""
    np.savez(path, gx_raw=rec.gx, gy_raw=rec.gy, vision_mask_x=rec.roi_x,
             vision_mask_y=rec.roi_y, vision_mask_h=rec.roi_h, vision_mask_w=rec.roi_w,
             touch_thresh=rec.touch_mask, touch_center_thresh=rec.touch_center_mask)


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff", ".webp")


def list_images(directory: str) -> List[str]:
    out = []
    for root, _, files in sorted(os.walk(directory)):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(root, f))
    return out


def list_touch_npz(directory: str) -> List[str]:
    return sorted(glob.glob(os.path.join(directory, "**", "*.npz"), recursive=True))
