"""Host-side image transforms over uint8 numpy arrays (the port's copy of
``vts_tpu/data/transforms.py``).

Crops are array slices.  A LANCZOS resize — needed only for a zoom, or
when the crop or the make-power-of-2 step changes the size, which the
flagship test setup (1800² padded → 1536² center crop) never does — goes
through PIL, imported only then; without PIL it raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .coords import crop_window


def resize_lanczos(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("this preprocessing step resizes an image (LANCZOS) and "
                           "needs Pillow, which is not installed") from e
    return np.asarray(Image.fromarray(arr).resize((w, h), Image.LANCZOS))


def zoom_img(img: np.ndarray, scale_h: float = 1.0, scale_w: float = 1.0) -> np.ndarray:
    """Scale by (scale_h, scale_w), LANCZOS, sides rounded to the nearest pixel."""
    h, w = img.shape[:2]
    return resize_lanczos(img, int(round(w * scale_w)), int(round(h * scale_h)))


def crop_img(img: np.ndarray, crop_h: int, crop_w: int,
             resize_ratio: Optional[float] = None, crop_pos_x: Optional[int] = None,
             crop_pos_y: Optional[int] = None, center_w: int = 0, center_h: int = 0,
             center_crop: bool = False, rng: Optional[np.random.Generator] = None
             ) -> Tuple[np.ndarray, float, int, int]:
    """Resize-if-needed then crop; returns (img, resize_ratio, pos_x, pos_y)."""
    h, w = img.shape[:2]
    if resize_ratio is None:
        resize_ratio = 1.0 if (w >= crop_w and h >= crop_h) else max(crop_w / w, crop_h / h)
    if resize_ratio != 1.0:
        img = resize_lanczos(img, int(round(w * resize_ratio)), int(round(h * resize_ratio)))
    if crop_pos_x is None and crop_pos_y is None:
        crop_pos_x, crop_pos_y = crop_window(img.shape[0], img.shape[1], crop_h, crop_w,
                                             center_h=center_h, center_w=center_w,
                                             center_crop=center_crop, rng=rng)
    out = img[crop_pos_y:crop_pos_y + crop_h, crop_pos_x:crop_pos_x + crop_w]
    return out, resize_ratio, crop_pos_x, crop_pos_y


def make_power_2_img(img: np.ndarray, base: int):
    """Round both sides to a multiple of base; returns (img, ratio_w, ratio_h)."""
    h, w = img.shape[:2]
    nh = int(round(h / base) * base)
    nw = int(round(w / base) * base)
    if nh == h and nw == w:
        return img, 1.0, 1.0
    return resize_lanczos(img, nw, nh), nw / w, nh / h


def to_array(img: np.ndarray, normalize: bool = True) -> np.ndarray:
    """uint8 → float32 (H, W, C); normalize maps [0,255] → [-1,1]."""
    arr = np.asarray(img, dtype=np.float32).copy()
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if normalize:
        arr *= np.float32(2.0 / 255.0)
        arr -= np.float32(1.0)
    else:
        arr *= np.float32(1.0 / 255.0)
    return arr


def variance_of_laplacian(image: np.ndarray) -> float:
    """Variance of the 4-neighbour Laplacian over the interior — the
    resampling weight of a sketch patch (``vts_tpu/data/transforms.py``)."""
    img = np.asarray(image, np.float64)
    if img.ndim == 3:
        img = img[..., 0]
    lap = (-4.0 * img
           + np.roll(img, 1, 0) + np.roll(img, -1, 0)
           + np.roll(img, 1, 1) + np.roll(img, -1, 1))
    return float(lap[1:-1, 1:-1].var())
