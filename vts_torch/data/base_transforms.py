"""The CycleGAN-heritage preprocess chains (``vts_tpu/data/base_transforms.py``)
of the legacy datasets: PIL images in, float32 HWC arrays out.

``get_params(opt, size, rng)`` draws what paired images share (the crop
corner, the flip, the zoom factor); ``apply_transform(opt, img, params)``
runs the ``--preprocess`` chain: ``resize`` (to ``--load_size``²) or
``scale_width`` (to ``--load_size`` wide, at least ``--crop_size`` high),
then ``zoom`` (by the drawn factor), ``crop`` (``--crop_size``² at the drawn
corner, centred without params), make-power-2 (to multiples of 4, under
``none`` or a chain naming ``power``) and the flip (unless ``--no_flip``).
The draws come from a ``numpy.random.Generator`` in the reference's order,
so a seed gives the reference's samples exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from .transforms import to_array

BICUBIC = Image.BICUBIC


def get_params(opt, size: Tuple[int, int],
               rng: Optional[np.random.Generator] = None) -> Dict:
    """The random parameters of one image of (width, height) ``size``."""
    rng = rng or np.random.default_rng()
    w, h = size
    new_h, new_w = h, w
    if opt.preprocess == "resize_and_crop":
        new_h = new_w = opt.load_size
    elif opt.preprocess == "scale_width_and_crop":
        new_w = opt.load_size
        new_h = opt.load_size * h // w
    x = int(rng.integers(0, max(0, new_w - opt.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - opt.crop_size) + 1))
    flip = bool(rng.uniform() > 0.5)
    return {"crop_pos": (x, y), "flip": flip,
            "scale_factor": float(rng.uniform(1.0 / getattr(opt, "random_scale_max", 3.0), 1.0))}


def _make_power_2(img, base, method=BICUBIC):
    ow, oh = img.size
    h = int(round(oh / base) * base)
    w = int(round(ow / base) * base)
    if h == oh and w == ow:
        return img
    return img.resize((w, h), method)


def _scale_width(img, target, crop, method=BICUBIC):
    ow, oh = img.size
    if ow == target and oh >= crop:
        return img
    return img.resize((target, int(max(target * oh / ow, crop))), method)


def apply_transform(opt, img: Image.Image, params: Optional[Dict] = None,
                    grayscale: bool = False, method=BICUBIC,
                    normalize: bool = True) -> np.ndarray:
    """``opt.preprocess``'s chain on ``img`` → HWC float32, in [-1, 1] when
    ``normalize``."""
    if grayscale and img.mode != "L":
        img = img.convert("L")
    p = opt.preprocess
    if "resize" in p:
        img = img.resize((opt.load_size, opt.load_size), method)
    elif "scale_width" in p:
        img = _scale_width(img, opt.load_size, opt.crop_size, method)
    if "zoom" in p and params is not None:
        sf = params["scale_factor"]
        img = img.resize((int(round(img.size[0] * sf)), int(round(img.size[1] * sf))), method)
    if "crop" in p:
        if params is None:
            x = max(0, (img.size[0] - opt.crop_size) // 2)
            y = max(0, (img.size[1] - opt.crop_size) // 2)
        else:
            x, y = params["crop_pos"]
        img = img.crop((x, y, x + opt.crop_size, y + opt.crop_size))
    if p == "none" or "power" in p:
        img = _make_power_2(img, base=4, method=method)
    if not getattr(opt, "no_flip", True) and params is not None and params["flip"]:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return to_array(img, normalize=normalize)
