"""Patch collages and bounding-box overlays for the HTML galleries: the port's
copy of ``vts_tpu/utils/collage.py`` (numpy only).  ``patch_collage`` tiles a
patch stack into one grid image; ``bbox_overlay`` draws the sampled-patch
rectangles (red = train, green = val) onto a generated image."""

from __future__ import annotations

import numpy as np

from .image import tensor2im


def draw_rect(img: np.ndarray, x0: int, y0: int, w: int, h: int, color) -> np.ndarray:
    """In-place 2-pixel rectangle outline on an (H, W, 3) uint8 image."""
    hh, ww = img.shape[:2]
    x0c, y0c = max(0, x0), max(0, y0)
    x1, y1 = min(ww, x0 + w), min(hh, y0 + h)
    c = np.asarray(color, img.dtype)
    t = 2
    img[y0c:min(y0c + t, hh), x0c:x1] = c
    img[max(0, y1 - t):y1, x0c:x1] = c
    img[y0c:y1, x0c:min(x0c + t, ww)] = c
    img[y0c:y1, max(0, x1 - t):x1] = c
    return img


def bbox_overlay(image, offsets_x, offsets_y, sizes, color) -> np.ndarray:
    """Generated image + rectangles at patch locations (the ``{phase}_I_bb`` /
    ``{phase}_gx_bb`` visuals)."""
    img = tensor2im(image).copy()
    sizes = np.broadcast_to(np.asarray(sizes), np.asarray(offsets_x).shape)
    for x, y, s in zip(np.asarray(offsets_x), np.asarray(offsets_y), sizes):
        draw_rect(img, int(x), int(y), int(s), int(s), color)
    return img


def patch_collage(patches: np.ndarray) -> np.ndarray:
    """(K, h, w, C) patch stack → one tiled uint8 image: a ceil(√K)-wide grid
    on white with 2-pixel gaps."""
    p = np.asarray(patches)
    pad, pad_value = 2, 255
    if p.size == 0:
        return np.full((8, 8, 3), pad_value, np.uint8)
    k = p.shape[0]
    cols = int(np.ceil(np.sqrt(k)))
    rows = int(np.ceil(k / cols))
    tiles = [tensor2im(p[i]) for i in range(k)]
    h, w = tiles[0].shape[:2]
    out = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3),
                  pad_value, np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, cols)
        out[r * (h + pad): r * (h + pad) + h, c * (w + pad): c * (w + pad) + w] = tile
    return out
