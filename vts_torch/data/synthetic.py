"""Procedural synthetic garments, built in memory.

The port's copy of ``vts_tpu/data/synthetic.py``: the same generator math
from the same seeds, and the same uint8 quantization, ``(clip(a, 0, 1)·255)
.astype(uint8)``, that the reference's PNG round trip gives — but the
images stay numpy arrays (no PIL, no files) and the touch records stay
:class:`TouchRecord` objects with the dtypes a ``.npz`` round trip gives.

``synthetic://<name>?size=P&patches=N&val_patches=V&center_w=..&center_h=..
&mult=1&seed=..`` names a garment exactly as the reference does;
:func:`save_garment` writes one to disk in the reference's layout, for the
on-disk dataroots of the launcher and the edited sketches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import urllib.parse
from typing import Dict, List, Tuple

import numpy as np

from .npz import TouchRecord, make_touch_record, save_touch_npz


@dataclasses.dataclass
class Garment:
    name: str
    padded_size: int
    sketch: np.ndarray          # (P, P) uint8
    image: np.ndarray           # (P, P, 3) uint8
    mask: np.ndarray            # (P, P) uint8
    records: Dict[str, List[TouchRecord]]   # trainT / valT / testT
    mult: int = 1


def _height_field(h: int, w: int, rng: np.random.Generator, n_waves: int = 6,
                  max_freq: float = 0.25) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    field = np.zeros((h, w), np.float32)
    for _ in range(n_waves):
        fx, fy = rng.uniform(0.02, max_freq, size=2)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.3, 1.0)
        field += amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
    field /= np.abs(field).max() + 1e-8
    return field


def _garment_mask(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    r = np.sqrt((xx / 0.85) ** 2 + (yy / 0.8) ** 2)
    ang = np.arctan2(yy, xx)
    wobble = sum(rng.uniform(0.02, 0.08) * np.cos(k * ang + rng.uniform(0, 2 * np.pi))
                 for k in range(2, 6))
    return (r < 0.9 + wobble).astype(np.float32)


def _quantize(arr: np.ndarray) -> np.ndarray:
    a8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return a8[..., 0] if a8.ndim == 3 and a8.shape[-1] == 1 else a8


def generate_garment(name: str, padded_size: int = 1800, center_w: int = 1280,
                     center_h: int = 960, n_train_patches: int = 12,
                     n_val_patches: int = 4, roi_hw: Tuple[int, int] = (192, 256),
                     mult: int = 1, seed: int = 0) -> Garment:
    rng = np.random.default_rng(seed)
    mask_c = _garment_mask(center_h, center_w, rng)
    height = _height_field(center_h * mult, center_w * mult, rng,
                           max_freq=0.25 / (2 * mult) if mult > 1 else 0.25)
    height_v = height[::mult, ::mult] if mult > 1 else height

    base_rgb = rng.uniform(0.25, 0.85, size=3).astype(np.float32)
    shade = 0.5 + 0.35 * height_v
    visual_c = (shade[..., None] * base_rgb[None, None, :]) * mask_c[..., None] \
        + (1.0 - mask_c[..., None])

    gy_v, gx_v = np.gradient(height_v)
    edge = (np.abs(gx_v) + np.abs(gy_v)) > np.percentile(np.abs(gx_v) + np.abs(gy_v), 92)
    mgy, mgx = np.gradient(mask_c)
    boundary = (np.abs(mgx) + np.abs(mgy)) > 0
    sketch_c = 1.0 - np.clip(edge * mask_c + boundary * 3.0, 0, 1) * 0.9

    pad_y = (padded_size - center_h) // 2
    pad_x = (padded_size - center_w) // 2

    def pad(img, fill):
        out = np.full((padded_size, padded_size) + img.shape[2:], fill, np.float32)
        out[pad_y:pad_y + center_h, pad_x:pad_x + center_w] = img
        return out

    roi_h = max(40, min(roi_hw[0], int(center_h * 0.45)))
    roi_w = max(40, min(roi_hw[1], int(center_w * 0.45)))
    gy_t, gx_t = np.gradient(height)
    scale = 1.0 / (np.abs(gx_t).max() + 1e-8)

    def touch_records(count, rng):
        out = []
        attempts = 0
        while len(out) < count and attempts < count * 50:
            attempts += 1
            x = int(rng.integers(0, center_w - roi_w))
            y = int(rng.integers(0, center_h - roi_h))
            if mask_c[y:y + roi_h, x:x + roi_w].mean() < 0.7:
                continue
            yt, xt = y * mult, x * mult
            gx_roi = (gx_t[yt:yt + roi_h * mult, xt:xt + roi_w * mult] * scale).astype(np.float32)
            gy_roi = (gy_t[yt:yt + roi_h * mult, xt:xt + roi_w * mult] * scale).astype(np.float32)
            hh, ww = gx_roi.shape
            yy, xx = np.meshgrid(np.linspace(-1, 1, hh), np.linspace(-1, 1, ww), indexing="ij")
            contact = ((np.abs(xx) ** 4 + np.abs(yy) ** 4) < 0.55).astype(np.float32)
            center = ((np.abs(xx) ** 4 + np.abs(yy) ** 4) < 0.18).astype(np.float32)
            out.append(make_touch_record(gx_roi, gy_roi, x, y, roi_h, roi_w, contact, center))
        assert len(out) == count, f"could not place {count} ROIs inside the garment"
        return out

    records = {
        "trainT": touch_records(n_train_patches, np.random.default_rng(seed + 1)),
        "valT": touch_records(n_val_patches, np.random.default_rng(seed + 2)),
        "testT": touch_records(max(2, n_val_patches), np.random.default_rng(seed + 3)),
    }
    return Garment(name=name, padded_size=padded_size,
                   sketch=_quantize(pad(sketch_c, 1.0)),
                   image=_quantize(pad(visual_c, 1.0)),
                   mask=_quantize(pad(mask_c, 0.0)),
                   records=records, mult=mult)


def save_garment(g: Garment, out_dir: str) -> str:
    """Write ``g`` as the reference writes a synthetic garment, an on-disk
    dataroot ``<out_dir>/singleskit_<name>_padded_<P>_x<mult>`` (S, I and M
    PNGs of both phases, the touch records of trainT, valT and testT), and
    return its path."""
    from PIL import Image
    root = os.path.join(out_dir, f"singleskit_{g.name}_padded_{g.padded_size}_x{g.mult}")
    for phase in ("train", "test"):
        for sub, kind, arr in (("S", "sketch", g.sketch), ("I", "image", g.image),
                               ("M", "mask", g.mask)):
            os.makedirs(os.path.join(root, phase + sub), exist_ok=True)
            Image.fromarray(arr).save(os.path.join(root, phase + sub, f"{g.name}_{kind}.png"))
    for sub, recs in g.records.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, rec in enumerate(recs):
            save_touch_npz(os.path.join(root, sub, f"{g.name}_{sub}_{i:03d}_tactile.npz"), rec)
    return root


def materialize_synthetic(uri: str, opt=None) -> Garment:
    """Resolve a ``synthetic://`` dataroot to an in-memory :class:`Garment`."""
    parsed = urllib.parse.urlparse(uri)
    name = parsed.netloc or "default"
    q = dict(urllib.parse.parse_qsl(parsed.query))
    seed = int(q.get("seed", int(hashlib.md5(name.encode()).hexdigest()[:6], 16)))
    mult = int(q.get("mult", getattr(opt, "T_resolution_multiplier", 1) if opt else 1))
    return generate_garment(
        name,
        padded_size=int(q.get("size", 1800)),
        center_w=int(q.get("center_w", getattr(opt, "center_w", 1280) if opt else 1280)),
        center_h=int(q.get("center_h", getattr(opt, "center_h", 960) if opt else 960)),
        n_train_patches=int(q.get("patches", 12)),
        n_val_patches=int(q.get("val_patches", 4)),
        mult=mult,
        seed=seed,
    )
