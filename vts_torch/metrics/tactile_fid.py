"""Tactile-patch FID (``vts_tpu/metrics/tactile_fid.py``, reference
models/tactile_patch_fid.py:12-154): every 3×3 window of a 2-channel patch
is a feature row, and the Fréchet distance is taken between the Gaussians
of the real and the fake rows.  Host numpy in float64; off the default
metric list (``"T_FID"`` in ``eval_metrics`` under ``--eval_mode legacy``)."""

from __future__ import annotations

import numpy as np

from .frechet import frechet_distance, gaussian_stats


def im2col_3x3(patch: np.ndarray) -> np.ndarray:
    """(H, W, C) → (windows, C·9) rows, channel-major within a row (the
    reference's channel-first take order)."""
    h, w, c = patch.shape
    im = np.transpose(patch, (2, 0, 1))
    cols = [im[ci, dy:dy + h - 2, dx:dx + w - 2].reshape(-1)
            for ci in range(c) for dy in range(3) for dx in range(3)]
    return np.stack(cols, axis=1)


def tactile_patch_fid(real: np.ndarray, fake: np.ndarray, reduction: str = "none") -> float:
    """real, fake: (N, H, W, C) patch stacks.  ``none``: one Gaussian over the
    windows of all patches on each side; ``mean``: the FID of each (real,
    fake) pair, averaged."""
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    if reduction == "none":
        f1 = np.concatenate([im2col_3x3(p) for p in real], axis=0)
        f2 = np.concatenate([im2col_3x3(p) for p in fake], axis=0)
        return frechet_distance(*gaussian_stats(f1), *gaussian_stats(f2))
    if reduction == "mean":
        if len(real) != len(fake):
            raise ValueError(f"{len(real)} real patches against {len(fake)} fake ones")
        return float(np.mean([frechet_distance(*gaussian_stats(im2col_3x3(r)),
                                               *gaussian_stats(im2col_3x3(f)))
                              for r, f in zip(real, fake)]))
    raise NotImplementedError(reduction)
