"""Fréchet distance between Gaussians fitted to feature samples — host numpy /
scipy, the port's own copy of ``vts_tpu/metrics/frechet.py`` (Dougal
Sutherland's stable form, reference models/sifid.py:102-153)."""

from __future__ import annotations

import numpy as np
from scipy import linalg


def _sqrtm(a: np.ndarray) -> np.ndarray:
    # scipy deprecates sqrtm's ``disp`` flag; the matrix result is the same
    return linalg.sqrtm(a)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def gaussian_stats(features: np.ndarray):
    """features (num_samples, dim) → (mu, sigma), sigma with np.cov's n − 1."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma
