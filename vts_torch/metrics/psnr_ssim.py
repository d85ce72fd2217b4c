"""PSNR / SSIM over NHWC tensors in [0, 1] (``vts_tpu/metrics/psnr_ssim.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Global-mean PSNR over the whole batch (torchmetrics default)."""
    mse = torch.mean((x.float() - y.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM with a gaussian window over the valid region."""
    x = x.float()
    y = y.float()
    c = x.shape[-1]
    k1d = _gaussian_kernel1d(kernel_size, sigma)
    k2d = np.outer(k1d, k1d)
    kernel = torch.from_numpy(np.tile(k2d[None, None], (c, 1, 1, 1))).to(x.device)

    def filt(img):
        return F.conv2d(img.permute(0, 3, 1, 2), kernel, groups=c).permute(0, 2, 3, 1)

    mu_x = filt(x)
    mu_y = filt(y)
    mu_xx = filt(x * x)
    mu_yy = filt(y * y)
    mu_xy = filt(x * y)
    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov = mu_xy - mu_x * mu_y
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)
    return torch.mean(num / den)
