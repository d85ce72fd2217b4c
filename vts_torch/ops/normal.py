"""Surface normal from tactile gradients (``vts_tpu/ops/normal.py``); NHWC."""

from __future__ import annotations

import torch


def compute_normal(t: torch.Tensor, scale_nz: float = 0.0, eps: float = 1e-12) -> torch.Tensor:
    """t (..., H, W, 2) gx/gy → (..., H, W, 3) unit normal
    normalize([gx, gy, scale_nz]) with torch F.normalize's max(norm, eps)."""
    gx = t[..., 0:1]
    gy = t[..., 1:2]
    n = torch.cat([gx, gy, scale_nz * torch.ones_like(gx)], dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    return n / torch.clamp_min(norm, eps)
