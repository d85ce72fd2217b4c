"""Surface-normal angle error (``vts_tpu/losses/normal.py``, mode
``evaluate`` — the metric; the training modes come with the training port)."""

from __future__ import annotations

import math

import torch


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Channel-axis cosine over NHWC normals, each norm clamped at eps."""
    dot = torch.sum(a * b, dim=-1)
    na = torch.clamp_min(torch.sqrt(torch.sum(a * a, dim=-1)), eps)
    nb = torch.clamp_min(torch.sqrt(torch.sum(b * b, dim=-1)), eps)
    return dot / (na * nb)


def surface_normal_angle_error(real_normal: torch.Tensor, pred_normal: torch.Tensor,
                               mode: str = "evaluate") -> torch.Tensor:
    """Per-pixel angle between the normals, in degrees."""
    if mode != "evaluate":
        raise NotImplementedError(f"angle-error mode {mode!r} is not ported yet")
    cos = torch.clamp(cosine_similarity(pred_normal, real_normal), -1.0, 1.0)
    return torch.arccos(cos) * 180.0 / math.pi
