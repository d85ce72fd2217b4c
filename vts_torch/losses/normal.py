"""Surface-normal angle error and its training losses
(``vts_tpu/losses/normal.py``)."""

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
    """The angle between the normals and the losses built on it, by ``mode``:
    ``evaluate``, per-pixel degrees; ``train_L2_loss``, 1 − mean cos;
    ``train_AL_loss``, the mean acos over pixels with |cos| < 0.999;
    ``train_TAL_loss``, acos where 0 < cos < 0.9999 and −cos where cos ≤ 0,
    averaged over both.  A mask that selects no pixel gives 0.  The
    gradients are the reference's, TAL's NaN where cos ≤ −1 included."""
    cos = cosine_similarity(pred_normal, real_normal)
    if mode == "evaluate":
        return torch.arccos(torch.clamp(cos, -1.0, 1.0)) * 180.0 / math.pi
    if mode == "train_L2_loss":
        return 1.0 - torch.mean(cos)
    zero = torch.zeros((), dtype=cos.dtype, device=cos.device)
    if mode == "train_AL_loss":
        safe = (cos < 0.999) & (cos > -0.999)
        acos = torch.arccos(torch.clamp(cos, -0.999, 0.999))
        return torch.sum(torch.where(safe, acos, zero)) / torch.clamp_min(safe.sum(), 1)
    if mode == "train_TAL_loss":
        acos_mask = (cos < 0.9999) & (cos > 0.0)
        cos_mask = cos <= 0.0
        # the clip passes the gradient through unmasked, as the reference's
        # does (its clip's gradient multiplies by a 0/1 mask), so a pixel
        # with cos ≤ −1 gets its NaN gradient (0 times acos' infinite slope)
        # as in the reference; the value is the clip's, exactly
        acos = torch.arccos(cos + (torch.clamp(cos, -1.0, 0.9999) - cos).detach())
        num = torch.sum(torch.where(acos_mask, acos, zero)) \
            - torch.sum(torch.where(cos_mask, cos, zero))
        return num / torch.clamp_min(acos_mask.sum() + cos_mask.sum(), 1)
    raise NotImplementedError(mode)
