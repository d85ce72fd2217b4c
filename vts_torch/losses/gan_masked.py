"""Validity-masked GAN reductions for the fixed-K patch stacks
(``vts_tpu/losses/gan_masked.py``): the D-side masked mean over valid
patches and G2's masked patch sum."""

from __future__ import annotations

import torch
import torch.nn.functional as F

GAN_MODES = ("lsgan", "vanilla", "nonsaturating")


def _per_sample_single(pred: torch.Tensor, target_is_real: bool, mode: str,
                       real_label: float, fake_label: float) -> torch.Tensor:
    flat = pred.float().reshape(pred.shape[0], -1)
    if mode == "lsgan":
        t = real_label if target_is_real else fake_label
        return torch.mean((flat - t) ** 2, dim=1)
    if mode == "vanilla":
        t = real_label if target_is_real else fake_label
        return torch.mean(F.softplus(flat) - t * flat, dim=1)
    if mode == "nonsaturating":
        return torch.mean(F.softplus(-flat) if target_is_real else F.softplus(flat), dim=1)
    raise NotImplementedError(f"gan mode {mode!r} is not ported yet")


def per_sample_gan_loss(pred, target_is_real: bool, mode: str, real_label: float = 1.0,
                        fake_label: float = 0.0) -> torch.Tensor:
    """(N,) per-sample loss; multiscale predictions sum over scales."""
    if isinstance(pred, (list, tuple)):
        if len(pred) and isinstance(pred[0], (list, tuple)):
            total = 0.0
            for scale in pred:
                total = total + _per_sample_single(scale[-1], target_is_real, mode,
                                                   real_label, fake_label)
            return total
        pred = pred[-1]
    return _per_sample_single(pred, target_is_real, mode, real_label, fake_label)


def masked_mean(vec: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.sum(vec * valid) / torch.clamp_min(torch.sum(valid), 1.0)


def masked_patch_sum(vec: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.sum(vec * valid)
