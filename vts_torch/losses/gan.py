"""GAN objectives with the reference's reductions (``vts_tpu/losses/gan.py``).

  * lsgan / vanilla: a scalar (global mean);
  * nonsaturating: a per-sample vector (N,);
  * a multiscale prediction (list over scales of feature lists) gives the
    sum over scales of the per-scale losses of each last entry (the logits).

Both are reductions of :func:`vts_torch.losses.gan_masked.per_sample_gan_loss`:
every sample of a logit map has as many elements, so the global mean is the
mean of the per-sample means.  ``wgan``/``wgangp`` (and the gradient
penalty) and ``hinge`` are not ported yet and raise.
"""

from __future__ import annotations

import torch

from .gan_masked import per_sample_gan_loss


def gan_loss(pred, target_is_real: bool, mode: str, real_label: float = 1.0,
             fake_label: float = 0.0):
    """A scalar or an (N,) vector, by ``mode``; ``pred`` is a logit map, a
    feature list ending in one, or a multiscale list of those."""
    vec = per_sample_gan_loss(pred, target_is_real, mode, real_label, fake_label)
    return vec if mode == "nonsaturating" else torch.mean(vec)


def feature_matching_loss(pred_fake, pred_real, n_layers: int, num_d: int):
    """pix2pixHD feature matching: L1 over every intermediate feature,
    weighted 4/(n_layers+1) per layer and 1/num_D per scale; the real-side
    features are constants."""
    feat_w = 4.0 / (n_layers + 1)
    d_w = 1.0 / num_d
    total = 0.0
    for scale_fake, scale_real in zip(pred_fake, pred_real):
        for f, r in zip(scale_fake[:-1], scale_real[:-1]):
            total = total + d_w * feat_w * torch.mean(torch.abs(f.float() - r.detach().float()))
    return total


def gradient_penalty(*args, **kwargs):
    raise NotImplementedError("the WGAN-GP gradient penalty is not ported yet")
