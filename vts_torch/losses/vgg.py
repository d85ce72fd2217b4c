"""VGG19 perceptual loss, pix2pixHD's ``VGGLoss`` (``vts_tpu/losses/vgg.py``),
NHWC, differentiable in x.

The weighted feature L1 at relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1
(weights 1/32, 1/16, 1/8, 1/4, 1): :meth:`VGG19.taps` runs the first 13 of
VGG19's 16 3×3 convs, each + bias + ReLU, with a 2×2 VALID max-pool before
conv 2, 4, 8 and 12, and stops after relu5_1.  The inputs are used as they
come, in [-1, 1], with no ImageNet normalization (a pix2pixHD quirk the
reference keeps), and in fp32 whatever the training dtype.  The convs are
``F.conv2d`` (cuDNN on the card) on NCHW views of the NHWC activations, as
they are XLA convs in the reference; the pools are ``F.max_pool2d``.

The weights are frozen buffers: nothing asks for their gradient, so a
backward through the loss computes the input gradient only, and the y
branch runs under ``torch.no_grad()`` (it is a constant in the reference).

Weights: :func:`init_vgg19_params` makes the reference's seeded fallback
(numpy ``default_rng(seed)``, He-normal HWIO draws, zero biases) bit for
bit, transposed to torch's OIHW; :func:`load_vgg19_weights` reads a
torchvision ``vgg19`` state dict or module (``features.{0,2,5,…,34}``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (out_channels, max-pool before the conv) for the 16 convs of VGG19
_VGG19_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False), (256, False),
    (512, True), (512, False), (512, False), (512, False),
    (512, True), (512, False), (512, False), (512, False),
]
# the taps after the ReLU of these convs: relu1_1, relu2_1, relu3_1, relu4_1, relu5_1
_TAPS = (0, 2, 4, 8, 12)
_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
# torchvision's vgg19 ``features`` index of each conv
_TV_INDEX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


def init_vgg19_params(seed: int = 0) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """``{"conv": [{"w": (out, in, 3, 3), "b": (out,)}] * 16}``: the
    reference's draws, N(0, √(2/(9·in))) in HWIO, transposed to OIHW."""
    rng = np.random.default_rng(seed)
    convs, in_c = [], 3
    for out_c, _ in _VGG19_PLAN:
        w = rng.normal(0, np.sqrt(2.0 / (in_c * 9)), (3, 3, in_c, out_c)).astype(np.float32)
        convs.append({"w": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                      "b": torch.zeros(out_c)})
        in_c = out_c
    return {"conv": convs}


def load_vgg19_weights(path: str) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """A torchvision ``vgg19`` checkpoint (a state dict, or a pickled module,
    as the reference reads it) → the :func:`init_vgg19_params` layout."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {"conv": [{"w": sd[f"features.{i}.weight"].detach().float().clone(),
                      "b": sd[f"features.{i}.bias"].detach().float().clone()}
                     for i in _TV_INDEX]}


class VGG19(nn.Module):
    """The first 13 convs of VGG19 as frozen buffers ``w{i}``, ``b{i}``."""

    def __init__(self, params: Dict[str, List[Dict[str, torch.Tensor]]]):
        super().__init__()
        for i, p in enumerate(params["conv"][:max(_TAPS) + 1]):
            self.register_buffer(f"w{i}", p["w"].float().contiguous())
            self.register_buffer(f"b{i}", p["b"].float().contiguous())

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N, H, W, 3) → the five taps, NCHW views of channels-last memory."""
        h = x.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        taps = []
        for i, (_, pool) in enumerate(_VGG19_PLAN[:max(_TAPS) + 1]):
            if pool:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(F.conv2d(h, getattr(self, f"w{i}"), getattr(self, f"b{i}"), padding=1))
            if i in _TAPS:
                taps.append(h)
        return taps


def vgg_loss(vgg: VGG19, x: torch.Tensor, y: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Σ over the taps of weight · mean |φ(x) − φ(y)|, y a constant.  With
    ``groups`` g, x and y hold g equal batches stacked and the result is the
    sum of their g losses, from one pass of each."""
    fx = vgg.taps(x)
    with torch.no_grad():
        fy = vgg.taps(y)
    total = 0.0
    for w, a, b in zip(_WEIGHTS, fx, fy):
        d = torch.abs(a - b).permute(0, 2, 3, 1).reshape(groups, -1)
        total = total + w * torch.sum(torch.mean(d, dim=1))
    return total
