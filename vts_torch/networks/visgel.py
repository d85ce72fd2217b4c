"""VisGel image→touch generator — ``--netG visgel`` and ``define_G2('VisGel')``
(``vts_tpu/networks/visgel.py``), NHWC in and out.

  ``ResNetI32Encoder``: a 3×3 stem (16), instance norm, ReLU (the stem skip);
                        three stages of five ``BasicBlock``s at 16, 32 and 64
                        channels, the first block of the last two at stride 2;
  ``BasicBlock``:       3×3 conv (stride s), IN, ReLU, 3×3 conv, IN, plus the
                        input (through a 1×1 stride-s conv and IN when the
                        stride or the width changes), ReLU; no conv bias;
  ``VisGelGenerator``:  the encoder; bilinear ×2, 3×3 conv 64, IN, ReLU,
                        twice (``conv_00``, ``conv_01``); with ``src_skip`` the
                        stem skip tiled to the conv's width (``jnp.tile``'s
                        order: the whole block repeated) and concatenated;
                        log2(``t_resolution_multiplier``) more bilinear ×2 +
                        conv + IN + ReLU stages (``conv_up{i}``, halving the
                        width down to 16); a 3×3 ``head`` to ``out_nc``, tanh.

The widths are fixed whatever ``--ngf`` is, the norms are instance norms
whatever ``--normG`` is, and the convs run in fp32 whatever the compute
dtype, as the reference's (its flax convs take no dtype).  The bilinear ×2 is
``F.interpolate(bilinear, align_corners=False)``: ``jax.image.resize``'s
"linear" drops the taps outside the image and renormalises, which at a 2×
upsample gives the edge pixel weight 1, as torch's clamped source
coordinate does.  Submodules carry the flax names (``encoder.stem``,
``encoder.s{stage}b{block}.{conv1,conv2,down}``, ``conv_00``, ``conv_01``,
``conv_up{i}``, ``head``), so a state-dict key is the flax tree path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv, InstanceNorm, _to_nchw, _to_nhwc, make_initializer


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, (n, *size, c), "linear")`` of NHWC ``x`` to a
    size no smaller than its own (the decoder's maps are never smaller than
    the stem skip, so it never shrinks: jax would antialias there)."""
    return _to_nhwc(F.interpolate(_to_nchw(x), size=tuple(size), mode="bilinear",
                                  align_corners=False))


def up2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 of NHWC ``x``."""
    return resize_linear(x, (x.shape[1] * 2, x.shape[2] * 2))


class BasicBlock(nn.Module):
    def __init__(self, in_c: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_c, features, 3, False, stride=stride, padding=1)
        self.conv2 = Conv(features, features, 3, False, padding=1)
        self.down = (Conv(in_c, features, 1, False, stride=stride)
                     if stride != 1 or in_c != features else None)
        self.norm = InstanceNorm()

    def forward(self, x):
        h = torch.relu(self.norm(self.conv1(x)))
        h = self.norm(self.conv2(h))
        if self.down is not None:
            x = self.norm(self.down(x))
        return torch.relu(h + x)


class ResNetI32Encoder(nn.Module):
    """3-stage CIFAR ResNet → (features at /4, stem skip)."""

    def __init__(self, in_nc: int, inplanes: int = 16, blocks_per_stage: int = 5):
        super().__init__()
        self.stem = Conv(in_nc, inplanes, 3, False, padding=1)
        self.norm = InstanceNorm()
        self.blocks = []
        c = inplanes
        for stage, (feats, stride) in enumerate(((16, 1), (32, 2), (64, 2))):
            for b in range(blocks_per_stage):
                self.add_module(f"s{stage}b{b}", BasicBlock(c, feats, stride if b == 0 else 1))
                self.blocks.append(f"s{stage}b{b}")
                c = feats

    def forward(self, x):
        h = torch.relu(self.norm(self.stem(x)))
        skip = h
        for name in self.blocks:
            h = getattr(self, name)(h)
        return h, skip


class VisGelGenerator(nn.Module):
    """32² input → tactile patch at 32·``t_resolution_multiplier``²."""

    def __init__(self, in_nc: int, out_nc: int = 2, t_resolution_multiplier: int = 2,
                 src_skip: bool = True, init_type: str = "normal", init_gain: float = 0.02):
        super().__init__()
        self.init_type, self.init_gain = init_type, init_gain
        self.src_skip = src_skip
        self.encoder = ResNetI32Encoder(in_nc)
        width = 16 * 4
        self.conv_00 = Conv(64, width, 3, padding=1)
        self.conv_01 = Conv(width, width, 3, padding=1)
        self.reps = max(1, width // 16)
        c = width + (16 * self.reps if src_skip else 0)
        self.n_extra = int(np.log2(max(int(t_resolution_multiplier), 1)))
        cur = width
        for i in range(self.n_extra):
            cur = max(cur // 2, 16)
            self.add_module(f"conv_up{i}", Conv(c, cur, 3, padding=1))
            c = cur
        self.head = Conv(c, out_nc, 3, padding=1)
        self.norm = InstanceNorm()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init (normal with the reference's gain by default); every
        bias starts at zero."""
        init = make_initializer(self.init_type, self.init_gain)
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(init, generator)

    def forward(self, x: torch.Tensor, style_code: torch.Tensor = None,
                dtype: torch.dtype = None, deterministic: bool = True) -> torch.Tensor:
        """x (N, H, W, in_nc) → (N, H·m, W·m, out_nc) in [-1, 1]."""
        if style_code is not None:
            raise ValueError("the VisGel generator takes no style code")
        feats, skip = self.encoder(x.float())
        h = torch.relu(self.norm(self.conv_00(up2(feats))))
        h = torch.relu(self.norm(self.conv_01(up2(h))))
        if self.src_skip:
            if skip.shape[1:3] != h.shape[1:3]:
                skip = resize_linear(skip, h.shape[1:3])
            h = torch.cat([h, skip.repeat(1, 1, 1, self.reps)], dim=-1)
        for i in range(self.n_extra):
            h = torch.relu(self.norm(getattr(self, f"conv_up{i}")(up2(h))))
        return torch.tanh(self.head(h))
