"""MUNIT-style encoder/decoder generator — ``--netG resnet_cat``
(``vts_tpu/networks/munit.py::GResnet``), NHWC in and out.

  content encoder:  reflect pad 3, 7×7 conv ngf, IN, ReLU (``stem``);
                    ``num_downs`` × (reflect pad 1, 4×4 stride-2 conv to twice
                    the width, IN, ReLU) (``down{i}``); ``n_res`` residual
                    blocks (``enc_res{i}``);
  decoder:          ``n_res`` residual blocks (``dec_res{i}``); ``num_downs`` ×
                    (nearest ×2, reflect pad 2, 5×5 conv to half the width,
                    :class:`LayerNorm2d`, ReLU) (``up{i}``, ``up_ln{i}``);
                    reflect pad 3, 7×7 ``head`` to ``out_nc``, tanh;
  ``_ResBlk``:      reflect pad 1, 3×3 conv, IN, ReLU, pad, 3×3 conv, IN, plus
                    the input (``Conv_0``, ``Conv_1``).

A latent ``z`` (N, nz) given to ``forward`` is concatenated onto the
features before the first decoder block, before each up conv and before the
head (the "cat" injection).  Every model calls G without one, and then the
path is the identity.  A z of
nonzero width cannot run: the first decoder block adds its input (width +
nz channels) to its output (width channels), which fails in the reference
too; the net raises on it by name.  The convs have biases and run in fp32
whatever the compute dtype, as the reference's (its flax convs take no
dtype).  Submodules carry the flax names, so a state-dict key is the flax
tree path.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import Conv, InstanceNorm, make_initializer
from .resnet_gen import _pad


class LayerNorm2d(nn.Module):
    """Normalization over (H, W, C) of each sample with the POPULATION
    variance (``jnp.var``), rsqrt(var + 1e-5), then a per-channel scale and
    bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
        var = torch.var(x, dim=(1, 2, 3), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.scale + self.bias


class _ResBlk(nn.Module):
    def __init__(self, in_c: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_c, features, 3)
        self.Conv_1 = Conv(features, features, 3)
        self.norm = InstanceNorm()

    def forward(self, x):
        h = torch.relu(self.norm(self.Conv_0(_pad(x, 1, "reflect"))))
        h = self.norm(self.Conv_1(_pad(h, 1, "reflect")))
        return x + h


class GResnet(nn.Module):
    """Content encoder + z-cat decoder (reference ``G_Resnet``)."""

    def __init__(self, in_nc: int, ngf: int = 64, out_nc: int = 3, num_downs: int = 2,
                 n_res: int = 4, init_type: str = "xavier", init_gain: float = 0.02):
        super().__init__()
        self.init_type, self.init_gain = init_type, init_gain
        self.num_downs, self.n_res = num_downs, n_res
        self.stem = Conv(in_nc, ngf, 7)
        dim = ngf
        for i in range(num_downs):
            self.add_module(f"down{i}", Conv(dim, dim * 2, 4, stride=2))
            dim *= 2
        for i in range(n_res):
            self.add_module(f"enc_res{i}", _ResBlk(dim, dim))
        for i in range(n_res):
            self.add_module(f"dec_res{i}", _ResBlk(dim, dim))
        for i in range(num_downs):
            self.add_module(f"up{i}", Conv(dim, dim // 2, 5))
            self.add_module(f"up_ln{i}", LayerNorm2d(dim // 2))
            dim //= 2
        self.head = Conv(dim, out_nc, 7)
        self.norm = InstanceNorm()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init (xavier-normal with the reference's gain by default);
        conv biases start at zero, the layer norms at scale 1, bias 0."""
        init = make_initializer(self.init_type, self.init_gain)
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(init, generator)
            elif isinstance(m, LayerNorm2d):
                nn.init.ones_(m.scale)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, z: torch.Tensor = None, dtype: torch.dtype = None,
                deterministic: bool = True) -> torch.Tensor:
        """x (N, H, W, in_nc) → (N, H, W, out_nc) in [-1, 1]; H and W
        multiples of 2^num_downs; ``z`` (N, 0) runs the concatenation path
        (a z of nonzero width raises, as the reference fails on it)."""
        if z is not None and z.shape[-1]:
            raise ValueError(f"GResnet with a z of width {z.shape[-1]}: the first decoder "
                             f"block adds its input (features + z channels) to its output "
                             f"(features channels); the reference fails there too")

        def cat_z(feat):
            if z is None:
                return feat
            zt = z[:, None, None, :].to(feat.dtype).expand(-1, feat.shape[1], feat.shape[2], -1)
            return torch.cat([feat, zt], dim=-1)

        h = torch.relu(self.norm(self.stem(_pad(x.float(), 3, "reflect"))))
        for i in range(self.num_downs):
            h = torch.relu(self.norm(getattr(self, f"down{i}")(_pad(h, 1, "reflect"))))
        for i in range(self.n_res):
            h = getattr(self, f"enc_res{i}")(h)
        for i in range(self.n_res):
            h = getattr(self, f"dec_res{i}")(cat_z(h) if i == 0 else h)
        for i in range(self.num_downs):
            h = cat_z(h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
            h = getattr(self, f"up{i}")(_pad(h, 2, "reflect"))
            h = torch.relu(getattr(self, f"up_ln{i}")(h))
        return torch.tanh(self.head(_pad(cat_z(h), 3, "reflect")))
