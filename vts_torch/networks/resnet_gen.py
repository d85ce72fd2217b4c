"""ResNet generator with antialiased resampling — the pix2pix baseline's G
(``vts_tpu/networks/resnet_gen.py``), NHWC in and out.

  stem:    reflect pad 3, 7×7 conv ngf, norm, ReLU;
  down:    n_downsampling stages to 2·, 4·ngf: a 3×3 conv (pad 1), norm,
           ReLU and :func:`~vts_torch.networks.blocks.blur_downsample`, or
           with ``no_antialias`` a stride-2 3×3 conv, norm, ReLU;
  blocks:  ``n_blocks`` residual blocks at 2^n_downsampling·ngf (pad by
           ``padding_type`` reflect, replicate or zero, 3×3 conv, norm,
           ReLU, [dropout], pad, 3×3 conv, norm, plus the input);
  up:      n_downsampling stages (plus log2(``t_resolution_multiplier``) with
           ``generate_T_imgs``) halving the channels:
           :func:`~vts_torch.networks.blocks.blur_upsample` and a 3×3 conv
           (pad 1), or with ``no_antialias_up`` a stride-2 3×3 transposed
           conv (torch padding 1, output padding 1: the reference's flax
           padding (1, 2) on the stride-dilated input), then norm, ReLU;
  head:    reflect pad 3, 7×7 conv to ``out_nc`` (with bias), tanh.

The convs have no bias under batch norm (``norm_uses_bias``).  Dropout
(p 0.5) runs only when ``forward`` is given ``deterministic=False``: the
reference's pix2pix never passes it, so there it is inert.  The convs run
in the net's ``dtype`` (params fp32) unless ``forward`` is given another.

Submodules carry the reference's flax names (``Conv_i`` in call order,
``BatchNorm_i``, ``ConvTranspose_i``, ``ResnetBlock_b.{Conv,BatchNorm}_{0,1}``),
so a state-dict key is the flax tree path (:mod:`vts_torch.utils.convert_jax`);
``ConvTranspose_i`` holds the (in, out, 3, 3) torch weight, the flax kernel
flipped and io-transposed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import (BatchNorm, Conv, _pad_nchw, _to_nchw, _to_nhwc, blur_downsample,
                     blur_upsample, make_initializer, make_norm, norm_uses_bias)


def _pad(x, p: int, mode: str):
    """Pad NHWC ``x`` by ``p`` on each side of H and W."""
    return _to_nhwc(_pad_nchw(_to_nchw(x), (p,) * 4, mode))


class ConvT3x3(nn.Module):
    """3×3 transposed conv, stride 2: an exact 2× upsample."""

    def __init__(self, in_c: int, out_c: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_c, out_c, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_c)) if use_bias else None

    def reset_parameters(self, init, gen):
        i, o, kh, kw = self.weight.shape
        init(self.weight, i * kh * kw, o * kh * kw, gen, 1)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        b = None if self.bias is None else self.bias.to(dtype)
        if dtype != torch.float32:
            y = _to_nhwc(F.conv_transpose2d(_to_nchw(x.to(dtype)), self.weight.to(dtype), None,
                                            stride=2, padding=1, output_padding=1))
            return y if b is None else y + b
        return _to_nhwc(F.conv_transpose2d(_to_nchw(x.float()), self.weight, b, stride=2,
                                           padding=1, output_padding=1))


class _Named(nn.Module):
    """A module whose convs and norms are named as flax names them: one
    counter per kind, in call order; a norm that holds nothing (instance,
    none) is named ``norm_i``."""

    def __init__(self, norm_type: str):
        super().__init__()
        self.norm_type = norm_type
        self.use_bias = norm_uses_bias(norm_type)
        self._counts = {}

    def _add(self, kind: str, module: nn.Module) -> str:
        if kind == "BatchNorm" and self.norm_type != "batch":
            kind = "norm"
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return f"{kind}_{i}"

    def _norm(self, c: int) -> str:
        return self._add("BatchNorm", make_norm(self.norm_type, c))

    def _conv_norm_relu(self, conv: str, norm: str, h, dtype):
        return torch.relu(getattr(self, norm)(getattr(self, conv)(h, dtype)))


class ResnetBlock(_Named):
    """pad, 3×3 conv, norm, ReLU, [dropout], pad, 3×3 conv, norm, plus the
    input; the convs have a bias unless a batch norm follows, or as
    ``use_bias`` says (pix2pixHD's always have one)."""

    def __init__(self, c: int, norm_type: str, use_dropout: bool = False,
                 padding_type: str = "reflect", use_bias: bool = None):
        super().__init__(norm_type)
        if use_bias is not None:
            self.use_bias = use_bias
        if padding_type not in ("reflect", "replicate", "zero"):
            raise NotImplementedError(f"padding [{padding_type}] is not implemented")
        self.use_dropout = use_dropout
        self.pad_mode = padding_type
        self.convs = [(self._add("Conv", Conv(c, c, 3, self.use_bias)), self._norm(c))
                      for _ in range(2)]

    def forward(self, x, dtype: torch.dtype, deterministic: bool = True):
        (c0, n0), (c1, n1) = self.convs
        h = self._conv_norm_relu(c0, n0, _pad(x, 1, self.pad_mode), dtype)
        if self.use_dropout and not deterministic:
            h = F.dropout(h, 0.5, training=True)
        h = getattr(self, c1)(_pad(h, 1, self.pad_mode), dtype)
        return x + getattr(self, n1)(h)


class ResnetGenerator(_Named):
    def __init__(self, in_nc: int, ngf: int = 64, out_nc: int = 3, n_blocks: int = 9,
                 n_downsampling: int = 2, norm_type: str = "instance",
                 use_dropout: bool = False, no_antialias: bool = False,
                 no_antialias_up: bool = False, padding_type: str = "reflect",
                 generate_T_imgs: bool = False, t_resolution_multiplier: int = 1,
                 init_type: str = "xavier", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__(norm_type)
        self.dtype = dtype
        self.init_type, self.init_gain = init_type, init_gain
        self.no_antialias, self.no_antialias_up = no_antialias, no_antialias_up
        bias = self.use_bias
        self.stem = (self._add("Conv", Conv(in_nc, ngf, 7, bias)), self._norm(ngf))
        self.downs = []
        for i in range(n_downsampling):
            cout = ngf * 2 ** (i + 1)
            conv = Conv(cout // 2, cout, 3, bias, stride=2 if no_antialias else 1, padding=1)
            self.downs.append((self._add("Conv", conv), self._norm(cout)))
        c = ngf * 2 ** n_downsampling
        self.blocks = [self._add("ResnetBlock", ResnetBlock(c, norm_type, use_dropout,
                                                            padding_type))
                       for _ in range(n_blocks)]
        n_up = n_downsampling
        if generate_T_imgs:
            n_up += int(np.log2(t_resolution_multiplier))
        self.ups = []
        for i in range(n_up):
            cin, c = c, int(ngf * 2 ** (n_downsampling - i) / 2)
            conv = ConvT3x3(cin, c, bias) if no_antialias_up else Conv(cin, c, 3, bias, padding=1)
            self.ups.append((self._add("ConvTranspose" if no_antialias_up else "Conv", conv),
                             self._norm(c)))
        self.head = self._add("Conv", Conv(c, out_nc, 7, True))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init (xavier-normal with the reference's gain by default);
        every bias starts at zero, batch-norm scales at N(1, 0.02)."""
        init = make_initializer(self.init_type, self.init_gain)
        for m in self.modules():
            if isinstance(m, (Conv, ConvT3x3, BatchNorm)):
                m.reset_parameters(init, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = None,
                deterministic: bool = True) -> torch.Tensor:
        """x (N, H, W, in_nc) → (N, H', W', out_nc) in [-1, 1] (H' = H, or
        H·t_resolution_multiplier with ``generate_T_imgs``)."""
        dt = dtype or self.dtype
        h = self._conv_norm_relu(*self.stem, _pad(x, 3, "reflect"), dt)
        for conv, norm in self.downs:
            h = self._conv_norm_relu(conv, norm, h, dt)
            if not self.no_antialias:
                h = blur_downsample(h)
        for name in self.blocks:
            h = getattr(self, name)(h, dt, deterministic)
        for conv, norm in self.ups:
            if not self.no_antialias_up:
                h = blur_upsample(h)
            h = self._conv_norm_relu(conv, norm, h, dt)
        return torch.tanh(getattr(self, self.head)(_pad(h, 3, "reflect"), dt))
