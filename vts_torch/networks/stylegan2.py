"""StyleGAN2 network family — ``--netG stylegan2|smallstylegan2`` and
``--netD stylegan2|tilestylegan2`` (``vts_tpu/networks/stylegan2.py``), NHWC
in and out.

  FIR resamplers:   :func:`fir_filter` is upfirdn2d: zero-insert ×up (the
                    reference's lhs dilation), pad (p0, p1), a depthwise
                    correlation with the fixed filter (not flipped), stride
                    ×down; :func:`blur`, :func:`upsample2`, :func:`downsample2`;
  equalized lr:     :class:`EqualConv` and :class:`EqualLinear` hold unit-normal
                    weights and scale them at call time (1/√fan_in, × ``lr_mul``);
  ``ConvLayer``:    [blur pad (1, 1), stride 2] EqualConv, and its bias moved to
                    the fused leaky ReLU (slope 0.2, gain √2) when it activates;
  ``ModulatedConv``: per-sample weights modulated by the style, demodulated in
                    fp32, the batch folded into the groups of one conv; with
                    ``upsample`` a nearest ×2 and ``blur(pad=(2, 1))`` first;
  ``StyledConv``:   the modulated conv (style ones(n, in_c) when None), plus
                    ``noise_strength`` × a fixed noise map, the fused leaky ReLU;
  ``ResBlock``:     (two ConvLayers + a 1×1 skip ConvLayer) / √2;
  generator:        ConvLayer 1×1, ``num_downsampling`` down ResBlocks, n_blocks
                    ResBlocks (6, or 2 for ``smallstylegan2``), as many up
                    StyledConvs, ConvLayer 1×1 to ``out_nc`` (activated, no tanh);
  discriminator:    ConvLayer 1×1, down ResBlocks to 4², the minibatch stddev,
                    a 3×3 ConvLayer, two EqualLinears to one logit a sample;
                    ``tile``: the input cut into (crop_size // 4)² tiles first.

Noise: the reference's models pass no "noise" rng, so its StyledConv adds
``normal(key(0), (n, h, w, 1))`` — the same draw on every call.  Here each
StyledConv keeps one fixed standard-normal map per shape, drawn once from a
seed that ``reset_parameters`` takes from the module's seeded generator: the
same law and the same fixedness, another draw.  ``StyledConv.noise`` maps a
shape (n, h, w) to its map, and a caller may put the reference's draw there.
The maps are not parameters and are not saved.

The minibatch stddev groups ``min(n, 4)`` samples in the reference's
group-major order (``h[:k].reshape(group, -1, …)``, then each group's value
repeated ``group`` times), which is not the original StyleGAN2's; kept.  A
D's ``group`` (a :class:`~vts_torch.parallel.dist.DataGroup` of more than
one rank, ``--mesh data:N``) takes it over the global batch: every rank's
features gathered, with their gradient, and this rank's rows kept.  The
nets compute in fp32 whatever the compute dtype (the reference's take none)
and hold no batch statistics.  Submodules and parameters carry the flax
names (``ConvLayer_0``, ``ResBlock_3.ConvLayer_1.EqualConv_0``,
``StyledConv_0.conv.modulation``, ``noise_strength``, ``weight``); a
state-dict key is the flax tree path (:mod:`vts_torch.utils.convert_jax`).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import _to_nchw, _to_nhwc, leaky_relu


def _fir_kernel(k: Sequence[float], gain: float = 1.0) -> np.ndarray:
    a = np.asarray(k, np.float32)
    f = np.outer(a, a)
    return f / f.sum() * gain


def fir_filter(x: torch.Tensor, kernel: np.ndarray, up: int = 1, down: int = 1,
               pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """upfirdn2d of NHWC ``x``: zero-upsample ×up (``up − 1`` zeros between
    pixels, none after the last), pad (p0, p1) on both axes, depthwise FIR
    correlation, stride ×down."""
    h = _to_nchw(x)
    n, c, hh, ww = h.shape
    if up > 1:
        z = h.new_zeros((n, c, (hh - 1) * up + 1, (ww - 1) * up + 1))
        z[:, :, ::up, ::up] = h
        h = z
    p0, p1 = pad
    h = F.pad(h, (p0, p1, p0, p1))
    k = torch.as_tensor(kernel, device=h.device).to(h.dtype)
    return _to_nhwc(F.conv2d(h, k[None, None].expand(c, 1, *kernel.shape), stride=down,
                             groups=c))


def blur(x, kernel=(1, 3, 3, 1), pad=(2, 1), upsample_factor: int = 1):
    return fir_filter(x, _fir_kernel(kernel, gain=upsample_factor ** 2), pad=pad)


def upsample2(x, kernel=(1, 3, 3, 1)):
    k = _fir_kernel(kernel, gain=4.0)
    p = k.shape[0] - 2
    return fir_filter(x, k, up=2, pad=((p + 1) // 2 + 1, p // 2))


def downsample2(x, kernel=(1, 3, 3, 1)):
    k = _fir_kernel(kernel)
    p = k.shape[0] - 2
    return fir_filter(x, k, down=2, pad=((p + 1) // 2, p // 2))


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2, scale: float = 2 ** 0.5):
    if bias is not None:
        x = x + bias
    return leaky_relu(x, negative_slope) * scale


class _Equalized(nn.Module):
    """A module whose weights are unit-normal draws scaled at call time:
    ``reset_parameters`` ignores ``--init_type``, as the reference's init."""

    def reset_parameters(self, init=None, gen: torch.Generator = None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight_std, generator=gen)
            if getattr(self, "bias", None) is not None:
                self.bias.fill_(self.bias_init)


class EqualConv(_Equalized):
    weight_std, bias_init = 1.0, 0.0

    def __init__(self, in_c: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, use_bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1.0 / math.sqrt(in_c * kernel ** 2)
        self.weight = nn.Parameter(torch.zeros(features, in_c, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        return _to_nhwc(F.conv2d(_to_nchw(x), self.weight * self.scale, self.bias,
                                 stride=self.stride, padding=self.padding))


class EqualLinear(_Equalized):
    def __init__(self, in_c: int, features: int, lr_mul: float = 1.0, activation: bool = False,
                 bias_init: float = 0.0):
        super().__init__()
        self.lr_mul, self.activation = lr_mul, activation
        self.weight_std, self.bias_init = 1.0 / lr_mul, bias_init
        self.scale = (1.0 / math.sqrt(in_c)) * lr_mul
        self.weight = nn.Parameter(torch.zeros(features, in_c))
        self.bias = nn.Parameter(torch.full((features,), float(bias_init)))

    def forward(self, x):
        y = F.linear(x, self.weight * self.scale)
        if self.activation:
            return fused_leaky_relu(y, self.bias * self.lr_mul)
        return y + self.bias * self.lr_mul


class ConvLayer(nn.Module):
    """EqualConv (+ blur-downsample) + fused leaky ReLU."""

    def __init__(self, in_c: int, features: int, kernel: int = 3, downsample: bool = False,
                 activate: bool = True, use_bias: bool = True):
        super().__init__()
        self.downsample, self.activate = downsample, activate
        if downsample:
            conv = EqualConv(in_c, features, kernel, stride=2, padding=0 if kernel == 1 else 1,
                             use_bias=use_bias and not activate)
        else:
            conv = EqualConv(in_c, features, kernel, padding=kernel // 2,
                             use_bias=use_bias and not activate)
        self.EqualConv_0 = conv
        self.bias = nn.Parameter(torch.zeros(features)) if activate else None

    def forward(self, x):
        if self.downsample:
            x = blur(x, pad=(1, 1))
        y = self.EqualConv_0(x)
        return fused_leaky_relu(y, self.bias) if self.activate else y


class ModulatedConv(_Equalized):
    """Style-modulated, demodulated conv; the style is (n, in_c) (the
    generator passes none, so the modulation maps in_c → in_c)."""

    weight_std = 1.0

    def __init__(self, in_c: int, features: int, kernel: int = 3, demodulate: bool = True,
                 upsample: bool = False):
        super().__init__()
        self.k, self.features = kernel, features
        self.demodulate, self.upsample = demodulate, upsample
        self.scale = 1.0 / math.sqrt(in_c * kernel * kernel)
        self.weight = nn.Parameter(torch.zeros(features, in_c, kernel, kernel))
        self.modulation = EqualLinear(in_c, in_c, bias_init=1.0)

    def forward(self, x, style):
        n, _, _, in_c = x.shape
        s = self.modulation(style)                                     # (n, in_c)
        w = (self.weight * self.scale)[None] * s[:, None, :, None, None]   # (n, out, in, k, k)
        if self.demodulate:
            demod = torch.rsqrt(torch.sum(w.float() ** 2, dim=(2, 3, 4)) + 1e-8)  # (n, out)
            w = w * demod[:, :, None, None, None].to(w.dtype)
        if self.upsample:
            x = blur(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2), pad=(2, 1))
        h, wd = x.shape[1:3]
        xg = _to_nchw(x).reshape(1, n * in_c, h, wd)
        y = F.conv2d(xg, w.reshape(n * self.features, in_c, self.k, self.k),
                     padding=self.k // 2, groups=n)
        return _to_nhwc(y.reshape(n, self.features, h, wd))


class StyledConv(nn.Module):
    def __init__(self, in_c: int, features: int, kernel: int = 3, upsample: bool = False,
                 inject_noise: bool = True):
        super().__init__()
        self.inject_noise = inject_noise
        self.conv = ModulatedConv(in_c, features, kernel, upsample=upsample)
        self.noise_strength = nn.Parameter(torch.zeros(())) if inject_noise else None
        self.bias = nn.Parameter(torch.zeros(features))
        self.noise_seed = 0
        self.noise = {}

    def reset_parameters(self, init=None, gen: torch.Generator = None) -> None:
        with torch.no_grad():
            self.bias.zero_()
            if self.noise_strength is not None:
                self.noise_strength.zero_()
        self.noise_seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        self.noise = {}

    def fixed_noise(self, n: int, h: int, w: int, device) -> torch.Tensor:
        """The (n, h, w, 1) noise map of this shape: drawn once, on the host,
        from the module's seed, then kept on ``device``."""
        m = self.noise.get((n, h, w))
        if m is None:
            m = torch.randn((n, h, w, 1), generator=torch.Generator().manual_seed(self.noise_seed))
        if m.device != torch.device(device):
            m = m.to(device)
        self.noise[(n, h, w)] = m
        return m

    def forward(self, x, style=None):
        if style is None:
            style = torch.ones((x.shape[0], x.shape[-1]), dtype=x.dtype, device=x.device)
        y = self.conv(x, style)
        if self.inject_noise:
            y = y + self.noise_strength * self.fixed_noise(*y.shape[:3], y.device).to(y.dtype)
        return fused_leaky_relu(y, self.bias)


class ResBlock(nn.Module):
    def __init__(self, in_c: int, features: int, downsample: bool = True):
        super().__init__()
        self.ConvLayer_0 = ConvLayer(in_c, in_c, 3)
        self.ConvLayer_1 = ConvLayer(in_c, features, 3, downsample=downsample)
        self.ConvLayer_2 = ConvLayer(in_c, features, 1, downsample=downsample, activate=False,
                                     use_bias=False)

    def forward(self, x):
        out = self.ConvLayer_1(self.ConvLayer_0(x))
        return (out + self.ConvLayer_2(x)) / math.sqrt(2)


def _channels(ngf: int):
    """The width table by resolution; a key above 1024 raises ``KeyError``,
    as the reference's."""
    cm = ngf / 32
    return {r: (min(512, int(round(base * cm))) if r <= 32 else int(round(base * cm)))
            for r, base in ((4, 4096), (8, 2048), (16, 1024), (32, 512),
                            (64, 256), (128, 128), (256, 64), (512, 32), (1024, 16))}


def _res(size: int) -> int:
    return 2 ** int(np.rint(np.log2(size)))


# the largest --crop_size whose width key 2^rint(log2(crop)) is in the table
MAX_CROP_SIZE = 1448


def _reset(net: nn.Module, gen: torch.Generator) -> None:
    for m in net.modules():
        if isinstance(m, (_Equalized, StyledConv)):
            m.reset_parameters(None, gen)
        elif isinstance(m, ConvLayer) and m.bias is not None:
            nn.init.zeros_(m.bias)


def _minibatch_stddev(h: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) features → (N, 1, 1, 1): the reference's grouped stddev."""
    n = h.shape[0]
    group = min(n, 4)
    g = h[: (n // group) * group].reshape(group, -1, *h.shape[1:])
    std = torch.sqrt(torch.var(g, dim=0, unbiased=False) + 1e-8)
    mean_std = torch.mean(std, dim=(1, 2, 3), keepdim=True)
    return torch.repeat_interleave(mean_std, group, dim=0)[:n]


class _Numbered(nn.Module):
    def _add(self, kind: str, module: nn.Module) -> str:
        counts = self.__dict__.setdefault("_counts", {})
        i = counts.get(kind, 0)
        counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return f"{kind}_{i}"


class StyleGAN2Generator(_Numbered):
    """Encoder/decoder translation generator."""

    def __init__(self, in_nc: int, ngf: int = 64, out_nc: int = 3, n_blocks: int = None,
                 crop_size: int = 256, num_downsampling: int = 1):
        super().__init__()
        res = _res(crop_size)
        if res > 1024:
            raise ValueError(f"--crop_size {crop_size} with the StyleGAN2 generator: its widths "
                             f"come from a table keyed 2^rint(log2(crop_size)) = {res}, which "
                             f"stops at 1024 (--crop_size <= {MAX_CROP_SIZE}); the reference "
                             f"fails with a KeyError there")
        nb = n_blocks if n_blocks is not None else 6
        ch = _channels(ngf)
        self.layers = [self._add("ConvLayer", ConvLayer(in_nc, ch[res], 1))]
        c = ch[res]
        for _ in range(num_downsampling):
            self.layers.append(self._add("ResBlock", ResBlock(c, ch[res // 2])))
            c, res = ch[res // 2], res // 2
        for _ in range(2 * (nb // 2)):
            self.layers.append(self._add("ResBlock", ResBlock(c, ch[res], downsample=False)))
            c = ch[res]
        for _ in range(num_downsampling):
            self.layers.append(self._add("StyledConv", StyledConv(
                c, ch[res * 2], 3, upsample=True, inject_noise=n_blocks is None)))
            c, res = ch[res * 2], res * 2
        self.layers.append(self._add("ConvLayer", ConvLayer(c, out_nc, 1)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: unit-normal equalized weights (``--init_type`` is not
        read, as in the reference), zero biases and noise strengths, each
        StyledConv's noise seed."""
        _reset(self, generator)

    def styled_convs(self):
        return [m for m in self.modules() if isinstance(m, StyledConv)]

    def forward(self, x: torch.Tensor, style_code: torch.Tensor = None,
                dtype: torch.dtype = None, deterministic: bool = True) -> torch.Tensor:
        """x (N, H, W, in_nc) → (N, H, W, out_nc), leaky-ReLU'd (no tanh)."""
        if style_code is not None:
            raise ValueError("the StyleGAN2 generator takes no style code")
        h = x.float()
        for name in self.layers:
            h = getattr(self, name)(h)
        return h


class StyleGAN2Discriminator(_Numbered):
    """Blur-downsampling D with minibatch stddev; ``input_size`` (H, W) is the
    size of the images it takes (the flattened head's width follows it)."""

    group = None

    def __init__(self, in_nc: int, ndf: int = 64, tile: bool = False, crop_size: int = 256,
                 input_size: Tuple[int, int] = (256, 256)):
        super().__init__()
        hh, ww = input_size
        self.tile = tile
        self.size = (crop_size // 4 if crop_size >= 64 else 16) if tile else None
        if tile:
            if hh % self.size or ww % self.size:
                raise ValueError(f"the tile StyleGAN2 D cuts its {hh}x{ww} input into "
                                 f"{self.size}² tiles (crop_size // 4), which do not divide it")
            hh = ww = self.size
        ch = _channels(ndf * 2)
        res = _res(hh)
        self.layers = [self._add("ConvLayer", ConvLayer(in_nc, ch[min(res, 1024)], 1))]
        c = ch[min(res, 1024)]
        while res > 4:
            self.layers.append(self._add("ResBlock", ResBlock(c, ch[max(res // 2, 4)])))
            c = ch[max(res // 2, 4)]
            res //= 2
            hh, ww = (hh - 2) // 2 + 1, (ww - 2) // 2 + 1
        self.final = self._add("ConvLayer", ConvLayer(c + 1, ch[4], 3))
        self.fc = (self._add("EqualLinear", EqualLinear(hh * ww * ch[4], ch[4], activation=True)),
                   self._add("EqualLinear", EqualLinear(ch[4], 1)))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """x (N, H, W, in_nc) → (N', 1) logits (N' = N × tiles for the tile
        D); ``update_stats`` is accepted: the net holds no statistics."""
        h = x.float()
        if self.tile:
            n, hh, ww, c = h.shape
            s = self.size
            h = h.reshape(n, hh // s, s, ww // s, s, c).permute(0, 1, 3, 2, 4, 5)
            h = h.reshape(n * (hh // s) * (ww // s), s, s, c)
        for name in self.layers:
            h = getattr(self, name)(h)
        n = h.shape[0]
        if self.group is not None and self.group.size > 1:
            # the global batch's statistic, this rank's rows of it
            mean_std = self.group.rows(_minibatch_stddev(self.group.gather_rows(h)))
        else:
            mean_std = _minibatch_stddev(h)
        h = torch.cat([h, mean_std.expand(n, h.shape[1], h.shape[2], 1)], dim=-1)
        h = getattr(self, self.final)(h).reshape(n, -1)
        for name in self.fc:
            h = getattr(self, name)(h)
        return h

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: unit-normal equalized weights, zero biases."""
        _reset(self, generator)
