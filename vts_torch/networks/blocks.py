"""U-Net and PatchGAN building blocks (``vts_tpu/networks/blocks.py``), NHWC
at every ``forward``; the convs run on NCHW views of the same memory.

The compute dtype is a ``forward`` argument, as flax's ``dtype=`` is a
module attribute: params stay fp32, and a conv casts its input, kernel and
bias to the compute dtype, convolves (a bf16 conv output is rounded once)
and adds the bias in that dtype, as ``nn.Conv(dtype=…)`` does.  The norms
take their statistics in fp32 from whatever they are given: instance norm
then does its arithmetic in x's dtype, batch norm in fp32 with one rounding
to x's dtype, as flax's ``BatchNorm(dtype=…)``.

Layouts: ``Conv4x4`` holds a torch OIHW weight; ``ConvT4x4`` holds the
(in, out, kh, kw) weight of ``ConvTranspose2d(k=4, s=2, p=1)`` — the
reference's flax ``ConvTranspose(padding=2)`` kernel spatially flipped and
io-transposed (:mod:`vts_torch.utils.convert_jax`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _to_nhwc(y):
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def leaky_relu(x, slope: float = 0.2):
    """LeakyReLU as flax's: where(x >= 0, x, slope·x), so the gradient at
    exactly 0 is 1 (``F.leaky_relu`` gives ``slope`` there; zeros are common
    here, e.g. a zero-bias conv over the masked-out canvas)."""
    return torch.where(x >= 0, x, x * slope)


def make_initializer(init_type: str, init_gain: float):
    """Reference models/networks.py:191-230 with the reference's flax fan
    convention (receptive field × in / × out).  Returns ``init(tensor,
    fan_in, fan_out, generator)`` filling the tensor in place."""
    def normal(std):
        def init(t, fan_in, fan_out, gen):
            with torch.no_grad():
                t.normal_(0.0, std(fan_in, fan_out), generator=gen)
        return init

    if init_type == "normal":
        return normal(lambda fi, fo: init_gain)
    if init_type == "xavier":
        return normal(lambda fi, fo: init_gain * math.sqrt(2.0 / (fi + fo)))
    if init_type == "kaiming":
        return normal(lambda fi, fo: math.sqrt(2.0 / fi))
    raise NotImplementedError(f"initialization method {init_type!r} is not ported yet")


class InstanceNorm(nn.Module):
    """Affine-free instance norm over (H, W) of NHWC, eps 1e-5, with the
    reference's ONE-pass fp32 statistics: var = E[x²] − E[x]², clamped at 0
    (``F.instance_norm`` takes two passes and rounds differently)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = torch.mean(xf, dim=(1, 2), keepdim=True)
        var = torch.mean(xf * xf, dim=(1, 2), keepdim=True) - mean * mean
        scale = torch.rsqrt(torch.clamp_min(var, 0.0) + self.eps)
        return (x - mean.to(x.dtype)) * scale.to(x.dtype)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of NHWC, written out because ``nn.BatchNorm2d`` differs in three ways:

      * flax's momentum 0.9 weights the OLD running value (torch's 0.1 the new);
      * the running variance takes the BIASED batch variance, computed in
        one fp32 pass, var = max(E[x²] − E[x]², 0);
      * a pass may use batch statistics and discard the new running ones
        (``update_stats=False``: the reference's G-loss pass through D).

    The batch statistics always normalize (the reference builds its
    discriminators in training mode only) and, with ``update_stats``, fold
    into the running ``mean``/``var`` buffers.  ``scale`` starts at
    N(1, 0.02)."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def reset_parameters(self, init, gen):
        with torch.no_grad():
            self.scale.normal_(0.0, 1.0, generator=gen).mul_(0.02).add_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, update_stats: bool = True):
        xf = x.float()
        mean = torch.mean(xf, dim=(0, 1, 2))
        var = torch.clamp_min(torch.mean(xf * xf, dim=(0, 1, 2)) - mean * mean, 0.0)
        if update_stats:
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def avg_pool_3x3_s2_nopad_count(x):
    """AvgPool2d(3, stride 2, padding 1, count_include_pad=False) over NHWC —
    the multiscale-D pyramid downsampler — as the reference computes it: the
    3×3 window sums over the zero-padded input divided by the count of
    in-image pixels.  Written with strided slices, not ``F.avg_pool2d``:
    its CUDA backward returns wrong input gradients for the NHWC
    (channels_last) view (measured on an H100 with torch 2.11)."""
    n, h, w, c = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    ones = F.pad(torch.ones((1, h, w, 1), dtype=x.dtype, device=x.device), (0, 0, 1, 1, 1, 1))
    total = cnt = 0.0
    for dy in range(3):
        for dx in range(3):
            win = (slice(None), slice(dy, dy + 2 * ho - 1, 2), slice(dx, dx + 2 * wo - 1, 2))
            total = total + xp[win].float()
            cnt = cnt + ones[win]
    return total.to(x.dtype) / cnt


class Conv4x4(nn.Module):
    """4×4 conv, stride 2 and pad 1 by default (the U-Net's); the PatchGAN
    heads use pad 2 at stride 2 and 1."""

    def __init__(self, in_c: int, out_c: int, use_bias: bool = True, stride: int = 2,
                 padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(out_c, in_c, 4, 4))
        self.bias = nn.Parameter(torch.zeros(out_c)) if use_bias else None

    def reset_parameters(self, init, gen):
        o, i, kh, kw = self.weight.shape
        init(self.weight, i * kh * kw, o * kh * kw, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        if dtype == torch.float32:
            return _to_nhwc(F.conv2d(_to_nchw(x.float()), self.weight, self.bias,
                                     stride=self.stride, padding=self.padding))
        y = _to_nhwc(F.conv2d(_to_nchw(x.to(dtype)), self.weight.to(dtype), None,
                              stride=self.stride, padding=self.padding))
        return y if self.bias is None else y + self.bias.to(dtype)


class ConvT4x4(nn.Module):
    """4×4 transposed conv, stride 2 → exact 2× upsample."""

    def __init__(self, in_c: int, out_c: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_c, out_c, 4, 4))
        self.bias = nn.Parameter(torch.zeros(out_c)) if use_bias else None

    def reset_parameters(self, init, gen):
        i, o, kh, kw = self.weight.shape
        init(self.weight, i * kh * kw, o * kh * kw, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        if dtype == torch.float32:
            return _to_nhwc(F.conv_transpose2d(_to_nchw(x.float()), self.weight, self.bias,
                                               stride=2, padding=1))
        y = _to_nhwc(F.conv_transpose2d(_to_nchw(x.to(dtype)), self.weight.to(dtype), None,
                                        stride=2, padding=1))
        return y if self.bias is None else y + self.bias.to(dtype)


class Down(nn.Module):
    """[LeakyReLU(0.2)] + Conv4x4(s2) + [norm]; outermost: conv only;
    innermost: no norm."""

    def __init__(self, in_c: int, out_c: int, innermost: bool = False,
                 outermost: bool = False, use_bias: bool = True):
        super().__init__()
        self.outermost = outermost
        self.conv = Conv4x4(in_c, out_c, use_bias)
        self.norm = None if (outermost or innermost) else InstanceNorm()

    def forward(self, x, dtype: torch.dtype = torch.float32):
        if not self.outermost:
            x = leaky_relu(x, 0.2)
        x = self.conv(x, dtype)
        return x if self.norm is None else self.norm(x)


class Up(nn.Module):
    """[cat(x, skip)] + ReLU + ConvT4x4(s2) + norm, or + Tanh at the
    outermost level (which takes no skip, like the innermost)."""

    def __init__(self, in_c: int, out_c: int, innermost: bool = False,
                 outermost: bool = False, use_bias: bool = True):
        super().__init__()
        self.outermost = outermost
        self.takes_skip = not (outermost or innermost)
        self.convt = ConvT4x4(in_c, out_c, True if outermost else use_bias)
        self.norm = None if outermost else InstanceNorm()

    def forward(self, x, skip=None, dtype: torch.dtype = torch.float32):
        if self.takes_skip and skip is not None:
            x = torch.cat([x, skip], dim=-1)
        x = self.convt(torch.relu(x), dtype)
        return torch.tanh(x) if self.outermost else self.norm(x)
