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
io-transposed (:mod:`vts_torch.utils.convert_jax`).  ``groups`` G > 1 (the
garment-packing layout, :mod:`vts_torch.parallel.packing`) keeps the keys:
a grouped ``Conv4x4`` weight is (G·out, in, kh, kw) and a grouped
``ConvT4x4`` weight (G·in, out, kh, kw), per-garment sizes inside, so in
both the garment blocks run along the first axis.

The antialiased resamplers of the ResNet generator (:func:`blur_downsample`,
:func:`blur_upsample`) are depthwise convs with a fixed binomial filter.
"""

from __future__ import annotations

import math

import numpy as np
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


def _orthogonal(t, out_axis: int, gain: float, gen) -> None:
    """``jax.nn.initializers.orthogonal()`` · gain: the weight as the flax
    (receptive field · in, out) matrix, orthonormal along its shorter side
    (QR of a normal draw, signs fixed by R's diagonal)."""
    w = t.movedim(out_axis, -1)
    cols = w.shape[-1]
    rows = w.numel() // cols
    big, small = max(rows, cols), min(rows, cols)
    a = torch.randn((big, small), generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    with torch.no_grad():
        w.copy_((q * gain).reshape(w.shape).to(t.dtype))


def make_initializer(init_type: str, init_gain: float):
    """Reference models/networks.py:191-230 with the reference's flax fan
    convention (receptive field × in / × out).  Returns ``init(tensor,
    fan_in, fan_out, generator, out_axis)`` filling the tensor in place
    (``out_axis``: the output-channel axis, for ``orthogonal``).  As the
    reference's: ``normal``, ``xavier`` (normal, std gain·√(2/(fi+fo))),
    ``kaiming`` (normal, √(2/fi)), ``xavier_uniform`` (±√(6/(fi+fo)), no
    gain), ``orthogonal`` (times the gain) and ``none`` (lecun normal: a
    normal truncated at ±2 with unit variance, times √(1/fi))."""
    def normal(std):
        def init(t, fan_in, fan_out, gen, out_axis=0):
            with torch.no_grad():
                t.normal_(0.0, std(fan_in, fan_out), generator=gen)
        return init

    if init_type == "normal":
        return normal(lambda fi, fo: init_gain)
    if init_type == "xavier":
        return normal(lambda fi, fo: init_gain * math.sqrt(2.0 / (fi + fo)))
    if init_type == "kaiming":
        return normal(lambda fi, fo: math.sqrt(2.0 / fi))
    if init_type == "xavier_uniform":
        def init(t, fan_in, fan_out, gen, out_axis=0):
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            with torch.no_grad():
                t.uniform_(-limit, limit, generator=gen)
        return init
    if init_type == "orthogonal":
        return lambda t, fan_in, fan_out, gen, out_axis=0: _orthogonal(t, out_axis, init_gain,
                                                                       gen)
    if init_type == "none":
        def init(t, fan_in, fan_out, gen, out_axis=0):
            with torch.no_grad():
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                t.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        return init
    raise NotImplementedError(f"initialization method {init_type!r} not implemented")


# the standard deviation of a unit normal truncated at ±2 (jax's lecun_normal
# divides it out)
_TRUNC_STD = .87962566103423978


class InstanceNorm(nn.Module):
    """Affine-free instance norm over (H, W) of NHWC, eps 1e-5, with the
    reference's ONE-pass fp32 statistics: var = E[x²] − E[x]², clamped at 0
    (``F.instance_norm`` takes two passes and rounds differently)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, update_stats: bool = True):
        xf = x.float()
        mean = torch.mean(xf, dim=(1, 2), keepdim=True)
        var = torch.mean(xf * xf, dim=(1, 2), keepdim=True) - mean * mean
        scale = torch.rsqrt(torch.clamp_min(var, 0.0) + self.eps)
        return (x - mean.to(x.dtype)) * scale.to(x.dtype)


class Identity(nn.Module):
    """``--norm* none``: no normalization (flax's ``Identity``)."""

    def forward(self, x, update_stats: bool = True):
        return x


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of NHWC, written out because ``nn.BatchNorm2d`` differs in three ways:

      * flax's momentum 0.9 weights the OLD running value (torch's 0.1 the new);
      * the running variance takes the BIASED batch variance, computed in
        one fp32 pass, var = max(E[x²] − E[x]², 0);
      * a pass may use batch statistics and discard the new running ones
        (``update_stats=False``: the reference's G-loss pass through D).

    In training mode the batch statistics normalize and, with
    ``update_stats``, fold into the running ``mean``/``var`` buffers (the
    discriminators are always in training mode, as the reference builds
    them); in eval mode (a ``--normG batch`` G's eval forward, the
    reference's ``netG_eval``) the running ones normalize.  ``scale`` starts
    at N(1, 0.02).  ``affine=False`` is SPADE's param-free norm
    (``BatchNorm(use_scale=False, use_bias=False)``): the buffers and no
    parameters.  Without autograd the normalization runs in place on its
    one temporary (SPADE's 1536² eval forward holds 4.8 GB tensors).

    ``group``: a :class:`~vts_torch.parallel.dist.DataGroup` of more than
    one rank makes a training-mode pass normalize with the global batch's
    statistics, as the reference's GSPMD step does under ``--mesh data:N``:
    (Σx, Σx², count) in fp32 summed over the ranks in one collective, with
    its gradient, then mean = Σx/count and var = max(Σx²/count − mean², 0);
    the running buffers take those, the same on every rank."""

    group = None
    # True while a rematerialized forward recomputes a pass (``--remat_g``):
    # the running statistics were folded in once already
    hold_stats = False

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(c)) if affine else None
        self.bias = nn.Parameter(torch.zeros(c)) if affine else None
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def reset_parameters(self, init, gen):
        with torch.no_grad():
            if self.scale is not None:
                self.scale.normal_(0.0, 1.0, generator=gen).mul_(0.02).add_(1.0)
                self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, update_stats: bool = True):
        xf = x.float()
        if not self.training:
            mean, var = self.mean, self.var
        elif self.group is not None and self.group.size > 1:
            c = xf.shape[-1]
            sums = self.group.all_reduce(torch.cat([
                torch.sum(xf, dim=(0, 1, 2)), torch.sum(xf * xf, dim=(0, 1, 2)),
                xf.new_full((1,), xf.numel() // c)]))
            mean = sums[:c] / sums[c * 2]
            var = torch.clamp_min(sums[c:c * 2] / sums[c * 2] - mean * mean, 0.0)
        else:
            mean = torch.mean(xf, dim=(0, 1, 2))
            var = torch.clamp_min(torch.mean(xf * xf, dim=(0, 1, 2)) - mean * mean, 0.0)
        if self.training and update_stats and not self.hold_stats:
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = xf - mean
        y = y * mul if torch.is_grad_enabled() else y.mul_(mul)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def make_norm(norm_type: str, c: int) -> nn.Module:
    """The norm after a conv (``vts_tpu/networks/blocks.py::make_norm_layer``):
    ``instance``, ``batch`` or ``none``.  Each takes ``(x, update_stats)``."""
    if norm_type == "instance":
        return InstanceNorm()
    if norm_type == "batch":
        return BatchNorm(c)
    if norm_type == "none":
        return Identity()
    raise NotImplementedError(f"normalization layer {norm_type!r} not found")


def norm_uses_bias(norm_type: str) -> bool:
    """A conv that a batch norm follows has no bias (the norm absorbs it); an
    instance norm is affine-free, so the conv keeps its bias."""
    return norm_type != "batch"


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


class Conv(nn.Module):
    """k×k conv over NHWC (a torch OIHW weight), with the reference's stride
    and symmetric padding; ``groups`` G > 1 is the garment-packing path:
    ``in_c`` and ``out_c`` count all G garments' channels, the weight is
    (out_c, in_c / G, k, k), and each garment's block of outputs reads its
    block of inputs."""

    def __init__(self, in_c: int, out_c: int, k: int, use_bias: bool = True, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.zeros(out_c, in_c // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(out_c)) if use_bias else None

    def reset_parameters(self, init, gen):
        o, i, kh, kw = self.weight.shape
        init(self.weight, i * kh * kw, o * kh * kw, gen, 0)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        return self._conv(x, self.weight, dtype)

    def _conv(self, x, weight, dtype):
        if dtype == torch.float32:
            return _to_nhwc(F.conv2d(_to_nchw(x.float()), weight, self.bias,
                                     stride=self.stride, padding=self.padding,
                                     groups=self.groups))
        y = _to_nhwc(F.conv2d(_to_nchw(x.to(dtype)), weight.to(dtype), None,
                              stride=self.stride, padding=self.padding, groups=self.groups))
        return y if self.bias is None else y + self.bias.to(dtype)


class Conv4x4(Conv):
    """4×4 conv, stride 2 and pad 1 by default (the U-Net's); the PatchGAN
    heads use pad 2 at stride 2 and 1."""

    def __init__(self, in_c: int, out_c: int, use_bias: bool = True, stride: int = 2,
                 padding: int = 1, groups: int = 1):
        super().__init__(in_c, out_c, 4, use_bias, stride, padding, groups)


class ConvT4x4(nn.Module):
    """4×4 transposed conv, stride 2 → exact 2× upsample.  With ``groups`` G
    (channels counted over all garments) the weight is ``ConvTranspose2d``'s
    grouped one, (in_c, out_c / G, 4, 4): the garment blocks run along its
    INPUT axis (along the output axis in a grouped ``Conv4x4``), under the
    same state-dict key as the ungrouped weight, as the reference's grouped
    conv keeps flax's ``ConvTranspose_0``."""

    def __init__(self, in_c: int, out_c: int, use_bias: bool = True, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(in_c, out_c // groups, 4, 4))
        self.bias = nn.Parameter(torch.zeros(out_c)) if use_bias else None

    def reset_parameters(self, init, gen):
        i, o, kh, kw = self.weight.shape
        init(self.weight, i // self.groups * kh * kw, o * self.groups * kh * kw, gen, 1)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        if dtype == torch.float32:
            return _to_nhwc(F.conv_transpose2d(_to_nchw(x.float()), self.weight, self.bias,
                                               stride=2, padding=1, groups=self.groups))
        y = _to_nhwc(F.conv_transpose2d(_to_nchw(x.to(dtype)), self.weight.to(dtype), None,
                                        stride=2, padding=1, groups=self.groups))
        return y if self.bias is None else y + self.bias.to(dtype)


def packed_concat(a: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel concat per garment block: (…, G·Ca) ⊕ (…, G·Cb) → (…, G·(Ca + Cb))
    with garment g's channels contiguous, ``[a_g, b_g]``, as a grouped conv
    reads them (a plain concat for G = 1)."""
    if groups == 1:
        return torch.cat([a, b], dim=-1)
    lead = a.shape[:-1]
    out = torch.cat([a.reshape(*lead, groups, a.shape[-1] // groups),
                     b.reshape(*lead, groups, b.shape[-1] // groups)], dim=-1)
    return out.reshape(*lead, a.shape[-1] + b.shape[-1])


class Down(nn.Module):
    """[LeakyReLU(0.2)] + Conv4x4(s2) + [norm]; outermost: conv only;
    innermost: no norm.  ``groups``: the packed layout (channels in G garment
    blocks; the norms are per channel, so per garment)."""

    def __init__(self, in_c: int, out_c: int, innermost: bool = False,
                 outermost: bool = False, use_bias: bool = True, norm: str = "instance",
                 groups: int = 1):
        super().__init__()
        self.outermost = outermost
        self.conv = Conv4x4(in_c, out_c, use_bias, groups=groups)
        self.norm = None if (outermost or innermost) else make_norm(norm, out_c)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        if not self.outermost:
            x = leaky_relu(x, 0.2)
        x = self.conv(x, dtype)
        return x if self.norm is None else self.norm(x)


class Up(nn.Module):
    """[cat(x, skip)] + ReLU + ConvT4x4(s2) + norm, or + Tanh at the
    outermost level (which takes no skip, like the innermost); with
    ``groups`` the concat keeps each garment's block contiguous."""

    def __init__(self, in_c: int, out_c: int, innermost: bool = False,
                 outermost: bool = False, use_bias: bool = True, norm: str = "instance",
                 groups: int = 1):
        super().__init__()
        self.outermost = outermost
        self.groups = groups
        self.takes_skip = not (outermost or innermost)
        self.convt = ConvT4x4(in_c, out_c, True if outermost else use_bias, groups=groups)
        self.norm = None if outermost else make_norm(norm, out_c)

    def forward(self, x, skip=None, dtype: torch.dtype = torch.float32):
        if self.takes_skip and skip is not None:
            x = packed_concat(x, skip, self.groups)
        x = self.convt(torch.relu(x), dtype)
        return torch.tanh(x) if self.outermost else self.norm(x)


# ---------------------------------------------------------------------------
# antialiased resampling (binomial FIR blur), ``vts_tpu/networks/blocks.py``
# ---------------------------------------------------------------------------

_BINOMIAL = {1: [1.0], 2: [1.0, 1.0], 3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0],
             5: [1.0, 4.0, 6.0, 4.0, 1.0], 6: [1.0, 5.0, 10.0, 10.0, 5.0, 1.0],
             7: [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0]}
_PAD_MODES = {"reflect": "reflect", "refl": "reflect", "repl": "replicate",
              "replicate": "replicate", "zero": "constant"}


def binomial_filter_2d(filt_size: int) -> np.ndarray:
    """The outer product of a Pascal row with itself, summed to 1 (float32)."""
    a = np.asarray(_BINOMIAL[filt_size], dtype=np.float32)
    f = np.outer(a, a)
    return f / f.sum()


def _pad_nchw(x, pads, mode: str):
    """Pad an NCHW tensor by ``pads`` = (top, bottom, left, right) in one of
    the reference's mode names (reflect/refl, repl/replicate, zero)."""
    pt, pb, pl, pr = pads
    return F.pad(x, (pl, pr, pt, pb), mode=_PAD_MODES[mode])


def _depthwise(filt: np.ndarray, x) -> torch.Tensor:
    c = x.shape[1]
    k = torch.as_tensor(filt, device=x.device).to(x.dtype)
    return k[None, None].expand(c, 1, *filt.shape)


def blur_downsample(x, filt_size: int = 3, stride: int = 2, pad_type: str = "reflect",
                    pad_off: int = 0):
    """Antialiased downsample of NHWC ``x``: pad (asymmetric (p0, p1) by the
    filter size, reflect by default), a depthwise binomial filter, stride;
    ``filt_size`` 1 only strides (after a pad of ``pad_off``)."""
    h = _to_nchw(x)
    if filt_size == 1:
        if pad_off:
            h = _pad_nchw(h, (pad_off,) * 4, pad_type)
        return _to_nhwc(h[:, :, ::stride, ::stride])
    p0 = (filt_size - 1) // 2 + pad_off
    p1 = int(np.ceil((filt_size - 1) / 2.0)) + pad_off
    h = _pad_nchw(h, (p0, p1, p0, p1), pad_type)
    filt = binomial_filter_2d(filt_size)
    return _to_nhwc(F.conv2d(h, _depthwise(filt, h), stride=stride, groups=h.shape[1]))


def blur_upsample(x, filt_size: int = 4, stride: int = 2, pad_type: str = "repl"):
    """Antialiased upsample of NHWC ``x``: pad 1 (replicate by default), a
    transposed depthwise binomial filter × stride² at padding 1 + (filt_size
    − 1) // 2, then crop the first row and column, and the last ones too for
    an even filter."""
    h = _pad_nchw(_to_nchw(x), (1, 1, 1, 1), pad_type)
    filt = binomial_filter_2d(filt_size) * (stride ** 2)
    y = F.conv_transpose2d(h, _depthwise(filt, h), stride=stride,
                           padding=1 + (filt_size - 1) // 2, groups=h.shape[1])
    y = y[:, :, 1:, 1:]
    if filt_size % 2 == 0:
        y = y[:, :, :-1, :-1]
    return _to_nhwc(y)
