"""LPIPS perceptual distance (VGG16 backbone), NHWC, differentiable in x.

Counterpart of ``vts_tpu/losses/lpips.py`` at fold 1: the scaling layer
folded into conv1_1 (``_scale_folded_conv1``, with the 1-channel weight
collapse for gx/gy patches), ``vgg16_taps`` with reshape + max pools, and
either one 2N batch for (x, y) or, with ``y_no_grad`` (the training
losses), a separate y forward under ``torch.no_grad()`` so that no backward
is built or paid for the constant y.  :func:`lpips_y_taps` computes y's
taps once, and ``LPIPS.forward(..., y_taps=)`` takes them in place of the y
forward (the ``--lpips_tap_cache`` of the training step: the real canvas
never changes).  VGG convs 1-3 (conv1_2 64→64, conv2_1 64→128, conv2_2
128→128) run through kernel K1 (:mod:`vts_torch.ops.conv3x3`), whose
backward is the K1 dx kernel; the other ten are ``F.conv2d`` on NCHW views
of the NHWC activations, as they are XLA convs in the reference.  The pools
are reshape + ``amax``, whose gradient is split evenly among tied maxima as
``jnp.max``'s is (ties are common here: masked canvases and patches are
zero outside the mask, and the folded conv1_1 bias makes a zero region a
constant activation).

The head (``head_mode``): ``composed`` normalizes each tap by its channel
norm (eps added to the norm), takes the difference and the 1×1 lin head of
its square; ``factored`` (``--lpips_head factored``) computes the same sum
as rx²·Σ lin·x² + ry²·Σ lin·y² − 2·rx·ry·Σ lin·x·y with rx = 1/(‖x‖ + eps)
per pixel: three channel reductions and per-pixel fp32 scalars, no
normalized tap and no difference tensor.  The channel reductions are the
reference's custom VJPs as ``torch.autograd.Function``s (``_SumSqC``,
``_LinSqHead``, ``_WSumSqC``, ``_WDotC``): each accumulates in fp32 and
saves only its tap-dtype inputs, so no fp32 copy of a tap is kept for the
backward.  The TPU's space-to-depth folds (``--lpips_fold``,
``--lpips_fold_axis``) and the Pallas/XLA conv choice (``--lpips_conv``)
re-lay the same sums for the TPU's lanes and are not ported.

``dtype=torch.bfloat16`` (the ``--dtype bfloat16`` training losses) runs the
backbone as the reference's ``lpips(dtype=bf16)`` does: the inputs and the
conv weights and biases in bf16 (K1 sums in fp32 and rounds once), the taps
and the composed head's normalize and difference in bf16, the channel sums
of the head accumulated in fp32.  ``dtype=None`` is fp32 throughout.

Weights: ``init_lpips_params(seed)`` rebuilds the reference's deterministic
fallback parameters bit for bit (numpy ``default_rng``), and
:func:`load_lpips_weights` converts a torch checkpoint as the reference's
loader does, both as numpy arrays in the reference layout (conv HWIO);
:class:`LPIPS` holds them as torch buffers (conv OIHW) via
:func:`vts_torch.utils.convert_jax.lpips_params_to_torch`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3_bias_relu

# VGG16 conv plan: (out_channels, followed_by_pool)
_VGG16_PLAN: List[Tuple[int, bool]] = [
    (64, False), (64, True),
    (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, True),
]
_TAPS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)
_KERNEL_CONVS = (1, 2, 3)     # conv1_2, conv2_1, conv2_2 → K1

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def init_lpips_params(seed: int = 0) -> Dict:
    """Deterministic fallback parameters (random VGG, averaging heads), as
    numpy: {"conv": [{"w": (3,3,ci,co), "b": (co,)}]*13, "lin": [(c,)]*5}."""
    rng = np.random.default_rng(seed)
    params = {"conv": [], "lin": []}
    in_c = 3
    for out_c, _ in _VGG16_PLAN:
        fan_in = in_c * 9
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(3, 3, in_c, out_c)).astype(np.float32)
        params["conv"].append({"w": w, "b": np.zeros((out_c,), np.float32)})
        in_c = out_c
    for c in _TAP_CHANNELS:
        params["lin"].append(np.full((c,), 1.0 / c, np.float32))
    return params


def load_lpips_weights(path: str) -> Dict:
    """A torch checkpoint → the params tree, as ``vts_tpu/losses/lpips.py``'s
    loader: a full ``lpips.LPIPS`` state dict (``net.slice*.N.weight`` and
    ``lin*.model.1.weight`` keys), or a dict holding a torchvision vgg16
    state dict under ``'vgg'`` (``features.N.weight``) and the five lin
    heads under ``'lins'``."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "vgg" in sd:
        vgg_sd, lins = sd["vgg"], sd["lins"]
    else:
        vgg_sd, lins = sd, sd

    def host(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    def grab(keys):
        for k in keys:
            if k in vgg_sd:
                return host(vgg_sd[k])
        raise KeyError(keys)

    # torchvision indices of vgg16.features' 13 convs, and the lpips slice of each
    tv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    params = {"conv": [], "lin": []}
    for li in tv_idx:
        s = 1 + sum(li >= b for b in (4, 9, 16, 23))
        w = grab([f"features.{li}.weight", f"net.slice{s}.{li}.weight"])
        b = grab([f"features.{li}.bias", f"net.slice{s}.{li}.bias"])
        params["conv"].append({"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)), "b": b})
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight", f"lin{i}.weight"):
            if key in lins:
                params["lin"].append(host(lins[key]).reshape(-1))
                break
        else:
            raise KeyError(f"lin head {i} not found in checkpoint")
    return params


def conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, b: torch.Tensor,
              stride: int = 1, padding: int = 1) -> torch.Tensor:
    """``F.conv2d`` on the NCHW view of an NHWC tensor; NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, stride=stride, padding=padding)
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _max_pool_2x2(h: torch.Tensor) -> torch.Tensor:
    """2×2/s2 VALID max pool as reshape + amax (an odd trailing row/col is
    dropped); a tie's gradient is split evenly, as the reference's."""
    n, hh, ww, c = h.shape
    h = h[:, :hh // 2 * 2, :ww // 2 * 2, :]
    return torch.amax(h.reshape(n, hh // 2, 2, ww // 2, 2, c), dim=(2, 4))


class LPIPS(nn.Module):
    """Frozen LPIPS(vgg): ``forward(x, y)`` → (N,) distances for NHWC inputs
    in [-1, 1] with 1 or 3 channels."""

    def __init__(self, params: Dict = None):
        super().__init__()
        for i, (out_c, _) in enumerate(_VGG16_PLAN):
            in_c = 3 if i == 0 else _VGG16_PLAN[i - 1][0]
            self.register_buffer(f"conv{i}_weight", torch.zeros(out_c, in_c, 3, 3))
            self.register_buffer(f"conv{i}_bias", torch.zeros(out_c))
        for i, c in enumerate(_TAP_CHANNELS):
            self.register_buffer(f"lin{i}", torch.zeros(c))
        self.register_buffer("inv_scale", torch.from_numpy(1.0 / _SCALE), persistent=False)
        self.register_buffer("shift_over_scale", torch.from_numpy(_SHIFT / _SCALE),
                             persistent=False)
        if params is not None:
            from ..utils.convert_jax import lpips_params_to_torch
            self.load_state_dict(lpips_params_to_torch(params))

    def _scale_folded_conv1(self, in_c: int):
        """conv(w, (x - shift)/scale) + b == conv(w/scale, x) + (b - Σ w·shift/scale);
        a 1-channel input sums the three weight planes (torch broadcast of
        gray x against the 3-channel shift)."""
        w = self.conv0_weight                                   # (64, 3, 3, 3) OIHW
        w1 = w * self.inv_scale[None, :, None, None]
        b1 = self.conv0_bias - torch.einsum("oihw,i->o", w, self.shift_over_scale)
        if in_c == 1:
            w1 = torch.sum(w1, dim=1, keepdim=True)
        return w1, b1

    def vgg16_taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The 5 post-ReLU tap activations, NHWC, computed in x's dtype."""
        taps = []
        w0, b0 = self._scale_folded_conv1(x.shape[-1])
        h, dt = x, x.dtype

        def conv(h, w, b):
            if dt == torch.float32:
                return conv_nhwc(h, w, b)
            return conv_nhwc(h, w.to(dt), None) + b.to(dt)

        for i, (_, pool) in enumerate(_VGG16_PLAN):
            w = getattr(self, f"conv{i}_weight")
            b = getattr(self, f"conv{i}_bias")
            if i == 0:
                h = torch.relu(conv(h, w0, b0))
            elif i in _KERNEL_CONVS:
                h = conv3x3_bias_relu(h, w.permute(2, 3, 1, 0).to(dt).contiguous(), b.to(dt),
                                      relu=True)
            else:
                h = torch.relu(conv(h, w, b))
            if i in _TAPS:
                taps.append(h)
            if pool and i != len(_VGG16_PLAN) - 1:   # the last pool feeds no tap
                h = _max_pool_2x2(h)
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor, y_no_grad: bool = False,
                dtype: torch.dtype = None, y_taps: Tuple[torch.Tensor, ...] = None,
                head_mode: str = "composed") -> torch.Tensor:
        """(N,) fp32 distances.  ``y_no_grad``: run y as its own forward under
        ``torch.no_grad()`` (values are the same; the backbone has no
        cross-sample ops).  ``dtype``: the backbone's compute dtype (fp32 if
        None).  ``y_taps``: y's taps from :func:`lpips_y_taps` at the same
        dtype and size, in place of the y forward (y is then not read; they
        imply ``y_no_grad``).  ``head_mode``: ``composed`` or ``factored``."""
        if head_mode not in ("composed", "factored"):
            raise ValueError(f"head_mode must be composed or factored, got {head_mode!r}")
        dt = dtype or torch.float32
        x = x.to(dt)
        if y_taps is not None:
            if not y_no_grad:
                raise ValueError("y_taps implies y_no_grad=True; pass y instead if "
                                 "gradients through the reference are needed")
            tx = self.vgg16_taps(x)
            ty = [t.detach() for t in y_taps]
            if [tuple(t.shape) for t in ty] != [tuple(t.shape) for t in tx] \
                    or any(t.dtype != a.dtype for t, a in zip(ty, tx)):
                raise ValueError("y_taps shapes don't match this call's x taps — recompute "
                                 "them with lpips_y_taps at the same (dtype, H, W)")
        elif y_no_grad:
            tx = self.vgg16_taps(x)
            with torch.no_grad():
                ty = self.vgg16_taps(y.to(dt))
        else:
            n = x.shape[0]
            both = self.vgg16_taps(torch.cat([x, y.to(dt)], dim=0))
            tx, ty = [t[:n] for t in both], [t[n:] for t in both]
        total = 0.0
        for i, (a, b) in enumerate(zip(tx, ty)):
            lin = getattr(self, f"lin{i}")
            if head_mode == "factored":
                ra = 1.0 / (torch.sqrt(_SumSqC.apply(a)) + 1e-10)
                rb = 1.0 / (torch.sqrt(_SumSqC.apply(b)) + 1e-10)
                val = (torch.square(ra) * _WSumSqC.apply(a, lin)
                       + torch.square(rb) * _WSumSqC.apply(b, lin)
                       - (2.0 * ra * rb) * _WDotC.apply(a, b, lin))[..., 0]
            else:
                val = _LinSqHead.apply(_normalize(a) - _normalize(b), lin)
            total = total + torch.mean(val, dim=(1, 2))
        return total


def lpips_y_taps(net: LPIPS, y: torch.Tensor, dtype: torch.dtype = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The VGG taps of a constant reference image y, without gradient, for
    ``net(x, None, y_no_grad=True, dtype=dtype, y_taps=...)``: the same
    arrays the y forward of that call computes (``dtype`` as there; K1 on a
    CUDA tensor)."""
    with torch.no_grad():
        return tuple(net.vgg16_taps(y.to(dtype or torch.float32)))


class _SumSqC(torch.autograd.Function):
    """Σ_c t², fp32 accumulation, (N, H, W, C) → (N, H, W, 1); saves t in its
    own dtype, not an fp32 copy (the reference's ``_sumsq_c``)."""

    @staticmethod
    def forward(ctx, t):
        ctx.save_for_backward(t)
        tf = t.float()
        return torch.sum(tf * tf, dim=-1, keepdim=True)

    @staticmethod
    def backward(ctx, g):
        t, = ctx.saved_tensors
        return (2.0 * g * t.float()).to(t.dtype)


class _LinSqHead(torch.autograd.Function):
    """Σ_c lin_c·δ_c², fp32 accumulation, (N, H, W, C) → (N, H, W); saves δ in
    its own dtype (the reference's ``_lin_sq_head``; lin is frozen)."""

    @staticmethod
    def forward(ctx, delta, lin):
        ctx.save_for_backward(delta, lin)
        d = delta.float()
        return torch.sum(d * d * lin.float(), dim=-1)

    @staticmethod
    def backward(ctx, g):
        delta, lin = ctx.saved_tensors
        return ((2.0 * g[..., None]) * lin.float() * delta.float()).to(delta.dtype), None


class _WSumSqC(torch.autograd.Function):
    """Σ_c lin_c·t_c², fp32 accumulation, → (N, H, W, 1) (``_wsumsq_c``)."""

    @staticmethod
    def forward(ctx, t, lin):
        ctx.save_for_backward(t, lin)
        tf = t.float()
        return torch.sum(tf * tf * lin.float(), dim=-1, keepdim=True)

    @staticmethod
    def backward(ctx, g):
        t, lin = ctx.saved_tensors
        return ((2.0 * g) * lin.float() * t.float()).to(t.dtype), None


class _WDotC(torch.autograd.Function):
    """Σ_c lin_c·x_c·y_c, fp32 accumulation, → (N, H, W, 1) (``_wdot_c``)."""

    @staticmethod
    def forward(ctx, x, y, lin):
        ctx.save_for_backward(x, y, lin)
        return torch.sum(x.float() * y.float() * lin.float(), dim=-1, keepdim=True)

    @staticmethod
    def backward(ctx, g):
        x, y, lin = ctx.saved_tensors
        gl = g * lin.float()
        gx = (gl * y.float()).to(x.dtype) if ctx.needs_input_grad[0] else None
        gy = (gl * x.float()).to(y.dtype) if ctx.needs_input_grad[1] else None
        return gx, gy, None


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Channel normalize with eps added to the norm: x / (||x|| + 1e-10), the
    norm from an fp32 sum of squares, the product in t's dtype."""
    return t * (1.0 / (torch.sqrt(_SumSqC.apply(t)) + 1e-10)).to(t.dtype)
