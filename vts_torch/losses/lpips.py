"""LPIPS perceptual distance (VGG16 backbone), NHWC, differentiable in x.

Counterpart of ``vts_tpu/losses/lpips.py`` at fold 1: the scaling layer
folded into conv1_1 (``_scale_folded_conv1``, with the 1-channel weight
collapse for gx/gy patches), ``vgg16_taps`` with reshape + max pools, the
composed head (normalize → diff → 1×1 lin head, eps added to the norm),
and either one 2N batch for (x, y) or, with ``y_no_grad`` (the training
losses), a separate y forward under ``torch.no_grad()`` so that no backward
is built or paid for the constant y.  VGG convs 1-3 (conv1_2 64→64,
conv2_1 64→128, conv2_2 128→128) run through kernel K1
(:mod:`vts_torch.ops.conv3x3`), whose backward is the K1 dx kernel; the
other ten are ``F.conv2d`` on NCHW views of the NHWC activations, as they
are XLA convs in the reference.  The pools are reshape + ``amax``, whose
gradient is split evenly among tied maxima as ``jnp.max``'s is (ties are
common here: masked canvases and patches are zero outside the mask, and the
folded conv1_1 bias makes a zero region a constant activation).  The TPU
layout work of the reference (folds, custom VJPs, tap caches, the factored
head) is not ported.

``dtype=torch.bfloat16`` (the ``--dtype bfloat16`` training losses) runs the
backbone as the reference's ``lpips(dtype=bf16)`` does: the inputs and the
conv weights and biases in bf16 (K1 sums in fp32 and rounds once), the taps
and the head's normalize and difference in bf16, the channel sums of the
head accumulated in fp32.  ``dtype=None`` is fp32 throughout.

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
                dtype: torch.dtype = None) -> torch.Tensor:
        """(N,) fp32 distances.  ``y_no_grad``: run y as its own forward under
        ``torch.no_grad()`` (values are the same; the backbone has no
        cross-sample ops).  ``dtype``: the backbone's compute dtype (fp32 if
        None)."""
        dt = dtype or torch.float32
        x = x.to(dt)
        y = y.to(dt)
        if y_no_grad:
            tx = self.vgg16_taps(x)
            with torch.no_grad():
                ty = self.vgg16_taps(y)
        else:
            n = x.shape[0]
            both = self.vgg16_taps(torch.cat([x, y], dim=0))
            tx, ty = [t[:n] for t in both], [t[n:] for t in both]
        total = 0.0
        for i, (a, b) in enumerate(zip(tx, ty)):
            d = (_normalize(a) - _normalize(b)).float()
            val = torch.sum(d * d * getattr(self, f"lin{i}"), dim=-1)
            total = total + torch.mean(val, dim=(1, 2))
        return total


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Channel normalize with eps added to the norm: x / (||x|| + 1e-10), the
    norm from an fp32 sum of squares, the product in t's dtype."""
    tf = t.float()
    ss = torch.sum(tf * tf, dim=-1, keepdim=True)
    return t * (1.0 / (torch.sqrt(ss) + 1e-10)).to(t.dtype)

