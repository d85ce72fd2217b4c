"""InceptionV3 block 0 — the SIFID backbone (``vts_tpu/metrics/inception.py``).

Conv2d_1a_3x3 (s2) → Conv2d_2a_3x3 → Conv2d_2b_3x3 (pad 1), each followed by
an eval-mode BatchNorm (eps 1e-3) and ReLU; no maxpool, no input resize.
``init_inception_params(seed)`` rebuilds the reference's deterministic
fallback weights bit for bit (numpy, conv HWIO), and
:func:`load_inception_weights` converts a torchvision ``inception_v3``
checkpoint as the reference's loader does; :class:`InceptionBlock0` holds
either as torch buffers (conv OIHW)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from ..losses.lpips import conv_nhwc

# (name, out_c, kernel, stride, pad)
_BLOCK0 = [
    ("Conv2d_1a_3x3", 32, 3, 2, 0),
    ("Conv2d_2a_3x3", 32, 3, 1, 0),
    ("Conv2d_2b_3x3", 64, 3, 1, 1),
]
_BN_EPS = 1e-3
_BN_FIELDS = ("scale", "bias", "mean", "var")


def init_inception_params(seed: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    params = {}
    in_c = 3
    for name, out_c, k, _, _ in _BLOCK0:
        fan_in = in_c * k * k
        params[name] = {
            "w": rng.normal(0, np.sqrt(2.0 / fan_in), (k, k, in_c, out_c)).astype(np.float32),
            "scale": np.ones((out_c,), np.float32),
            "bias": np.zeros((out_c,), np.float32),
            "mean": np.zeros((out_c,), np.float32),
            "var": np.ones((out_c,), np.float32),
        }
        in_c = out_c
    return params


def load_inception_weights(path: str) -> Dict:
    """A torchvision ``inception_v3`` state dict (``Conv2d_1a_3x3.conv.weight``,
    ``Conv2d_1a_3x3.bn.running_mean``, ...) → the params tree."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()

    def g(key):
        v = sd[key]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    return {name: {"w": np.ascontiguousarray(g(f"{name}.conv.weight").transpose(2, 3, 1, 0)),
                   "scale": g(f"{name}.bn.weight"), "bias": g(f"{name}.bn.bias"),
                   "mean": g(f"{name}.bn.running_mean"), "var": g(f"{name}.bn.running_var")}
            for name, *_ in _BLOCK0}


class InceptionBlock0(nn.Module):
    """``forward(x, normalize_input)``: (N, H, W, 3) → (N, h, w, 64) features at
    the input's native resolution.  ``normalize_input`` maps [0,1] → [-1,1]."""

    def __init__(self, params: Dict = None):
        super().__init__()
        in_c = 3
        for name, out_c, k, _, _ in _BLOCK0:
            self.register_buffer(f"{name}_weight", torch.zeros(out_c, in_c, k, k))
            for f in _BN_FIELDS:
                self.register_buffer(f"{name}_{f}", torch.zeros(out_c))
            in_c = out_c
        if params is not None:
            from ..utils.convert_jax import inception_params_to_torch
            self.load_state_dict(inception_params_to_torch(params))

    def forward(self, x: torch.Tensor, normalize_input: bool = True) -> torch.Tensor:
        x = x.float()
        if normalize_input:
            x = x * 2.0 - 1.0
        for name, _, _, stride, pad in _BLOCK0:
            g = lambda f: getattr(self, f"{name}_{f}")
            x = conv_nhwc(x, g("weight"), None, stride=stride, padding=pad)
            x = (x - g("mean")) * torch.rsqrt(g("var") + _BN_EPS) * g("scale") + g("bias")
            x = torch.relu(x)
        return x

