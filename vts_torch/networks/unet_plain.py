"""Plain single-head U-Net — ``--netG unet_256`` (8 downs) and ``unet_128``
(7 downs) (``vts_tpu/networks/unet_plain.py::UnetGenerator``), NHWC in and
out.

  encoder:  down0 conv only in→g; down_i (0 < i < nd−1) LeakyReLU(0.2),
            4×4 stride-2 conv, norm; the innermost down no norm; widths
            g·min(2^min(i, 3), 8);
  decoder:  up_{nd−1} takes the innermost map; every other up_i takes
            cat(h, skip_i), the OUTERMOST one too (unlike ``CustomUNet``'s);
            ReLU, 4×4 stride-2 transposed conv, then norm (up_0: tanh, and a
            bias at any norm).

The convs have no bias under batch norm (``norm_uses_bias``).  Dropout
(p 0.5) on ups nd//2 ≤ i < nd−1 runs only when ``forward`` is given
``deterministic=False``: every model calls G with the default, so it never
fires, as in the reference.  Submodules carry the flax names: ``down{i}``
holding ``Conv_0``, ``up{i}`` holding ``ConvTranspose_0`` (the flax kernel
flipped and io-transposed), the norms ``BatchNorm_k`` in call order under
``--normG batch`` (``norm_k``, holding nothing, otherwise); a state-dict key
is the flax tree path (:mod:`vts_torch.utils.convert_jax`).  The convs run in
the net's ``dtype`` (params fp32) unless ``forward`` is given another.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm, Conv, Conv4x4, ConvT4x4, leaky_relu, make_initializer
from .resnet_gen import _Named


def _scope(name: str, module: nn.Module) -> nn.Module:
    """A flax scope holding one child ``name``."""
    scope = nn.Module()
    scope.add_module(name, module)
    return scope


class UnetGenerator(_Named):
    def __init__(self, in_nc: int, ngf: int = 64, out_nc: int = 3, num_downs: int = 8,
                 norm_type: str = "batch", use_dropout: bool = False,
                 init_type: str = "xavier", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__(norm_type)
        self.num_downs, self.use_dropout = num_downs, use_dropout
        self.init_type, self.init_gain, self.dtype = init_type, init_gain, dtype
        nd, bias = num_downs, self.use_bias
        feats = [ngf * min(2 ** min(i, 3), 8) for i in range(nd)]
        self.down_norms = {}
        for i in range(nd):
            self.add_module(f"down{i}", _scope("Conv_0", Conv4x4(
                in_nc if i == 0 else feats[i - 1], feats[i], bias)))
            if 0 < i < nd - 1:
                self.down_norms[i] = self._norm(feats[i])
        self.up_norms = {}
        for i in range(nd - 1, -1, -1):
            cin = feats[i] * (1 if i == nd - 1 else 2)
            cout = out_nc if i == 0 else feats[i - 1]
            self.add_module(f"up{i}", _scope("ConvTranspose_0", ConvT4x4(
                cin, cout, True if i == 0 else bias)))
            if i > 0:
                self.up_norms[i] = self._norm(cout)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init (xavier-normal with the reference's gain by default);
        every bias starts at zero, batch-norm scales at N(1, 0.02)."""
        init = make_initializer(self.init_type, self.init_gain)
        for m in self.modules():
            if isinstance(m, (Conv, ConvT4x4, BatchNorm)):
                m.reset_parameters(init, generator)

    def forward(self, x: torch.Tensor, style_code: torch.Tensor = None,
                dtype: torch.dtype = None, deterministic: bool = True) -> torch.Tensor:
        """x (N, H, W, in_nc) → (N, H, W, out_nc) in [-1, 1]; H and W
        multiples of 2^num_downs.  The net takes no style code (the options
        refuse ``--use_style_code`` with it)."""
        if style_code is not None:
            raise ValueError("the plain U-Net takes no style code")
        dt = dtype or self.dtype
        nd = self.num_downs
        if x.shape[1] % (2 ** nd) or x.shape[2] % (2 ** nd):
            raise ValueError(f"input spatial size {x.shape[1]}x{x.shape[2]} must be "
                             f"divisible by 2^num_downs = {2 ** nd}")
        skips, h = [], x
        for i in range(nd):
            if i > 0:
                h = leaky_relu(h, 0.2)
            h = getattr(self, f"down{i}").Conv_0(h, dt)
            if i in self.down_norms:
                h = getattr(self, self.down_norms[i])(h)
            skips.append(h)
        for i in range(nd - 1, -1, -1):
            if i < nd - 1:
                h = torch.cat([h, skips[i]], dim=-1)
            h = getattr(self, f"up{i}").ConvTranspose_0(torch.relu(h), dt)
            if i == 0:
                return torch.tanh(h)
            h = getattr(self, self.up_norms[i])(h)
            if self.use_dropout and not deterministic and nd // 2 <= i < nd - 1:
                h = F.dropout(h, 0.5, training=True)
