"""Dual-head custom U-Net — the sinskitG generator
(``vts_tpu/networks/unet_custom.py::CustomUNet``), NHWC in and out.

  encoder:  down0 conv only in→g; down1..3 g→2g→4g→8g; down4..6 8g→8g;
            down7 innermost 8g→8g (no norm)
  decoder:  up7 innermost (no skip); up6..up1 take cat(x, skip_i);
            up0 outermost → 3 (tanh, no skip)
  The top ``num_layer_separate`` decoder levels are duplicated into a
  tactile branch (``up{i}_T``), forked right before level
  ``num_layer_separate − 1``; the net returns the pair (visual 3, tactile 2).
  Tactile super-resolution (``t_mult`` 2, 4, …, a power of two): log2(t_mult)
  extra innermost-style up stages ``up0_T_extra{j}`` (g → g, no skip) run
  before ``up0_T``, so the tactile head comes out at t_mult× the canvas.
``norm_type`` is ``instance`` (the shipped G), ``batch`` (running stats in
eval mode; its convs have no bias, as the reference's) or ``none``.
``use_dropout`` builds nothing: the reference's dropout layers are always
deterministic (its sinskit never passes ``deterministic=False``), so they
are inert in training and eval alike.
The convs run in the net's ``dtype`` (bf16 under ``--dtype bfloat16``, params
fp32) unless ``forward`` is given another: the eval forward passes fp32.

The style-code and garment-packing branches of the reference are not
ported yet and raise.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import Down, Up, make_initializer, norm_uses_bias


class CustomUNet(nn.Module):
    def __init__(self, in_nc: int, ngf: int = 10, out_nc: int = 5, num_downs: int = 8,
                 num_layer_separate: int = 4, norm_type: str = "instance",
                 use_dropout: bool = False, use_style_code: bool = False,
                 t_mult: int = 1, init_type: str = "xavier", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if out_nc != 5:
            raise ValueError("architecture emits 3 RGB + 2 touch channels")
        if use_style_code:
            raise NotImplementedError("CustomUNet port: style codes are not ported yet")
        if t_mult < 1 or t_mult & (t_mult - 1):
            raise ValueError(f"t_mult={t_mult} must be a power of two: the tactile head gains "
                             f"bit_length-1 extra up stages")
        if num_layer_separate < 1:
            raise NotImplementedError("CustomUNet port: num_layer_separate must be >= 1")
        g = ngf
        nd = num_downs
        self.num_downs = nd
        self.num_layer_separate = num_layer_separate
        self.init_type, self.init_gain = init_type, init_gain
        self.t_mult = t_mult
        nb = dict(norm=norm_type, use_bias=norm_uses_bias(norm_type))
        c_down = [g * min(2 ** min(i, 3), 8) if i < nd // 2 else g * 8 for i in range(nd)]
        self.down = nn.ModuleDict()
        c_prev = in_nc
        for i in range(nd):
            self.down[f"down{i}"] = Down(c_prev, c_down[i], innermost=(i == nd - 1),
                                         outermost=(i == 0), **nb)
            c_prev = c_down[i]
        self.up = nn.ModuleDict()
        for i in range(nd - 1, -1, -1):
            if i == nd - 1:
                c_in = c_down[i]
            elif i == 0:
                c_in = g
            else:
                c_in = g * min(2 ** i, 8) + c_down[i]   # up_{i+1} output ⊕ skip_i
            c_out = g * min(2 ** (i - 1), 8) if i > 0 else 3
            kw = dict(innermost=(i == nd - 1), outermost=(i == 0), **nb)
            self.up[f"up{i}"] = Up(c_in, c_out, **kw)
            if i <= num_layer_separate - 1:
                if i == 0:
                    for j in range(t_mult.bit_length() - 1):
                        self.up[f"up0_T_extra{j}"] = Up(g, g, innermost=True, **nb)
                self.up[f"up{i}_T"] = Up(c_in, c_out if i > 0 else 2, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init (xavier-normal with the reference's gain by default);
        every bias starts at zero."""
        init = make_initializer(self.init_type, self.init_gain)
        for m in self.modules():
            if hasattr(m, "reset_parameters") and m is not self:
                m.reset_parameters(init, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = None):
        dt = dtype or self.dtype
        nd = self.num_downs
        if x.shape[1] % (2 ** nd) or x.shape[2] % (2 ** nd):
            raise ValueError(f"input spatial size {x.shape[1]}x{x.shape[2]} must be "
                             f"divisible by 2^num_downs = {2 ** nd}")
        skips = []
        h = x
        for i in range(nd):
            h = self.down[f"down{i}"](h, dt)
            skips.append(h)
        h_vis = skips[nd - 1]
        h_tac = None
        for i in range(nd - 1, -1, -1):
            if i <= self.num_layer_separate - 1 and h_tac is None:
                h_tac = h_vis                      # fork point
            skip = skips[i] if 0 < i < nd - 1 else None
            h_vis = self.up[f"up{i}"](h_vis, skip, dt)
            if h_tac is not None:
                if i == 0:
                    for j in range(self.t_mult.bit_length() - 1):
                        h_tac = self.up[f"up0_T_extra{j}"](h_tac, None, dt)
                h_tac = self.up[f"up{i}_T"](h_tac, skip, dt)
        return h_vis, h_tac
