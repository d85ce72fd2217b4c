"""Dual-head custom U-Net — the sinskitG and skitG generator
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

Style code (skitG, ``use_style_code``): at each decoder level i ≥
num_downs − ``num_layer_style_code`` (−1: every level) a per-level style map
is merged into both branches right before the level's up stage, by channel
concat (``[h, st]``, so that stage takes the extra channels) or by AdaIN;
the map is the raw (N, style_code_dim) code tiled over the level's H × W
(``tile``) or ``style_code_mapping{num_downs − i − 1}``'s projection of it
(``project``: a bias-free linear map of the fp32 code, normalized over its
features, ReLU, reshaped to NHWC (N, H_i, W_i, C) with C = 8·ngf for AdaIN
and ngf // 2 for concat; H_i from ``input_size``).  The fork into the
tactile branch comes after the level's injection, so the first ``up{i}_T``
takes the style channels too.

Garment packing (``pack`` G > 1): G independent garments' nets in one, on
grouped convs (``groups=G``) over channel-stacked inputs (N, H, W, G·in_nc);
every level has G·its channels, in G garment blocks, the skip concats and
the tactile head's extra up stages included; the norms are per channel, so
per garment.  At ``t_mult`` 1 the net then returns one (N, H, W, G·5)
tensor, each garment's [visual 3, tactile 2] contiguous
(:func:`~vts_torch.networks.blocks.packed_concat`); at ``t_mult`` > 1 the
pair (N, H, W, G·3), (N, H·t, W·t, G·2).  A packed state dict has the keys
of a single garment's (:mod:`vts_torch.parallel.packing` maps one onto the
other).  Packing takes no style code.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import Down, Up, make_initializer, norm_uses_bias, packed_concat


def adaptive_instance_norm(content: torch.Tensor, style: torch.Tensor, eps: float = 1e-5):
    """AdaIN over NHWC with population statistics over (H, W), eps inside the
    square root (``vts_tpu/networks/unet_custom.py::adaptive_instance_norm``)."""
    c_mean = torch.mean(content, dim=(1, 2), keepdim=True)
    c_std = torch.sqrt(torch.var(content, dim=(1, 2), keepdim=True, unbiased=False) + eps)
    s_mean = torch.mean(style, dim=(1, 2), keepdim=True)
    s_std = torch.sqrt(torch.var(style, dim=(1, 2), keepdim=True, unbiased=False) + eps)
    return (content - c_mean) / c_std * s_std + s_mean


class StyleMapping(nn.Module):
    """One decoder level's style projection (``StyleMapping``): a bias-free
    linear map of the fp32 code to out_hw²·out_nc features, normalized over
    them (population variance, eps 1e-5 inside the square root), ReLU,
    reshaped to NHWC (N, out_hw, out_hw, out_nc).  ``weight`` is (out, in),
    the flax Dense kernel transposed."""

    def __init__(self, in_dim: int, out_hw: int, out_nc: int):
        super().__init__()
        self.out_hw, self.out_nc = out_hw, out_nc
        self.weight = nn.Parameter(torch.zeros(out_hw * out_hw * out_nc, in_dim))

    def reset_parameters(self, init, gen):
        o, i = self.weight.shape
        init(self.weight, i, o, gen, 0)

    def forward(self, code: torch.Tensor, dtype: torch.dtype = torch.float32):
        x = torch.nn.functional.linear(code.float().to(dtype), self.weight.to(dtype))
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True).to(dtype)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False).to(dtype)
        x = torch.relu((x - mean) / torch.sqrt(var + 1e-5))
        return x.reshape(code.shape[0], self.out_hw, self.out_hw, self.out_nc)


class CustomUNet(nn.Module):
    def __init__(self, in_nc: int, ngf: int = 10, out_nc: int = 5, num_downs: int = 8,
                 num_layer_separate: int = 4, norm_type: str = "instance",
                 use_dropout: bool = False, use_style_code: bool = False,
                 style_code_dim: int = 512, style_code_mode: str = "concat",
                 style_code_mapping_mode: str = "tile", num_layer_style_code: int = -1,
                 input_size: int = 1536, t_mult: int = 1, init_type: str = "xavier",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32, pack: int = 1):
        super().__init__()
        self.dtype = dtype
        if pack > 1 and use_style_code:
            raise NotImplementedError("style codes are per-model; packing is "
                                      "for independent per-garment models")
        if out_nc != 5:
            raise ValueError("architecture emits 3 RGB + 2 touch channels")
        if style_code_mode not in ("concat", "adain"):
            raise NotImplementedError(style_code_mode)
        if style_code_mapping_mode not in ("tile", "project"):
            raise NotImplementedError(style_code_mapping_mode)
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
        self.pack = pack
        self.use_style_code = use_style_code
        self.style_code_mode = style_code_mode
        self.style_code_mapping_mode = style_code_mapping_mode
        n_style = nd if num_layer_style_code == -1 else num_layer_style_code
        # the decoder levels that take the style code
        self.style_levels = set(range(nd - n_style, nd)) if use_style_code else set()
        nb = dict(norm=norm_type, use_bias=norm_uses_bias(norm_type), groups=pack)
        c_down = [pack * g * min(2 ** min(i, 3), 8) if i < nd // 2 else pack * g * 8
                  for i in range(nd)]
        self.style = nn.ModuleDict()
        if style_code_mapping_mode == "project":
            st_nc = g * 8 if style_code_mode == "adain" else g // 2
            for i in sorted(self.style_levels):
                self.style[f"style_code_mapping{nd - i - 1}"] = StyleMapping(
                    style_code_dim, input_size // 2 ** (i + 1), st_nc)
        else:
            st_nc = style_code_dim
        # the channels a concat adds at a style level
        st_cat = st_nc if style_code_mode == "concat" else 0
        self.down = nn.ModuleDict()
        c_prev = pack * in_nc
        for i in range(nd):
            self.down[f"down{i}"] = Down(c_prev, c_down[i], innermost=(i == nd - 1),
                                         outermost=(i == 0), **nb)
            c_prev = c_down[i]
        self.up = nn.ModuleDict()
        for i in range(nd - 1, -1, -1):
            if i == nd - 1:
                c_in = c_down[i]
            elif i == 0:
                c_in = pack * g
            else:
                c_in = pack * g * min(2 ** i, 8) + c_down[i]   # up_{i+1} output ⊕ skip_i
            if i in self.style_levels:
                c_in += st_cat
            c_out = pack * (g * min(2 ** (i - 1), 8) if i > 0 else 3)
            kw = dict(innermost=(i == nd - 1), outermost=(i == 0), **nb)
            self.up[f"up{i}"] = Up(c_in, c_out, **kw)
            if i <= num_layer_separate - 1:
                if i == 0 and t_mult > 1:
                    # the extra stages run first, so the first takes the style
                    for j in range(t_mult.bit_length() - 1):
                        self.up[f"up0_T_extra{j}"] = Up(c_in if j == 0 else pack * g, pack * g,
                                                        innermost=True, **nb)
                    c_in = pack * g
                self.up[f"up{i}_T"] = Up(c_in, c_out if i > 0 else pack * 2, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init (xavier-normal with the reference's gain by default);
        every bias starts at zero."""
        init = make_initializer(self.init_type, self.init_gain)
        for m in self.modules():
            if hasattr(m, "reset_parameters") and m is not self:
                m.reset_parameters(init, generator)

    def _style(self, i: int, code: torch.Tensor, ref: torch.Tensor, dt: torch.dtype):
        """Decoder level i's style map for the (N, H, W, ·) map ``ref``."""
        if self.style_code_mapping_mode == "tile":
            return code[:, None, None, :].expand(-1, ref.shape[1], ref.shape[2], -1)
        return self.style[f"style_code_mapping{self.num_downs - i - 1}"](code, dt)

    def _inject(self, h: torch.Tensor, st: torch.Tensor) -> torch.Tensor:
        if self.style_code_mode == "concat":
            return torch.cat([h, st], dim=-1)       # the wider dtype, as jnp.concatenate
        return adaptive_instance_norm(h, st)

    def forward(self, x: torch.Tensor, style_code: torch.Tensor = None,
                dtype: torch.dtype = None):
        """x (N, H, W, in_nc) → (visual (N, H, W, 3), tactile (N, H·t, W·t, 2));
        ``style_code`` (N, style_code_dim) is merged in when the net was built
        with ``use_style_code`` (and ignored, as by the reference, when None).
        Packed (``pack`` G > 1): x (N, H, W, G·in_nc) → (N, H, W, G·5) at
        ``t_mult`` 1, else the pair with G·3 and G·2 channels."""
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
            if style_code is not None and i in self.style_levels:
                st = self._style(i, style_code, skips[i], dt)
                h_vis = self._inject(h_vis, st)
                if h_tac is not None:
                    h_tac = self._inject(h_tac, st)
            if i <= self.num_layer_separate - 1 and h_tac is None:
                h_tac = h_vis                      # fork point
            skip = skips[i] if 0 < i < nd - 1 else None
            h_vis = self.up[f"up{i}"](h_vis, skip, dt)
            if h_tac is not None:
                if i == 0:
                    for j in range(self.t_mult.bit_length() - 1):
                        h_tac = self.up[f"up0_T_extra{j}"](h_tac, None, dt)
                h_tac = self.up[f"up{i}_T"](h_tac, skip, dt)
        if self.pack > 1 and self.t_mult == 1:
            return packed_concat(h_vis, h_tac, self.pack)
        return h_vis, h_tac
