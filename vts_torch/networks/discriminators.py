"""PatchGAN discriminators (``vts_tpu/networks/discriminators.py``), NHWC.

``NLayerDiscriminator``: 4×4 convs with pad 2 — stride 2 × n_layers, then a
stride-1 conv and the 1-channel stride-1 logit head — with LeakyReLU(0.2)
and a norm (``--normD``: batch, instance or none) after every conv but the
first and the head; channels ndf, 2·ndf, … capped at 512.
With ``--normD spectral{instance,batch,none}`` (SPADE's Ds) the five convs
are ``SpectralConv_{0..4}`` (:class:`~vts_torch.networks.spade_nets.SpectralConv`,
pad 2) and the norm after them is the rest of the name.
``MultiscaleDiscriminator``: num_D such heads on a ×2 average-pool pyramid;
its output is a list over scales (finest first) of feature lists whose last
entry is the logit map (the logit map alone unless ``get_interm_feat``).
``PixelDiscriminator``: 1×1 convs ndf → 2·ndf → 1.  ``PatchDiscriminator``:
the input cut into 16×16 tiles, a 2-layer NLayer head on the tile batch.
The single Ds return the logit map (an NLayer's feature list with
``get_interm_feat``).

Submodules carry the reference's flax names (``scale2``, ``Conv4x4_0``,
``BatchNorm_0``, ``conv0``, ``head``, …) so a state-dict key is the flax tree
path (:mod:`vts_torch.utils.convert_jax`); an instance or no norm has no
entries; a spectral conv's ``u`` is ``<scale>.SpectralConv_j.u``.
``forward(x, update_stats)`` passes ``update_stats`` to every batch norm and
spectral conv: the G-loss pass and the gradient penalty's pass through D use
batch statistics (and σ from the stored ``u``) and keep the running ones
(and ``u``) as they were, as the reference does.  The convs run in the net's ``dtype`` (bf16 under ``--dtype
bfloat16``, params fp32); the pyramid pools the input in the dtype it comes
in.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .blocks import BatchNorm, Conv, Conv4x4, avg_pool_3x3_s2_nopad_count, leaky_relu, make_norm
from .spade_nets import SpectralConv


def _norm_name(norm_type: str, i: int) -> str:
    """The flax name of the i-th norm: only a batch norm has parameters (and a
    name in the tree)."""
    return f"BatchNorm_{i}" if norm_type == "batch" else f"norm_{i}"


def split_spectral(norm_type: str):
    """SPADE's D norms: ``spectralinstance`` → (True, "instance"); a bare
    ``spectral`` is the spectral norm with no norm after it."""
    if norm_type.startswith("spectral"):
        return True, norm_type[len("spectral"):] or "none"
    return False, norm_type


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_c: int, ndf: int = 64, n_layers: int = 3, norm_type: str = "batch",
                 use_sigmoid: bool = False, get_interm_feat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        self.use_sigmoid = use_sigmoid
        self.get_interm_feat = get_interm_feat
        self.spectral, norm_type = split_spectral(norm_type)
        kind = "SpectralConv" if self.spectral else "Conv4x4"
        self.convs = [f"{kind}_{i}" for i in range(n_layers + 2)]
        self.norms = [_norm_name(norm_type, i) for i in range(n_layers)]

        def conv4(in_c, out_c, stride):
            if self.spectral:
                return SpectralConv(in_c, out_c, 4, stride=stride, padding=2)
            return Conv4x4(in_c, out_c, stride=stride, padding=2)

        self.add_module(self.convs[0], conv4(in_c, ndf, 2))
        nf = ndf
        for i in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(self.convs[i], conv4(prev, nf, 2))
            self.add_module(self.norms[i - 1], make_norm(norm_type, nf))
        prev, nf = nf, min(nf * 2, 512)
        self.add_module(self.convs[n_layers], conv4(prev, nf, 1))
        self.add_module(self.norms[n_layers - 1], make_norm(norm_type, nf))
        self.add_module(self.convs[n_layers + 1], conv4(nf, 1, 1))

    def _conv(self, i: int, h, update_stats: bool):
        conv = getattr(self, self.convs[i])
        return conv(h, self.dtype, update_stats) if self.spectral else conv(h, self.dtype)

    def forward(self, x, update_stats: bool = True):
        feats: List[torch.Tensor] = []
        h = leaky_relu(self._conv(0, x, update_stats), 0.2)
        feats.append(h)
        for i in range(1, self.n_layers + 1):
            h = self._conv(i, h, update_stats)
            h = leaky_relu(getattr(self, self.norms[i - 1])(h, update_stats), 0.2)
            feats.append(h)
        h = self._conv(self.n_layers + 1, h, update_stats)
        if self.use_sigmoid:
            h = torch.sigmoid(h)
        feats.append(h)
        return feats if self.get_interm_feat else h


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, in_c: int, ndf: int = 64, n_layers: int = 3, num_D: int = 3,
                 norm_type: str = "batch", use_sigmoid: bool = False,
                 get_interm_feat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_D = num_D
        self.get_interm_feat = get_interm_feat
        for i in range(num_D):
            self.add_module(f"scale{num_D - 1 - i}", NLayerDiscriminator(
                in_c, ndf, n_layers, norm_type, use_sigmoid, get_interm_feat=True, dtype=dtype))

    def forward(self, x, update_stats: bool = True):
        results = []
        h = x
        for i in range(self.num_D):
            out = getattr(self, f"scale{self.num_D - 1 - i}")(h, update_stats)
            results.append(out if self.get_interm_feat else [out[-1]])
            if i != self.num_D - 1:
                h = avg_pool_3x3_s2_nopad_count(h)
        return results


class PixelDiscriminator(nn.Module):
    """1×1 PatchGAN: conv ndf, LeakyReLU, conv 2·ndf, norm, LeakyReLU, conv 1."""

    def __init__(self, in_c: int, ndf: int = 64, norm_type: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv(in_c, ndf, 1)
        self.conv1 = Conv(ndf, ndf * 2, 1)
        self.norm = _norm_name(norm_type, 0)
        self.add_module(self.norm, make_norm(norm_type, ndf * 2))
        self.conv2 = Conv(ndf * 2, 1, 1)

    def forward(self, x, update_stats: bool = True):
        h = leaky_relu(self.conv0(x, self.dtype), 0.2)
        h = leaky_relu(getattr(self, self.norm)(self.conv1(h, self.dtype), update_stats), 0.2)
        return self.conv2(h, self.dtype)


class PatchDiscriminator(nn.Module):
    """16×16 tiles of the input (row-major per image) through a 2-layer
    NLayer head: (N, H, W, C) → (N·(H/16)·(W/16), …) logits."""

    def __init__(self, in_c: int, ndf: int = 64, norm_type: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = NLayerDiscriminator(in_c, ndf, 2, norm_type, dtype=dtype)

    def forward(self, x, update_stats: bool = True):
        n, hh, ww, c = x.shape
        size = 16
        y, xb = hh // size, ww // size
        tiles = x.reshape(n, y, size, xb, size, c).permute(0, 1, 3, 2, 4, 5)
        return self.head(tiles.reshape(n * y * xb, size, size, c), update_stats)


def reset_parameters(net: nn.Module, init, gen: torch.Generator) -> None:
    """Seeded init of a discriminator: every conv weight from ``init`` with the
    reference's flax fans, conv biases zero, batch-norm scales N(1, 0.02); a
    D with a seeded ``reset_parameters(generator)`` of its own (the StyleGAN2
    D, whose equalized weights ignore ``init``) takes that."""
    if hasattr(type(net), "reset_parameters"):
        net.reset_parameters(gen)
        return
    for m in net.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset_parameters(init, gen)
