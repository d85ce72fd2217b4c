"""PatchGAN discriminators (``vts_tpu/networks/discriminators.py``), NHWC.

``NLayerDiscriminator``: 4×4 convs with pad 2 — stride 2 × n_layers, then a
stride-1 conv and the 1-channel stride-1 logit head — with LeakyReLU(0.2)
and a batch norm (``normD batch``, the only D norm ported) after every conv
but the first and the head; channels ndf, 2·ndf,
… capped at 512.  ``MultiscaleDiscriminator``: num_D such heads on a ×2
average-pool pyramid; its output is a list over scales (finest first) of
feature lists whose last entry is the logit map (the logit map alone unless
``get_interm_feat``).

Submodules carry the reference's flax names (``scale2``, ``Conv4x4_0``,
``BatchNorm_0``, …) so a state-dict key is the flax tree path
(:mod:`vts_torch.utils.convert_jax`).  ``forward(x, update_stats)`` passes
``update_stats`` to every batch norm: the G-loss pass through D uses batch
statistics and keeps the running ones as they were, as the reference does.
The convs run in the net's ``dtype`` (bf16 under ``--dtype bfloat16``, params
fp32); the pyramid pools the input in the dtype it comes in.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .blocks import BatchNorm, Conv4x4, avg_pool_3x3_s2_nopad_count, leaky_relu


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_c: int, ndf: int = 64, n_layers: int = 3, norm_type: str = "batch",
                 use_sigmoid: bool = False, get_interm_feat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if norm_type != "batch":
            raise NotImplementedError(f"D norm {norm_type!r} is not ported yet (only batch)")
        self.n_layers = n_layers
        self.use_sigmoid = use_sigmoid
        self.get_interm_feat = get_interm_feat
        self.add_module("Conv4x4_0", Conv4x4(in_c, ndf, stride=2, padding=2))
        nf = ndf
        for i in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"Conv4x4_{i}", Conv4x4(prev, nf, stride=2, padding=2))
            self.add_module(f"BatchNorm_{i - 1}", BatchNorm(nf))
        prev, nf = nf, min(nf * 2, 512)
        self.add_module(f"Conv4x4_{n_layers}", Conv4x4(prev, nf, stride=1, padding=2))
        self.add_module(f"BatchNorm_{n_layers - 1}", BatchNorm(nf))
        self.add_module(f"Conv4x4_{n_layers + 1}", Conv4x4(nf, 1, stride=1, padding=2))

    def forward(self, x, update_stats: bool = True):
        feats: List[torch.Tensor] = []
        h = leaky_relu(self.Conv4x4_0(x, self.dtype), 0.2)
        feats.append(h)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"Conv4x4_{i}")(h, self.dtype)
            h = leaky_relu(getattr(self, f"BatchNorm_{i - 1}")(h, update_stats), 0.2)
            feats.append(h)
        h = getattr(self, f"Conv4x4_{self.n_layers + 1}")(h, self.dtype)
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


def reset_parameters(net: nn.Module, init, gen: torch.Generator) -> None:
    """Seeded init of a discriminator: every conv weight from ``init`` with the
    reference's flax fans, conv biases zero, batch-norm scales N(1, 0.02)."""
    for m in net.modules():
        if isinstance(m, (Conv4x4, BatchNorm)):
            m.reset_parameters(init, gen)
