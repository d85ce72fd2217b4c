"""The vision-aided discriminator D3: heads on frozen CLIP features, with
sigmoid (softplus) losses.  Counterpart of ``vts_tpu/losses/vision_aided.py``.

Taps after blocks 3, 7 and 11 and the final embedding each feed one head,
LayerNorm → Dense(128) → exact GELU → Dense(1), applied per token.  Per
level: D: mean softplus(-logit_real) + mean softplus(logit_fake); G: mean
softplus(-logit_fake); summed over the levels.  Softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus`` is (``F.softplus`` switches to
the identity above 20).  The heads hold frozen parameters in the
reference's layout; the reference never steps them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..networks.clip_vit import (CLIPViT, LayerNormParams, clip_image_features,
                                 frozen_parameter, layer_norm)

TAP_LAYERS = (3, 7, 11)
HIDDEN = 128


def init_d3_head_params(seed: int = 0, width: int = 768, embed_dim: int = 512) -> Dict:
    """The reference's seeded heads, as a numpy tree (w1 then w2 per head, the
    three tap heads, then the embedding head)."""
    rng = np.random.default_rng(seed)

    def head(in_dim):
        return {
            "ln": {"scale": np.ones((in_dim,), np.float32),
                   "bias": np.zeros((in_dim,), np.float32)},
            "w1": rng.normal(0, in_dim ** -0.5, (in_dim, HIDDEN)).astype(np.float32),
            "b1": np.zeros((HIDDEN,), np.float32),
            "w2": rng.normal(0, HIDDEN ** -0.5, (HIDDEN, 1)).astype(np.float32),
            "b2": np.zeros((1,), np.float32),
        }
    return {"taps": [head(width) for _ in TAP_LAYERS], "embed": head(embed_dim)}


class _Head(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        self.ln = LayerNormParams(in_dim)
        self.w1, self.b1 = frozen_parameter(in_dim, HIDDEN), frozen_parameter(HIDDEN)
        self.w2, self.b2 = frozen_parameter(HIDDEN, 1), frozen_parameter(1)

    def forward(self, x):
        h = F.gelu(layer_norm(self.ln, x) @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2)[..., 0]


class D3Heads(nn.Module):
    def __init__(self, params: Dict = None, width: int = 768, embed_dim: int = 512):
        super().__init__()
        self.taps = nn.ModuleList(_Head(width) for _ in TAP_LAYERS)
        self.embed = _Head(embed_dim)
        if params is not None:
            from ..utils.convert_jax import d3_head_params_to_torch
            self.load_state_dict(d3_head_params_to_torch(params))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def d3_logits(clip: CLIPViT, heads: D3Heads, images: torch.Tensor) -> List[torch.Tensor]:
    """Per-token logits of the three tap heads ((N, 50) each), then the
    embedding head's ((N, 1))."""
    emb, taps = clip_image_features(clip, images, TAP_LAYERS)
    logits = [head(t) for head, t in zip(heads.taps, taps)]
    logits.append(heads.embed(emb[:, None, :]))
    return logits


def d3_d_loss(clip: CLIPViT, heads: D3Heads, real: torch.Tensor,
              fake: torch.Tensor) -> torch.Tensor:
    lr = d3_logits(clip, heads, real)
    lf = d3_logits(clip, heads, fake.detach())
    total = 0.0
    for a, b in zip(lr, lf):
        total = total + torch.mean(softplus(-a)) + torch.mean(softplus(b))
    return total * 0.5


def d3_g_loss(clip: CLIPViT, heads: D3Heads, fake: torch.Tensor) -> torch.Tensor:
    return sum(torch.mean(softplus(-l)) for l in d3_logits(clip, heads, fake))
