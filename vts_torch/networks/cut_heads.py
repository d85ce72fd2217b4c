"""CUT feature-sampling heads, PatchNCE and the gram-matrix texture loss
(``vts_tpu/networks/cut_heads.py``), NHWC.  No shipped model wires them;
they are building blocks for the library surface, as in the reference.

  * :class:`PoolingF`, :class:`ReshapeF`, :class:`StridedConvF`,
    :class:`PatchSampleF` (the ``define_F`` heads);
  * :func:`patch_nce_loss` (PatchNCE), :func:`gram_matrix` and
    :func:`texture_loss`.

flax creates ``StridedConvF``'s convs and ``PatchSampleF``'s MLP at the first
call, from the input's height and channels; here those sizes are given at
construction.  Parameter names are flax's (``Conv_i``, ``mlp_i_j``), so
:func:`vts_torch.utils.convert_jax.cut_head_params_to_torch` maps a flax tree
one for one.  Kernels and Dense weights initialize as flax's default (lecun
normal), biases at 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import make_initializer


def l2_normalize(x: torch.Tensor, dim: int = -1, power: float = 2,
                 eps: float = 1e-7) -> torch.Tensor:
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), power), dim=dim, keepdim=True),
                     1.0 / power)
    return x / (norm + eps)


def _lecun(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    init = make_initializer("none", 1.0)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            init(m.weight, m.weight[0].numel(), m.weight.shape[0], generator)
            nn.init.zeros_(m.bias)


class PoolingF(nn.Module):
    """The max over (H, W), L2-normalized: (N, H, W, C) → (N, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(torch.amax(x, dim=(1, 2)))


class ReshapeF(nn.Module):
    """An average pool to a 4×4 grid (windows of ⌊side/4⌋, at least 1, no
    padding), flattened to tokens and L2-normalized: (N, H, W, C) →
    (N, tokens, C), tokens in row-major order."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        k = (h // 4 or 1, w // 4 or 1)
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, k)
        return l2_normalize(y.permute(0, 2, 3, 1).reshape(n, -1, c))


class StridedConvF(nn.Module):
    """Stride-2 3×3 convs (pad 1) with ReLU, each halving the channels (at
    least 64), until the height is at most 64; flattened and L2-normalized.
    ``in_channels`` and ``height``: the input's, which fix the stack."""

    def __init__(self, in_channels: int, height: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.height = height
        self.n_convs = 0
        h, c = height, in_channels
        while h > 64:
            out = max(c // 2, 64)
            self.add_module(f"Conv_{self.n_convs}", nn.Conv2d(c, out, 3, 2, 1))
            h, c = (h - 1) // 2 + 1, out
            self.n_convs += 1
        _lecun(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.height:
            raise ValueError(f"StridedConvF was built for height {self.height}, got "
                             f"{x.shape[1]}")
        h = x.permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            h = F.relu(getattr(self, f"Conv_{i}")(h))
        return l2_normalize(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))


class PatchSampleF(nn.Module):
    """``num_patches`` locations of each feature map (the same for the whole
    batch), optionally through a 2-layer MLP of width ``nc`` (then
    ``in_channels``, each map's channels, are needed), L2-normalized.

    ``forward(feats, generator, patch_ids)`` returns the sampled features,
    one (N·P, C) tensor a map, and the locations: ``patch_ids[i]`` when given
    (e.g. to reuse a query's locations for its keys), else the first
    ``min(num_patches, H·W)`` of a random permutation of the map's H·W
    positions from ``generator``."""

    def __init__(self, use_mlp: bool = False, nc: int = 256, num_patches: int = 256,
                 in_channels: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_mlp, self.nc, self.num_patches = use_mlp, nc, num_patches
        if use_mlp:
            if not in_channels:
                raise ValueError("PatchSampleF(use_mlp=True) needs in_channels")
            for i, c in enumerate(in_channels):
                self.add_module(f"mlp_{i}_0", nn.Linear(c, nc))
                self.add_module(f"mlp_{i}_1", nn.Linear(nc, nc))
            _lecun(self, generator)

    def forward(self, feats: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None,
                patch_ids: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        out_feats, out_ids = [], []
        for i, feat in enumerate(feats):
            n, h, w, c = feat.shape
            tokens = feat.reshape(n, h * w, c)
            if patch_ids is not None:
                ids = torch.as_tensor(patch_ids[i], dtype=torch.long, device=feat.device)
            else:
                ids = torch.randperm(h * w, generator=generator)[:min(self.num_patches, h * w)]
                ids = ids.to(feat.device)
            sample = tokens[:, ids, :].reshape(-1, c)
            if self.use_mlp:
                sample = getattr(self, f"mlp_{i}_1")(F.relu(getattr(self, f"mlp_{i}_0")(sample)))
            out_feats.append(l2_normalize(sample))
            out_ids.append(ids)
        return out_feats, out_ids


def patch_nce_loss(feat_q: torch.Tensor, feat_k: torch.Tensor, nce_T: float = 0.07,
                   batch_size: int = 1) -> torch.Tensor:
    """PatchNCE: each query's positive is its key, its negatives the other
    keys of its image (the diagonal masked to −10), cross-entropy at
    temperature ``nce_T``.  The keys take no gradient.  (N, D) each →
    per-patch losses (N,)."""
    feat_k = feat_k.detach()
    n, dim = feat_q.shape
    l_pos = torch.sum(feat_q * feat_k, dim=-1, keepdim=True)
    per_img = n // batch_size
    q = feat_q.reshape(batch_size, per_img, dim)
    k = feat_k.reshape(batch_size, per_img, dim)
    l_neg = torch.einsum("bid,bjd->bij", q, k)
    mask = torch.eye(per_img, dtype=torch.bool, device=feat_q.device)[None]
    l_neg = l_neg.masked_fill(mask, -10.0).reshape(n, per_img)
    logits = torch.cat([l_pos, l_neg], dim=1) / nce_T
    return -torch.log_softmax(logits, dim=1)[:, 0]


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → the (N, C, C) gram matrix over the positions, divided
    by H·W·C."""
    n, h, w, c = feat.shape
    f = feat.reshape(n, h * w, c)
    return torch.einsum("npc,npd->ncd", f, f) / (h * w * c)


def texture_loss(feats_fake: Sequence[torch.Tensor],
                 feats_real: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over the feature pairs of the mean squared difference of their
    gram matrices; the real side takes no gradient."""
    total = 0.0
    for a, b in zip(feats_fake, feats_real):
        total = total + torch.mean((gram_matrix(a) - gram_matrix(b.detach())) ** 2)
    return total
