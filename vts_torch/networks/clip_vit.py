"""CLIP ViT-B/32 image tower, frozen: the backbone of the vision-aided D3
and the skitG style encoder (:func:`clip_style_code`, its 512-d embedding).
Counterpart of ``vts_tpu/networks/clip_vit.py``.

Patch-32 conv → class token + positional embedding → ``ln_pre`` → 12
pre-LN blocks (width 768, 12 heads, exact-erf GELU MLP) → ``ln_post`` on
token 0 → the 512-d projection.  :class:`CLIPViT` holds the weights as
frozen parameters (``requires_grad`` False) in the reference's layout
(dense weights (in, out), the patch conv HWIO), so its state-dict keys are
the reference's tree paths, dot-joined (``blocks.3.attn.qkv_w``);
:func:`clip_image_features` runs them, each product the reference's
``x @ w + b``.  The patch conv is that product
on the 49 non-overlapping 32×32×3 patches.  Attention is written out as
``softmax((q·scale) @ kᵀ) @ v``, as in the reference: at 50 tokens it costs
nothing, and it keeps the reference's math and summation order.

Weights: :func:`init_clip_params` rebuilds the reference's seeded tower
bit for bit (numpy ``default_rng`` draws in the reference's order);
:func:`load_clip_weights` reads an OpenAI CLIP state dict (``visual.*``).
Both give numpy trees in the reference layout, which :class:`CLIPViT`
loads through :func:`vts_torch.utils.convert_jax.clip_params_to_torch`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize_mm import resize_mm

WIDTH = 768
LAYERS = 12
HEADS = 12
PATCH = 32
GRID = 7          # 224 / 32
EMBED_DIM = 512

# CLIP's image preprocessing constants (values in [0, 1])
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _ln_params(width: int) -> Dict:
    return {"scale": np.ones((width,), np.float32), "bias": np.zeros((width,), np.float32)}


def init_clip_params(seed: int = 0) -> Dict:
    """The reference's deterministic random tower, as a numpy tree.  The draws
    run per block (qkv_w, out_w, fc_w, proj_w), then conv, class_embedding,
    positional_embedding and proj; the layer norms draw nothing."""
    rng = np.random.default_rng(seed)

    def norm(*shape, scale=0.02):
        return rng.normal(0, scale, shape).astype(np.float32)

    def zeros(n):
        return np.zeros((n,), np.float32)

    blocks = []
    for _ in range(LAYERS):
        blocks.append({
            "ln_1": _ln_params(WIDTH),
            "attn": {"qkv_w": norm(WIDTH, 3 * WIDTH, scale=WIDTH ** -0.5),
                     "qkv_b": zeros(3 * WIDTH),
                     "out_w": norm(WIDTH, WIDTH, scale=WIDTH ** -0.5),
                     "out_b": zeros(WIDTH)},
            "ln_2": _ln_params(WIDTH),
            "mlp": {"fc_w": norm(WIDTH, 4 * WIDTH, scale=(2 * WIDTH) ** -0.5),
                    "fc_b": zeros(4 * WIDTH),
                    "proj_w": norm(4 * WIDTH, WIDTH, scale=WIDTH ** -0.5),
                    "proj_b": zeros(WIDTH)},
        })
    return {
        "conv": norm(PATCH, PATCH, 3, WIDTH, scale=WIDTH ** -0.5),
        "class_embedding": norm(WIDTH, scale=WIDTH ** -0.5),
        "positional_embedding": norm(GRID * GRID + 1, WIDTH, scale=0.01),
        "ln_pre": _ln_params(WIDTH),
        "blocks": blocks,
        "ln_post": _ln_params(WIDTH),
        "proj": norm(WIDTH, EMBED_DIM, scale=WIDTH ** -0.5),
    }


def load_clip_weights(path: str) -> Dict:
    """An OpenAI CLIP checkpoint (a state dict with ``visual.*`` keys, or an
    object with ``state_dict()``) → the numpy tree, with the reference's key
    and transpose map (torch Linear/in_proj weights are (out, in))."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "visual.conv1.weight" not in sd:
        raise KeyError("unrecognized CLIP checkpoint format (expected visual.* keys)")

    def g(k):
        v = sd[k]
        return np.asarray(v.float() if hasattr(v, "float") else v, dtype=np.float32)

    def ln(k):
        return {"scale": g(f"{k}.weight"), "bias": g(f"{k}.bias")}

    blocks = []
    for i in range(LAYERS):
        p = f"visual.transformer.resblocks.{i}"
        blocks.append({
            "ln_1": ln(f"{p}.ln_1"),
            "attn": {"qkv_w": g(f"{p}.attn.in_proj_weight").T,
                     "qkv_b": g(f"{p}.attn.in_proj_bias"),
                     "out_w": g(f"{p}.attn.out_proj.weight").T,
                     "out_b": g(f"{p}.attn.out_proj.bias")},
            "ln_2": ln(f"{p}.ln_2"),
            "mlp": {"fc_w": g(f"{p}.mlp.c_fc.weight").T,
                    "fc_b": g(f"{p}.mlp.c_fc.bias"),
                    "proj_w": g(f"{p}.mlp.c_proj.weight").T,
                    "proj_b": g(f"{p}.mlp.c_proj.bias")},
        })
    return {
        "conv": g("visual.conv1.weight").transpose(2, 3, 1, 0),
        "class_embedding": g("visual.class_embedding"),
        "positional_embedding": g("visual.positional_embedding"),
        "ln_pre": ln("visual.ln_pre"),
        "blocks": blocks,
        "ln_post": ln("visual.ln_post"),
        "proj": g("visual.proj"),
    }


def frozen_parameter(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


def layer_norm(p: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's layer norm: biased variance, ``rsqrt(var + eps)``."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * p.scale + p.bias


class LayerNormParams(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.scale = frozen_parameter(width)
        self.bias = frozen_parameter(width)


class _Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv_w, self.qkv_b = frozen_parameter(WIDTH, 3 * WIDTH), frozen_parameter(3 * WIDTH)
        self.out_w, self.out_b = frozen_parameter(WIDTH, WIDTH), frozen_parameter(WIDTH)

    def forward(self, x):
        n, t, _ = x.shape
        q, k, v = torch.split(x @ self.qkv_w + self.qkv_b, WIDTH, dim=-1)
        q, k, v = (a.reshape(n, t, HEADS, WIDTH // HEADS).transpose(1, 2) for a in (q, k, v))
        scale = (WIDTH // HEADS) ** -0.5
        attn = torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(n, t, WIDTH)
        return out @ self.out_w + self.out_b


class _MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc_w, self.fc_b = frozen_parameter(WIDTH, 4 * WIDTH), frozen_parameter(4 * WIDTH)
        self.proj_w, self.proj_b = frozen_parameter(4 * WIDTH, WIDTH), frozen_parameter(WIDTH)

    def forward(self, x):
        return F.gelu(x @ self.fc_w + self.fc_b) @ self.proj_w + self.proj_b


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.ln_1, self.attn = LayerNormParams(WIDTH), _Attention()
        self.ln_2, self.mlp = LayerNormParams(WIDTH), _MLP()

    def forward(self, h):
        h = h + self.attn(layer_norm(self.ln_1, h))
        return h + self.mlp(layer_norm(self.ln_2, h))


class CLIPViT(nn.Module):
    """The frozen ViT-B/32 weights; :func:`clip_image_features` runs them."""

    def __init__(self, params: Dict = None):
        super().__init__()
        self.conv = frozen_parameter(PATCH, PATCH, 3, WIDTH)
        self.class_embedding = frozen_parameter(WIDTH)
        self.positional_embedding = frozen_parameter(GRID * GRID + 1, WIDTH)
        self.ln_pre = LayerNormParams(WIDTH)
        self.blocks = nn.ModuleList(_Block() for _ in range(LAYERS))
        self.ln_post = LayerNormParams(WIDTH)
        self.proj = frozen_parameter(WIDTH, EMBED_DIM)
        self.register_buffer("mean", torch.from_numpy(_MEAN), persistent=False)
        self.register_buffer("std", torch.from_numpy(_STD), persistent=False)
        if params is not None:
            from ..utils.convert_jax import clip_params_to_torch
            self.load_state_dict(clip_params_to_torch(params))


def clip_image_features(clip: CLIPViT, images: torch.Tensor, tap_layers: Sequence[int] = ()
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """images (N, H, W, 3) in [-1, 1], resized to 224² when H is not 224 →
    (embedding (N, 512), the (N, 50, 768) token sequences after the blocks
    in ``tap_layers``)."""
    x = images.float() * 0.5 + 0.5
    x = (x - clip.mean) / clip.std
    if x.shape[1] != 224:
        x = resize_mm(x, (224, 224))
    n = x.shape[0]
    patches = x.reshape(n, GRID, PATCH, GRID, PATCH, 3).permute(0, 1, 3, 2, 4, 5)
    h = patches.reshape(n, GRID * GRID, PATCH * PATCH * 3) \
        @ clip.conv.reshape(PATCH * PATCH * 3, WIDTH)                # (N, 49, 768)
    cls = clip.class_embedding.expand(n, 1, WIDTH)
    h = torch.cat([cls, h], dim=1) + clip.positional_embedding
    h = layer_norm(clip.ln_pre, h)
    taps = []
    for i, blk in enumerate(clip.blocks):
        h = blk(h)
        if i in tap_layers:
            taps.append(h)
    pooled = layer_norm(clip.ln_post, h[:, 0, :])
    return pooled @ clip.proj, taps


def clip_style_code(clip: CLIPViT, images: torch.Tensor) -> torch.Tensor:
    """The skitG style code: the (N, 512) embedding of images (N, H, W, 3) in
    [-1, 1] (resized to 224² by :func:`clip_image_features` when H is not
    224)."""
    return clip_image_features(clip, images)[0]
