"""Weights across the two packages: ``vts_tpu`` param trees (numpy, flax
layout) ↔ ``vts_torch`` state dicts.

Layout rules (the inverse of ``vts_tpu/utils/convert_torch.py:9-11``):
  conv:  flax HWIO (kh, kw, in, out)  ↔ torch OIHW        = transpose(3, 2, 0, 1)
  convT: flax ConvTranspose(padding 2) kernel (kh, kw, in, out), applied
         unflipped to the stride-dilated input ↔ torch ConvTranspose2d(p=1)
         weight (in, out, kh, kw) = the kernel spatially flipped, then
         transpose(2, 3, 0, 1)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _conv_to_torch(k):
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _conv_from_torch(w):
    return np.ascontiguousarray(_np(w).transpose(2, 3, 1, 0))


def _convt_to_torch(k):
    return _t(np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))


def _convt_from_torch(w):
    return np.ascontiguousarray(_np(w).transpose(2, 3, 0, 1)[::-1, ::-1])


# ---------------------------------------------------------------- U-Net ---

def unet_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``CustomUNet`` params tree → :class:`vts_torch.networks.unet_custom.CustomUNet`
    state dict (``up0_T_extra{j}`` stages and ``--normG batch`` norms included)."""
    sd = OrderedDict()
    for name, sub in params.items():
        group = "down" if name.startswith("down") else "up" if name.startswith("up") else None
        if group is None:
            raise KeyError(f"unexpected CustomUNet param group {name!r}")
        conv, leaf = (("conv", sub["Conv4x4_0"]["Conv_0"]) if group == "down"
                      else ("convt", sub["ConvT4x4_0"]["ConvTranspose_0"]))
        sd[f"{group}.{name}.{conv}.weight"] = (_conv_to_torch if group == "down"
                                               else _convt_to_torch)(leaf["kernel"])
        if "bias" in leaf:
            sd[f"{group}.{name}.{conv}.bias"] = _t(leaf["bias"])
        for k, v in sub.get("BatchNorm_0", {}).items():
            sd[f"{group}.{name}.norm.{k}"] = _t(v)
    return sd


def unet_stats_to_torch(stats: Dict) -> "OrderedDict[str, torch.Tensor]":
    """A ``--normG batch`` U-Net's flax ``batch_stats`` → the running
    ``mean``/``var`` buffers of its norms."""
    return OrderedDict(
        (f"{'down' if name.startswith('down') else 'up'}.{name}.norm.{k}", _t(v))
        for name, sub in stats.items() for k, v in sub["BatchNorm_0"].items())


def torch_to_unet_params(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`unet_params_to_torch` (what the checkpoint writer
    stores); running stats in the state dict are left out (see
    :func:`torch_to_unet_stats`)."""
    params: Dict = {}
    for key, t in state_dict.items():
        group, name, mod, kind = key.split(".")
        if mod == "norm":
            if kind not in ("mean", "var"):
                params.setdefault(name, {}).setdefault("BatchNorm_0", {})[kind] = _np(t).copy()
            continue
        inner = ("Conv4x4_0", "Conv_0") if group == "down" else ("ConvT4x4_0", "ConvTranspose_0")
        leaf = params.setdefault(name, {}).setdefault(inner[0], {}).setdefault(inner[1], {})
        if kind == "weight":
            leaf["kernel"] = (_conv_from_torch if group == "down" else _convt_from_torch)(t)
        else:
            leaf["bias"] = _np(t).copy()
    return params


def torch_to_unet_stats(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The running stats of a U-Net state dict → flax ``batch_stats`` ({} for
    a U-Net without batch norm)."""
    stats: Dict = {}
    for key, t in state_dict.items():
        _, name, mod, kind = key.split(".")
        if mod == "norm" and kind in ("mean", "var"):
            stats.setdefault(name, {}).setdefault("BatchNorm_0", {})[kind] = _np(t).copy()
    return stats


# ---------------------------------------------------------------- LPIPS ---

def lpips_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """``{"conv": [{"w", "b"}]*13, "lin": [..]*5}`` → :class:`vts_torch.losses.lpips.LPIPS`
    state dict."""
    sd = OrderedDict()
    for i, p in enumerate(params["conv"]):
        sd[f"conv{i}_weight"] = _conv_to_torch(p["w"])
        sd[f"conv{i}_bias"] = _t(p["b"])
    for i, lin in enumerate(params["lin"]):
        sd[f"lin{i}"] = _t(np.asarray(lin).reshape(-1))
    return sd


# ------------------------------------------------------------ Inception ---

_BN_FIELDS = ("scale", "bias", "mean", "var")


def inception_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """``{name: {"w", "scale", "bias", "mean", "var"}}`` →
    :class:`vts_torch.metrics.inception.InceptionBlock0` state dict."""
    sd = OrderedDict()
    for name, p in params.items():
        sd[f"{name}_weight"] = _conv_to_torch(p["w"])
        for f in _BN_FIELDS:
            sd[f"{name}_{f}"] = _t(p[f])
    return sd


# ------------------------------------------------------ CLIP and D3 heads ---
# The port's CLIP tower and D3 heads keep the reference's layout, so a
# state-dict key is the tree path, dot-joined (list indices included):
#   blocks.3.attn.qkv_w ↔ params["blocks"][3]["attn"]["qkv_w"]

def _tree_to_state_dict(tree, prefix: str = "") -> "OrderedDict[str, torch.Tensor]":
    sd = OrderedDict()
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            sd.update(_tree_to_state_dict(v, key + "."))
        else:
            sd[key] = _t(v)
    return sd


def clip_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """CLIP tower tree (``vts_tpu.networks.clip_vit``) → the state dict of
    :class:`vts_torch.networks.clip_vit.CLIPViT`."""
    return _tree_to_state_dict(params)


def d3_head_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """D3 heads tree (``{"taps": [head]*3, "embed": head}``) → the state dict of
    :class:`vts_torch.losses.vision_aided.D3Heads`."""
    return _tree_to_state_dict(params)


# ------------------------------------------------------- discriminators ---
# A D's torch state-dict key is its flax tree path, dot-joined:
#   <scale>.Conv4x4_i.weight|bias   ↔ params[<scale>][Conv4x4_i][Conv_0][kernel|bias]
#   <scale>.BatchNorm_i.scale|bias  ↔ params[<scale>][BatchNorm_i][scale|bias]
#   <scale>.BatchNorm_i.mean|var    ↔ batch_stats[<scale>][BatchNorm_i][mean|var]
#   conv<i>.weight|bias             ↔ params[conv<i>][kernel|bias]  (the pixel D)
# (no <scale> level for a single NLayerDiscriminator, ``head`` for the patch D).

def _leaves(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def d_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax discriminator params → the port's D state-dict entries."""
    sd = OrderedDict()
    for path, v in _leaves(params):
        module = path[:-2] if path[-2] == "Conv_0" else path[:-1]
        if path[-1] == "kernel":
            sd[".".join(module) + ".weight"] = _conv_to_torch(v)
        elif path[-2] == "Conv_0":
            sd[".".join(module) + ".bias"] = _t(v)
        else:
            sd[".".join(path)] = _t(v)
    return sd


def d_stats_to_torch(stats: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``batch_stats`` → the port's running ``mean``/``var`` buffers."""
    return OrderedDict((".".join(path), _t(v)) for path, v in _leaves(stats))


def torch_to_d_params(state_dict: Dict[str, torch.Tensor]):
    """The port's D state dict (or any subset, e.g. Adam moments keyed like
    the parameters) → (flax params, flax batch_stats)."""
    params: Dict = {}
    stats: Dict = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        module, leaf = path[-2], path[-1]
        if module.startswith("Conv4x4") or module.startswith("conv"):
            # the PatchGAN's Conv4x4 wraps an nn.Conv; the pixel D's 1×1 convs are bare
            inner = ("Conv_0",) if module.startswith("Conv4x4") else ()
            _set(params, path[:-1] + inner + ("kernel" if leaf == "weight" else "bias",),
                 _conv_from_torch(t) if leaf == "weight" else _np(t).copy())
        elif leaf in ("mean", "var"):
            _set(stats, path, _np(t).copy())
        else:
            _set(params, path, _np(t).copy())
    return params, stats


# ------------------------------------------------------------ Adam state ---

def adam_state_to_flax(count: int, mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                       to_flax_params) -> Dict:
    """The port's Adam moments (keyed like the parameters) → the state dict of
    ``optax.ScaleByAdamState`` that ``flax.serialization.to_bytes`` writes:
    ``{"count": int32 scalar, "mu": tree, "nu": tree}`` in the params' layout."""
    return {"count": np.array(count, np.int32), "mu": to_flax_params(mu),
            "nu": to_flax_params(nu)}


def adam_state_to_torch(state: Dict, params_to_torch):
    """Inverse of :func:`adam_state_to_flax` → (count, mu, nu)."""
    return (int(np.asarray(state["count"])), params_to_torch(state["mu"]),
            params_to_torch(state["nu"]))
