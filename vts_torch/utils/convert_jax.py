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
from typing import Dict, List

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


def _convt_to_torch(k, groups: int = 1):
    """A flax ConvTranspose kernel → the ``ConvTranspose2d`` weight; a grouped
    one, (kh, kw, in_g, G·out_g) with the garment blocks on the output axis
    → the grouped ``ConvTranspose2d`` weight (G·in_g, out_g, kh, kw): each
    block flipped and io-transposed, the blocks moved onto the input axis."""
    k = np.asarray(k)[::-1, ::-1]
    kh, kw, cin, gout = k.shape
    return _t(k.reshape(kh, kw, cin, groups, gout // groups).transpose(3, 2, 4, 0, 1)
              .reshape(groups * cin, gout // groups, kh, kw))


def _convt_from_torch(w):
    return np.ascontiguousarray(_np(w).transpose(2, 3, 0, 1)[::-1, ::-1])


# ---------------------------------------------------------------- U-Net ---

def unet_params_to_torch(params: Dict, groups: int = 1) -> "OrderedDict[str, torch.Tensor]":
    """flax ``CustomUNet`` params tree → :class:`vts_torch.networks.unet_custom.CustomUNet`
    state dict (``up0_T_extra{j}`` stages, ``--normG batch`` norms and the
    skitG ``style_code_mapping{k}`` projections included: a flax Dense
    kernel (in, out) ↔ ``style.style_code_mapping{k}.weight`` (out, in)).
    ``groups``: the tree of a ``pack=G`` net (:func:`packed_unet_to_torch`)."""
    sd = OrderedDict()
    for name, sub in params.items():
        if name.startswith("style_code_mapping"):
            sd[f"style.{name}.weight"] = _t(np.asarray(sub["Dense_0"]["kernel"]).T)
            continue
        group = "down" if name.startswith("down") else "up" if name.startswith("up") else None
        if group is None:
            raise KeyError(f"unexpected CustomUNet param group {name!r}")
        conv, leaf = (("conv", sub["Conv4x4_0"]["Conv_0"]) if group == "down"
                      else ("convt", sub["ConvT4x4_0"]["ConvTranspose_0"]))
        sd[f"{group}.{name}.{conv}.weight"] = (_conv_to_torch(leaf["kernel"]) if group == "down"
                                               else _convt_to_torch(leaf["kernel"], groups))
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


def packed_unet_to_torch(params: Dict, stats: Dict, groups: int
                         ) -> "OrderedDict[str, torch.Tensor]":
    """The reference's ``CustomUNet(pack=G)`` params and batch stats (e.g. its
    ``pack_tree`` of G garments' trees) → the state dict of the port's
    ``pack=G`` net.  A packed conv kernel (kh, kw, in_g, G·out_g) maps as an
    ungrouped one, to (G·out_g, in_g, kh, kw); a packed transposed-conv
    kernel, blocked on its output axis too, maps to ``ConvTranspose2d``'s
    grouped weight, blocked on its input axis (:func:`_convt_to_torch`);
    biases, norm params and running stats (G·C,) as they are."""
    sd = unet_params_to_torch(params, groups)
    sd.update(unet_stats_to_torch(stats))
    return sd


def torch_to_unet_params(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`unet_params_to_torch` (what the checkpoint writer
    stores); running stats in the state dict are left out (see
    :func:`torch_to_unet_stats`)."""
    params: Dict = {}
    for key, t in state_dict.items():
        if key.startswith("style."):
            params[key.split(".")[1]] = {"Dense_0": {"kernel": _np(t).T.copy()}}
            continue
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
        if key.startswith("style."):
            continue
        _, name, mod, kind = key.split(".")
        if mod == "norm" and kind in ("mean", "var"):
            stats.setdefault(name, {}).setdefault("BatchNorm_0", {})[kind] = _np(t).copy()
    return stats


# ------------------------- ResNet, pix2pixHD, SPADE and the zoo's generators ---
# The port's ResnetGenerator, pix2pixHD's GlobalGenerator, LocalEnhancer and
# Encoder, SPADE's SPADEGenerator and ConvEncoder, and the zoo's plain
# UnetGenerator, VisGelGenerator and GResnet name their submodules as flax
# does, so a key is the flax tree path, dot-joined, under the scopes
# ``core``, ``global``, ``down{i}``, ``encoder``, … where the tree has them
# (core.ResnetBlock_3.Conv_1.weight ↔
# params["core"]["ResnetBlock_3"]["Conv_1"]["kernel"]); the converters below
# take any such tree:
#   Conv_i.weight|bias, ResnetBlock_b.Conv_{0,1}.weight  ↔ params[...][kernel|bias]
#   <any conv>.weight (stem, s0b0.conv1, up0, head, …)   ↔ params[...][kernel]
#   ConvTranspose_i.weight|bias                          ↔ the flax ConvTranspose
#   a 2-D weight (SPADE's Dense fc, fc_mu, fc_var)       ↔ the Dense kernel, transposed
#   BatchNorm_i.scale|bias, up_ln{i}.scale|bias          ↔ params[...][scale|bias]
#   BatchNorm_i.mean|var                                 ↔ batch_stats[...][mean|var]
#   <conv>.u (a spectral conv's)                         ↔ batch_stats[...][<conv>][u]

def resnet_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``ResnetGenerator`` (or ``GlobalGenerator``, ``LocalEnhancer``,
    ``Encoder``, ``SPADEGenerator``, ``ConvEncoder``, ``UnetGenerator``,
    ``VisGelGenerator``, ``GResnet``) params → the port's
    generator's state-dict entries (every leaf of the tree: params, or Adam
    moments in the params' layout)."""
    sd = OrderedDict()
    for path, v in _leaves(params):
        key = ".".join(path[:-1])
        if path[-1] == "kernel":
            sd[key + ".weight"] = (_t(np.asarray(v).T) if np.ndim(v) == 2
                                   else _convt_to_torch(v) if path[-2].startswith("ConvTranspose")
                                   else _conv_to_torch(v))
        else:
            sd[".".join(path)] = _t(v)
    return sd


def resnet_stats_to_torch(stats: Dict) -> "OrderedDict[str, torch.Tensor]":
    """A generator's flax ``batch_stats`` → its running ``mean``/``var`` and
    spectral ``u`` buffers."""
    return OrderedDict((".".join(path), _t(v)) for path, v in _leaves(stats))


def torch_to_resnet_params(state_dict: Dict[str, torch.Tensor]):
    """Inverse of :func:`resnet_params_to_torch` and
    :func:`resnet_stats_to_torch` → (flax params, flax batch_stats)."""
    params: Dict = {}
    stats: Dict = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        module, leaf = path[-2], path[-1]
        if module.startswith("BatchNorm"):
            _set(stats if leaf in ("mean", "var") else params, path, _np(t).copy())
        elif leaf == "u":
            _set(stats, path, _np(t).copy())
        elif leaf == "weight":
            _set(params, path[:-1] + ("kernel",),
                 _np(t).T.copy() if t.dim() == 2
                 else _convt_from_torch(t) if module.startswith("ConvTranspose")
                 else _conv_from_torch(t))
        else:
            _set(params, path, _np(t).copy())
    return params, stats


# ------------------------------------------------------------- StyleGAN2 ---
# The StyleGAN2 G and D name their modules and parameters as flax does, and
# their equalized weights are flax params named ``weight``:
#   <conv>.weight (EqualConv, ModulatedConv)  ↔ params[...][weight] (HWIO ↔ OIHW)
#   <linear>.weight (EqualLinear)             ↔ params[...][weight] ((in, out) ↔ (out, in))
#   bias, noise_strength (a scalar)           ↔ params[...][bias|noise_strength]
# They hold no batch statistics (their checkpoints' ``stats`` are {}), and the
# StyledConvs' fixed noise maps are not saved.

def stylegan2_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``StyleGAN2Generator`` or ``StyleGAN2Discriminator`` params (or
    Adam moments in their layout) → the port's state dict."""
    sd = OrderedDict()
    for path, v in _leaves(params):
        sd[".".join(path)] = ((_t(np.asarray(v).T) if np.ndim(v) == 2 else _conv_to_torch(v))
                              if path[-1] == "weight" else _t(v))
    return sd


def torch_to_stylegan2_params(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`stylegan2_params_to_torch`."""
    params: Dict = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        _set(params, path, (_np(t).T.copy() if t.dim() == 2 else _conv_from_torch(t))
             if path[-1] == "weight" else _np(t).copy())
    return params


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
#   <scale>.Conv4x4_i.weight|bias      ↔ params[<scale>][Conv4x4_i][Conv_0][kernel|bias]
#   <scale>.SpectralConv_i.weight|bias ↔ params[<scale>][SpectralConv_i][kernel|bias]
#   <scale>.SpectralConv_i.u           ↔ batch_stats[<scale>][SpectralConv_i][u]
#   <scale>.BatchNorm_i.scale|bias     ↔ params[<scale>][BatchNorm_i][scale|bias]
#   <scale>.BatchNorm_i.mean|var       ↔ batch_stats[<scale>][BatchNorm_i][mean|var]
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
    """flax ``batch_stats`` → the port's running ``mean``/``var`` (and
    spectral ``u``) buffers."""
    return OrderedDict((".".join(path), _t(v)) for path, v in _leaves(stats))


def torch_to_d_params(state_dict: Dict[str, torch.Tensor]):
    """The port's D state dict (or any subset, e.g. Adam moments keyed like
    the parameters) → (flax params, flax batch_stats)."""
    params: Dict = {}
    stats: Dict = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        module, leaf = path[-2], path[-1]
        if leaf in ("weight", "bias") and module.startswith(("Conv4x4", "conv",
                                                              "SpectralConv")):
            # the PatchGAN's Conv4x4 wraps an nn.Conv; the pixel D's 1×1 convs
            # and the spectral convs are bare
            inner = ("Conv_0",) if module.startswith("Conv4x4") else ()
            _set(params, path[:-1] + inner + ("kernel" if leaf == "weight" else "bias",),
                 _conv_from_torch(t) if leaf == "weight" else _np(t).copy())
        elif leaf in ("mean", "var", "u"):
            _set(stats, path, _np(t).copy())
        else:
            _set(params, path, _np(t).copy())
    return params, stats


# ------------------------------------------------------------- CUT heads ---
# ``StridedConvF`` and ``PatchSampleF`` keep flax's module names:
#   Conv_i.weight|bias    ↔ params[Conv_i][kernel|bias]    (HWIO ↔ OIHW)
#   mlp_i_j.weight|bias   ↔ params[mlp_i_j][kernel|bias]   (Dense (in, out) ↔ Linear (out, in))

def cut_head_params_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``StridedConvF`` or ``PatchSampleF`` params → the state dict of
    :mod:`vts_torch.networks.cut_heads`' module."""
    sd = OrderedDict()
    for (name, leaf), v in _leaves(params):
        if leaf == "kernel":
            sd[f"{name}.weight"] = _conv_to_torch(v) if np.ndim(v) == 4 else _t(np.asarray(v).T)
        else:
            sd[f"{name}.{leaf}"] = _t(v)
    return sd


def torch_to_cut_head_params(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`cut_head_params_to_torch`."""
    params: Dict = {}
    for key, t in state_dict.items():
        name, leaf = key.split(".")
        if leaf == "weight":
            params.setdefault(name, {})["kernel"] = (_conv_from_torch(t) if t.dim() == 4
                                                     else _np(t).T.copy())
        else:
            params.setdefault(name, {})[leaf] = _np(t).copy()
    return params


# ---------------------------------------------------------------- fleet ---

def _field(state, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _garment(tree, g: int):
    """Garment g's slice of every leaf of a garment-stacked (nested) dict."""
    return {k: _garment(v, g) if isinstance(v, dict) else np.asarray(v)[g]
            for k, v in tree.items()}


def fleet_states_to_torch(states: Dict, groups: int) -> List[Dict]:
    """The reference's garment-stacked states (``{"G", "D", "D2"}`` →
    ``NetState``, every leaf with a leading G axis, as ``stack_states``
    gives them; a ``NetState`` is read by its fields ``params``, ``stats``,
    ``opt_state``, and the Adam state by ``count``, ``mu``, ``nu``) → per
    garment ``{name: (state dict, (count, mu, nu) or None)}``, what
    :meth:`vts_torch.parallel.fleet.FleetTrainer.load_states` takes."""
    out = []
    for g in range(groups):
        per = {}
        for name, state in states.items():
            to_torch, stats_to_torch = ((unet_params_to_torch, unet_stats_to_torch)
                                        if name == "G" else (d_params_to_torch, d_stats_to_torch))
            sd = to_torch(_garment(_field(state, "params"), g))
            sd.update(stats_to_torch(_garment(_field(state, "stats"), g)))
            adam = _field(state, "opt_state")
            if adam is not None:
                adam = (int(np.asarray(_field(adam, "count"))[g]),
                        to_torch(_garment(_field(adam, "mu"), g)),
                        to_torch(_garment(_field(adam, "nu"), g)))
            per[name] = (sd, adam)
        out.append(per)
    return out


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
