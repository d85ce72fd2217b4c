"""The reference's generator checkpoints (``<epoch>_net_G.pth``) → the
msgpack checkpoints that both packages read (``vts_tpu/utils/convert_torch.py``).

This is how a user of the reference brings the sinskitG and skitG
generators it ships, and the baselines' generators, into the port:

  python -m vts_torch.utils.convert_torch --input best_net_G.pth \\
      --output checkpoints/<name>/best_net_G.msgpack --arch unet256_custom

The file is a plain state dict (read with ``torch.load(...,
weights_only=True)``; a ``module.`` prefix from ``DataParallel`` is
stripped) of the reference's ``CustomUnetGenerator`` (models/networks.py:
1430-1532): ``down{i}.model.{j}`` holds the conv (j = 0 at the outermost
level, else 1), ``up{i}[_T].model.1`` the ConvTranspose, the instance norms
carry nothing, and skitG's ``style_code_mapping{i}.0`` is a bias-free Linear;
or (``--arch resnet_{N}blocks``) of its ``ResnetGenerator``
(models/networks.py:1051-1155, instance norm): one ``nn.Sequential``
``model.{j}`` walked as :func:`convert_resnet` says; or (``--arch global``,
``local``, ``encoder``) of pix2pixHD's ``GlobalGenerator``,
``LocalEnhancer`` and ``Encoder`` (models/networks.py:1897-2019), walked as
:func:`convert_global`, :func:`convert_local` and :func:`convert_encoder`
say.  ``--set KEY=VALUE`` gives a walk's arguments (resnet:
``no_antialias``, ``no_antialias_up``, ``use_dropout``, ``n_downsampling``,
``n_upsampling``; global: ``n_downsampling``, ``n_blocks``; local:
``n_local_enhancers``, ``n_downsample_global``, ``n_blocks_global``,
``n_blocks_local``; encoder: ``n_downsampling``; spade:
``num_upsampling_layers``, ``use_vae``, ``ngf``, ``sh``, ``sw``), with the
reference converter's defaults; or (``--arch spade``) of SPADE's
``SPADEGenerator`` (models/networks.py:2075-2201), walked as
:func:`convert_spade` says.  The output is ``{"params": <the flax tree>,
"stats": <the flax batch_stats: SPADE's u and running statistics, else
{}>}``, with the reference's layout rules:

  torch Conv2d   (out, in, kh, kw) → flax HWIO = transpose(2, 3, 1, 0)
  torch ConvT2d  (in, out, kh, kw) → flax HWIO = transpose(2, 3, 0, 1), flipped
  torch Linear   (out, in)         → flax Dense kernel (in, out)
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

from .msgpack import msgpack_serialize


def _grab(sd: Dict, key: str) -> np.ndarray:
    t = sd[key]
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _conv_w(t: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(t.transpose(2, 3, 1, 0))


def _convt_w(t: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(t.transpose(2, 3, 0, 1)[::-1, ::-1])


def _conv_entry(sd: Dict, base: str, transposed: bool = False) -> Dict:
    """torch ``{base}.weight[/bias]`` → a flax Conv/ConvTranspose leaf dict."""
    leaf = {"kernel": (_convt_w if transposed else _conv_w)(_grab(sd, f"{base}.weight"))}
    if f"{base}.bias" in sd:
        leaf["bias"] = _grab(sd, f"{base}.bias")
    return leaf


def convert_custom_unet(sd: Dict, num_downs: int = 8, num_layer_separate: int = 4) -> Dict:
    """The reference ``CustomUnetGenerator`` state dict → the flax
    ``CustomUNet`` params tree."""
    params: Dict = {}

    def up(name: str) -> Dict:
        return {"ConvT4x4_0": {"ConvTranspose_0": _conv_entry(sd, f"{name}.model.1", True)}}

    for i in range(num_downs):
        params[f"down{i}"] = {"Conv4x4_0": {"Conv_0": _conv_entry(
            sd, f"down{i}.model.{0 if i == 0 else 1}")}}
    for i in range(num_downs):
        params[f"up{i}"] = up(f"up{i}")
        if i < num_layer_separate and f"up{i}_T.model.1.weight" in sd:
            params[f"up{i}_T"] = up(f"up{i}_T")
    for k in sd:
        if k.startswith("style_code_mapping") and k.endswith(".0.weight"):
            name = k.split(".")[0]
            params[name] = {"Dense_0": {"kernel": np.ascontiguousarray(_grab(sd, k).T)}}
    return params


def convert_resnet(sd: Dict, n_blocks: int = 9, n_downsampling: int = 2,
                   n_upsampling: int = None, no_antialias: bool = False,
                   no_antialias_up: bool = False, use_dropout: bool = False) -> Dict:
    """The reference ``ResnetGenerator`` state dict → the flax
    ``ResnetGenerator`` params tree.  The walk over its ``model.{j}``: 0 a
    reflection pad, 1 the 7×7 stem conv, then per down stage [conv, norm,
    ReLU] plus the blur ``Downsample`` unless ``no_antialias``, the blocks
    (``conv_block.1`` and ``conv_block.5``, 6 after a dropout), per up stage
    [ConvTranspose, norm, ReLU] with ``no_antialias_up`` else [``Upsample``,
    conv, norm, ReLU], then pad and the 7×7 head.  Flax names the convs
    ``Conv_i`` in call order, ``ResnetBlock_b/Conv_{0,1}`` and
    ``ConvTranspose_i``; the blur filters are fixed and not converted."""
    if n_upsampling is None:
        n_upsampling = n_downsampling
    params: Dict = {}
    convs = ["model.1"]
    per_down = 3 if no_antialias else 4
    convs += [f"model.{4 + per_down * i}" for i in range(n_downsampling)]
    s0 = 4 + per_down * n_downsampling
    c2 = 6 if use_dropout else 5
    for b in range(n_blocks):
        params[f"ResnetBlock_{b}"] = {
            "Conv_0": _conv_entry(sd, f"model.{s0 + b}.conv_block.1"),
            "Conv_1": _conv_entry(sd, f"model.{s0 + b}.conv_block.{c2}")}
    s1 = s0 + n_blocks
    for i in range(n_upsampling):
        if no_antialias_up:
            params[f"ConvTranspose_{i}"] = _conv_entry(sd, f"model.{s1 + 3 * i}", True)
        else:
            convs.append(f"model.{s1 + 4 * i + 1}")
    convs.append(f"model.{s1 + (3 if no_antialias_up else 4) * n_upsampling + 1}")
    for i, base in enumerate(convs):
        params[f"Conv_{i}"] = _conv_entry(sd, base)
    return params


def _core(sd: Dict, n_downsampling: int, n_blocks: int) -> Dict:
    """pix2pixHD's global trunk in ``model.{j}``: 0 a reflection pad, 1 the
    7×7 stem conv, [conv s2, norm, ReLU] per down stage, the blocks
    (``conv_block.1`` and ``.5``), [ConvTranspose, norm, ReLU] per up stage
    → flax ``Conv_{0..nd}``, ``ResnetBlock_b``, ``ConvTranspose_i``."""
    core: Dict = {"Conv_0": _conv_entry(sd, "model.1")}
    for i in range(n_downsampling):
        core[f"Conv_{1 + i}"] = _conv_entry(sd, f"model.{4 + 3 * i}")
    s0 = 4 + 3 * n_downsampling
    for b in range(n_blocks):
        core[f"ResnetBlock_{b}"] = {
            "Conv_0": _conv_entry(sd, f"model.{s0 + b}.conv_block.1"),
            "Conv_1": _conv_entry(sd, f"model.{s0 + b}.conv_block.5")}
    s1 = s0 + n_blocks
    for i in range(n_downsampling):
        core[f"ConvTranspose_{i}"] = _conv_entry(sd, f"model.{s1 + 3 * i}", True)
    return core


def convert_global(sd: Dict, n_downsampling: int = 3, n_blocks: int = 9) -> Dict:
    """The reference ``GlobalGenerator`` (instance norm) → ``{"core": the
    trunk, "Conv_0": the 7×7 head}``; the head follows the trunk and a pad."""
    head = f"model.{4 + 3 * n_downsampling + n_blocks + 3 * n_downsampling + 1}"
    return {"core": _core(sd, n_downsampling, n_blocks), "Conv_0": _conv_entry(sd, head)}


def convert_encoder(sd: Dict, n_downsampling: int = 4) -> Dict:
    """The reference ``Encoder`` → its flat flax tree: the trunk without
    blocks and the head ``Conv_{nd+1}`` (the instance average is no layer)."""
    params = _core(sd, n_downsampling, 0)
    params[f"Conv_{n_downsampling + 1}"] = _conv_entry(
        sd, f"model.{4 + 6 * n_downsampling + 1}")
    return params


def convert_local(sd: Dict, n_local_enhancers: int = 1, n_downsample_global: int = 3,
                  n_blocks_global: int = 9, n_blocks_local: int = 3) -> Dict:
    """The reference ``LocalEnhancer`` → ``{"global": the trunk, ...}``.  Its
    ``model.*`` holds the global trunk (without the head); level n's
    ``model{n}_1`` is [pad, conv7, norm, ReLU, conv s2, norm, ReLU] (convs at
    1 and 4) and ``model{n}_2`` [the blocks, ConvTranspose at L, norm, ReLU,
    and on the last level pad, conv7 at L + 4, tanh].  Flax counts the
    convs across levels: level n has ``Conv_{2(n-1)}``, ``Conv_{2(n-1)+1}``,
    ``ResnetBlock_{L(n-1)+b}``, ``ConvTranspose_{n-1}``; the head is
    ``Conv_{2·n_local_enhancers}``."""
    params: Dict = {"global": _core(sd, n_downsample_global, n_blocks_global)}
    nb = n_blocks_local
    for n in range(1, n_local_enhancers + 1):
        params[f"Conv_{2 * (n - 1)}"] = _conv_entry(sd, f"model{n}_1.1")
        params[f"Conv_{2 * (n - 1) + 1}"] = _conv_entry(sd, f"model{n}_1.4")
        for b in range(nb):
            params[f"ResnetBlock_{nb * (n - 1) + b}"] = {
                "Conv_0": _conv_entry(sd, f"model{n}_2.{b}.conv_block.1"),
                "Conv_1": _conv_entry(sd, f"model{n}_2.{b}.conv_block.5")}
        params[f"ConvTranspose_{n - 1}"] = _conv_entry(sd, f"model{n}_2.{nb}", True)
    params[f"Conv_{2 * n_local_enhancers}"] = _conv_entry(
        sd, f"model{n_local_enhancers}_2.{nb + 4}")
    return params


def convert_spade(sd: Dict, num_upsampling_layers: int = 3, use_vae: bool = False,
                  ngf: int = None, sh: int = None, sw: int = None):
    """The reference ``SPADEGenerator`` (models/networks.py:2075-2201,
    architecture.py:21-68, normalization.py:68-112) → (params, batch_stats).
    A spectral conv's ``weight_orig`` is the kernel and its ``weight_u`` the
    ``u`` in the stats (σ and ``u`` do not depend on the flattening, so the
    forwards agree from the same ``u``); a norm's ``mlp_shared.0``,
    ``mlp_gamma`` and ``mlp_beta`` are its convs, and its
    ``param_free_norm.running_{mean,var}`` the stats' ``BatchNorm_0``.
    The blocks: head_0, G_middle_{0,1}, up_0, up_1..3 by
    ``num_upsampling_layers``, up_4 beyond 6.  With ``use_vae`` the ``fc``
    Linear's output axis, (C, H, W) in torch's ``view``, is permuted to the
    NHWC reshape's (H, W, C), which needs ``ngf``, ``sh`` and ``sw``;
    without it a 2-D ``fc.weight`` is the reference's ``ValueError``."""
    params: Dict = {}
    stats: Dict = {}
    if use_vae:
        if None in (ngf, sh, sw):
            raise ValueError("VAE fc conversion needs ngf/sh/sw")
        w = _grab(sd, "fc.weight")                       # (C·H·W, z_dim)
        w = w.reshape(16 * ngf, sh, sw, -1).transpose(1, 2, 0, 3)
        params["fc"] = {"kernel": np.ascontiguousarray(w.reshape(16 * ngf * sh * sw, -1).T)}
        if "fc.bias" in sd:
            b = _grab(sd, "fc.bias").reshape(16 * ngf, sh, sw)
            params["fc"]["bias"] = np.ascontiguousarray(b.transpose(1, 2, 0).reshape(-1))
    else:
        if "fc.weight" in sd and getattr(sd["fc.weight"], "ndim", 4) == 2:
            raise ValueError("checkpoint's fc.weight is 2-D (a VAE Dense layer) — this is a "
                             "use_vae SPADE checkpoint; pass use_vae=True plus ngf/sh/sw (CLI: "
                             "--set use_vae=1 --set ngf=64 --set sh=.. --set sw=..)")
        params["fc"] = _conv_entry(sd, "fc")
    blocks = ["head_0", "G_middle_0", "G_middle_1", "up_0"]
    blocks += [f"up_{i}" for i in range(1, min(num_upsampling_layers - 1, 4))]
    if num_upsampling_layers > 6:
        blocks.append("up_4")
    for blk in blocks:
        bp: Dict = {}
        bs: Dict = {}
        convs = ["conv_0", "conv_1"]
        if f"{blk}.conv_s.weight_orig" in sd or f"{blk}.conv_s.weight" in sd:
            convs.append("conv_s")
        for cv in convs:
            if f"{blk}.{cv}.weight_orig" in sd:
                bp[cv] = {"kernel": _conv_w(_grab(sd, f"{blk}.{cv}.weight_orig"))}
                bs[cv] = {"u": _grab(sd, f"{blk}.{cv}.weight_u")}
            else:
                bp[cv] = _conv_entry(sd, f"{blk}.{cv}")
            if f"{blk}.{cv}.bias" in sd:
                bp[cv]["bias"] = _grab(sd, f"{blk}.{cv}.bias")
        for nm in ["norm_0", "norm_1"] + (["norm_s"] if "conv_s" in convs else []):
            bp[nm] = {"mlp_shared": _conv_entry(sd, f"{blk}.{nm}.mlp_shared.0"),
                      "mlp_gamma": _conv_entry(sd, f"{blk}.{nm}.mlp_gamma"),
                      "mlp_beta": _conv_entry(sd, f"{blk}.{nm}.mlp_beta")}
            rm = f"{blk}.{nm}.param_free_norm.running_mean"
            if rm in sd:
                bs.setdefault(nm, {})["BatchNorm_0"] = {
                    "mean": _grab(sd, rm),
                    "var": _grab(sd, f"{blk}.{nm}.param_free_norm.running_var")}
        params[blk] = bp
        if bs:
            stats[blk] = bs
    params["conv_img"] = _conv_entry(sd, "conv_img")
    return params, stats


_PIX2PIXHD = {"global": convert_global, "local": convert_local, "encoder": convert_encoder}


def convert_checkpoint(input_path: str, arch: str = "unet256_custom", num_downs: int = 8,
                       num_layer_separate: int = 4, **kw) -> Dict:
    """A reference ``.pth`` generator → ``{"params": ..., "stats": ...}``
    (the stats are empty but for ``spade``); ``kw`` are the walk's
    arguments (``--set``; the U-Net takes none, as in the reference, which
    ignores them there)."""
    resnet = arch.startswith("resnet_") and arch.endswith("blocks")
    if arch not in ("unet256_custom", "spade") and not resnet and arch not in _PIX2PIXHD:
        raise NotImplementedError(f"converter for arch {arch!r} not implemented "
                                  f"(unet256_custom, resnet_<N>blocks, global, local, encoder "
                                  f"and spade)")
    import torch

    sd = torch.load(input_path, map_location="cpu", weights_only=True)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    if resnet:
        n_blocks = int(arch[len("resnet_"):-len("blocks")])
        return {"params": convert_resnet(sd, n_blocks=n_blocks, **kw), "stats": {}}
    if arch in _PIX2PIXHD:
        return {"params": _PIX2PIXHD[arch](sd, **kw), "stats": {}}
    if arch == "spade":
        params, stats = convert_spade(sd, **kw)
        return {"params": params, "stats": stats}
    return {"params": convert_custom_unet(sd, num_downs, num_layer_separate), "stats": {}}


def _parse_value(v: str):
    """A ``--set`` value as bool (true/false), int or float where it parses."""
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--arch", default="unet256_custom")
    ap.add_argument("--num_downs", type=int, default=8)
    ap.add_argument("--num_layer_separate", type=int, default=4)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="per-arch converter arguments, repeatable (resnet: e.g. "
                         "--set no_antialias=1 --set use_dropout=true; global: --set "
                         "n_downsampling=4; spade: --set use_vae=1 --set ngf=64 --set sh=4 "
                         "--set sw=4); values parse as bool/int/float where they can")
    args = ap.parse_args(argv)
    kw = {}
    for item in args.set:
        key, eq, val = item.partition("=")
        if not eq:
            ap.error(f"--set expects KEY=VALUE, got {item!r}")
        kw[key] = _parse_value(val)
    payload = convert_checkpoint(args.input, args.arch, args.num_downs, args.num_layer_separate,
                                 **kw)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "wb") as f:
        f.write(msgpack_serialize(payload))
    print(f"wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
