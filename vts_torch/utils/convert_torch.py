"""The reference's generator checkpoints (``<epoch>_net_G.pth``) → the
msgpack checkpoints that both packages read (``vts_tpu/utils/convert_torch.py``).

This is how a user of the reference brings the sinskitG and skitG
generators it ships, and pix2pix's ResNet generators, into the port:

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
``model.{j}`` walked as :func:`convert_resnet` says, ``--set KEY=VALUE``
giving the walk's arguments (``no_antialias``, ``no_antialias_up``,
``use_dropout``, ``n_downsampling``, ``n_upsampling``).  The output is
``{"params": <the flax tree>, "stats": {}}``, with the reference's layout
rules:

  torch Conv2d   (out, in, kh, kw) → flax HWIO = transpose(2, 3, 1, 0)
  torch ConvT2d  (in, out, kh, kw) → flax HWIO = transpose(2, 3, 0, 1), flipped
  torch Linear   (out, in)         → flax Dense kernel (in, out)

The reference's other converters (``global``, ``local``, ``encoder``,
``spade``) come with pix2pixHD and SPADE.
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


def convert_checkpoint(input_path: str, arch: str = "unet256_custom", num_downs: int = 8,
                       num_layer_separate: int = 4, **kw) -> Dict:
    """A reference ``.pth`` generator → ``{"params": ..., "stats": {}}``;
    ``kw`` are the resnet walk's arguments (``--set``; the U-Net takes none,
    as in the reference, which ignores them there)."""
    resnet = arch.startswith("resnet_") and arch.endswith("blocks")
    if arch != "unet256_custom" and not resnet:
        raise NotImplementedError(f"converter for arch {arch!r} is not ported yet "
                                  f"(unet256_custom and resnet_<N>blocks only)")
    import torch

    sd = torch.load(input_path, map_location="cpu", weights_only=True)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    if resnet:
        n_blocks = int(arch[len("resnet_"):-len("blocks")])
        return {"params": convert_resnet(sd, n_blocks=n_blocks, **kw), "stats": {}}
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
                         "--set no_antialias=1 --set use_dropout=true); values parse as "
                         "bool/int/float where they can")
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
