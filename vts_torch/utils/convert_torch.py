"""The reference's generator checkpoints (``<epoch>_net_G.pth``) → the
msgpack checkpoints that both packages read (``vts_tpu/utils/convert_torch.py``).

This is how a user of the reference brings the sinskitG and skitG
generators it ships into the port:

  python -m vts_torch.utils.convert_torch --input best_net_G.pth \\
      --output checkpoints/<name>/best_net_G.msgpack --arch unet256_custom

The file is a plain state dict (read with ``torch.load(...,
weights_only=True)``; a ``module.`` prefix from ``DataParallel`` is
stripped) of the reference's ``CustomUnetGenerator`` (models/networks.py:
1430-1532): ``down{i}.model.{j}`` holds the conv (j = 0 at the outermost
level, else 1), ``up{i}[_T].model.1`` the ConvTranspose, the instance norms
carry nothing, and skitG's ``style_code_mapping{i}.0`` is a bias-free Linear.
The output is ``{"params": <the flax CustomUNet tree>, "stats": {}}``, with
the reference's layout rules:

  torch Conv2d   (out, in, kh, kw) → flax HWIO = transpose(2, 3, 1, 0)
  torch ConvT2d  (in, out, kh, kw) → flax HWIO = transpose(2, 3, 0, 1), flipped
  torch Linear   (out, in)         → flax Dense kernel (in, out)

Only ``--arch unet256_custom`` is ported; the reference's other
converters (resnet, pix2pixHD, SPADE) come with those models.
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


def convert_custom_unet(sd: Dict, num_downs: int = 8, num_layer_separate: int = 4) -> Dict:
    """The reference ``CustomUnetGenerator`` state dict → the flax
    ``CustomUNet`` params tree."""
    params: Dict = {}

    def entry(base: str, inner: str, outer: str, to_flax) -> Dict:
        leaf = {"kernel": to_flax(_grab(sd, f"{base}.weight"))}
        if f"{base}.bias" in sd:
            leaf["bias"] = _grab(sd, f"{base}.bias")
        return {outer: {inner: leaf}}

    for i in range(num_downs):
        params[f"down{i}"] = entry(f"down{i}.model.{0 if i == 0 else 1}", "Conv_0",
                                   "Conv4x4_0", _conv_w)
    for i in range(num_downs):
        params[f"up{i}"] = entry(f"up{i}.model.1", "ConvTranspose_0", "ConvT4x4_0", _convt_w)
        if i < num_layer_separate and f"up{i}_T.model.1.weight" in sd:
            params[f"up{i}_T"] = entry(f"up{i}_T.model.1", "ConvTranspose_0", "ConvT4x4_0",
                                       _convt_w)
    for k in sd:
        if k.startswith("style_code_mapping") and k.endswith(".0.weight"):
            name = k.split(".")[0]
            params[name] = {"Dense_0": {"kernel": np.ascontiguousarray(_grab(sd, k).T)}}
    return params


def convert_checkpoint(input_path: str, arch: str = "unet256_custom", num_downs: int = 8,
                       num_layer_separate: int = 4) -> Dict:
    """A reference ``.pth`` generator → ``{"params": ..., "stats": {}}``."""
    if arch != "unet256_custom":
        raise NotImplementedError(f"converter for arch {arch!r} is not ported yet "
                                  f"(unet256_custom only)")
    import torch

    sd = torch.load(input_path, map_location="cpu", weights_only=True)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    return {"params": convert_custom_unet(sd, num_downs, num_layer_separate), "stats": {}}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--arch", default="unet256_custom")
    ap.add_argument("--num_downs", type=int, default=8)
    ap.add_argument("--num_layer_separate", type=int, default=4)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="per-arch converter arguments of the archs not ported yet "
                         "(unet256_custom takes none, as in the reference)")
    args = ap.parse_args(argv)
    payload = convert_checkpoint(args.input, args.arch, args.num_downs, args.num_layer_separate)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "wb") as f:
        f.write(msgpack_serialize(payload))
    print(f"wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
