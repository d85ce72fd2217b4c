"""Network factories (``vts_tpu/networks/__init__.py``); ``dtype`` is the
compute dtype of the convs, as the reference's (params stay fp32)."""

from __future__ import annotations

import torch

from .discriminators import (MultiscaleDiscriminator, NLayerDiscriminator, PatchDiscriminator,
                             PixelDiscriminator)
from .unet_custom import CustomUNet


def define_G(opt, input_nc: int, output_nc: int,
             dtype: torch.dtype = torch.float32) -> CustomUNet:
    """Generator factory; ``unet256_custom`` only in this port so far."""
    if opt.netG != "unet256_custom":
        raise NotImplementedError(f"netG {opt.netG!r} is not ported yet")
    return CustomUNet(
        input_nc, ngf=opt.ngf, out_nc=output_nc, num_downs=8,
        num_layer_separate=opt.num_layer_separate, norm_type=opt.normG,
        use_dropout=not opt.no_dropout,
        use_style_code=opt.use_style_code,
        t_mult=int(opt.T_resolution_multiplier),
        init_type=opt.init_type, init_gain=opt.init_gain, dtype=dtype)


def define_D(opt, input_nc: int, netD: str = None, n_layers: int = None, num_D: int = 3,
             dtype: torch.dtype = torch.float32):
    """Discriminator factory (reference models/networks.py:392-442): basic,
    n_layers, pixel, patch or multiscale."""
    name = netD or opt.netD
    nl = n_layers if n_layers is not None else opt.n_layers_D
    sig = opt.gan_mode == "vanilla"
    interm = bool(getattr(opt, "getIntermFeat_D", False))
    if name in ("basic", "n_layers"):
        return NLayerDiscriminator(input_nc, opt.ndf, 3 if name == "basic" else nl, opt.normD,
                                   sig, interm, dtype=dtype)
    if name == "pixel":
        return PixelDiscriminator(input_nc, opt.ndf, opt.normD, dtype=dtype)
    if name == "patch":
        return PatchDiscriminator(input_nc, opt.ndf, opt.normD, dtype=dtype)
    if name == "multiscale":
        return MultiscaleDiscriminator(input_nc, ndf=opt.ndf, n_layers=nl, num_D=num_D,
                                       norm_type=opt.normD, use_sigmoid=sig,
                                       get_interm_feat=interm, dtype=dtype)
    raise NotImplementedError(f"netD {name!r} is not ported yet")
