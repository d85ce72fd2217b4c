"""Network factories (``vts_tpu/networks/__init__.py``); ``dtype`` is the
compute dtype of the convs, as the reference's (params stay fp32)."""

from __future__ import annotations

import torch

from .discriminators import MultiscaleDiscriminator
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
    """Discriminator factory: ``multiscale`` only in this port so far."""
    name = netD or opt.netD
    if name != "multiscale":
        raise NotImplementedError(f"netD {name!r} is not ported yet")
    return MultiscaleDiscriminator(
        input_nc, ndf=opt.ndf, n_layers=n_layers if n_layers is not None else opt.n_layers_D,
        num_D=num_D, norm_type=opt.normD, use_sigmoid=opt.gan_mode == "vanilla",
        get_interm_feat=bool(getattr(opt, "getIntermFeat_D", False)), dtype=dtype)
