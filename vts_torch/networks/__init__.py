"""Network factory (``vts_tpu/networks/__init__.py``)."""

from __future__ import annotations

from .unet_custom import CustomUNet


def define_G(opt, input_nc: int, output_nc: int) -> CustomUNet:
    """Generator factory; ``unet256_custom`` only in this port so far."""
    if opt.netG != "unet256_custom":
        raise NotImplementedError(f"netG {opt.netG!r} is not ported yet")
    return CustomUNet(
        input_nc, ngf=opt.ngf, out_nc=output_nc, num_downs=8,
        num_layer_separate=opt.num_layer_separate, norm_type=opt.normG,
        use_dropout=not opt.no_dropout,
        use_style_code=opt.use_style_code,
        t_mult=int(opt.T_resolution_multiplier),
        init_type=opt.init_type, init_gain=opt.init_gain)
