"""Network factories (``vts_tpu/networks/__init__.py``); ``dtype`` is the
compute dtype of the convs, as the reference's (params stay fp32)."""

from __future__ import annotations

import torch

from .discriminators import (MultiscaleDiscriminator, NLayerDiscriminator, PatchDiscriminator,
                             PixelDiscriminator)
from .munit import GResnet
from .pix2pixhd_nets import Encoder, GlobalGenerator, LocalEnhancer
from .resnet_gen import ResnetGenerator
from .spade_nets import ConvEncoder, SPADEGenerator
from .stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
from .unet_custom import CustomUNet
from .unet_plain import UnetGenerator
from .visgel import VisGelGenerator

_RESNET_BLOCKS = {"resnet_9blocks": 9, "resnet_6blocks": 6, "resnet_4blocks": 4}


def define_G(opt, input_nc: int, output_nc: int, dtype: torch.dtype = torch.float32):
    """Generator factory: ``unet256_custom`` (sinskitG, skitG),
    ``resnet_{9,6,4}blocks`` (pix2pix), pix2pixHD's ``global``, ``local``
    and ``encoder``, SPADE's ``spade`` (conditioned on the
    ``input_nc``-channel sketch) and ``conv_encoder`` (the VAE's image
    encoder, ``input_nc`` the image's channels, ndf ``--ngf``), and the
    zoo's ``unet_256``/``unet_128``, ``visgel``, ``resnet_cat``,
    ``stylegan2`` and ``smallstylegan2``; every other name raises.  The
    pix2pixHD and SPADE depths and the
    style-code options default as the reference's factory defaults them
    when the model's parser did not declare them (a pix2pix run with
    ``--netG global``, a sinskit run with ``--use_style_code``)."""
    if opt.netG in _RESNET_BLOCKS:
        return ResnetGenerator(
            input_nc, ngf=opt.ngf, out_nc=output_nc, n_blocks=_RESNET_BLOCKS[opt.netG],
            norm_type=opt.normG, use_dropout=not opt.no_dropout,
            no_antialias=bool(opt.no_antialias), no_antialias_up=bool(opt.no_antialias_up),
            t_resolution_multiplier=int(opt.T_resolution_multiplier),
            generate_T_imgs=bool(getattr(opt, "generate_T_imgs", False)),
            init_type=opt.init_type, init_gain=opt.init_gain, dtype=dtype)
    common = dict(norm_type=opt.normG, init_type=opt.init_type, init_gain=opt.init_gain,
                  dtype=dtype)
    n_down = int(getattr(opt, "n_downsample_global", 4))
    if opt.netG == "global":
        return GlobalGenerator(input_nc, ngf=opt.ngf, out_nc=output_nc, n_downsampling=n_down,
                               n_blocks=int(getattr(opt, "n_blocks_global", 9)), **common)
    if opt.netG == "local":
        return LocalEnhancer(input_nc, ngf=opt.ngf, out_nc=output_nc, n_downsample_global=n_down,
                             n_blocks_global=int(getattr(opt, "n_blocks_global", 9)),
                             n_local_enhancers=int(getattr(opt, "n_local_enhancers", 1)),
                             n_blocks_local=int(getattr(opt, "n_blocks_local", 3)), **common)
    if opt.netG == "encoder":
        return Encoder(input_nc, ngf=opt.ngf, out_nc=output_nc, n_downsampling=n_down, **common)
    if opt.netG == "spade":
        return SPADEGenerator(
            input_nc, ngf=opt.ngf, out_nc=output_nc,
            num_upsampling_layers=int(getattr(opt, "num_upsampling_layers", 3)),
            aspect_ratio=float(getattr(opt, "aspect_ratio", 1.0)), norm_g=opt.normG,
            use_vae=bool(getattr(opt, "use_vae", False)), z_dim=int(getattr(opt, "z_dim", 256)),
            crop_size=int(getattr(opt, "output_width", opt.crop_size)),
            init_type=opt.init_type, init_gain=opt.init_gain, dtype=dtype)
    if opt.netG == "conv_encoder":
        return ConvEncoder(input_nc, ndf=opt.ngf, z_dim=int(getattr(opt, "z_dim", 256)),
                           init_type=opt.init_type, init_gain=opt.init_gain)
    if opt.netG in ("unet_256", "unet_128"):
        return UnetGenerator(input_nc, ngf=opt.ngf, out_nc=output_nc,
                             num_downs=8 if opt.netG == "unet_256" else 7,
                             use_dropout=not opt.no_dropout, **common)
    if opt.netG == "visgel":
        return define_G2(opt, input_nc, output_nc,
                         t_resolution_multiplier=int(opt.T_resolution_multiplier))
    if opt.netG == "resnet_cat":
        return GResnet(input_nc, ngf=opt.ngf, out_nc=output_nc, num_downs=2, n_res=4,
                       init_type=opt.init_type, init_gain=opt.init_gain)
    if opt.netG in ("stylegan2", "smallstylegan2"):
        return StyleGAN2Generator(input_nc, ngf=opt.ngf, out_nc=output_nc,
                                  n_blocks=2 if opt.netG == "smallstylegan2" else None,
                                  crop_size=int(opt.crop_size))
    if opt.netG != "unet256_custom":
        raise NotImplementedError(f"netG {opt.netG!r} is not ported yet")
    return CustomUNet(
        input_nc, ngf=opt.ngf, out_nc=output_nc, num_downs=8,
        num_layer_separate=opt.num_layer_separate, norm_type=opt.normG,
        use_dropout=not opt.no_dropout,
        use_style_code=bool(opt.use_style_code),
        style_code_dim=int(getattr(opt, "style_code_dim", 512)),
        style_code_mode=getattr(opt, "style_code_mode", "concat"),
        style_code_mapping_mode=getattr(opt, "style_code_mapping_mode", "tile"),
        num_layer_style_code=int(getattr(opt, "num_layer_style_code", -1)),
        input_size=int(opt.crop_size),
        t_mult=int(opt.T_resolution_multiplier),
        init_type=opt.init_type, init_gain=opt.init_gain, dtype=dtype)


def define_G2(opt, input_nc: int, output_nc: int, netG2: str = "VisGel",
              t_resolution_multiplier: int = None):
    """Super-resolution G2 factory (``vts_tpu/networks/__init__.py::define_G2``):
    the VisGel generator, emitting at ``t_resolution_multiplier`` (default
    ``--T_resolution_multiplier``, and 2 where the options have none) × its
    input (in fp32, whatever the compute dtype, as the reference's); every
    other name raises, as the reference's."""
    if netG2 != "VisGel":
        raise NotImplementedError(f"super resolution model name {netG2!r} is not recognized")
    if t_resolution_multiplier is None:
        t_resolution_multiplier = int(getattr(opt, "T_resolution_multiplier", 2))
    return VisGelGenerator(input_nc, out_nc=output_nc,
                           t_resolution_multiplier=t_resolution_multiplier,
                           init_type=opt.init_type, init_gain=opt.init_gain)


def define_D(opt, input_nc: int, netD: str = None, n_layers: int = None, num_D: int = 3,
             dtype: torch.dtype = torch.float32, input_size=None):
    """Discriminator factory (reference models/networks.py:392-442): basic,
    n_layers, pixel, patch, multiscale, or ``stylegan2`` and
    ``tilestylegan2``, which take the (H, W) ``input_size`` of the images they
    will see (default ``--crop_size``²: their flattened head's width follows
    it)."""
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
    if name in ("stylegan2", "tilestylegan2"):
        return StyleGAN2Discriminator(input_nc, ndf=opt.ndf, tile=name.startswith("tile"),
                                      crop_size=int(opt.crop_size),
                                      input_size=input_size or (int(opt.crop_size),) * 2)
    raise NotImplementedError(f"netD {name!r} is not ported yet")
