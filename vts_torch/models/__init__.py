"""Model factory (``vts_tpu/models/__init__.py``): sinskit (sinskitG), skit
(skitG) and the pix2pix and pix2pixHD baselines.  Names are looked up
lowercased, as the reference's registry does."""

from __future__ import annotations

from ..config.options import check_dataset, check_zoo
from .pix2pix import Pix2PixModel
from .pix2pixhd import Pix2PixHDModel
from .sinskit import SinSKITModel
from .skit import SKITModel
from .spade import SPADEModel

MODELS = {"sinskit": SinSKITModel, "sinskitg": SinSKITModel, "skit": SKITModel,
          "skitg": SKITModel, "pix2pix": Pix2PixModel, "pix2pixhd": Pix2PixHDModel,
          "spade": SPADEModel}


def create_model(opt):
    if opt.model.lower() not in MODELS:
        raise NotImplementedError(f"model {opt.model!r} is not ported yet")
    cls = MODELS[opt.model.lower()]
    # the pool is queried by the D fake pass of pix2pixHD and of SPADE, which
    # inherits it (reference pix2pixHD_model.py:582); the reference refuses
    # it everywhere else
    if int(getattr(opt, "pool_size", 0)) > 0 and not getattr(cls, "supports_image_pool", False):
        raise ValueError(f"--pool_size > 0 is only wired into pix2pixHD (the reference's sole "
                         f"ImagePool query site) and SPADE; model {opt.model!r} ignores it. "
                         f"Pass --pool_size 0.")
    check_dataset(opt)
    check_zoo(opt)
    return cls(opt)
