"""Model factory (``vts_tpu/models/__init__.py``): sinskit (sinskitG), skit
(skitG) and the pix2pix baseline.  Names are looked up lowercased, as the
reference's registry does."""

from __future__ import annotations

from .pix2pix import Pix2PixModel
from .sinskit import SinSKITModel
from .skit import SKITModel

MODELS = {"sinskit": SinSKITModel, "sinskitg": SinSKITModel, "skit": SKITModel,
          "skitg": SKITModel, "pix2pix": Pix2PixModel}


def create_model(opt):
    if opt.model.lower() not in MODELS:
        raise NotImplementedError(f"model {opt.model!r} is not ported yet")
    return MODELS[opt.model.lower()](opt)
