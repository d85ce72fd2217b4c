"""Model factory (``vts_tpu/models/__init__.py``): sinskit only, so far.
Names are looked up lowercased, as the reference's registry does."""

from __future__ import annotations

from .sinskit import SinSKITModel

MODELS = {"sinskit": SinSKITModel, "sinskitg": SinSKITModel}


def create_model(opt):
    if opt.model.lower() not in MODELS:
        raise NotImplementedError(f"model {opt.model!r} is not ported yet")
    return MODELS[opt.model.lower()](opt)
