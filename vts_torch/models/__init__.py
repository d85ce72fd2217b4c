"""Model factory (``vts_tpu/models/__init__.py``): sinskit only, so far."""

from __future__ import annotations

from .sinskit import SinSKITModel

MODELS = {"sinskit": SinSKITModel, "sinskitG": SinSKITModel}


def create_model(opt):
    if opt.model not in MODELS:
        raise NotImplementedError(f"model {opt.model!r} is not ported yet")
    return MODELS[opt.model](opt)
