"""SKIT — the multi-garment model with a CLIP style code
(``vts_tpu/models/skit.py``, reference models/skitG_model.py).

Everything sinskitG does (:class:`~vts_torch.models.sinskit.SinSKITModel`),
with one generator for all garments: a 512-d style code, the frozen CLIP
ViT-B/32 embedding of a style image, enters G's decoder (tile or project ×
concat or AdaIN, at ``--num_layer_style_code`` levels; see
:mod:`vts_torch.networks.unet_custom`).  :meth:`SKITModel.set_input` takes
the code from the first source the batch has:

  1. ``batch["style_code"]``, as given (``--precomputed_style_codes`` changes
     nothing beyond that key, as in the reference);
  2. ``batch["style_image"]``, encoded (the skit dataset's: the garment's
     own image at 224², or one of ``--style_image_dir``);
  3. the full-resolution ``I``, encoded (resized to 224² inside CLIP);

and fails with the reference's message when the batch has none of them (an
edited sketch without ``--style_image_dir``).

The encode runs without a gradient on the one CLIP tower the model holds,
which D3 shares.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..networks.clip_vit import clip_style_code
from .sinskit import SinSKITModel


class SKITModel(SinSKITModel):

    @torch.no_grad()
    def encode_style(self, style_images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images in [-1, 1] → (N, 512) style codes."""
        return clip_style_code(self.clip, style_images)

    def set_input(self, batch: Dict[str, np.ndarray], phase: str = "train") -> None:
        super().set_input(batch, phase)
        inp = self._input
        if self.opt.use_style_code and "style_code" not in inp:
            source = inp.get("style_image", inp.get("I"))
            if source is None:
                raise ValueError("skitG needs a style image or visual image")
            inp["style_code"] = self.encode_style(source)
