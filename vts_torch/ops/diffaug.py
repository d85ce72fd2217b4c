"""DiffAugment, policy "bs" (``vts_tpu/ops/diffaug.py``): per-sample
brightness then saturation, NHWC.

The draws are per sample and per letter, uniform in [0, 1): from a
``torch.Generator``, or injected as ``draws`` (a dict letter → (N,) tensor)
so a caller can replay another framework's numbers.  Other policy letters
(contrast, translation, cutout, noise) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def rand_brightness(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return x + (u - 0.5).reshape(-1, 1, 1, 1)


def rand_saturation(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    return (x - mean) * (u * 2.0).reshape(-1, 1, 1, 1) + mean


_AUGMENT_FNS = {"b": rand_brightness, "s": rand_saturation}


def draw(policy: str, n: int, generator: Optional[torch.Generator] = None
         ) -> Dict[str, torch.Tensor]:
    """One (N,) uniform vector per policy letter, in policy order."""
    return {letter: torch.rand((n,), generator=generator) for letter in policy}


def diff_augment(x: torch.Tensor, policy: str = "", generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    if not policy:
        return x
    bad = [c for c in policy if c not in _AUGMENT_FNS]
    if bad:
        raise NotImplementedError(f"DiffAugment letters {bad} are not ported yet (only 'bs')")
    if draws is None:
        draws = draw(policy, x.shape[0], generator)
    for letter in policy:
        x = _AUGMENT_FNS[letter](x, draws[letter].to(device=x.device, dtype=x.dtype))
    return x
