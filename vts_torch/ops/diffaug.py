"""DiffAugment (``vts_tpu/ops/diffaug.py``), NHWC, per-sample draws: b
brightness, s saturation, c contrast, t translation (1/8 of the side,
zero fill), o cutout (a half-side square zeroed), n noise (a Gaussian of
std ∈ [0, 0.1) on half the samples).  The letters apply in policy order.

The draws of each letter can be injected as ``draws`` (a dict letter →
draws), so a caller can replay another framework's numbers, or come from a
``torch.Generator``:
  * b, s, c: an (N,) tensor of uniforms in [0, 1);
  * t: an (N, 2) int tensor of (row, column) shifts in [−⌊H/8+½⌋, ⌊H/8+½⌋]
    (likewise for the width);
  * o: an (N, 2) int tensor of (row, column) cutout centres in
    [0, H + 1 − ch mod 2) (likewise for the width), ch = ⌊H/2+½⌋;
  * n: a dict of ``sigma`` and ``gate`` (N,) uniforms and a ``normal``
    draw of the image's shape.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def rand_brightness(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return x + (u.to(device=x.device, dtype=x.dtype) - 0.5).reshape(-1, 1, 1, 1)


def rand_saturation(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    return (x - mean) * (u.to(device=x.device, dtype=x.dtype) * 2.0).reshape(-1, 1, 1, 1) + mean


def rand_contrast(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (u.to(device=x.device, dtype=x.dtype) + 0.5).reshape(-1, 1, 1, 1) + mean


def _half(side: int, ratio: float) -> int:
    return int(side * ratio + 0.5)


def rand_translation(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Shift each image by its (row, column) draw; pixels shifted in are 0."""
    n, h, w, _ = x.shape
    shift = shift.to(device=x.device, dtype=torch.long)
    gy = (torch.arange(h, device=x.device)[None, :] + shift[:, 0:1] + 1).clamp(0, h + 1)
    gx = (torch.arange(w, device=x.device)[None, :] + shift[:, 1:2] + 1).clamp(0, w + 1)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    bi = torch.arange(n, device=x.device)[:, None, None]
    return xp[bi, gy[:, :, None], gx[:, None, :]]


def rand_cutout(x: torch.Tensor, centre: torch.Tensor, ratio: float = 0.5) -> torch.Tensor:
    n, h, w, _ = x.shape
    ch, cw = _half(h, ratio), _half(w, ratio)
    centre = centre.to(device=x.device, dtype=torch.long)
    oy, ox = centre[:, 0, None, None], centre[:, 1, None, None]
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    in_y = (gy >= oy - ch // 2) & (gy < oy - ch // 2 + ch)
    in_x = (gx >= ox - cw // 2) & (gx < ox - cw // 2 + cw)
    return x * (1.0 - (in_y & in_x).to(x.dtype))[..., None]


def rand_noise(x: torch.Tensor, d: Dict[str, torch.Tensor], noise_std: float = 0.1,
               p: float = 0.5) -> torch.Tensor:
    sigma = torch.abs(d["sigma"].to(device=x.device, dtype=x.dtype)) * noise_std
    gate = d["gate"].to(device=x.device, dtype=x.dtype) < p
    sigma = torch.where(gate, sigma, torch.zeros_like(sigma)).reshape(-1, 1, 1, 1)
    return x + sigma * d["normal"].to(device=x.device, dtype=x.dtype)


_AUGMENT_FNS = {"b": rand_brightness, "s": rand_saturation, "c": rand_contrast,
                "t": rand_translation, "o": rand_cutout, "n": rand_noise}


def draw(policy: str, shape, generator: Optional[torch.Generator] = None) -> Dict:
    """The draws of each policy letter for an (N, H, W, C) image (``shape``)."""
    n, h, w = shape[:3]
    out: Dict = {}
    for letter in policy:
        if letter in "bsc":
            out[letter] = torch.rand((n,), generator=generator)
        elif letter == "t":
            sh, sw = _half(h, 0.125), _half(w, 0.125)
            out[letter] = torch.stack([torch.randint(-sh, sh + 1, (n,), generator=generator),
                                       torch.randint(-sw, sw + 1, (n,), generator=generator)], 1)
        elif letter == "o":
            ch, cw = _half(h, 0.5), _half(w, 0.5)
            out[letter] = torch.stack([
                torch.randint(0, h + (1 - ch % 2), (n,), generator=generator),
                torch.randint(0, w + (1 - cw % 2), (n,), generator=generator)], 1)
        elif letter == "n":
            out[letter] = {"sigma": torch.rand((n,), generator=generator),
                           "gate": torch.rand((n,), generator=generator),
                           "normal": torch.randn(tuple(shape), generator=generator)}
        else:
            raise ValueError(f"unknown DiffAugment letter {letter!r}")
    return out


def diff_augment(x: torch.Tensor, policy: str = "", generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict] = None) -> torch.Tensor:
    if not policy:
        return x
    if draws is None:
        draws = draw(policy, x.shape, generator)
    for letter in policy:
        x = _AUGMENT_FNS[letter](x, draws[letter])
    return x
