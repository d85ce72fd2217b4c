"""Garment packing (``vts_tpu/parallel/packing.py``): G independent garments'
generator weights fused into one ``pack=G``
:class:`~vts_torch.networks.unet_custom.CustomUNet`, whose convs are grouped
(``groups=G``) over channel-stacked inputs.

A packed state dict has exactly the keys of a single garment's, so packing
is leaf by leaf on the garment-stacked state dict
(:func:`vts_torch.parallel.fleet.stack_states`, every leaf with a leading G
axis).  In torch's layouts the garment blocks of every packed leaf run along
its FIRST axis, whatever the leaf:

  Conv4x4 weight   (G, out, in, kh, kw) → (G·out, in, kh, kw)   (groups on the output axis)
  ConvT4x4 weight  (G, in, out, kh, kw) → (G·in, out, kh, kw)   (``ConvTranspose2d`` groups
                                                                  on the input axis)
  bias, norm scale/bias, running stats (G, C) → (G·C,)

so a packed leaf is the stack with its first two axes merged.  The
reference's flax kernels are HWIO for both conv kinds and pack both on the
output axis, (G, kh, kw, in, out) → (kh, kw, in, G·out): the kind of conv
matters only across the two packages, and
:func:`vts_torch.utils.convert_jax.packed_unet_to_torch` reads it from the
module name.  Packing is exact: grouped convs partition the channels, the
norms are per channel, the activations elementwise.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def pack_leaf(leaf: torch.Tensor) -> torch.Tensor:
    """One garment-stacked leaf (leading G axis) → its packed layout."""
    if leaf.dim() < 2:
        raise ValueError(f"cannot pack leaf of shape {tuple(leaf.shape)}")
    return leaf.reshape(leaf.shape[0] * leaf.shape[1], *leaf.shape[2:])


def unpack_leaf(leaf: torch.Tensor, groups: int) -> torch.Tensor:
    """A packed leaf → the garment stack, with a leading G axis."""
    if leaf.dim() < 1 or leaf.shape[0] % groups:
        raise ValueError(f"cannot unpack leaf of shape {tuple(leaf.shape)} into {groups}")
    return leaf.reshape(groups, leaf.shape[0] // groups, *leaf.shape[1:])


def pack_tree(stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A garment-stacked state dict → the state dict of a ``pack=G`` net."""
    return {k: pack_leaf(v) for k, v in stacked.items()}


def unpack_tree(packed: Dict[str, torch.Tensor], groups: int) -> Dict[str, torch.Tensor]:
    return {k: unpack_leaf(v, groups) for k, v in packed.items()}


def pack_images(per_garment: Sequence[torch.Tensor]) -> torch.Tensor:
    """G tensors (N, H, W, C) → (N, H, W, G·C), garment-contiguous channels."""
    return torch.cat(list(per_garment), dim=-1)


def unpack_images(packed: torch.Tensor, groups: int) -> torch.Tensor:
    """(N, H, W, G·C) → (G, N, H, W, C)."""
    n, h, w, gc = packed.shape
    return packed.reshape(n, h, w, groups, gc // groups).movedim(3, 0)
