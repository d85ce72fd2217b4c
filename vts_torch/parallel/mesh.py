"""Device layouts (``vts_tpu/parallel/mesh.py``).

The reference lays its devices out as a ``jax.sharding.Mesh`` over named
axes and lets GSPMD partition one program over it:

  * ``garment``: independent garments (the fleet, :mod:`vts_torch.launch`);
  * ``data``: one garment's batch split over devices, every reduction over
    samples kept global (:meth:`vts_torch.models.sinskit.SinSKITModel.setup`);
  * ``spatial``: declared, and used by no train path of the reference.

Here a layout is the same grid of devices, one process (a rank) per entry
once the ranks are up (:mod:`vts_torch.platform`).  ``parse_mesh_spec``,
``build_mesh`` and ``factor_devices`` keep the reference's behaviour and
messages; :func:`garment_block` is the block of garments ``P("garment")``
gives one device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("garment", "data", "spatial")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'garment:4,data:2' → {'garment': 4, 'data': 2}."""
    out: Dict[str, int] = {}
    if not spec:
        return out
    for part in spec.split(","):
        name, _, size = part.partition(":")
        name = name.strip()
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}; valid: {AXES}")
        out[name] = int(size)
    return out


@dataclasses.dataclass
class Layout:
    """A grid of devices: ``sizes`` (axis → size, in the spec's order) and
    ``devices``, the first ``size`` devices laid out row-major as
    ``np.reshape`` lays them out; a rank's flat position in it is its
    rank."""
    sizes: Dict[str, int]
    devices: np.ndarray

    @property
    def size(self) -> int:
        return int(np.prod(list(self.sizes.values()), dtype=np.int64))

    def axis(self, name: str) -> int:
        return self.sizes.get(name, 1)

    def data_groups(self) -> List[List[int]]:
        """The flat positions that share every coordinate but ``data``, one
        list per such set, in row-major order: each is one replica's data
        axis, the ranks whose batch shards add up to one global batch."""
        names, shape = list(self.sizes), tuple(self.sizes.values())
        groups: Dict[Tuple, List[int]] = {}
        for i in range(self.size):
            coords = np.unravel_index(i, shape)
            key = tuple(int(c) for n, c in zip(names, coords) if n != "data")
            groups.setdefault(key, []).append(i)
        return list(groups.values())


def visible_devices(kind: str) -> List[torch.device]:
    """The devices an explicit ``--mesh`` of a run of ``kind`` ("cuda" or
    "cpu") may lay out: one per card, or on the CPU one per core this
    process may run on (the counterpart of XLA's host devices)."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * len(os.sched_getaffinity(0))


def build_mesh(spec: str = "", devices: Optional[Sequence[torch.device]] = None) -> Layout:
    """The layout of ``spec`` over ``devices`` (default: one per visible
    card, or ``[cpu]``); an empty spec is ``garment:len(devices)``."""
    if devices is None:
        devices = visible_devices("cuda") if torch.cuda.is_available() else [torch.device("cpu")]
    devices = list(devices)
    sizes = parse_mesh_spec(spec)
    if not sizes:
        sizes = {"garment": len(devices)}
    total = int(np.prod(list(sizes.values())))
    assert total <= len(devices), f"mesh needs {total} devices, have {len(devices)}"
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Layout(sizes, grid.reshape(tuple(sizes.values())))


def mesh_for_flag(spec: str, devices: Sequence[torch.device]) -> Layout:
    """:func:`build_mesh` for ``--mesh``: its refusals name the flag."""
    try:
        return build_mesh(spec, devices)
    except (AssertionError, ValueError) as err:
        raise type(err)(f"--mesh {spec}: {err}") from None


def garment_block(num_garments: int, g: int, index: int) -> range:
    """The garments that device ``index`` of a ``garment`` axis of ``g``
    holds: ``P("garment")``'s contiguous block ``[index·G/g, (index+1)·G/g)``.
    Where ``g`` does not divide G the reference's ``device_put`` fails; so
    does this, naming the axis and the garment count."""
    if num_garments % g:
        raise ValueError(f"--mesh garment:{g} cannot shard {num_garments} garments: the "
                         f"reference's device_put onto P('garment') needs the garment count "
                         f"divisible by the axis ({num_garments} % {g} = {num_garments % g})")
    per = num_garments // g
    return range(index * per, (index + 1) * per)


def factor_devices(n: int) -> Tuple[int, int]:
    """Split n devices into (garment, data).  Prefers a non-trivial data axis
    (n ≥ 4 → data=2) so multi-axis shardings are exercised; odd/small n fall
    back to garment-only."""
    if n >= 4 and n % 2 == 0:
        return n // 2, 2
    return n, 1
