"""Nearest resize with torch ``F.interpolate('nearest')``'s index rule,
computed the way ``vts_tpu/ops/resize.py::resize_nearest`` computes it.

src = floor(dst · (in/out)) with the product taken in fp32, exactly as the
reference does.  ``F.interpolate`` itself is not used: its scale arithmetic
rounds differently on some sizes."""

from __future__ import annotations

import numpy as np
import torch


def _nearest_index(n_out: int, n_in: int) -> np.ndarray:
    src = np.floor(np.arange(n_out, dtype=np.float32) * np.float32(n_in / n_out))
    return np.minimum(src.astype(np.int64), n_in - 1)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """NHWC (or HWC) → spatial ``size`` = (h, w)."""
    h, w = size
    iy = torch.from_numpy(_nearest_index(h, x.shape[-3])).to(x.device)
    ix = torch.from_numpy(_nearest_index(w, x.shape[-2])).to(x.device)
    return x.index_select(-3, iy).index_select(-2, ix)
