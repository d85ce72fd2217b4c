"""2-D positional encodings (``vts_tpu/networks/positional.py``), NHWC:
``spe`` (sinusoidal, computed in float64 numpy then cast, exactly like the
reference) and ``csg`` (the Cartesian grid in [-1, 1] by ``jnp.linspace``'s
float32 formula; XLA's CPU fusion of it rounds some points one or two ulps
apart, so the two agree within 2^-22)."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_embedding_table(num_positions: int, dim: int,
                               div_half_dim: bool = False) -> np.ndarray:
    """Rows 0..num_positions-1 of the SPE table (float32); row 0 is zero."""
    assert dim % 2 == 0, "embedding_dim must be divisible by 2"
    half = dim // 2
    denom = half if div_half_dim else max(half - 1, 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -(np.log(1e4) / denom))
    pos = np.arange(num_positions, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    table[0, :] = 0.0  # padding index
    return table.astype(np.float32)


def spe_grid(h: int, w: int, dim: int = 4) -> np.ndarray:
    """(h, w, 2·dim) grid: x-axis embeddings tiled over rows, then y-axis
    embeddings tiled over columns (channel order [x_emb, y_emb])."""
    table = sinusoidal_embedding_table(max(h, w) + 2, dim)
    x_grid = np.broadcast_to(table[1:1 + w][None, :, :], (h, w, dim))
    y_grid = np.broadcast_to(table[1:1 + h][:, None, :], (h, w, dim))
    return np.concatenate([x_grid, y_grid], axis=-1)


def _linspace_m1_1(n: int) -> np.ndarray:
    """``jnp.linspace(-1, 1, n)`` in its float32 arithmetic: −(1 − t) + t at
    t = i / (n − 1), the last point exactly 1 (0 for n = 1, as the reference)."""
    f32 = np.float32
    if n <= 1:
        return np.zeros((1,), f32)
    step = np.arange(n - 1, dtype=f32) / f32(n - 1)
    return np.concatenate([f32(-1.0) * (f32(1.0) - step) + f32(1.0) * step, [f32(1.0)]]
                          ).astype(f32)


def csg_grid(h: int, w: int) -> np.ndarray:
    """(h, w, 2) Cartesian grid in [-1, 1], channels (x, y)."""
    gx = np.broadcast_to(_linspace_m1_1(w)[None, :], (h, w))
    gy = np.broadcast_to(_linspace_m1_1(h)[:, None], (h, w))
    return np.stack([gx, gy], axis=-1)


def positional_encoding(h: int, w: int, mode: str = "spe", dim: int = 4,
                        batch: int = 1, device=None) -> torch.Tensor:
    """(batch, h, w, C) encoding tensor; C = 2·dim for spe, 2 for csg."""
    if mode == "spe":
        g = spe_grid(h, w, dim)
    elif mode == "csg":
        g = csg_grid(h, w)
    else:
        raise NotImplementedError(f"positional encoding mode {mode!r}")
    g = torch.from_numpy(np.ascontiguousarray(g)).to(device)
    return g[None].expand(batch, *g.shape)
