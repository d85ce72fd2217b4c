"""Sinusoidal 2-D positional encoding (``vts_tpu/networks/positional.py``),
NHWC.  Computed in float64 numpy then cast, exactly like the reference."""

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


def positional_encoding(h: int, w: int, mode: str = "spe", dim: int = 4,
                        batch: int = 1, device=None) -> torch.Tensor:
    """(batch, h, w, 2·dim) encoding tensor."""
    if mode != "spe":
        raise NotImplementedError(f"positional encoding mode {mode!r} is not ported yet")
    g = torch.from_numpy(spe_grid(h, w, dim)).to(device)
    return g[None].expand(batch, *g.shape)
