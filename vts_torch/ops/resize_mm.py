"""Separable antialiased linear resize as two matmuls: the counterpart of
``vts_tpu/ops/resize_mm.py``, the 1536² → 224² step in front of CLIP.

A linear resize is a linear operator, separable per axis, so
``resize(x) == A_h @ x @ A_w^T`` with the 1-D interpolation matrices
``A (out, in)``.  The JAX package reads those matrices off
``jax.image.resize`` applied to the identity; here :func:`_resize_matrix`
rebuilds them without jax, step by step as ``compute_weight_mat`` of
``jax/_src/image/scale.py`` (jax 0.9.0) does, in fp32: half-pixel sample
positions, a triangle kernel stretched by ``max(in/out, 1)`` (the
antialias), columns normalized by their sum behind the ``> 1000·eps(f32)``
guard, and zeroed where the sample falls outside ``[-0.5, in - 0.5]``.
``tests/test_torch_port_d3.py`` holds the matrices against the JAX ones.
The backward is autograd's transposed matmuls.  The same construction
with the Keys cubic kernel gives :func:`vts_torch.ops.resize.resize_bicubic`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax's Keys cubic (A = -0.5), in its order of operations (torch's
    bicubic takes A = -0.75)."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= f32(1.0), ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0),
                   out)
    return np.where(x >= f32(2.0), f32(0.0), out).astype(f32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=32)
def _resize_matrix(in_size: int, out_size: int, kernel: str = "linear") -> np.ndarray:
    """(out_size, in_size) fp32 matrix of a 1-D antialiased resize with the
    ``kernel`` ("linear" or "cubic"): taps that fall outside the input are
    dropped and each output's weights renormalised by their sum."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))     # jax: 1. / (out / in), as float32
    kernel_scale = max(inv_scale, f32(1.0))          # the antialias stretch
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _KERNELS[kernel](x)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * _EPS32),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    return np.ascontiguousarray(weights.T)


@functools.lru_cache(maxsize=32)
def _matrix(in_size: int, out_size: int, device: torch.device,
            kernel: str = "linear") -> torch.Tensor:
    """:func:`_resize_matrix` as an fp32 tensor, copied to ``device`` once."""
    return torch.from_numpy(_resize_matrix(in_size, out_size, kernel)).to(device)


def resize_mm(x: torch.Tensor, size, kernel: str = "linear") -> torch.Tensor:
    """NHWC (or HWC) antialiased resize to ``size = (h, w)``; equals
    ``jax.image.resize(x, ..., kernel, antialias=True)`` to fp32 round-off
    (computed in fp32, returned in x's dtype).  The H pass is one (out_h, H)
    @ (H, W·C) product per image, the W pass one (out_w, W) @ (W, N·h·C)
    product, as in the reference."""
    out_h, out_w = int(size[0]), int(size[1])
    batched = x.dim() == 4
    if not batched:
        x = x[None]
    n, h, w, c = x.shape
    if (out_h, out_w) == (h, w):
        return x if batched else x[0]
    dt = x.dtype
    y = x.float()
    if out_h != h:
        a = _matrix(h, out_h, y.device, kernel)
        y = torch.matmul(a, y.reshape(n, h, w * c)).reshape(n, out_h, w, c)
    if out_w != w:
        b = _matrix(w, out_w, y.device, kernel)
        hh = y.shape[1]
        yt = y.permute(2, 0, 1, 3).reshape(w, n * hh * c)
        y = torch.matmul(b, yt).reshape(out_w, n, hh, c).permute(1, 2, 0, 3)
    y = y.to(dt)
    return y if batched else y[0]
