"""K2: batched patch extraction — windows cut from NHWC images at offsets —
its gradient (a scatter-add), and the "more fake T" offset sampler.

Counterpart of ``vts_tpu/ops/patch.py`` (``patch_offsets_jnp``,
``gather_patches``, ``gather_patches_from_coords``, ``dilate_mask``,
``sample_offsets_in_mask``) and of the Pallas kernel
``vts_tpu/ops/pallas_gather.py::gather_patches_pallas``.  Two CUDA kernels:
``vts_torch/csrc/gather_patches.cu`` (forward) and
``vts_torch/csrc/scatter_patches.cu`` (backward: the scatter-add that the
JAX package leaves to XLA's transpose of the gather).
:func:`gather_patches` is differentiable in the image; each wrapper launches
its kernel for a CUDA tensor and takes its plain version for a CPU tensor
only, and the launch counts are kept apart (``gather_patches.launches``,
``scatter_patches.launches``).

Modes, as in the reference: ``'gather'`` clamps every pixel index into the
image (out-of-bounds windows repeat edge pixels); ``'slice'`` clamps the
window origin (a whole-window shift).  Both agree on in-bounds windows.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SCATTER_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_MODES = {"gather": 0, "slice": 1}


def patch_offsets(coords: torch.Tensor, scale_multiplier: int = 1):
    """Packed coords (..., 8) → int32 (offset_x, offset_y, cutout), in fp32 like
    the reference; ``torch.round`` rounds half to even like ``jnp.round``."""
    coords = coords.float()
    rr = coords[..., 5]
    off_x = torch.round((coords[..., 0] + coords[..., 6] / rr) * scale_multiplier).to(torch.int32)
    off_y = torch.round((coords[..., 1] + coords[..., 7] / rr) * scale_multiplier).to(torch.int32)
    cutout = torch.round(coords[..., 4] / rr * scale_multiplier).to(torch.int32)
    return off_x, off_y, cutout


def _as_batched(image, offset_x, offset_y):
    """(H, W, C) + (K,) or (N, H, W, C) + (N, K) → 4-D image, 2-D offsets."""
    if image.dim() == 3:
        image = image[None]
    if offset_x.dim() == 1:
        offset_x, offset_y = offset_x[None], offset_y[None]
    if image.dim() != 4 or offset_x.shape != offset_y.shape or offset_x.dim() != 2 \
            or offset_x.shape[0] != image.shape[0]:
        raise ValueError(f"gather_patches: image {tuple(image.shape)} does not match "
                         f"offsets {tuple(offset_x.shape)}/{tuple(offset_y.shape)}")
    return image, offset_x, offset_y


def gather_patches_plain(image, offset_x, offset_y, cutout: int, mode: str = "gather"):
    """Plain version (advanced indexing).  Same signature as :func:`gather_patches`."""
    image, offset_x, offset_y = _as_batched(image, offset_x, offset_y)
    n, h, w, c = image.shape
    if mode not in _MODES:
        raise NotImplementedError(mode)
    iy, ix = _window_indices(offset_x, offset_y, h, w, cutout, mode)   # (N, K, cut)
    bi = torch.arange(n, device=image.device)[:, None, None, None]
    out = image[bi, iy[..., :, None], ix[..., None, :]]       # (N, K, cut, cut, C)
    return out.reshape((-1, cutout, cutout, c))


def _lib():
    lib = build.load("gather_patches")
    lib.gather_patches.argtypes = _ARGTYPES
    lib.gather_patches.restype = ctypes.c_int
    return lib


def _gather(image: torch.Tensor, offset_x: torch.Tensor, offset_y: torch.Tensor,
            cutout: int, mode: str) -> torch.Tensor:
    """One forward: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if image.device.type == "cpu":
        return gather_patches_plain(image, offset_x, offset_y, cutout, mode)
    image, offset_x, offset_y = _as_batched(image, offset_x, offset_y)
    n, h, w, c = image.shape
    k = offset_x.shape[1]
    if image.device.type != "cuda" or offset_x.device != image.device \
            or offset_y.device != image.device:
        raise ValueError("gather_patches: image and offsets must lie on one CUDA device")
    if cutout > h or cutout > w or cutout <= 0:
        raise ValueError(f"gather_patches: cutout {cutout} does not fit {h}x{w}")
    if image.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"gather_patches: unsupported dtype {image.dtype}")
    image = image.contiguous()
    ox = offset_x.to(torch.int32).contiguous()
    oy = offset_y.to(torch.int32).contiguous()
    out = torch.empty((n * k, cutout, cutout, c), dtype=image.dtype, device=image.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = lib.gather_patches(image.data_ptr(), ox.data_ptr(), oy.data_ptr(),
                                out.data_ptr(), n, k, h, w, c, cutout,
                                _MODES[mode], image.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: CUDA error {rc}")
    gather_patches.launches += 1
    return out


def _window_indices(offset_x, offset_y, h: int, w: int, cutout: int, mode: str):
    """(N, K) offsets → the clamped (N, K, cut) row and column indices."""
    ox = offset_x.long()
    oy = offset_y.long()
    if mode == "slice":
        ox = ox.clamp(0, w - cutout)
        oy = oy.clamp(0, h - cutout)
    ar = torch.arange(cutout, device=ox.device)
    return (oy[..., None] + ar).clamp(0, h - 1), (ox[..., None] + ar).clamp(0, w - 1)


def scatter_patches_plain(grad: torch.Tensor, offset_x: torch.Tensor, offset_y: torch.Tensor,
                          image_shape, mode: str = "gather") -> torch.Tensor:
    """Plain version of :func:`scatter_patches`: ``index_put_`` with
    ``accumulate=True`` into a zeroed fp32 canvas."""
    n, h, w, c = image_shape
    ox = offset_x.reshape(n, -1)
    oy = offset_y.reshape(n, -1)
    k = ox.shape[1]
    cutout = grad.shape[1]
    iy, ix = _window_indices(ox, oy, h, w, cutout, mode)
    bi = torch.arange(n, device=grad.device)[:, None, None, None]
    canvas = torch.zeros((n, h, w, c), dtype=torch.float32, device=grad.device)
    g = grad.float().reshape(n, k, cutout, cutout, c)
    canvas.index_put_((bi, iy[..., :, None], ix[..., None, :]), g, accumulate=True)
    return canvas


def _lib_scatter():
    lib = build.load("scatter_patches")
    lib.scatter_patches_f32.argtypes = _SCATTER_ARGTYPES
    lib.scatter_patches_f32.restype = ctypes.c_int
    return lib


def scatter_patches(grad: torch.Tensor, offset_x: torch.Tensor, offset_y: torch.Tensor,
                    image_shape, mode: str = "gather") -> torch.Tensor:
    """Transpose of :func:`gather_patches`: the (N·K, cut, cut, C) cotangent
    summed into a zeroed fp32 (N, H, W, C) canvas at the same windows.
    Overlapping and clamped windows accumulate.  On CUDA the kernel adds
    with atomics, so the order of the additions (and the last bits of a
    pixel that several windows share) varies from run to run."""
    if mode not in _MODES:
        raise NotImplementedError(mode)
    n, h, w, c = (int(v) for v in image_shape)
    if grad.dim() != 4 or grad.shape[1] != grad.shape[2] or grad.shape[3] != c \
            or offset_x.numel() != grad.shape[0] or offset_y.numel() != grad.shape[0] \
            or grad.shape[0] % max(n, 1):
        raise ValueError(f"scatter_patches: cotangent {tuple(grad.shape)} does not match "
                         f"image {(n, h, w, c)} and offsets {tuple(offset_x.shape)}")
    if grad.device.type == "cpu":
        return scatter_patches_plain(grad, offset_x, offset_y, (n, h, w, c), mode)
    if grad.device.type != "cuda" or offset_x.device != grad.device \
            or offset_y.device != grad.device:
        raise ValueError("scatter_patches: cotangent and offsets must lie on one CUDA device")
    if grad.dtype != torch.float32:
        raise TypeError(f"scatter_patches: the scatter kernel takes float32, got {grad.dtype}")
    cutout = grad.shape[1]
    if cutout > h or cutout > w:
        raise ValueError(f"scatter_patches: cutout {cutout} does not fit {h}x{w}")
    g = grad.contiguous()
    ox = offset_x.to(torch.int32).contiguous()
    oy = offset_y.to(torch.int32).contiguous()
    canvas = torch.empty((n, h, w, c), dtype=torch.float32, device=grad.device)
    if canvas.numel() == 0:
        return canvas
    lib = _lib_scatter()
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        rc = lib.scatter_patches_f32(g.data_ptr(), ox.data_ptr(), oy.data_ptr(),
                                     canvas.data_ptr(), n, grad.shape[0] // max(n, 1), h, w, c,
                                     cutout, _MODES[mode], stream)
    if rc != 0:
        raise RuntimeError(f"scatter_patches kernel launch failed: CUDA error {rc}")
    scatter_patches.launches += 1
    return canvas


scatter_patches.launches = 0


class _GatherPatches(torch.autograd.Function):
    """The batched gather, with :func:`scatter_patches` as its gradient."""

    @staticmethod
    def forward(ctx, image, offset_x, offset_y, cutout, mode):
        image, offset_x, offset_y = _as_batched(image, offset_x, offset_y)
        ctx.image_shape = tuple(image.shape)
        ctx.mode = mode
        ctx.save_for_backward(offset_x, offset_y)
        return _gather(image, offset_x, offset_y, cutout, mode)

    @staticmethod
    def backward(ctx, grad):
        offset_x, offset_y = ctx.saved_tensors
        canvas = scatter_patches(grad, offset_x, offset_y, ctx.image_shape, ctx.mode)
        return canvas.to(grad.dtype), None, None, None, None


def gather_patches(image: torch.Tensor, offset_x: torch.Tensor, offset_y: torch.Tensor,
                   cutout: int, mode: str = "gather") -> torch.Tensor:
    """K windows of cutout² from each image.  image (H, W, C) with (K,) offsets
    → (K, cut, cut, C); image (N, H, W, C) with (N, K) offsets → (N·K, cut,
    cut, C), sample-major.  Offsets are int top-left corners (x, y).
    Differentiable in the image (the gradient is :func:`scatter_patches`,
    shaped like the image that was passed)."""
    if mode not in _MODES:
        raise NotImplementedError(mode)
    if image.dim() == 3:
        image = image[None]
    return _GatherPatches.apply(image, offset_x, offset_y, int(cutout), mode)


gather_patches.launches = 0


def gather_patches_from_coords(image: torch.Tensor, coords: torch.Tensor,
                               patch_size: int = 32, scale_multiplier: int = 1,
                               mode: str = "gather") -> torch.Tensor:
    """Patches at packed coords.  image (N, H, W, C) with coords (N, K, 8) →
    (N·K, cut, cut, C) sample-major; a single image with (K, 8) or (1, K, 8)
    coords → (K, cut, cut, C).  cut = patch_size·scale_multiplier."""
    if image.dim() == 4 and image.shape[0] == 1:
        image = image[0]
    if coords.dim() == 3 and image.dim() == 3:
        coords = coords.reshape(-1, coords.shape[-1])
    off_x, off_y, _ = patch_offsets(coords, scale_multiplier)
    return gather_patches(image, off_x, off_y, patch_size * scale_multiplier, mode=mode)


def _box_sum_last(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """'same' correlation with ones(kernel) along the last axis as a prefix-sum
    difference, out[i] = P[i+p] − P[i−p−1] with zero padding (exact for 0/1
    masks), as in the reference."""
    p = kernel // 2
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    idx = torch.arange(n, device=x.device)
    hi = cs[..., (idx + p).clamp(0, n - 1)]
    lo_idx = idx - p - 1
    lo = torch.where(lo_idx >= 0, cs[..., lo_idx.clamp(0, n - 1)], torch.zeros_like(hi))
    return hi - lo


def dilate_mask(mask: torch.Tensor, kernel: int = 17) -> torch.Tensor:
    """clamp(conv(M, ones(k, k)), 0, 1) on an (H, W) mask, as two separable
    prefix-sum box filters (``vts_tpu/ops/patch.py::dilate_mask``)."""
    if mask.dim() != 2:
        raise ValueError(f"dilate_mask: expects an (H, W) mask, got {tuple(mask.shape)}")
    if kernel % 2 != 1:
        raise ValueError("dilate_mask: the box filter needs an odd kernel")
    out = _box_sum_last(mask.transpose(0, 1), kernel)        # vertical pass
    out = _box_sum_last(out.transpose(0, 1), kernel)         # horizontal pass
    return torch.clamp(out, 0.0, 1.0)


def sample_offsets_in_mask(mask: torch.Tensor, k: int, patch_size: int, dilate: int = 17,
                           generator: torch.Generator = None, uniforms: torch.Tensor = None):
    """K patch top-left corners drawn with probability ∝ the dilated mask
    (``vts_tpu/ops/patch.py::sample_offsets_in_mask``): the row from the row-sum
    CDF, then the column within that row, both by inverting uniforms.

    ``uniforms`` (2, K) in [0, 1) — row draws, then column draws — replaces the
    draws from ``generator``, so a caller can replay another framework's
    numbers.  mask (H, W) → (offset_x, offset_y) int32 (K,) on mask's device."""
    h, w = mask.shape
    weights = dilate_mask(mask.float(), dilate)
    weights[h - patch_size + 1:, :] = 0.0        # forbid windows that overflow
    weights[:, w - patch_size + 1:] = 0.0
    if uniforms is None:
        uniforms = torch.rand((2, k), generator=generator, dtype=torch.float32)
    uniforms = uniforms.to(device=mask.device, dtype=torch.float32)
    row_cdf = torch.cumsum(torch.sum(weights, dim=1), dim=0)
    rows = torch.searchsorted(row_cdf, uniforms[0] * row_cdf[-1], right=True).clamp(0, h - 1)
    col_cdf = torch.cumsum(weights[rows], dim=1)
    u_col = (uniforms[1] * col_cdf[:, -1]).reshape(k, 1)
    cols = torch.searchsorted(col_cdf, u_col, right=True).reshape(k).clamp(0, w - 1)
    return cols.to(torch.int32), rows.to(torch.int32)
