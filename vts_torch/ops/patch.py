"""K2: batched patch extraction — windows cut from NHWC images at offsets.

Counterpart of ``vts_tpu/ops/patch.py`` (``patch_offsets_jnp``,
``gather_patches``, ``gather_patches_from_coords``) and of the Pallas
kernel ``vts_tpu/ops/pallas_gather.py::gather_patches_pallas``.  The CUDA
kernel is ``vts_torch/csrc/gather_patches.cu``.  :func:`gather_patches`
launches it for a CUDA tensor and takes :func:`gather_patches_plain` for a
CPU tensor only.

Modes, as in the reference: ``'gather'`` clamps every pixel index into the
image (out-of-bounds windows repeat edge pixels); ``'slice'`` clamps the
window origin (a whole-window shift).  Both agree on in-bounds windows.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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
    ox = offset_x.long()
    oy = offset_y.long()
    if mode == "slice":
        ox = ox.clamp(0, w - cutout)
        oy = oy.clamp(0, h - cutout)
    elif mode != "gather":
        raise NotImplementedError(mode)
    ar = torch.arange(cutout, device=image.device)
    iy = (oy[..., None] + ar).clamp(0, h - 1)                 # (N, K, cut)
    ix = (ox[..., None] + ar).clamp(0, w - 1)
    bi = torch.arange(n, device=image.device)[:, None, None, None]
    out = image[bi, iy[..., :, None], ix[..., None, :]]       # (N, K, cut, cut, C)
    return out.reshape((-1, cutout, cutout, c))


def _lib():
    lib = build.load("gather_patches")
    lib.gather_patches.argtypes = _ARGTYPES
    lib.gather_patches.restype = ctypes.c_int
    return lib


def gather_patches(image: torch.Tensor, offset_x: torch.Tensor, offset_y: torch.Tensor,
                   cutout: int, mode: str = "gather") -> torch.Tensor:
    """K windows of cutout² from each image.  image (H, W, C) with (K,) offsets
    → (K, cut, cut, C); image (N, H, W, C) with (N, K) offsets → (N·K, cut,
    cut, C), sample-major.  Offsets are int top-left corners (x, y)."""
    if mode not in _MODES:
        raise NotImplementedError(mode)
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
