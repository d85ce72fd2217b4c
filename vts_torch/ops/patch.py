"""K2: batched patch extraction — windows cut from NHWC images at offsets —
its gradient (a scatter-add), and the "more fake T" offset sampler.

Counterpart of ``vts_tpu/ops/patch.py`` (``patch_offsets_jnp``,
``gather_patches``, ``gather_patches_from_coords``, ``dilate_mask``,
``sample_offsets_in_mask``) and of the Pallas kernel
``vts_tpu/ops/pallas_gather.py::gather_patches_pallas``.  Two CUDA kernels:
``vts_torch/csrc/gather_patches.cu`` (forward) and
``vts_torch/csrc/scatter_patches.cu`` (backward: the scatter-add that the
JAX package leaves to XLA's transpose of the gather).

:func:`gather_patches_group` cuts the same windows from up to 4 images of
one size in one launch, at int offsets or at the data's packed coords,
which the kernel decodes itself; :func:`gather_patches` and
:func:`gather_patches_from_coords` are groups of one.  The gather is
differentiable in each image.  Each wrapper launches its kernel for CUDA
tensors and takes its plain version for CPU tensors only, and the launch
counts are kept apart (``gather_patches.launches``,
``scatter_patches.launches``).

Modes, as in the reference: ``'gather'`` clamps every pixel index into the
image (out-of-bounds windows repeat edge pixels); ``'slice'`` clamps the
window origin (a whole-window shift).  Both agree on in-bounds windows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ._launch import entry, launch

_P, _I = ctypes.c_void_p, ctypes.c_int
# gather_patches_group: 4 images, 4 outputs, 4 channel counts + nsrc, off_x,
# off_y, coords, mult, N, K, H, W, cut, mode, element size, stream
_GROUP_ARGTYPES = [_P] * 8 + [_I] * 5 + [_P] * 3 + [_I] * 8 + [_P]
# scatter_patches_{f32,bf16}: g, off_x, off_y, coords, mult, canvas, N, K, H, W, C, cut,
# mode, stream
_SCATTER_ARGTYPES = [_P] * 4 + [_I, _P] + [_I] * 7 + [_P]
_MODES = {"gather": 0, "slice": 1}
MAX_GROUP = 4


def _round_int32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even like ``jnp.round``, then convert as XLA (and CUDA)
    convert to int32: NaN, which the all-zero coords of a padded patch give,
    to 0, and out-of-range values saturated (PyTorch's own cast on the CPU
    would give INT_MIN for both)."""
    return torch.round(x).double().nan_to_num(0.0).clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)


def patch_offsets(coords: torch.Tensor, scale_multiplier: int = 1):
    """Packed coords (..., 8) → int32 (offset_x, offset_y, cutout), in fp32 like
    the reference."""
    coords = coords.float()
    rr = coords[..., 5]
    off_x = _round_int32((coords[..., 0] + coords[..., 6] / rr) * scale_multiplier)
    off_y = _round_int32((coords[..., 1] + coords[..., 7] / rr) * scale_multiplier)
    cutout = _round_int32(coords[..., 4] / rr * scale_multiplier)
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


class _Windows(NamedTuple):
    """K windows in each of n images: int offsets, or packed coords with
    their scale multiplier."""
    offset_x: Optional[torch.Tensor]
    offset_y: Optional[torch.Tensor]
    coords: Optional[torch.Tensor]
    mult: int
    n: int
    k: int

    def offsets(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n, k) offsets for the plain versions, decoded by patch_offsets from coords."""
        if self.coords is None:
            ox, oy = self.offset_x, self.offset_y
        else:
            ox, oy, _ = patch_offsets(self.coords, self.mult)
        return ox.reshape(self.n, self.k), oy.reshape(self.n, self.k)

    def kernel_args(self, device: torch.device):
        """(off_x, off_y, coords) pointers for a kernel, cast only where the
        dtype or the layout needs it."""
        ts = (self.offset_x, self.offset_y) if self.coords is None else (self.coords,)
        if any(t.device != device for t in ts):
            raise ValueError("gather_patches: the windows must lie on the images' device")
        if self.coords is None:
            ox, oy = (t if t.dtype == torch.int32 and t.is_contiguous()
                      else t.to(torch.int32).contiguous() for t in ts)
            return (ox, oy), (ox.data_ptr(), oy.data_ptr(), None)
        c = self.coords
        if c.dtype != torch.float32 or not c.is_contiguous():
            c = c.float().contiguous()
        return (c,), (None, None, c.data_ptr())


def _windows(n: int, offset_x, offset_y, coords, mult: int) -> _Windows:
    """Check the windows against n images: offsets (K,) for one image or (n, K);
    coords (..., 8), all of them cut from a single image, or (n, K, 8)."""
    if coords is not None:
        if offset_x is not None or offset_y is not None or coords.shape[-1:] != (8,):
            raise ValueError(f"gather_patches: give offsets or (..., 8) coords, not both; "
                             f"got coords {tuple(coords.shape)}")
        if n == 1:
            return _Windows(None, None, coords, mult, 1, coords.numel() // 8)
        if coords.dim() != 3 or coords.shape[0] != n:
            raise ValueError(f"gather_patches: coords {tuple(coords.shape)} do not match "
                             f"{n} images")
        return _Windows(None, None, coords, mult, n, coords.shape[1])
    if offset_x is None or offset_y is None or offset_x.shape != offset_y.shape \
            or offset_x.dim() not in (1, 2) or offset_x.dim() == 1 and n != 1 \
            or offset_x.dim() == 2 and offset_x.shape[0] != n:
        shapes = [None if t is None else tuple(t.shape) for t in (offset_x, offset_y)]
        raise ValueError(f"gather_patches: offsets {shapes} do not match {n} images")
    return _Windows(offset_x, offset_y, None, mult, n, offset_x.shape[-1])


def _group_size(images: Sequence[torch.Tensor]) -> Tuple[int, int, int]:
    """(N, H, W) that the images of a group share; they must also share a
    device and an element size."""
    if not 1 <= len(images) <= MAX_GROUP:
        raise ValueError(f"gather_patches_group: 1 to {MAX_GROUP} images, got {len(images)}")
    first = images[0]
    size = (1, *first.shape[:2]) if first.dim() == 3 else tuple(first.shape[:3])
    for im in images:
        if im.dim() not in (3, 4) or \
                ((1, *im.shape[:2]) if im.dim() == 3 else tuple(im.shape[:3])) != size:
            raise ValueError(f"gather_patches_group: image {tuple(im.shape)} does not "
                             f"share (N, H, W) = {size}")
        if im.device != first.device:
            raise ValueError("gather_patches_group: the images lie on different devices")
        if im.element_size() != first.element_size():
            raise TypeError(f"gather_patches_group: element sizes differ ({im.dtype} and "
                            f"{first.dtype})")
    return size


def _gather_group(images, win: _Windows, cutout: int, mode: str):
    """One forward: the kernel for CUDA tensors, the plain version for CPU ones."""
    dev = images[0].device
    if dev.type == "cpu":
        ox, oy = win.offsets()
        return tuple(gather_patches_plain(im.reshape(win.n, *im.shape[-3:]), ox, oy,
                                          cutout, mode) for im in images)
    if dev.type != "cuda":
        raise ValueError("gather_patches: the images must lie on one CUDA device")
    h, w = images[0].shape[-3:-1]
    if cutout > h or cutout > w or cutout <= 0:
        raise ValueError(f"gather_patches: cutout {cutout} does not fit {h}x{w}")
    esize = images[0].element_size()
    if esize not in (1, 2, 4, 8):
        raise TypeError(f"gather_patches: unsupported dtype {images[0].dtype}")
    # ``keep`` holds every cast or contiguous copy until the launch is
    # enqueued: freed earlier, its memory could become one of the outputs
    keep, ptrs = win.kernel_args(dev)
    srcs, outs = [None] * MAX_GROUP, [None] * MAX_GROUP
    chans = [0] * MAX_GROUP
    result = []
    for s, im in enumerate(images):
        if not im.is_contiguous():
            im = im.contiguous()
        keep += (im,)
        out = torch.empty((win.n * win.k, cutout, cutout, im.shape[-1]), dtype=im.dtype,
                          device=dev)
        srcs[s], outs[s], chans[s] = im.data_ptr(), out.data_ptr(), im.shape[-1]
        result.append(out)
    if win.n * win.k == 0:
        return tuple(result)
    launch(entry("gather_patches", "gather_patches_group", _GROUP_ARGTYPES), dev,
           *srcs, *outs, *chans, len(images), *ptrs, win.mult, win.n, win.k, h, w, cutout,
           _MODES[mode], esize)
    gather_patches.launches += 1
    return tuple(result)


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
    ``accumulate=True`` into a zeroed fp32 canvas, rounded to grad's dtype.  On the CPU that adds in
    the order of the index tensor (window, row, column) when it runs
    serially: under ``torch.use_deterministic_algorithms(True)``, on one
    thread, or below PyTorch's parallel grain; otherwise it adds with atomics
    in parallel, in an order that varies."""
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
    return canvas.to(grad.dtype)


def scatter_patches(grad: torch.Tensor, offset_x: Optional[torch.Tensor],
                    offset_y: Optional[torch.Tensor], image_shape, mode: str = "gather", *,
                    coords: Optional[torch.Tensor] = None,
                    scale_multiplier: int = 1) -> torch.Tensor:
    """Transpose of :func:`gather_patches`: the (N·K, cut, cut, C) cotangent,
    fp32 or bf16, summed in fp32 into an (N, H, W, C) canvas of its dtype at
    the same windows, given by offsets or (with ``offset_x = offset_y =
    None``) by packed ``coords``.  Overlapping and clamped windows
    accumulate; a bf16 canvas element is rounded once, from its fp32 sum.
    On CUDA each canvas element is summed by one thread in a fixed order
    (window, row, column), so the result is the same from run to run."""
    if mode not in _MODES:
        raise NotImplementedError(mode)
    n, h, w, c = (int(v) for v in image_shape)
    win = _windows(n, offset_x, offset_y, coords, int(scale_multiplier))
    if grad.dim() != 4 or grad.shape[1] != grad.shape[2] or grad.shape[3] != c \
            or grad.shape[0] != win.n * win.k:
        raise ValueError(f"scatter_patches: cotangent {tuple(grad.shape)} does not match "
                         f"image {(n, h, w, c)} and {win.k} windows an image")
    dev = grad.device
    if dev.type == "cpu":
        return scatter_patches_plain(grad, *win.offsets(), (n, h, w, c), mode)
    if dev.type != "cuda":
        raise ValueError("scatter_patches: the cotangent must lie on a CUDA device")
    fn = {torch.float32: "scatter_patches_f32", torch.bfloat16: "scatter_patches_bf16"}.get(
        grad.dtype)
    if fn is None:
        raise TypeError(f"scatter_patches: the scatter kernel takes float32 or bfloat16, "
                        f"got {grad.dtype}")
    cutout = grad.shape[1]
    if cutout > h or cutout > w:
        raise ValueError(f"scatter_patches: cutout {cutout} does not fit {h}x{w}")
    g = grad if grad.is_contiguous() else grad.contiguous()
    keep, (ox, oy, cp) = win.kernel_args(dev)     # alive until the launch, as in the gather
    canvas = torch.empty((n, h, w, c), dtype=grad.dtype, device=dev)
    if canvas.numel() == 0:
        return canvas
    launch(entry("scatter_patches", fn, _SCATTER_ARGTYPES), dev,
           g.data_ptr(), ox, oy, cp, win.mult, canvas.data_ptr(), n, win.k, h, w, c, cutout,
           _MODES[mode])
    scatter_patches.launches += 1
    return canvas


scatter_patches.launches = 0


class _GatherPatches(torch.autograd.Function):
    """The grouped gather, with :func:`scatter_patches` as the gradient of
    each image that needs one."""

    @staticmethod
    def forward(ctx, win, cutout, mode, *images):
        ctx.win, ctx.mode = win, mode
        ctx.shapes = [tuple(im.shape) for im in images]
        outs = _gather_group(images, win, cutout, mode)
        ctx.mark_non_differentiable(*[o for o, needed in zip(outs, ctx.needs_input_grad[3:])
                                      if not needed])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        win = ctx.win
        canvases = []
        for g, shape, needed in zip(grads, ctx.shapes, ctx.needs_input_grad[3:]):
            if not needed:
                canvases.append(None)
                continue
            canvas = scatter_patches(g, win.offset_x, win.offset_y, (win.n, *shape[-3:]),
                                     ctx.mode, coords=win.coords, scale_multiplier=win.mult)
            canvases.append(canvas.to(g.dtype).reshape(shape))
        return (None, None, None, *canvases)


def gather_patches_group(images: Sequence[torch.Tensor], *,
                         offset_x: Optional[torch.Tensor] = None,
                         offset_y: Optional[torch.Tensor] = None,
                         coords: Optional[torch.Tensor] = None, cutout: int,
                         mode: str = "gather",
                         scale_multiplier: int = 1) -> Tuple[torch.Tensor, ...]:
    """The same K windows of cutout² from each of 1 to 4 images that share N,
    H, W, the device and the element size (channels may differ): one output
    (N·K, cut, cut, C_s) per image, sample-major, in one kernel launch.

    Images are (H, W, C) or (N, H, W, C).  The windows are int top-left
    corners ``offset_x``/``offset_y``, (K,) for one image or (N, K); or the
    data's packed ``coords``, (N, K, 8), or (..., 8) for one image, decoded
    as :func:`patch_offsets` does with ``scale_multiplier``.  Differentiable
    in each image (the gradient is :func:`scatter_patches`, shaped like the
    image that was passed)."""
    if mode not in _MODES:
        raise NotImplementedError(mode)
    images = tuple(images)
    n = _group_size(images)[0]
    win = _windows(n, offset_x, offset_y, coords, int(scale_multiplier))
    if torch.is_grad_enabled() and any(im.requires_grad for im in images):
        return _GatherPatches.apply(win, int(cutout), mode, *images)
    return _gather_group(images, win, int(cutout), mode)


def gather_patches(image: torch.Tensor, offset_x: torch.Tensor, offset_y: torch.Tensor,
                   cutout: int, mode: str = "gather") -> torch.Tensor:
    """K windows of cutout² from each image.  image (H, W, C) with (K,) offsets
    → (K, cut, cut, C); image (N, H, W, C) with (N, K) offsets → (N·K, cut,
    cut, C), sample-major.  Offsets are int top-left corners (x, y).
    Differentiable in the image.  A group of one of :func:`gather_patches_group`."""
    return gather_patches_group((image,), offset_x=offset_x, offset_y=offset_y,
                                cutout=cutout, mode=mode)[0]


gather_patches.launches = 0


def gather_patches_from_coords(image: torch.Tensor, coords: torch.Tensor,
                               patch_size: int = 32, scale_multiplier: int = 1,
                               mode: str = "gather") -> torch.Tensor:
    """Patches at packed coords.  image (N, H, W, C) with coords (N, K, 8) →
    (N·K, cut, cut, C) sample-major; a single image with (K, 8) or (1, K, 8)
    coords → (K, cut, cut, C).  cut = patch_size·scale_multiplier.  A group
    of one of :func:`gather_patches_group`."""
    return gather_patches_group((image,), coords=coords, cutout=patch_size * scale_multiplier,
                                mode=mode, scale_multiplier=scale_multiplier)[0]


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
