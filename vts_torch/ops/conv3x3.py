"""K1: fused 3×3/s1/p1 conv + bias (+ ReLU) over NHWC — the LPIPS VGG16
block-1/2 convs — and its input gradient.

Counterpart of ``vts_tpu/ops/pallas_conv.py::conv3x3_relu``, forward and
backward.  One CUDA kernel template, ``vts_torch/csrc/conv3x3.cu``, built
for both directions: the forward, and dx (the ReLU-masked cotangent
convolved with the spatially flipped, in/out-transposed weight, as
``pallas_conv.py:119-127`` launches the same Pallas kernel for it).  Its
source notes say what bounds it on the H100 and how it is laid out.

:func:`conv3x3_bias_relu` is differentiable (a ``torch.autograd.Function``):
its backward launches the dx kernel, and computes dw/db with plain einsums
only when they are asked for (the LPIPS weights are frozen buffers, so the
training path never asks).  Each wrapper launches its kernel for a CUDA
tensor and takes its plain version for a CPU tensor only; the two launch
counts are kept apart (``conv3x3_bias_relu.launches``,
``conv3x3_dx.launches``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def conv3x3_bias_relu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            relu: bool = True) -> torch.Tensor:
    """Plain version: zero pad, the nine shifted (…, C)×(C, Co) products
    summed in fp32, bias, ReLU.  x (N, H, W, C), w (3, 3, C, Co) HWIO,
    b (Co,) → (N, H, W, Co) in x's dtype."""
    n, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + torch.matmul(xp[:, dy:dy + h, dx:dx + wd, :], wf[dy, dx])
    acc = acc + b.float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(x.dtype)


def conv3x3_dx_plain(gy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """Plain version of the input gradient: g = gy·[y > 0] (or gy without the
    ReLU), convolved with w flipped in space and transposed in/out, no bias.
    gy, y (N, H, W, Co); w (3, 3, C, Co) the forward weight → (N, H, W, C)."""
    g = torch.where(y > 0, gy, torch.zeros_like(gy)) if relu else gy
    wt = torch.flip(w, (0, 1)).transpose(2, 3)
    zero = torch.zeros(w.shape[2], dtype=torch.float32, device=gy.device)
    return conv3x3_bias_relu_plain(g, wt, zero, relu=False)


def _lib():
    lib = build.load("conv3x3")
    for fn in (lib.conv3x3_bias_relu_f32, lib.conv3x3_bias_relu_bf16, lib.conv3x3_dx_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """One forward: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]) or b.shape != (w.shape[-1],):
        raise ValueError(f"conv3x3_bias_relu: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, w, b, relu)
    if x.device.type != "cuda" or w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3_bias_relu: x, w, b must lie on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"conv3x3_bias_relu: x and w must both be float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    n, h, wd, c = x.shape
    co = w.shape[-1]
    x = x.contiguous()
    w = w.contiguous()
    b = b.float().contiguous()
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    fn = lib.conv3x3_bias_relu_f32 if x.dtype == torch.float32 else lib.conv3x3_bias_relu_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                n, h, wd, c, co, int(bool(relu)), stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bias_relu kernel launch failed: CUDA error {rc}")
    conv3x3_bias_relu.launches += 1
    return y


def conv3x3_dx(gy: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               relu: bool = True) -> torch.Tensor:
    """Input gradient of :func:`conv3x3_bias_relu`.  gy, y (N, H, W, Co) the
    output's cotangent and the saved output (read only when ``relu``), w
    (3, 3, C, Co) the forward HWIO weight → dx (N, H, W, C), fp32."""
    if gy.dim() != 4 or y.shape != gy.shape or w.dim() != 4 or w.shape[:2] != (3, 3) \
            or w.shape[-1] != gy.shape[-1]:
        raise ValueError(f"conv3x3_dx: bad shapes gy {tuple(gy.shape)}, y {tuple(y.shape)}, "
                         f"w {tuple(w.shape)}")
    if gy.device.type == "cpu":
        return conv3x3_dx_plain(gy, y, w, relu)
    if gy.device.type != "cuda" or y.device != gy.device or w.device != gy.device:
        raise ValueError("conv3x3_dx: gy, y, w must lie on one CUDA device")
    if gy.dtype != torch.float32 or y.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv3x3_dx: the dx kernel takes float32, got gy {gy.dtype}, "
                        f"y {y.dtype}, w {w.dtype}")
    n, h, wd, k = gy.shape
    c = w.shape[2]
    gy = gy.contiguous()
    y = y.contiguous() if relu else gy
    w = w.contiguous()
    dx = torch.empty((n, h, wd, c), dtype=torch.float32, device=gy.device)
    if dx.numel() == 0:
        return dx
    lib = _lib()
    with torch.cuda.device(gy.device):
        stream = torch.cuda.current_stream(gy.device).cuda_stream
        rc = lib.conv3x3_dx_f32(gy.data_ptr(), y.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                n, h, wd, c, k, int(bool(relu)), stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_dx kernel launch failed: CUDA error {rc}")
    conv3x3_dx.launches += 1
    return dx


conv3x3_dx.launches = 0


class _Conv3x3BiasRelu(torch.autograd.Function):
    """relu(conv3x3(x, w) + b) with the dx kernel as its input gradient."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        y = _forward(x, w, b, relu)
        ctx.relu = relu
        need_wb = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.save_for_backward(y, w, x if need_wb else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        y, w, x = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dx(gy, y, w, ctx.relu).to(y.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # dw/db: plain einsums, as in the reference (XLA there, never
            # requested by the training path: the LPIPS weights are frozen)
            g = (torch.where(y > 0, gy, torch.zeros_like(gy)) if ctx.relu else gy).float()
            if ctx.needs_input_grad[1]:
                h, wd = x.shape[1], x.shape[2]
                xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
                dw = torch.stack([torch.stack([
                    torch.einsum("nhwc,nhwd->cd", xp[:, dy:dy + h, dx_:dx_ + wd, :], g)
                    for dx_ in range(3)]) for dy in range(3)]).to(w.dtype)
            if ctx.needs_input_grad[2]:
                db = torch.sum(g, dim=(0, 1, 2))
        return dx, dw, db, None


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """relu(conv3x3_s1_p1(x, w) + b), NHWC.  x (N, H, W, C) fp32 or bf16,
    w (3, 3, C, Co) in x's dtype, b (Co,).  Any H, W, C, Co.  Differentiable:
    the input gradient runs :func:`conv3x3_dx` (fp32)."""
    return _Conv3x3BiasRelu.apply(x, w, b, bool(relu))


conv3x3_bias_relu.launches = 0
