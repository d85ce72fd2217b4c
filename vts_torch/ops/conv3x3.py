"""K1: fused 3×3/s1/p1 conv + bias (+ ReLU) over NHWC — the LPIPS VGG16
block-1/2 convs.

Counterpart of ``vts_tpu/ops/pallas_conv.py::conv3x3_relu`` (forward).  The
CUDA kernel is ``vts_torch/csrc/conv3x3.cu``; its source note says what
bounds it on the H100 and how it is laid out.  :func:`conv3x3_bias_relu`
launches it for a CUDA tensor and takes :func:`conv3x3_bias_relu_plain` for
a CPU tensor only.
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


def _lib():
    lib = build.load("conv3x3")
    for fn in (lib.conv3x3_bias_relu_f32, lib.conv3x3_bias_relu_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """relu(conv3x3_s1_p1(x, w) + b), NHWC.  x (N, H, W, C) fp32 or bf16,
    w (3, 3, C, Co) in x's dtype, b (Co,).  Any H, W, C, Co."""
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


conv3x3_bias_relu.launches = 0
