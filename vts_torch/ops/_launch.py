"""The kernel wrappers' thin host path: a kernel library's C entry point,
looked up once, and its call on the device's current stream."""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..kernels import build

_FNS: Dict[str, object] = {}


def entry(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """A kernel library's C entry point, its argument types set once, when it
    loads."""
    fn = _FNS.get(fn_name)
    if fn is None:
        fn = getattr(build.load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[fn_name] = fn
    return fn


def launch(fn, device: torch.device, *args):
    """Call a kernel's entry point with the device's current stream as its
    last argument; a device guard only when the device is not the current
    one.  Raises on a nonzero CUDA error code."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(fn, device, *args)
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {rc}")
