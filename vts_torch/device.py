"""Device resolution for the port's entry points: CUDA unless asked otherwise,
and never a quiet fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False; "
            "pass --device cpu (or device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return dev
