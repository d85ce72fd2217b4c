"""Checkpoint io in the reference's own file format (``vts_tpu/models/base.py``).

One ``<tag>_net_<Name>.msgpack`` per network per tag, holding
``{"params": <flax param tree>, "stats": <batch stats or {}>}``, written and
read by the port's own msgpack codec, so either package loads the other's
checkpoints.  Missing files are skipped with a message, like the reference.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import torch

from ..utils.msgpack import msgpack_restore, msgpack_serialize


def save_net(ckpt_dir: str, tag: str, name: str, params: Dict, stats: Dict = None) -> str:
    """Write one network's param tree (numpy leaves, flax layout)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{tag}_net_{name}.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_serialize({"params": params, "stats": stats or {}}))
    return path


def load_net(ckpt_dir: str, tag: str, name: str, net: torch.nn.Module,
             params_to_torch: Callable[[Dict], Dict]) -> bool:
    """Load ``<tag>_net_<name>.msgpack`` into ``net``; False if absent."""
    path = os.path.join(ckpt_dir, f"{tag}_net_{name}.msgpack")
    if not os.path.exists(path):
        print(f"[load_networks] {path} not found — keeping initialized weights")
        return False
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    if payload.get("stats"):
        raise NotImplementedError(f"{path}: batch-stat networks are not ported yet")
    net.load_state_dict(params_to_torch(payload["params"]))
    return True
