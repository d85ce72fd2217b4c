"""Optimizer, learning-rate schedule and checkpoint io
(``vts_tpu/models/base.py``).

  * :class:`Adam` is ``optax.scale_by_adam(b1, b2, eps=1e-8)`` with the
    learning rate applied outside, as the reference's ``adam_step`` does:
    params ← params − lr · m̂ / (√v̂ + eps);
  * :func:`lr_factor` is the per-epoch multiplier on the base lr (1 under
    ``plateau``, whose :class:`PlateauTracker` scale the training driver
    multiplies in);
  * checkpoints are the reference's own files: ``<tag>_net_<Name>.msgpack``
    holding ``{"params": <flax tree>, "stats": <batch stats or {}>}`` and
    ``<tag>_opt_<Name>.msgpack`` holding the Adam state as
    ``flax.serialization.to_bytes`` writes it (``{"count", "mu", "nu"}``),
    read and written by the port's own msgpack codec, so either package
    loads the other's.  Missing files are skipped with a message.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..utils.msgpack import msgpack_restore, msgpack_serialize


class Adam:
    """Adam moments for a set of named parameters, with the lr applied by
    :meth:`step` (``optax.scale_by_adam`` + ``params − lr·update``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], b1: float, b2: float,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named_params}
        self.nu = {k: torch.zeros_like(p) for k, p in self.mu.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             lr: float) -> None:
        self.count += 1
        dev = next(iter(self.mu.values())).device
        # scalars filled on the device: a copy from the host would wait for
        # the stream, and a chunk of steps (--steps_per_dispatch) syncs nowhere
        c = torch.full((), self.count, dtype=torch.int32, device=dev)
        bc1 = 1.0 - torch.full((), self.b1, dtype=torch.float32, device=dev) ** c
        bc2 = 1.0 - torch.full((), self.b2, dtype=torch.float32, device=dev) ** c
        lr_t = torch.full((), lr, dtype=torch.float32, device=dev)
        for k, p in params.items():
            g = grads[k].float()
            mu = self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            nu = self.nu[k].mul_(self.b2).add_((1 - self.b2) * (g * g))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-lr_t * update)


def lr_factor(policy: str, epoch: int, opt) -> float:
    """Per-epoch multiplier on the base lr (reference networks.py:148-174)."""
    if policy == "linear":
        return 1.0 - max(0, epoch + opt.epoch_count - opt.n_epochs) / float(opt.n_epochs_decay + 1)
    if policy == "step":
        return 0.1 ** (epoch // opt.lr_decay_iters)
    if policy == "cosine":
        return 0.5 * (1 + math.cos(math.pi * min(epoch, opt.n_epochs) / opt.n_epochs))
    if policy == "plateau":
        return 1.0
    raise NotImplementedError(f"learning rate policy {policy!r} is not implemented")


class PlateauTracker:
    """ReduceLROnPlateau (mode min, factor 0.2, relative threshold 0.01,
    patience 5: the reference's scheduler).  :meth:`update` takes the
    epoch's metric and returns the lr scale."""

    FACTOR, PATIENCE, THRESHOLD = 0.2, 5, 0.01

    def __init__(self):
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.THRESHOLD):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.PATIENCE:
                self.scale *= self.FACTOR
                self.bad_epochs = 0
        return self.scale


def save_net(ckpt_dir: str, tag: str, name: str, params: Dict, stats: Dict = None,
             opt_state: Optional[Dict] = None) -> str:
    """Write one network's param tree (numpy leaves, flax layout), and its Adam
    state (``{"count", "mu", "nu"}`` in the same layout) when given."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{tag}_net_{name}.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_serialize({"params": params, "stats": stats or {}}))
    if opt_state is not None:
        with open(os.path.join(ckpt_dir, f"{tag}_opt_{name}.msgpack"), "wb") as f:
            f.write(msgpack_serialize(opt_state))
    return path


def load_net(ckpt_dir: str, tag: str, name: str, net: torch.nn.Module,
             params_to_torch: Callable[[Dict], Dict],
             stats_to_torch: Optional[Callable[[Dict], Dict]] = None) -> bool:
    """Load ``<tag>_net_<name>.msgpack`` (params, and batch stats through
    ``stats_to_torch``) into ``net``; False if the file is absent."""
    path = os.path.join(ckpt_dir, f"{tag}_net_{name}.msgpack")
    if not os.path.exists(path):
        print(f"[load_networks] {path} not found — keeping initialized weights")
        return False
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    sd = dict(params_to_torch(payload["params"]))
    if payload.get("stats"):
        if stats_to_torch is None:
            raise ValueError(f"{path} holds batch stats but this network has none")
        sd.update(stats_to_torch(payload["stats"]))
    dev = next(iter(net.state_dict().values())).device
    net.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    return True


def load_opt_state(ckpt_dir: str, tag: str, name: str) -> Optional[Dict]:
    """The ``{"count", "mu", "nu"}`` tree of ``<tag>_opt_<name>.msgpack``, or
    None when the file is absent."""
    path = os.path.join(ckpt_dir, f"{tag}_opt_{name}.msgpack")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
