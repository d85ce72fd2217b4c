"""Collectives of a data-parallel step (the counterpart of GSPMD's global
reductions under ``--mesh data:N``).

A :class:`DataGroup` is the ranks whose batch shards make up one global
batch.  Each rank's loss is its *share* of the global loss, so the
gradients of the ranks add up to the global gradient: :meth:`DataGroup.
all_reduce` sums over the ranks in the forward and, in the backward, sums
the ranks' cotangents (itself differentiable, for WGAN-GP's double
backward).  Only sums are used (``all_reduce``), which every backend runs
on CPU and CUDA tensors alike; a gather is a sum of zero-padded blocks.
:data:`TRAFFIC` counts the collectives this process made and the bytes each
rank contributed to them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

TRAFFIC = {"collectives": 0, "bytes": 0}


def reset_traffic() -> None:
    TRAFFIC.update(collectives=0, bytes=0)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        group.sum_(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g.contiguous(), ctx.group), None


class DataGroup:
    """This rank's data group: this rank's place in it (``rank``), the
    ranks' number (``size``) and their process ``group``."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place, with no gradient."""
        TRAFFIC["collectives"] += 1
        TRAFFIC["bytes"] += t.numel() * t.element_size()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``t``, with the gradient of that sum."""
        return _AllReduce.apply(t, self)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) stacked along axis 0
        in rank order, with the gradient to this rank's rows."""
        n = t.shape[0]
        pad = t.new_zeros((n,) + tuple(t.shape[1:]))
        return self.all_reduce(torch.cat([pad] * self.rank + [t]
                                         + [pad] * (self.size - 1 - self.rank), 0))

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t``'s axis 0 (of a whole batch's tensor)."""
        n = t.shape[0] // self.size
        return t[self.rank * n:(self.rank + 1) * n]

    def sum_flat_(self, tensors: List[torch.Tensor]) -> None:
        """Sum every tensor over the ranks in place, through one flat fp32
        buffer (one collective)."""
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        self.sum_(flat)
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
