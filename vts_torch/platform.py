"""Ranks: a process per device, joined in one ``torch.distributed`` group
(``vts_tpu/platform.py``).

The reference runs one program over all of a host's chips and, with
``--multihost``, calls ``jax.distributed.initialize`` so that its meshes
span every host.  Here each device of a layout is one process, a rank:

  * :func:`spawn_ranks` starts the ranks of a list of devices on this
    machine (``torch.multiprocessing``, spawn), joined through a file store
    in a temporary directory of their own, so that runs side by side never
    meet on a port; a rank that fails fails the call;
  * :func:`init_multihost` joins a process started elsewhere (one per
    device, on one host or several): ``--multihost`` with
    ``--coordinator_address``/``--num_processes``/``--process_id``, or
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK`` where those flags are unset.

The backend follows the layout, never a failure: ``nccl`` when every rank
holds a card of its own, ``gloo`` on the CPU or when ranks share a card.
The ranks first meet over ``gloo``, tell each other their device, and make
the ``nccl`` group when that rule asks for it.  Every rank prints
``[dist] rank r/W on <device> (backend b)``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .device import describe, resolve_device


@dataclasses.dataclass
class World:
    """The ranks this process belongs to: its rank, their number, each rank's
    device (as that rank named it), the backend and the group collectives
    go through."""
    rank: int
    size: int
    devices: List[torch.device]
    backend: str
    group: object

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def lead(self) -> bool:
        return self.rank == 0


_WORLD: Optional[World] = None


def world() -> Optional[World]:
    """This process's ranks, or None when it is not one of several."""
    return _WORLD


def is_lead() -> bool:
    """Whether this process writes a run's files: rank 0, or the only process."""
    return _WORLD is None or _WORLD.lead


def agree(values: Sequence[float]) -> List[float]:
    """Rank 0's ``values`` on every rank (the values themselves outside
    ranks): a decision that only rank 0 takes, the same everywhere."""
    if _WORLD is None:
        return list(values)
    dev = _WORLD.device if _WORLD.backend == "nccl" else torch.device("cpu")
    t = torch.tensor(list(values), dtype=torch.float64, device=dev)
    dist.broadcast(t, src=0, group=_WORLD.group)
    return t.tolist()


def over_ranks(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks by ``op`` ("sum" or "min"); ``t``
    itself outside ranks."""
    if _WORLD is None:
        return t
    s = t.to(_WORLD.device if _WORLD.backend == "nccl" else torch.device("cpu"))
    dist.all_reduce(s, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op],
                    group=_WORLD.group)
    return s.to(t.device)


def join(rank: int, size: int, device: torch.device, init_method: str) -> World:
    """Join ``size`` ranks as ``rank`` on ``device`` through ``init_method``."""
    global _WORLD
    if device.type == "cuda":
        torch.cuda.set_device(device)
        device = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=size)
    where: List = [None] * size
    dist.all_gather_object(where, (socket.gethostname(), device.type, device.index))
    own_cards = all(w[1] == "cuda" for w in where) and len(set(where)) == size
    backend = "nccl" if own_cards else "gloo"
    group = dist.new_group(backend="nccl") if own_cards else dist.group.WORLD
    _WORLD = World(rank, size, [torch.device(t, i) if i is not None else torch.device(t)
                                for _, t, i in where], backend, group)
    # one write, so that the ranks' lines do not interleave
    sys.stdout.write(f"[dist] rank {rank}/{size} on {describe(device)} (backend {backend})\n")
    sys.stdout.flush()
    return _WORLD


def leave() -> None:
    """Leave the ranks (a no-op outside them)."""
    global _WORLD
    if _WORLD is not None:
        dist.destroy_process_group()
        _WORLD = None


def init_multihost(opt) -> bool:
    """``--multihost``: join the ranks at ``tcp://--coordinator_address`` as
    ``--process_id`` of ``--num_processes`` (torchrun's variables where the
    flags are unset), on the card ``LOCAL_RANK`` (else the process id)
    modulo this host's cards, or on the CPU.  True when it joined; a no-op
    (False) without ``--multihost``, as in the reference."""
    if not getattr(opt, "multihost", False):
        return False
    env = os.environ
    need = [v for flag, v in (("coordinator_address", "MASTER_ADDR"), ("num_processes",
                                                                      "WORLD_SIZE"),
                              ("process_id", "RANK"))
            if getattr(opt, flag) in ("", -1) and v not in env]
    if need:
        raise ValueError(f"--multihost: set --coordinator_address, --num_processes and "
                         f"--process_id, or torchrun's variables ({', '.join(need)} missing)")
    addr = opt.coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    size = opt.num_processes if opt.num_processes >= 0 else int(env["WORLD_SIZE"])
    rank = opt.process_id if opt.process_id >= 0 else int(env["RANK"])
    device = resolve_device(opt.device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    join(rank, size, device, f"tcp://{addr}")
    return True


def _rank_main(rank: int, fn: Callable, args: tuple, devices: Sequence[torch.device],
               init_method: str, out_dir: str, threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    join(rank, len(devices), devices[rank], init_method)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
        dist.barrier(group=_WORLD.group)
    except BaseException as err:
        torch.save(err, os.path.join(out_dir, f"error_{rank}.pt"))
        raise
    finally:
        leave()


def spawn_ranks(fn: Callable, args: tuple = (), devices: Sequence[torch.device] = (),
                threads: Optional[int] = None, tmp_dir: Optional[str] = None) -> List:
    """Run ``fn(*args)`` in one spawned rank per entry of ``devices`` (two
    entries may name one device: ranks that share a card, or CPU ranks) and
    return each rank's result, in rank order.  ``fn`` must be importable by
    name (spawn pickles it); ``threads``: each rank's intra-op threads;
    ``tmp_dir``: where the store's directory goes (default the system's).
    A rank that raises ends the others, and its exception is raised here."""
    import torch.multiprocessing as mp
    devices = [torch.device(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="vts_ranks_", dir=tmp_dir) as d:
        init = f"file://{os.path.join(d, 'store')}"
        try:
            mp.start_processes(_rank_main, args=(fn, args, devices, init, d, threads),
                               nprocs=len(devices), join=True, start_method="spawn")
        except mp.ProcessRaisedException as failed:
            path = os.path.join(d, f"error_{failed.error_index}.pt")
            if os.path.exists(path):
                raise torch.load(path, weights_only=False) from failed
            raise
        return [torch.load(os.path.join(d, f"result_{r}.pt"), weights_only=False)
                for r in range(len(devices))]
