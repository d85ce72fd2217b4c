"""The garment fleet (``vts_tpu/parallel/fleet.py``): G independent garments
trained in one process on one card; over several cards, one such process
(a rank) per card, each on its block of the garments (:mod:`vts_torch.launch`).

The reference stacks the garments' states on a leading axis and ``vmap``s
its fused step over it.  Here each garment has a slot (:class:`GarmentSlot`:
its G, D and D2, their Adam moments, the batch statistics riding in the
nets, and its draw generator), and one model
(:class:`~vts_torch.models.sinskit.SinSKITModel` or a subclass) holds the
frozen towers (LPIPS, Inception, CLIP and the D3 heads, on the device once)
and the step's code.  A fleet step points the model at slot g and runs the
model's own ``set_input`` and ``optimize_parameters`` for each garment in
turn: swapping references copies nothing, and the single step stays the one
source of the step's math, so a fleet step is, bit for bit, G independent
single-garment steps from the same weights, batches and draws.  The
garments run one after another, so the card holds one step's activations at
a time beside the G small states.

Seeds, as the reference's (``FleetTrainer.init_states(seeds=range(G))``,
``vts_tpu/launch.py:128-130``): garment g's G, D and D2 initialize as a
single-garment run with ``--seed g`` would (G from g, D from g + 1, D2 from
g + 2), whatever ``--seed`` is.  Garment g's draws (DiffAugment, the "more
fake T" offsets, the LPIPS crop, WGAN-GP's weights) come from its own
``torch.Generator`` seeded with ``--seed`` + g; with the default ``--seed``
0, garment g's run is then the single run with ``--seed g``, draws included.
``step(..., draws=[...])`` injects them instead, as the single step's
``optimize_parameters(draws=...)`` does.  A trainer of a block of garments
(``first``: the block's first garment) seeds each by its place in the whole
fleet, so a garment's run is the same on whichever rank it sits.

The state functions work on the port's state dicts (flat name → tensor):
:func:`stack_states` stacks G of them leaf-wise on a new axis 0, as the
reference's stacks its pytrees.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..platform import over_ranks, world

NETS = ("G", "D", "D2")


def stack_states(states: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-garment state dicts → one with every leaf stacked on a new axis 0."""
    keys = list(states[0])
    if any(list(s) != keys for s in states[1:]):
        raise ValueError("the garments' state dicts hold different keys")
    return {k: torch.stack([s[k] for s in states], dim=0) for k in keys}


def unstack_state(stacked: Dict[str, torch.Tensor], index: int) -> Dict[str, torch.Tensor]:
    return {k: v[index] for k, v in stacked.items()}


def common_keys(batches: Sequence[Dict]) -> List[str]:
    """The keys every batch has, in the first batch's order."""
    shared = set(batches[0])
    for b in batches[1:]:
        shared &= set(b)
    return [k for k in batches[0] if k in shared]


def stack_batches(batches: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """Per-garment batches → one with each shared key stacked on a new axis 0
    (the keys that some garment lacks are dropped, as by the reference)."""
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches], dim=0)
            for k in common_keys(batches)}


@dataclasses.dataclass
class GarmentSlot:
    """One garment's training state."""
    nets: Dict[str, torch.nn.Module]
    adam: Dict
    generator: torch.Generator


class FleetTrainer:
    """G garments' slots around one model; see the module docstring."""

    def __init__(self, model, num_garments: int, first: int = 0):
        self.model = model
        self.num_garments = num_garments
        self.first = first
        self.slots: List[GarmentSlot] = []
        self.losses: List[Dict[str, torch.Tensor]] = []

    def init_states(self, seeds: Optional[List[int]] = None) -> List[GarmentSlot]:
        """The model's ``setup`` once (its frozen towers), then one slot per
        seed (default the garments' places in the fleet, ``first`` … ``first``
        + G − 1): the model's networks copied and initialized from that seed
        in place, with fresh Adam moments."""
        model = self.model
        seeds = list(range(self.first, self.first + self.num_garments)) if seeds is None \
            else list(seeds)
        if len(seeds) != self.num_garments:
            raise ValueError(f"{len(seeds)} seeds for {self.num_garments} garments")
        model.setup()
        base = {name: getattr(model, f"net{name}") for name in NETS}
        self.slots = []
        for g, seed in enumerate(seeds):
            for name, net in base.items():
                setattr(model, f"net{name}", copy.deepcopy(net))
            model.init_nets(seed)
            self.slots.append(GarmentSlot(
                nets={name: getattr(model, f"net{name}") for name in NETS}, adam=model.adam,
                generator=torch.Generator().manual_seed(int(model.opt.seed) + self.first + g)))
        self.select(0)
        return self.slots

    def select(self, g: int) -> None:
        """Point the model at garment g's networks, Adam moments and generator
        (and its losses of the last step, for ``get_current_losses``)."""
        slot = self.slots[g]
        for name, net in slot.nets.items():
            setattr(self.model, f"net{name}", net)
        self.model.adam = slot.adam
        self.model.generator = slot.generator
        if g < len(self.losses):
            self.model._losses = self.losses[g]

    def step(self, batches: Sequence[Dict], epoch: int,
             draws: Optional[Sequence[Dict]] = None) -> List[Dict[str, torch.Tensor]]:
        """One training step of every garment at ``epoch`` (its lr, and D3 from
        ``--vision_aided_warmup_epoch`` on): garment g takes ``batches[g]``,
        cut to the keys every garment's batch has, and ``draws[g]`` when
        given, else its own generator's.  The per-garment losses (detached
        tensors), also kept in :attr:`losses`."""
        if len(batches) != self.num_garments:
            raise ValueError(f"{len(batches)} batches for {self.num_garments} garments")
        keys = common_keys(batches)
        model = self.model
        self.losses = []
        for g, batch in enumerate(batches):
            self.select(g)
            # no sample key: the per-sample caches are the single model's
            # (the reference's fleet step takes none either)
            model.set_input({k: batch[k] for k in keys if k != "sample_idx"})
            model.optimize_parameters(epoch, draws=None if draws is None else draws[g])
            self.losses.append(dict(model._losses))
        return self.losses

    def mean_losses(self, total: Optional[int] = None) -> Dict[str, float]:
        """The last step's losses, each averaged over the garments (one
        device-to-host copy).  On ranks, each holding its block of a fleet
        of ``total``: over every rank's garments, each rank's block put in
        a zero (total, losses) table that one sum over the ranks fills."""
        names = sorted(self.losses[0])
        dev = self.model.device
        table = torch.stack([torch.stack([torch.as_tensor(l[k], dtype=torch.float32, device=dev)
                                          for k in names]) for l in self.losses])
        if world() is not None:
            full = table.new_zeros((total, len(names)))
            full[self.first:self.first + self.num_garments] = table
            table = over_ranks(full)
        vals = table.mean(0).cpu()
        return {k: float(v) for k, v in zip(names, vals)}

    def save(self, g: int, ckpt_dir: str, tag: str = "latest") -> None:
        """Garment g's ``<tag>_{net,opt}_{G,D,D2}.msgpack`` under ``ckpt_dir``."""
        self.select(g)
        self.model.save_networks(tag, ckpt_dir=ckpt_dir)

    def load_states(self, per_garment: Sequence[Dict]) -> None:
        """Each slot's networks (and Adam state) from ``per_garment[g][name]`` =
        ``(state dict, (count, mu, nu) or None)``, e.g. what
        :func:`vts_torch.utils.convert_jax.fleet_states_to_torch` gives."""
        for slot, states in zip(self.slots, per_garment):
            for name, (sd, adam) in states.items():
                net = slot.nets[name]
                dev = next(iter(net.state_dict().values())).device
                net.load_state_dict({k: v.to(dev) for k, v in sd.items()})
                if adam is not None and name in slot.adam:
                    a = slot.adam[name]
                    a.count, mu, nu = adam
                    a.mu = {k: v.to(dev) for k, v in mu.items()}
                    a.nu = {k: v.to(dev) for k, v in nu.items()}
