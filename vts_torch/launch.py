"""Per-garment experiment launcher (``vts_tpu/launch.py``; the reference's
tmux/GPUtil layer, experiments/tmux_launcher.py:70-163, __main__.py:26-88).

The reference fans the 20 TouchClothing garments out as 20 OS processes.
Here a ``launch`` is either:

  * ``--mode fleet`` (the default): the garments sharded over
    g = min(G, devices) devices, as the reference shards them over its
    ``garment`` axis (``[fleet] G garments over g devices``; the devices
    are the cards, or on the CPU one device, as the reference's CPU has one,
    unless a ``--mesh garment:N`` among the flags lays N CPU ranks out, the
    counterpart of XLA's host devices; a g that does not divide G fails, as
    the reference's ``device_put`` does).  One process (a rank,
    :mod:`vts_torch.platform`; the only process when g is 1) per device
    trains its contiguous block of garments (:mod:`vts_torch.parallel.fleet`):
    the frozen LPIPS, Inception, CLIP and D3 towers on its device once, its
    garments' steps one after another, each garment's G, D and D2
    initialized from its index in the fleet as ``--seed`` (the reference's
    ``seeds=range(G)``).  Each epoch runs over the zip of the garments'
    loaders (as long as the shortest), a ``[fleet]`` line with each loss
    averaged over all the garments every ``max(1, print_freq // 100)``
    epochs (rank 0 prints it), each garment's ``latest_{net,opt}_{G,D,D2}
    .msgpack`` under ``<checkpoints_dir>/<material>_<suffix>`` every
    ``--save_epoch_freq`` epochs and at the end, by the rank that trains it;
    no validation, no ``best`` and no gallery, as in the reference.  A
    ``--mesh`` among the flags gets the reference's checks (its model's
    setup builds that mesh) and changes no step: the reference's fleet
    steps each garment's whole batch.  ``ours`` and ``skit`` run in the
    fleet; the baselines' presets (pix2pix, pix2pixhd, spade) are refused by
    name, before any data is built (the reference's fleet calls
    ``_train_step(..., frozen, use_d3=...)``, which their steps do not take);
  * ``--mode process``: one ``vts_torch.train`` (phase ``launch``) or
    ``vts_torch.test`` (phase ``test``) subprocess per garment, all at once
    on the same card; the first non-zero exit code is returned.

The ``test`` phase always runs process mode, as in the reference: test a
fleet's garments with ``--epoch latest`` (the default ``best`` finds no
checkpoint after a fleet launch, and the test driver then keeps the
initialized weights with a message, as the reference's does).  ``commands``
prints the per-garment commands, ``compare`` writes one side-by-side gallery
per garment over the methods (:mod:`vts_torch.utils.compare`).  Flags after
``--`` go to every child unchanged, or to the fleet's options; both run on
``cuda`` unless given ``--device cpu`` there.

Usage:
  python -m vts_torch.launch ours launch --materials mat1,mat2 \\
      --dataroot-template ./datasets/singleskit_{material}_padded_1800_x1/ -- --n_epochs 5
  python -m vts_torch.launch ours launch --mode process --materials ...
  python -m vts_torch.launch ours test --materials ... --epoch latest
  python -m vts_torch.launch ours commands
  python -m vts_torch.launch ours compare --against skit --filter fake_I
"""

from __future__ import annotations

import argparse
import copy
import itertools
import os
import shlex
import subprocess
import sys
import time
from typing import Dict, List

# per-method flag presets (reference experiments/SingleG_AllMaterials_baseline_*_launcher.py
# and the edited-sketch test launcher ..._test_DALLE_sketch_launcher.py)
METHOD_PRESETS: Dict[str, Dict] = {
    "ours": dict(model="sinskit", dataset_mode="singleskit", name_suffix="sinskitG_baseline_ours"),
    "pix2pix": dict(model="pix2pix", dataset_mode="patchskit", name_suffix="pix2pix_baseline"),
    "pix2pixhd": dict(model="pix2pixhd", dataset_mode="patchskit", name_suffix="pix2pixHD_baseline"),
    "spade": dict(model="spade", dataset_mode="patchskit", name_suffix="spade_baseline"),
    "skit": dict(model="skit", dataset_mode="skit", name_suffix="skitG"),
    # trained 'ours' checkpoints on edited (e.g. DALL-E) sketches: the
    # dataroot template points at the *_edit_* roots (S and M only, no
    # ground truth: metrics skipped, galleries and raw touch maps written)
    "ours_edit": dict(model="sinskit", dataset_mode="singleskit",
                      name_suffix="sinskitG_baseline_ours"),
}

# the TouchClothing 20-garment material list (reference
# experiments/SingleG_AllMaterials_baseline_ours_launcher.py:26-45)
DEFAULT_MATERIALS = [
    "BlackJean", "BluePants", "BlueSports", "BrownVest", "ColorPants",
    "ColorSweater", "DenimShirt", "FlowerJeans", "FlowerShorts", "GrayPants",
    "GreenShirt", "GreenSweater", "GreenTee", "NavyHoodie", "PinkShorts",
    "PurpleShirt", "RedShirt", "WhiteTshirt", "WhiteVest", "YellowShirt",
]


def garment_command(method: str, material: str, args) -> List[str]:
    preset = METHOD_PRESETS[method]
    cmd = [sys.executable, "-m",
           "vts_torch.train" if args.phase == "launch" else "vts_torch.test",
           "--model", preset["model"], "--dataset_mode", preset["dataset_mode"],
           "--dataroot", args.dataroot_template.format(material=material),
           "--name", f"{material}_{preset['name_suffix']}",
           "--checkpoints_dir", args.checkpoints_dir,
           "--results_dir", args.results_dir]
    if args.phase == "test":
        cmd += ["--epoch", args.epoch]
    return cmd + args.extra


def run_process_mode(method: str, materials: List[str], args) -> int:
    """One child per garment, started together; the first non-zero exit code
    (in the materials' order) or 0."""
    procs = []
    for m in materials:
        cmd = garment_command(method, m, args)
        print("launch:", " ".join(shlex.quote(c) for c in cmd), flush=True)
        if not args.dry_run:
            procs.append((m, subprocess.Popen(cmd)))
    rc = 0
    for m, p in procs:
        code = p.wait()
        print(f"[{m}] exited {code}")
        rc = rc or code
    return rc


# the models whose step the fleet can run: sinskit's, and skit's, which
# inherits it; the baselines' steps have another signature in the reference
FLEET_MODELS = ("sinskit", "skit")


def run_fleet_mode(method: str, materials: List[str], args, devices=None) -> int:
    """The garments over min(G, devices) ranks (see the module docstring);
    ``devices``: the devices to lay them over (default the visible cards, or
    on the CPU one device, or as many as a ``--mesh`` garment axis asks)."""
    import torch

    from .config import TrainOptions
    from .device import resolve_device
    from .models.sinskit import data_axis
    from .parallel.mesh import (build_mesh, garment_block, mesh_for_flag, parse_mesh_spec,
                                 visible_devices)
    from .platform import spawn_ranks

    preset = METHOD_PRESETS[method]
    if preset["model"] not in FLEET_MODELS:
        raise ValueError(
            f"--mode fleet cannot train {method!r} (--model {preset['model']}): the reference's "
            f"fleet calls _train_step(..., frozen, use_d3=...) (vts_tpu/parallel/fleet.py:62, "
            f":71), which the {preset['model']} step does not take; use --mode process")
    base_argv = ["--model", preset["model"], "--dataset_mode", preset["dataset_mode"],
                 "--dataroot", args.dataroot_template.format(material=materials[0]),
                 "--checkpoints_dir", args.checkpoints_dir,
                 "--results_dir", args.results_dir] + args.extra
    opt = TrainOptions().parse(base_argv, quiet=True)
    kind = resolve_device(opt.device).type
    if opt.mesh:
        mesh_for_flag(opt.mesh, visible_devices(kind))
        data_axis(opt)
    if devices is None:
        devices = (visible_devices(kind) if kind == "cuda"
                   else [torch.device("cpu")] * parse_mesh_spec(opt.mesh).get("garment", 1))
    opt.mesh = ""
    n_garments = len(materials)
    layout = build_mesh(f"garment:{min(n_garments, len(devices))}", devices)
    g_ax = layout.axis("garment")
    garment_block(n_garments, g_ax, 0)
    print(f"[fleet] {n_garments} garments over {g_ax} devices", flush=True)
    if g_ax == 1:
        return _fleet_rank(method, materials, args, opt, g_ax)
    threads = max(1, torch.get_num_threads() // g_ax) if kind == "cpu" else None
    spawn_ranks(_fleet_rank, (method, materials, args, opt, g_ax), list(layout.devices),
                threads=threads)
    return 0


def _fleet_rank(method: str, materials: List[str], args, opt, g_ax: int) -> int:
    """Train this rank's block of the garments (all of them outside ranks)."""
    import torch

    from .data import create_dataset
    from .device import describe, resolve_device
    from .models import create_model
    from .parallel.fleet import FleetTrainer
    from .parallel.mesh import garment_block
    from .platform import is_lead, over_ranks, world

    preset = METHOD_PRESETS[method]
    ranks = world()
    block = garment_block(len(materials), g_ax, 0 if ranks is None else ranks.rank)
    device = resolve_device(opt.device)
    print(f"[device] fleet trains on {describe(device)}"
          + ("" if ranks is None else f": garments {block.start}-{block.stop - 1}"), flush=True)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loaders = []
        for m in materials[block.start:block.stop]:
            sub = copy.copy(opt)
            sub.dataroot = args.dataroot_template.format(material=m)
            sub.name = f"{m}_{preset['name_suffix']}"
            loaders.append(create_dataset(sub))
        model = create_model(opt)
        trainer = FleetTrainer(model, len(block), first=block.start)
        trainer.init_states()
        total_epochs = opt.n_epochs + opt.n_epochs_decay
        # the shortest loader of the whole fleet, whichever rank holds it
        steps = int(over_ranks(torch.tensor([min(len(ld) for ld in loaders)]), "min")[0])
        t0 = time.time()
        for epoch in range(opt.epoch_count, total_epochs + 1):
            for ld in loaders:
                ld.set_epoch(epoch)
            for batches in itertools.islice(zip(*[iter(ld) for ld in loaders]), steps):
                trainer.step(list(batches), epoch)
            if epoch % max(1, opt.print_freq // 100) == 0 and trainer.losses:
                means = trainer.mean_losses(len(materials))
                if is_lead():
                    print(f"[fleet] epoch {epoch}/{total_epochs} ({time.time() - t0:.0f}s) "
                          + " ".join(f"{k}:{v:.3f}" for k, v in means.items()), flush=True)
            if epoch % opt.save_epoch_freq == 0 or epoch == total_epochs:
                for gi, m in enumerate(materials[block.start:block.stop]):
                    trainer.save(gi, os.path.join(args.checkpoints_dir,
                                                  f"{m}_{preset['name_suffix']}"), "latest")
        if is_lead():
            print(f"[fleet] trained {len(materials)} garments in {time.time() - t0:.0f}s",
                  flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return 0


def run_compare(methods: List[str], materials: List[str], args) -> int:
    """One comparison page per garment, ``<results_dir>/comparison_<material>``,
    one column per method's ``test_<epoch>/images``."""
    from .utils.compare import create_comparison_html
    for mat in materials:
        dirs = [os.path.join(args.results_dir, f"{mat}_{METHOD_PRESETS[meth]['name_suffix']}",
                             f"test_{args.epoch}", "images") for meth in methods]
        print(create_comparison_html(os.path.join(args.results_dir, f"comparison_{mat}"),
                                     dirs, methods, title=f"{mat} ({args.epoch})",
                                     name_filter=args.filter or None))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-garment experiment launcher")
    ap.add_argument("method", choices=sorted(METHOD_PRESETS))
    ap.add_argument("phase", choices=["launch", "test", "commands", "compare"])
    ap.add_argument("--materials", type=str, default=",".join(DEFAULT_MATERIALS))
    ap.add_argument("--dataroot-template", type=str,
                    default="./datasets/singleskit_{material}_padded_1800_x1/")
    ap.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    ap.add_argument("--results_dir", type=str, default="./results")
    ap.add_argument("--epoch", type=str, default="best")
    ap.add_argument("--mode", choices=["fleet", "process"], default="fleet")
    ap.add_argument("--against", type=str, default="",
                    help="comma-separated other methods for phase=compare "
                         "(columns after the positional method)")
    ap.add_argument("--filter", type=str, default="",
                    help="phase=compare: only basenames containing this "
                         "substring (e.g. fake_I)")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("extra", nargs="*", default=[])
    # the flags after "--" are split off here: argparse of some Python 3.12
    # releases fills the ``extra`` positional before the options that follow
    # the positionals and then refuses what comes after "--"
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args = ap.parse_args(argv[:cut])
    args.extra += argv[cut + 1:]
    materials = [m for m in args.materials.split(",") if m]

    if args.phase == "compare":
        methods = [args.method] + [m for m in args.against.split(",") if m]
        unknown = [m for m in methods if m not in METHOD_PRESETS]
        if unknown:
            ap.error(f"--against: unknown method(s) {unknown}; "
                     f"choose from {sorted(METHOD_PRESETS)}")
        return run_compare(methods, materials, args)
    if args.phase == "commands":
        args.phase = "launch"
        for m in materials:
            print(" ".join(shlex.quote(c) for c in garment_command(args.method, m, args)))
        return 0
    if args.phase == "test" or args.mode == "process":
        return run_process_mode(args.method, materials, args)
    return run_fleet_mode(args.method, materials, args)


if __name__ == "__main__":
    sys.exit(main())
