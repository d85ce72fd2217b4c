"""Per-garment experiment launcher (``vts_tpu/launch.py``; the reference's
tmux/GPUtil layer, experiments/tmux_launcher.py:70-163, __main__.py:26-88).

The reference fans the 20 TouchClothing garments out as 20 OS processes.
Here ``--mode process`` starts one ``vts_torch.train`` (phase ``launch``) or
``vts_torch.test`` (phase ``test``) subprocess per garment, all at once on
the same card, and returns the first non-zero exit code.  ``commands``
prints the per-garment commands, ``compare`` writes one side-by-side gallery
per garment over the methods (:mod:`vts_torch.utils.compare`).  Flags after
``--`` go to every child unchanged; the children run on ``cuda`` unless
they get ``--device cpu`` there.  ``--mode fleet`` (the reference's default:
all garments in one process, ``vts_tpu/parallel/fleet.py``) is not ported
and is refused by name; the test phase always runs process mode, as in the
reference.  The baselines' presets (pix2pix, pix2pixhd, spade) are printed
by ``commands``, and their children fail: the port refuses ``--model
pix2pix`` and the others.

Usage:
  python -m vts_torch.launch ours launch --mode process --materials mat1,mat2 \\
      --dataroot-template ./datasets/singleskit_{material}_padded_1800_x1/ -- --n_epochs 5
  python -m vts_torch.launch ours test --materials ... --epoch best
  python -m vts_torch.launch ours commands
  python -m vts_torch.launch ours compare --against skit --filter fake_I
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
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
    raise NotImplementedError("--mode fleet (every garment in one process, "
                              "vts_tpu/parallel/fleet.py) is not ported yet; "
                              "use --mode process")


if __name__ == "__main__":
    sys.exit(main())
