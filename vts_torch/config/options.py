"""Test options for the port (``vts_tpu/config/options.py`` ∘ the sinskit
flags of ``vts_tpu/models/sinskit.py`` ∘ the singleskit dataset flags).

The subset the eval path reads, with the reference's test-time defaults,
plus ``--device`` (default ``cuda``).  The reference's TPU-only flags
(``--canvas_fold``, ``--lpips_fold``, ``--lpips_fold_axis``, ``--mesh``,
``--platform``) are accepted and have no effect: the port runs the plain
math on one device.  Unknown flags are an error.
"""

from __future__ import annotations

import argparse
import os


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    a = p.add_argument
    # experiment identity / io
    a("--dataroot", type=str, default="synthetic://default")
    a("--name", type=str, default="experiment_name")
    a("--checkpoints_dir", type=str, default="./checkpoints")
    a("--results_dir", type=str, default="./results/")
    a("--phase", type=str, default="test")
    a("--seed", type=int, default=0)
    a("--device", type=str, default="cuda", help="cuda | cpu")
    # model
    a("--model", type=str, default="sinskit")
    a("--netG", type=str, default="unet256_custom")
    a("--ngf", type=int, default=10)
    a("--normG", type=str, default="instance")
    a("--init_type", type=str, default="xavier")
    a("--init_gain", type=float, default=0.02)
    a("--no_dropout", type=str2bool, nargs="?", const=True, default=True)
    a("--num_layer_separate", type=int, default=4)
    a("--sketch_nc", type=int, default=1)
    a("--image_nc", type=int, default=3)
    a("--touch_nc", type=int, default=2)
    a("--use_positional_encoding", type=str2bool, default=True)
    a("--positional_encoding_mode", type=str, default="spe", choices=["spe", "csg"])
    a("--positional_encoding_dim", type=int, default=4)
    a("--T_resolution_multiplier", type=int, default=1)
    a("--use_style_code", type=str2bool, default=False)
    a("--eval_mode", type=str, default="batched", choices=["batched", "legacy"])
    a("--epoch", type=str, default="latest")
    a("--pretrained_name", type=str, default=None)
    # data
    a("--dataset_mode", type=str, default="singleskit")
    a("--crop_size", type=int, default=1536)
    a("--preprocess", type=str, default="none")
    a("--data_len", type=int, default=1)
    a("--num_test", type=int, default=1)
    a("--batch_size_G2", type=int, default=100)
    a("--center_w", type=int, default=1280)
    a("--center_h", type=int, default=960)
    a("--use_bg_mask", type=str2bool, default=True)
    a("--sample_bbox_per_patch", type=int, default=1)
    a("--subdir_S", type=str, default="testS")
    a("--subdir_I", type=str, default="testI")
    a("--subdir_T", type=str, default="testT")
    a("--subdir_M", type=str, default="testM")
    # accepted for command-line compatibility with vts_tpu; no effect here
    for flag, kind, default in (("--canvas_fold", int, 8), ("--lpips_fold", int, 2),
                                ("--lpips_fold_axis", str, "w"), ("--mesh", str, ""),
                                ("--platform", str, "")):
        a(flag, type=kind, default=default, help="TPU-only; ignored by the port")
    return p


class TestOptions:
    """``parse(argv)`` → an ``argparse.Namespace``; writes ``test_opt.txt`` under
    ``<checkpoints_dir>/<name>`` like the reference."""

    isTrain = False

    def parse(self, args=None, quiet: bool = False) -> argparse.Namespace:
        parser = _parser()
        opt = parser.parse_args(args)
        opt.isTrain = self.isTrain
        lines = ["----------------- Options ---------------"]
        for k, v in sorted(vars(opt).items()):
            default = parser.get_default(k)
            lines.append(f"{k:>25}: {v!s:<30}" + (f"\t[default: {default}]" if v != default else ""))
        lines.append("----------------- End -------------------")
        text = "\n".join(lines)
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(expr_dir, exist_ok=True)
        with open(os.path.join(expr_dir, f"{opt.phase}_opt.txt"), "w") as f:
            f.write(text + "\n")
        if not quiet:
            print(text)
        return opt
