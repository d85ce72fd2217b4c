"""Options for the port (``vts_tpu/config/options.py`` ∘ the sinskit flags of
``vts_tpu/models/sinskit.py`` ∘ the singleskit dataset flags).

:class:`TestOptions` and :class:`TrainOptions` hold the flags the eval and
training paths read, with the reference's sinskit defaults for each phase,
plus ``--device`` (default ``cuda``).  The reference's TPU-only and
cache flags (``--canvas_fold``, ``--lpips_fold``, ``--lpips_fold_axis``,
``--platform``; in training also ``--step_mode``, ``--remat_g``,
``--lpips_remat``, ``--lpips_conv``, ``--lpips_head``,
``--steps_per_dispatch``, ``--device_sample_cache``, ``--lpips_tap_cache``,
``--d3_logit_cache``) are accepted and have no effect: the port runs the
plain math on one device, and their values do not change the result.  In
training, ``--lpips_crop`` ≠ 0, ``--dtype bfloat16`` and ``--mesh`` ≠ ""
change the result or need more than one device, are not ported, and raise.
Unknown flags are an error.
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


def _common(p: argparse.ArgumentParser, train: bool) -> None:
    """Flags of both phases; defaults follow the phase, as in the reference."""
    a = p.add_argument
    ph = "train" if train else "test"
    # experiment identity / io
    a("--dataroot", type=str, default="synthetic://default")
    a("--name", type=str, default="experiment_name")
    a("--checkpoints_dir", type=str, default="./checkpoints")
    a("--results_dir", type=str, default="./results/")
    a("--phase", type=str, default=ph)
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
    a("--batch_size", type=int, default=1)
    a("--serial_batches", action="store_true", default=not train)
    a("--crop_size", type=int, default=1536)
    a("--preprocess", type=str, default="crop" if train else "none")
    a("--data_len", type=int, default=200 if train else 1)
    a("--batch_size_G2", type=int, default=64 if train else 100)
    a("--center_w", type=int, default=1280)
    a("--center_h", type=int, default=960)
    a("--use_bg_mask", type=str2bool, default=True)
    a("--sample_bbox_per_patch", type=int, default=2 if train else 1)
    for sub in ("S", "I", "T", "M"):
        a(f"--subdir_{sub}", type=str, default=f"{ph}{sub}")
    # accepted for command-line compatibility with vts_tpu; no effect here
    for flag, kind, default in (("--canvas_fold", int, 8), ("--lpips_fold", int, 2),
                                ("--lpips_fold_axis", str, "w"), ("--mesh", str, ""),
                                ("--platform", str, "")):
        a(flag, type=kind, default=default, help="TPU-only; ignored by the port")


def _test_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _common(p, train=False)
    p.add_argument("--num_test", type=int, default=1)
    return p


def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _common(p, train=True)
    a = p.add_argument
    # discriminators and losses (vts_tpu/models/sinskit.py:75-127)
    a("--netD", type=str, default="multiscale")
    a("--netD2", type=str, default="multiscale")
    a("--ndf", type=int, default=8)
    a("--n_layers_D", type=int, default=3)
    a("--n_layers_D2", type=int, default=3)
    a("--num_D_D1", type=int, default=3)
    a("--num_D_D2", type=int, default=3)
    a("--normD", type=str, default="batch")
    a("--gan_mode", type=str, default="nonsaturating",
      choices=["vanilla", "lsgan", "wgan", "wgangp", "nonsaturating", "hinge"])
    a("--use_cGAN", type=str2bool, default=True)
    a("--lambda_G1_GAN", type=float, default=1.0)
    a("--lambda_G1_L1", type=float, default=100.0)
    a("--lambda_G1_lpips", type=float, default=1.0)
    a("--use_cGAN_G2", type=str2bool, default=True)
    a("--use_cGAN_G2_S", type=str2bool, default=True)
    a("--use_cGAN_G2_I", type=str2bool, default=True)
    a("--lambda_G2_GAN", type=float, default=5.0)
    a("--lambda_G2_L1", type=float, default=10.0)
    a("--lambda_G2_lpips", type=float, default=10.0)
    a("--lambda_G2_GAN_feat", type=float, default=1.0)
    a("--smooth_GAN_label", type=str2bool, default=True)
    a("--use_vision_aided_loss", type=str2bool, default=True)
    a("--vision_aided_warmup_epoch", type=int, default=100)
    a("--g2_gan_backprop", type=str2bool, default=False)
    a("--use_more_fakeT", type=str2bool, default=True)
    a("--add_fake_T_sample_size", type=int, default=32)
    a("--use_diffaug", type=str2bool, default=True)
    a("--diffaugment", type=str, default="bs")
    a("--batch_size_G2_val", type=int, default=128)
    a("--w_resampling", type=str2bool, default=True)
    a("--resampling_w_min", type=int, default=1)
    a("--resampling_w_max", type=int, default=10)
    a("--subdir_valT", type=str, default="valT")
    a("--lpips_crop", type=int, default=0)
    a("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    # optimisation and schedule (vts_tpu/config/options.py TrainOptions)
    a("--lr", type=float, default=0.001)
    a("--lr_G2", type=float, default=0.0005)
    a("--beta1", type=float, default=0.0)
    a("--beta2", type=float, default=0.99)
    a("--lr_policy", type=str, default="linear", choices=["linear", "step", "cosine"])
    a("--lr_decay_iters", type=int, default=50)
    a("--epoch_count", type=int, default=1)
    a("--n_epochs", type=int, default=5)
    a("--n_epochs_decay", type=int, default=400)
    a("--continue_train", action="store_true")
    a("--val_for_each_epoch", type=str2bool, default=True)
    # logging and checkpoints
    a("--print_freq", type=int, default=100)
    a("--display_freq", type=int, default=100)
    a("--save_latest_freq", type=int, default=100)
    a("--save_epoch_freq", type=int, default=50)
    a("--no_html", action="store_true",
      help="required for now: the HTML gallery and visuals are not ported yet")
    # accepted for command-line compatibility with vts_tpu; no effect here
    for flag, kind, default in (("--step_mode", str, "fused"), ("--remat_g", str, "auto"),
                                ("--lpips_remat", str, "auto"), ("--lpips_conv", str, "xla"),
                                ("--lpips_head", str, "composed"),
                                ("--steps_per_dispatch", int, 1),
                                ("--device_sample_cache", str2bool, False),
                                ("--lpips_tap_cache", str2bool, False),
                                ("--d3_logit_cache", str2bool, False),
                                ("--num_threads", int, 0)):
        a(flag, type=kind, default=default, help="TPU-only or cache flag; ignored by the port")
    return p


class _Options:
    isTrain = False

    def _parser(self) -> argparse.ArgumentParser:
        raise NotImplementedError

    def check(self, opt) -> None:
        """Raise on settings the port does not run."""

    def parse(self, args=None, quiet: bool = False) -> argparse.Namespace:
        """``parse(argv)`` → an ``argparse.Namespace``; writes
        ``<phase>_opt.txt`` under ``<checkpoints_dir>/<name>`` like the
        reference."""
        parser = self._parser()
        opt = parser.parse_args(args)
        opt.isTrain = self.isTrain
        self.check(opt)
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


class TestOptions(_Options):
    isTrain = False

    def _parser(self):
        return _test_parser()


class TrainOptions(_Options):
    isTrain = True

    def _parser(self):
        return _train_parser()

    def check(self, opt) -> None:
        if opt.lpips_crop:
            raise NotImplementedError("--lpips_crop (a cropped canvas LPIPS) is not ported yet")
        if opt.dtype != "float32":
            raise NotImplementedError("--dtype bfloat16 is not ported yet (the port trains in fp32)")
        if opt.mesh:
            raise NotImplementedError("--mesh (data parallelism over devices) is not ported yet")
