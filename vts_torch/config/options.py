"""Options for the port (``vts_tpu/config/options.py`` ∘ the sinskit flags of
``vts_tpu/models/sinskit.py`` ∘ the singleskit dataset flags).

:class:`TestOptions` and :class:`TrainOptions` declare every flag that the
reference's sinskit parser of the same phase declares, with its defaults
for that phase, plus ``--device`` (default ``cuda``) and
``--use_style_code``.  As the reference's parser does, ``--model skit``
(or ``skitG``) adds the style-code flags (``--style_code_dim``,
``--style_code_mode``, ``--style_code_mapping_mode``,
``--num_layer_style_code`` (default 1), ``--precomputed_style_codes``) and
makes ``--use_style_code`` true and ``--dataset_mode`` skit by default, and
``--dataset_mode skit`` adds the skit dataset's flags (``--material_list``,
``--dataroot_prefix``, ``--dataroot_suffix``, ``--style_image_dir``,
``--style_image_size``).  Each flag does one of three things:

  * it is read, as in the reference (the data, model, loss, schedule,
    checkpoint and gallery flags, and the loggers' ``--display_id``,
    ``--display_port`` and ``--use_wandb``; ``--suffix`` renames the run as
    ``<name>_<suffix.format(**opt)>``; ``--max_dataset_size`` caps the
    epoch; ``--lpips_weights``/``--inception_weights`` load the perceptual
    towers; in training also ``--dtype``, ``--lpips_crop`` and
    ``--anneal_epoch``/``--anneal_set``);
  * it is accepted and has no effect, because it changes no math on one
    device: the TPU layout and cache flags (``--canvas_fold``,
    ``--lpips_fold``, ``--lpips_fold_axis``, ``--lpips_conv``,
    ``--lpips_head``, ``--step_mode``, ``--remat_g``, ``--lpips_remat``,
    ``--steps_per_dispatch``, ``--device_sample_cache``,
    ``--cache_data_device``, ``--lpips_tap_cache``, ``--d3_logit_cache``,
    ``--platform``), the loader's ``--num_threads`` and ``--cache_dir``,
    ``--verbose``, and flags the reference declares but never reads for this model
    (``--easy_label``, ``--load_iter``, ``--direction``, ``--load_size``,
    ``--no_flip``, ``--use_eval_mode``, ``--padded_size``, ...).  The test
    phase's ``--dtype`` and ``--lpips_crop`` are of this kind: the eval
    forward is fp32 whatever ``--dtype`` says, as in the reference; so are
    the training-only flags that the test parser declares too (the D, loss
    and schedule flags);
  * it raises ``NotImplementedError`` naming the flag when set to what the
    port does not run: a ``--model`` other than sinskit and skit, a
    ``--dataset_mode`` other than singleskit and skit, another ``--netG``,
    ``--normG``/``--normD`` other than instance, batch or none,
    ``--multihost``; in training also the StyleGAN2 ``--netD``/``--netD2``, a DiffAugment policy that repeats a letter,
    ``--pool_size`` > 0 and ``--mesh``.

``--no_dropout false`` is accepted and builds no dropout: the reference's
dropout layers never run (its sinskit never passes ``deterministic=False``).
A ``--T_resolution_multiplier`` that is not a power of two, or a
DiffAugment letter outside ``bscton``, is a ``ValueError``, as in the
reference.

So an option string of the reference is never an argparse error here.
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


_NETG = ["resnet_9blocks", "resnet_6blocks", "resnet_4blocks", "unet_256", "unet_128",
         "stylegan2", "smallstylegan2", "resnet_cat", "unet256_custom", "global", "local",
         "encoder", "spade", "conv_encoder", "visgel"]
_NETD = ["basic", "n_layers", "pixel", "patch", "multiscale", "stylegan2", "tilestylegan2"]
_INIT = ["normal", "xavier", "xavier_uniform", "kaiming", "orthogonal", "none"]
_GAN = ["vanilla", "lsgan", "wgan", "wgangp", "nonsaturating", "hinge"]


def _no_effect(p: argparse.ArgumentParser, flags) -> None:
    for flag, kind, default in flags:
        if kind is bool:
            p.add_argument(flag, action="store_true", help="accepted; no effect in the port")
        else:
            p.add_argument(flag, type=kind, default=default,
                           help="accepted; no effect in the port")


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
    a("--suffix", type=str, default="", help="appended to --name as _<suffix.format(**opt)>")
    a("--device", type=str, default="cuda", help="cuda | cpu")
    a("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
      help="training compute dtype (params stay fp32); the eval forward is fp32")
    a("--mesh", type=str, default="", help="training: a device mesh (not ported)")
    a("--multihost", action="store_true", help="not ported")
    # model
    a("--model", type=str, default="sinskit")
    a("--netG", type=str, default="unet256_custom", choices=_NETG)
    a("--netD", type=str, default="multiscale", choices=_NETD)
    a("--netD2", type=str, default="multiscale")
    a("--ngf", type=int, default=10)
    a("--ndf", type=int, default=8)
    a("--n_layers_D", type=int, default=3)
    a("--n_layers_D2", type=int, default=3)
    a("--num_D_D1", type=int, default=3)
    a("--num_D_D2", type=int, default=3)
    a("--normG", type=str, default="instance")
    a("--normD", type=str, default="batch")
    a("--init_type", type=str, default="xavier", choices=_INIT)
    a("--init_gain", type=float, default=0.02)
    a("--no_dropout", type=str2bool, nargs="?", const=True, default=True,
      help="false is accepted and builds no dropout: the reference's dropout layers are "
           "always deterministic, so inert in training and eval")
    a("--gan_mode", type=str, default="nonsaturating", choices=_GAN)
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
    a("--lpips_weights", type=str, default="",
      help="an lpips.LPIPS or {'vgg','lins'} torch checkpoint; empty: the seeded VGG")
    a("--inception_weights", type=str, default="",
      help="a torchvision inception_v3 checkpoint; empty: the seeded block 0")
    a("--clip_weights", type=str, default="",
      help="OpenAI CLIP checkpoint (visual.* keys) for D3; empty: the seeded tower")
    # the sinskit losses (read in training)
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
    a("--lr_G2", type=float, default=0.0005)
    a("--g2_gan_backprop", type=str2bool, default=False)
    a("--use_more_fakeT", type=str2bool, default=True)
    a("--add_fake_T_sample_size", type=int, default=32)
    a("--use_diffaug", type=str2bool, default=True)
    a("--diffaugment", type=str, default="bs")
    a("--lpips_crop", type=int, default=0,
      help="training: the canvas LPIPS on one random crop² window a step (0: the canvas)")
    a("--train_d3_heads", type=str2bool, default=False,
      help="accepted; the D3 heads never step (as in the reference)")
    # data
    a("--dataset_mode", type=str, default="singleskit")
    a("--batch_size", type=int, default=1)
    a("--serial_batches", action="store_true", default=not train)
    a("--crop_size", type=int, default=1536)
    a("--preprocess", type=str, default="crop" if train else "none")
    a("--max_dataset_size", type=int, default=None)
    a("--data_len", type=int, default=200 if train else 1)
    a("--batch_size_G2", type=int, default=64 if train else 100)
    a("--batch_size_G2_val", type=int, default=128)
    a("--center_w", type=int, default=1280)
    a("--center_h", type=int, default=960)
    a("--use_bg_mask", type=str2bool, default=True)
    a("--sample_bbox_per_patch", type=int, default=2 if train else 1)
    a("--w_resampling", type=str2bool, default=True)
    a("--resampling_w_min", type=int, default=1)
    a("--resampling_w_max", type=int, default=10)
    a("--random_scale_max", type=float, default=3.0,
      help="with zoom in --preprocess: training zoom levels in [1/this, 1)")
    for sub in ("S", "I", "T", "M"):
        a(f"--subdir_{sub}", type=str, default=f"{ph}{sub}")
    a("--subdir_valT", type=str, default="valT" if train else "")
    # visuals and the HTML gallery
    a("--display_winsize", type=int, default=256)
    a("--display_id", type=int, default=0,
      help="> 0: the live dashboard on 127.0.0.1:<display_port> while training")
    a("--display_port", type=int, default=8097, help="the live dashboard's port (0: any free)")
    a("--use_wandb", action="store_true", help="log to wandb when it is installed")
    a("--display_freq", type=int, default=100 if train else 400)
    a("--print_freq", type=int, default=100)
    a("--no_html", action="store_true",
      help="training: write no visuals and no HTML gallery under <checkpoints_dir>/<name>/web")
    a("--num_touch_patch_for_logging", type=int, default=10 if train else 100)
    a("--save_raw_arr_vis", type=str2bool, default=False)
    a("--scale_nz", type=float, default=0.25)
    # accepted for command-line compatibility with vts_tpu; no effect here
    p.add_argument("--no_flip", type=str2bool, nargs="?", const=True, default=True,
                   help="accepted; no effect in the port (singleskit never flips)")
    _no_effect(p, (
        ("--easy_label", str, "experiment_name"), ("--platform", str, ""),
        ("--coordinator_address", str, ""), ("--num_processes", int, -1),
        ("--process_id", int, -1), ("--no_antialias", bool, False),
        ("--no_antialias_up", bool, False), ("--direction", str, "AtoB"),
        ("--num_threads", int, 0), ("--cache_data_device", bool, False),
        ("--load_size", int, 286), ("--cache_dir", str, ""),
        ("--verbose", bool, False), ("--load_iter", int, 0),
        ("--model_phase", str, "train" if train else "eval"),
        ("--padded_size", int, 1800), ("--save_S_patch", str2bool, not train),
        ("--save_T_concat_tensor", str2bool, False), 
        ("--separate_val_set", str2bool, False), ("--canvas_fold", int, 8),
        ("--lpips_fold", int, 2), ("--lpips_fold_axis", str, "w"),
        ("--lpips_head", str, "composed"), ("--lpips_conv", str, "xla"),
        ("--step_mode", str, "fused"), ("--remat_g", str, "auto"),
        ("--lpips_remat", str, "auto"), ("--device_sample_cache", str2bool, False),
        ("--lpips_tap_cache", str2bool, False), ("--d3_logit_cache", str2bool, False)))


def _test_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _common(p, train=False)
    p.add_argument("--num_test", type=int, default=1)
    p.add_argument("--use_eval_mode", type=str2bool, default=True,
                   help="accepted; no effect in the port (the eval forward normalizes a "
                        "--normG batch G with its running statistics, as the reference)")
    return p


def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _common(p, train=True)
    a = p.add_argument
    # optimisation and schedule (vts_tpu/config/options.py TrainOptions)
    a("--lr", type=float, default=0.001)
    a("--beta1", type=float, default=0.0)
    a("--beta2", type=float, default=0.99)
    a("--lr_policy", type=str, default="linear", choices=["linear", "step", "plateau", "cosine"])
    a("--lr_decay_iters", type=int, default=50)
    a("--epoch_count", type=int, default=1)
    a("--n_epochs", type=int, default=5)
    a("--n_epochs_decay", type=int, default=400)
    a("--continue_train", action="store_true")
    a("--val_for_each_epoch", type=str2bool, default=True)
    a("--pool_size", type=int, default=0, help="> 0: an image pool (not ported)")
    a("--anneal_epoch", type=int, default=0,
      help="epoch at which --anneal_set is applied once (0: off)")
    a("--anneal_set", type=str, default="",
      help="comma list k=v applied to the options at --anneal_epoch; keys: lpips_crop, "
           "batch_size, remat_g, lpips_remat, lpips_fold_axis, lpips_head")
    # logging and checkpoints
    a("--save_latest_freq", type=int, default=100)
    a("--save_epoch_freq", type=int, default=50)
    _no_effect(p, (
        ("--evaluation_freq", int, 5000), ("--validation_freq", int, 100),
        ("--save_by_iter", bool, False), ("--gan_mode_override", str, ""),
        ("--steps_per_dispatch", int, 1), ("--train_for_each_epoch", str2bool, True),
        ("--update_fixed_epoch", int, 0)))
    return p


def _skit_model_flags(p: argparse.ArgumentParser) -> None:
    """``--model skit`` (``vts_tpu/models/skit.py``): the style-code flags and
    the model's defaults (the style code on, the skit dataset)."""
    a = p.add_argument
    a("--style_code_dim", type=int, default=512)
    a("--style_code_mode", type=str, default="concat", choices=["concat", "adain"])
    a("--style_code_mapping_mode", type=str, default="tile", choices=["tile", "project"])
    a("--num_layer_style_code", type=int, default=1,
      help="decoder levels that take the style code, innermost first (-1: every level)")
    a("--precomputed_style_codes", type=str2bool, default=False,
      help="a batch's own style_code is used when present, whatever this says")
    p.set_defaults(model="skit", dataset_mode="skit", use_style_code=True)


def _skit_dataset_flags(p: argparse.ArgumentParser) -> None:
    """``--dataset_mode skit`` (``vts_tpu/data/skit.py``)."""
    a = p.add_argument
    a("--material_list", type=str, default="",
      help="comma-separated material names; each maps to "
           "<dataroot_prefix><material><dataroot_suffix>")
    a("--dataroot_prefix", type=str, default="singleskit_")
    a("--dataroot_suffix", type=str, default="_padded_1800_x1")
    a("--style_image_dir", type=str, default="",
      help="external style images for cross-material style swap")
    a("--style_image_size", type=int, default=224)


def _refuse(flag: str, what: str) -> None:
    raise NotImplementedError(f"{flag} {what} is not ported yet")


_NORMS = ("instance", "batch", "none")


_SKIT_MODELS = ("skit", "skitg")


def _check_common(opt) -> None:
    if opt.model.lower() not in ("sinskit", "sinskitg") + _SKIT_MODELS:
        _refuse("--model", repr(opt.model))
    if opt.dataset_mode.lower() not in ("singleskit", "skit"):
        _refuse("--dataset_mode", repr(opt.dataset_mode))
    if opt.netG != "unet256_custom":
        _refuse("--netG", repr(opt.netG))
    if opt.normG not in _NORMS:
        _refuse("--normG", repr(opt.normG))
    m = int(opt.T_resolution_multiplier)
    if m < 1 or m & (m - 1):
        raise ValueError(f"--T_resolution_multiplier {m} must be a power of two")
    if opt.multihost:
        _refuse("--multihost", "(several hosts)")


class _Options:
    isTrain = False

    def _parser(self) -> argparse.ArgumentParser:
        raise NotImplementedError

    def check(self, opt) -> None:
        """Raise ``NotImplementedError`` naming the flag on settings the port
        does not run."""
        _check_common(opt)

    def parse(self, args=None, quiet: bool = False) -> argparse.Namespace:
        """``parse(argv)`` → an ``argparse.Namespace``; writes
        ``<phase>_opt.txt`` under ``<checkpoints_dir>/<name>`` like the
        reference."""
        parser = self._parser()
        # the reference's staged parse: the model's flags and defaults, then
        # the dataset's, each once the name that selects it is known
        known, _ = parser.parse_known_args(args)
        if known.model.lower() in _SKIT_MODELS:
            _skit_model_flags(parser)
            known, _ = parser.parse_known_args(args)
        if known.dataset_mode.lower() == "skit":
            _skit_dataset_flags(parser)
        opt = parser.parse_args(args)
        opt.isTrain = self.isTrain
        self.check(opt)
        if opt.suffix:
            opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
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
        _check_common(opt)
        for flag, v in (("--netD", opt.netD), ("--netD2", opt.netD2)):
            if "stylegan2" in v:
                _refuse(flag, repr(v))
        if opt.normD not in _NORMS:
            _refuse("--normD", repr(opt.normD))
        if opt.use_diffaug:
            policy = opt.diffaugment
            if set(policy) - set("bscton"):
                raise ValueError(f"--diffaugment {policy!r}: the letters are b, s, c, t, o, n")
            if len(set(policy)) != len(policy):
                _refuse("--diffaugment", f"{policy!r} (a letter used twice)")
        if opt.pool_size > 0:
            _refuse("--pool_size", "> 0 (an image pool)")
        if opt.mesh:
            _refuse("--mesh", "(data parallelism over devices)")
