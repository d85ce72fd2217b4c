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
``--style_image_size``), and ``--dataset_mode template`` adds
``--new_dataset_option``.  ``--model pix2pix`` adds ``--lambda_L1`` and
``--return_patch`` and takes the reference's pix2pix defaults: the base
parser's where sinskit overrides them and pix2pix does not (ngf/ndf 64,
Adam β 0.5/0.999, lr 2e-4, 200 + 200 epochs, ...), then pix2pix's own (the
``resnet_9blocks`` batch-norm G, the ``basic`` D, the patchskit dataset at
crop 1536; in training batch 32 of patches, the 320-sample cadences, the
vanilla GAN; in the test phase the full canvas at batch 1, 64 test patches).
``--model pix2pixHD`` (any case) takes pix2pix's flags and defaults, then
its own flags and defaults (the instance-norm ``global`` G with 4
downsamplings and 9 blocks, two 2-scale ``multiscale`` instance-norm Ds
with intermediate features, lsgan, GAN-feat and VGG19 at λ 10, 50 + 150
epochs); its ``--feat_num``, ``--load_features``, ``--nef``,
``--n_clusters`` and ``--n_downsample_E`` parse and are read by nothing,
as in the reference.  ``--model spade`` takes pix2pixHD's flags and
defaults, then its own flags (``--use_vae``, ``--z_dim``,
``--semantic_nc``, ``--no_TTUR``, ``--lambda_kld``,
``--num_upsampling_layers``, ``--output_width``, ``--aspect_ratio``) and
defaults (the ``spade`` G with ``--normG spectralspadesyncbatch3x3`` and 3
upsamplings, the Ds at ``--normD spectralinstance``, the hinge GAN, 50
epochs without decay, in training batch 16 and Adam β (0, 0.9) at lr 2e-4,
in the test phase ``--output_width 1536`` and ``--load_size 1800``);
``--semantic_nc`` parses and is read by nothing, as in the reference, and
``--use_vae true`` is a ``ValueError`` at model creation.  ``--pool_size``
> 0 is read by pix2pixHD and SPADE alone and is a ``ValueError`` at model
creation for every other model, as the reference's.  Each flag does one of
three things:

  * it is read, as in the reference (the data, model, loss, schedule,
    checkpoint and gallery flags, the ranks' ``--multihost``,
    ``--coordinator_address``, ``--num_processes`` and ``--process_id``
    (:mod:`vts_torch.platform`), and the loggers' ``--display_id``,
    ``--display_port`` and ``--use_wandb``; ``--suffix`` renames the run as
    ``<name>_<suffix.format(**opt)>``; ``--max_dataset_size`` caps the
    epoch; ``--lpips_weights``/``--inception_weights`` load the perceptual
    towers; the run-time pipeline: the loader's ``--num_threads``,
    ``--cache_data_device`` and ``--cache_dir`` (:mod:`vts_torch.data`),
    the model's ``--device_sample_cache``, ``--lpips_tap_cache``,
    ``--d3_logit_cache``, ``--remat_g``, ``--lpips_remat`` and
    ``--lpips_head`` (:mod:`vts_torch.models.sinskit`,
    :mod:`vts_torch.losses.lpips`); in training also ``--dtype``,
    ``--lpips_crop``, ``--anneal_epoch``/``--anneal_set``,
    ``--steps_per_dispatch`` and ``--mesh``, whose refusals are the
    reference's, made where it makes them, at the model's set-up (and by
    the training driver before it starts ranks), each naming the flag: an
    unknown axis, too few devices, a batch the ``data`` axis does not
    divide, ``--steps_per_dispatch`` > 1 with one);
  * it is accepted and has no effect, for a stated reason.  The TPU's
    layouts of the same math: ``--canvas_fold``, ``--lpips_fold`` and
    ``--lpips_fold_axis`` (space-to-depth folds that fill the TPU's 128
    lanes), ``--step_mode split`` (one jit a stage, so that XLA lays each
    out on its own: the port's eager step already runs stage by stage),
    ``--lpips_conv`` (Pallas or XLA for the LPIPS convs: K1 always takes
    VGG convs 1-3 here), ``--platform`` (JAX's backend; the port's is
    ``--device``).  Logging: ``--verbose``.  The sinskit flags under
    ``--model pix2pix`` and ``pix2pixhd`` (their steps read none of them).
    Flags the reference declares but never reads for this model
    (``--easy_label``, ``--load_iter``, ``--direction``, ``--load_size``,
    ``--no_flip``, ``--use_eval_mode``, ``--padded_size``,
    ``--model_phase``, ``--save_S_patch``, ``--save_T_concat_tensor``,
    ``--separate_val_set``, ``--evaluation_freq``, ``--validation_freq``,
    ``--save_by_iter``, ``--gan_mode_override``, ``--train_for_each_epoch``,
    ``--update_fixed_epoch``).  The test phase's ``--dtype`` and
    ``--lpips_crop`` are of this kind: the eval forward is fp32 whatever
    ``--dtype`` says, as in the reference; so are the training-only flags
    that the test parser declares too (the D, loss, cache and remat flags),
    and the test driver's ``--num_threads`` and ``--cache_data_device``
    (it loads in its own thread, as the reference's, and visits each sample
    once).  The layout flags take the reference's ``choices``, so that a
    value it refuses is an argparse error here too;
  * it raises ``NotImplementedError`` naming the flag when set to what the
    port does not run: a ``--model`` other than sinskit, skit, pix2pix,
    pix2pixhd and spade, a ``--dataset_mode`` other than singleskit, skit,
    patchskit and the legacy four (single, unaligned, singleimage,
    template), a ``--netG`` other than unet256_custom (sinskit, skit),
    resnet_{9,6,4}blocks, global, local and encoder (pix2pix, pix2pixHD) or
    spade (SPADE) or the zoo's (unet_256, unet_128, visgel, resnet_cat,
    stylegan2, smallstylegan2 for sinskit, skit, pix2pix and pix2pixHD;
    resnet_cat for SPADE, whose step passes G a second argument),
    ``--normG`` other than instance, batch or none (with ``--netG spade`` a
    SPADE config string as the reference's ``parse_spade_config`` reads it:
    an unparsable one is its ``ValueError``; the zoo's G other than the
    plain U-Nets read none), ``--normD`` other than instance, batch or none
    (or, with the three patch baselines, ``spectral`` followed by one of
    them or by nothing).

A legacy ``--dataset_mode`` parses and loads (its flags and samples are the
reference's), and is a ``ValueError`` naming the flag at model creation
(:func:`check_dataset`): its samples hold no sketch, and the reference's
models fail reading it at setup.  The zoo's combinations that the
reference parses and cannot run are each a
``ValueError`` naming the flag at model creation (:func:`check_zoo`): a
plain U-Net on pix2pix's 32² patches, the StyleGAN2 G above ``--crop_size``
1448, a zoo G with ``--use_style_code`` or, under sinskit, at
``--T_resolution_multiplier`` > 1; in training a StyleGAN2 D under
``--dtype bfloat16`` or on batches of more than 4 not divisible by 4, and
``tilestylegan2`` where its (crop_size // 4)² tiles do not divide its input
(as D2, on the 32² patches, at any crop from 132 on).

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
    a("--mesh", type=str, default="",
      help="training: a device layout 'axis:size,...' (garment, data, spatial); a data axis "
           "of N > 1 trains on N ranks, one per card (the CPU: one per core)")
    a("--multihost", action="store_true",
      help="join the ranks at --coordinator_address (or torchrun's MASTER_ADDR:MASTER_PORT) "
           "before anything runs")
    a("--coordinator_address", type=str, default="",
      help="--multihost: host:port of rank 0's store")
    a("--num_processes", type=int, default=-1,
      help="--multihost: the number of ranks (-1: torchrun's WORLD_SIZE)")
    a("--process_id", type=int, default=-1,
      help="--multihost: this process's rank (-1: torchrun's RANK)")
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
    a("--no_antialias", action="store_true",
      help="resnet G: stride-2 convs in place of the blur downsample")
    a("--no_antialias_up", action="store_true",
      help="resnet G: transposed convs in place of the blur upsample")
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
    # the run-time pipeline: the loader, the sample caches, rematerialization
    # and the LPIPS head (as vts_tpu/config/options.py and models/sinskit.py)
    a("--num_threads", type=int, default=0,
      help="host threads that build the batches (0: in the training loop's thread)")
    a("--cache_data_device", action="store_true",
      help="keep each sample on the device after its first visit (the loader's cache)")
    a("--cache_dir", type=str, default="",
      help="on-disk sample cache (empty: <dataroot>/.vts_cache; none for synthetic://)")
    a("--device_sample_cache", type=str2bool, default=False,
      help="keep each training sample's device tensors after its first set_input "
           "(at most max(data_len, 32) entries)")
    a("--lpips_tap_cache", type=str2bool, default=False,
      help="compute the real canvas's VGG taps once a sample, not every step "
           "(full-canvas LPIPS; refused at data_len > 1)")
    a("--d3_logit_cache", type=str2bool, default=False,
      help="compute D3's CLIP logits of each real image once (not under --train_d3_heads)")
    a("--remat_g", type=str, default="auto", choices=["auto", "on", "off"],
      help="recompute G's forward in the backward (auto: on at batch > 1)")
    a("--lpips_remat", type=str, default="auto",
      choices=["auto", "on", "off", "True", "False", "1", "0"],
      help="recompute the canvas LPIPS's x branch in the backward (auto: on at batch > 1; "
           "True/1 mean on, False/0 auto)")
    a("--lpips_head", type=str, default="composed", choices=["composed", "factored"],
      help="the LPIPS head: normalize, difference, lin head; or the same sum from three "
           "channel reductions")
    # accepted for command-line compatibility with vts_tpu; no effect here
    p.add_argument("--no_flip", type=str2bool, nargs="?", const=True, default=True,
                   help="accepted; no effect in the port (singleskit never flips)")
    a("--lpips_fold_axis", type=str, default="w", choices=["hw", "w"],
      help="accepted; no effect in the port (a TPU lane layout)")
    a("--lpips_conv", type=str, default="xla", choices=["xla", "pallas"],
      help="accepted; no effect in the port (K1 takes VGG convs 1-3 always)")
    a("--step_mode", type=str, default="fused", choices=["fused", "split"],
      help="accepted; no effect in the port (the step runs stage by stage as it is)")
    _no_effect(p, (
        ("--easy_label", str, "experiment_name"), ("--platform", str, ""),
        ("--direction", str, "AtoB"),
        ("--load_size", int, 286),
        ("--verbose", bool, False), ("--load_iter", int, 0),
        ("--model_phase", str, "train" if train else "eval"),
        ("--padded_size", int, 1800), ("--save_S_patch", str2bool, not train),
        ("--save_T_concat_tensor", str2bool, False),
        ("--separate_val_set", str2bool, False), ("--canvas_fold", int, 8),
        ("--lpips_fold", int, 2)))


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
    a("--pool_size", type=int, default=0,
      help="> 0: pix2pixHD's image pool of past fakes for D's fake pass (other models: an error)")
    a("--anneal_epoch", type=int, default=0,
      help="epoch at which --anneal_set is applied once (0: off)")
    a("--anneal_set", type=str, default="",
      help="comma list k=v applied to the options at --anneal_epoch; keys: lpips_crop, "
           "batch_size, remat_g, lpips_remat, lpips_fold_axis, lpips_head")
    # logging and checkpoints
    a("--save_latest_freq", type=int, default=100)
    a("--save_epoch_freq", type=int, default=50)
    a("--steps_per_dispatch", type=int, default=1,
      help="train k steps a dispatch, with no host sync inside and the losses logged "
           "at its end (the baselines step one at a time)")
    _no_effect(p, (
        ("--evaluation_freq", int, 5000), ("--validation_freq", int, 100),
        ("--save_by_iter", bool, False), ("--gan_mode_override", str, ""),
        ("--train_for_each_epoch", str2bool, True),
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


def _pix2pix_model_flags(p: argparse.ArgumentParser, train: bool) -> None:
    """``--model pix2pix`` (``vts_tpu/models/pix2pix.py``): its flags, the
    base parser's defaults that sinskit's override and pix2pix's keep, and
    pix2pix's own defaults for the phase."""
    a = p.add_argument
    a("--lambda_L1", type=float, default=100.0)
    a("--return_patch", type=str2bool, default=train,
      help="the patchskit dataset's items: 32² patches (true) or the full record")
    p.set_defaults(ngf=64, ndf=64, netD="basic", netG="resnet_9blocks", normG="batch",
                   normD="batch", dataset_mode="patchskit", crop_size=1536,
                   preprocess="resize_and_crop")
    if train:
        p.set_defaults(gan_mode="vanilla", batch_size=32, num_threads=4, display_freq=320,
                       print_freq=320, save_latest_freq=320, validation_freq=320, save_epoch_freq=50,
                       pool_size=0, display_id=0, n_epochs=200, n_epochs_decay=200,
                       beta1=0.5, beta2=0.999, lr=0.0002, val_for_each_epoch=False)
    else:
        p.set_defaults(gan_mode="lsgan", batch_size=1, save_S_patch=True,
                       sample_bbox_per_patch=1, data_len=1, num_test=50,
                       num_touch_patch_for_logging=10, batch_size_G2=64)


def _pix2pixhd_model_flags(p: argparse.ArgumentParser, train: bool) -> None:
    """``--model pix2pixhd`` (``vts_tpu/models/pix2pixhd.py``): pix2pix's
    flags and defaults, then pix2pixHD's flags and its own defaults."""
    _pix2pix_model_flags(p, train)
    a = p.add_argument
    for flag, default in (("--feat_num", 3), ("--n_downsample_E", 4), ("--nef", 16),
                          ("--n_clusters", 10)):
        a(flag, type=int, default=default, help="accepted; read by nothing (as in the reference)")
    a("--load_features", action="store_true", help="accepted; read by nothing")
    a("--n_downsample_global", type=int, default=4)
    a("--n_blocks_global", type=int, default=9)
    a("--n_blocks_local", type=int, default=3)
    a("--n_local_enhancers", type=int, default=1)
    a("--niter_fix_global", type=int, default=0,
      help="epochs after which the global G's leaves train too (before: zero gradients)")
    a("--getIntermFeat_D", type=str2bool, default=True)
    a("--no_ganFeat_loss", action="store_true")
    a("--no_vgg_loss", action="store_true")
    a("--lambda_feat", type=float, default=10.0)
    a("--lambda_vgg", type=float, default=10.0)
    a("--correct_gan_feat", type=str2bool, default=False,
      help="match the fake features against D's real-side ones (default: the reference's "
           "term, identically 0)")
    a("--vgg_weights", type=str, default="",
      help="a torchvision vgg19 checkpoint for the VGG loss; empty: the seeded VGG19")
    p.set_defaults(netG="global", netD="multiscale", normG="instance", normD="instance",
                   num_D_D1=2, num_D_D2=2)
    if train:
        p.set_defaults(gan_mode="lsgan", n_epochs=50, n_epochs_decay=150)


def _spade_model_flags(p: argparse.ArgumentParser, train: bool) -> None:
    """``--model spade`` (``vts_tpu/models/spade.py``): pix2pixHD's flags and
    defaults, then SPADE's flags and its own defaults."""
    _pix2pixhd_model_flags(p, train)
    a = p.add_argument
    a("--use_vae", type=str2bool, default=False,
      help="true is a ValueError at model creation (the reference cannot run it)")
    a("--z_dim", type=int, default=256, help="the VAE's latent width")
    a("--semantic_nc", type=int, default=1,
      help="accepted; read by nothing (G takes the sketch's channels, as in the reference)")
    a("--no_TTUR", action="store_true", help="every network at --lr (default: G lr/2, Ds 2·lr)")
    a("--lambda_kld", type=float, default=0.05, help="the VAE's KLD weight")
    a("--num_upsampling_layers", type=int, default=3,
      help="G's 2× ups: its stem works at the input width / 2^this")
    a("--output_width", type=int, default=32, help="the VAE stem's output width")
    a("--aspect_ratio", type=float, default=1.0, help="the stem's width / height")
    p.set_defaults(netG="spade", normG="spectralspadesyncbatch3x3", normD="spectralinstance",
                   gan_mode="hinge")
    if train:
        p.set_defaults(batch_size=16, n_epochs=50, n_epochs_decay=0, beta1=0.0, beta2=0.9,
                       lr=0.0002)
    else:
        p.set_defaults(load_size=1800, output_width=1536)


def _refuse(flag: str, what: str) -> None:
    raise NotImplementedError(f"{flag} {what} is not ported yet")


_NORMS = ("instance", "batch", "none")


_SKIT_MODELS = ("skit", "skitg")
_PATCH_MODELS = ("pix2pix", "pix2pixhd", "spade")
_PATCH_G = ("resnet_9blocks", "resnet_6blocks", "resnet_4blocks", "global", "local", "encoder")
# the zoo's generators: no --normG read but by the plain U-Nets, one output
# map at the input's size (VisGel's at T_resolution_multiplier times it)
_PLAIN_UNETS = ("unet_256", "unet_128")
_NORM_FREE_G = ("visgel", "resnet_cat", "stylegan2", "smallstylegan2")
_ZOO_G = _PLAIN_UNETS + _NORM_FREE_G


def _netgs(model: str):
    """The generators each model runs, as the reference's run them; the
    plain U-Nets under the patch models are refused with their reason at
    model creation (:func:`check_zoo`)."""
    if model == "spade":
        return ("spade", "resnet_cat")
    if model in _PATCH_MODELS:
        return _PATCH_G + _ZOO_G
    return ("unet256_custom",) + _ZOO_G


def check_dataset(opt) -> None:
    """At model creation: a legacy dataset's samples hold no sketch, which
    every model reads first (the reference parses the options and loads the
    data, then fails at its model's setup)."""
    from ..data.legacy import LEGACY_DATASETS
    if opt.dataset_mode.lower() in LEGACY_DATASETS:
        raise ValueError(f"--dataset_mode {opt.dataset_mode} with --model {opt.model}: its "
                         f"samples hold no sketch 'S', which the model's setup reads (the "
                         f"reference fails there with a KeyError 'S'); the legacy datasets "
                         f"serve the library only")


def check_zoo(opt) -> None:
    """At model creation: ValueErrors, each naming its flag with the
    reference's failure, for the zoo's combinations that the reference
    parses and cannot run (its step or its model creation fails)."""
    model = opt.model.lower()
    if opt.isTrain:
        _check_stylegan2_ds(opt)
    g = opt.netG
    if g not in _ZOO_G:
        return
    if g in _PLAIN_UNETS and model in _PATCH_MODELS:
        raise ValueError(f"--netG {g} with --model {opt.model}: its {8 if g == 'unet_256' else 7} "
                         f"stride-2 downs collapse the 32² training patches to nothing (the "
                         f"reference's step fails concatenating a 1² map with a 0² skip)")
    if g in ("stylegan2", "smallstylegan2"):
        from ..networks.stylegan2 import MAX_CROP_SIZE
        if int(opt.crop_size) > MAX_CROP_SIZE:
            raise ValueError(f"--netG {g} with --crop_size {opt.crop_size}: its width table, "
                             f"keyed 2^rint(log2(crop_size)), stops at 1024, so the crop must "
                             f"be <= {MAX_CROP_SIZE} (the reference fails with a KeyError)")
    if getattr(opt, "use_style_code", False):
        raise ValueError(f"--use_style_code with --netG {g}: the reference passes the style "
                         f"code positionally to a generator that takes none (a TypeError)")
    if int(opt.T_resolution_multiplier) > 1 and model not in _PATCH_MODELS:
        raise ValueError(f"--T_resolution_multiplier {opt.T_resolution_multiplier} with --netG "
                         f"{g}: G gives one map, touch and image at one size, which the "
                         f"reference's step multiplies by masks at two sizes and fails")


def _check_common(opt) -> None:
    model = opt.model.lower()
    if model not in ("sinskit", "sinskitg") + _PATCH_MODELS + _SKIT_MODELS:
        _refuse("--model", repr(opt.model))
    from ..data import DATASETS
    if opt.dataset_mode.lower() not in DATASETS:
        _refuse("--dataset_mode", repr(opt.dataset_mode))
    if opt.netG not in _netgs(model):
        _refuse("--netG", f"{opt.netG!r} with --model {opt.model}")
    if opt.netG == "spade":
        from ..networks.spade_nets import parse_spade_config
        parse_spade_config(opt.normG)        # the reference's ValueError when unparsable
    elif opt.normG not in _NORMS and opt.netG not in _NORM_FREE_G:
        _refuse("--normG", repr(opt.normG))
    m = int(opt.T_resolution_multiplier)
    if m < 1 or m & (m - 1):
        raise ValueError(f"--T_resolution_multiplier {m} must be a power of two")


def _check_stylegan2_ds(opt) -> None:
    """ValueErrors, each with the reference's failure, for the StyleGAN2 Ds'
    combinations the reference's sinskit cannot run (the patch models take
    their own D kinds whatever ``--netD`` says)."""
    if opt.model.lower() in _PATCH_MODELS:
        return
    crop, m = int(opt.crop_size), int(opt.T_resolution_multiplier)
    for flag, name, side in (("--netD", opt.netD, crop), ("--netD2", opt.netD2, 32 * m)):
        if "stylegan2" not in name:
            continue
        if opt.dtype == "bfloat16":
            raise ValueError(f"{flag} {name} with --dtype bfloat16: its equalized convs take "
                             f"bf16 images with fp32 weights, which the reference's conv "
                             f"refuses (a TypeError)")
        k, more = int(opt.batch_size_G2), int(opt.add_fake_T_sample_size)
        for b in ([int(opt.batch_size)] if flag == "--netD" else
                  [opt.batch_size * k] + ([opt.batch_size * more] if opt.use_more_fakeT else [])):
            if b > 4 and b % 4:
                raise ValueError(f"{flag} {name} on batches of {b}: its minibatch stddev "
                                 f"groups min(n, 4) samples and needs n < 4 or a multiple of 4 "
                                 f"(the reference fails broadcasting the group values)")
        tile = crop // 4 if crop >= 64 else 16
        if name == "tilestylegan2" and side % tile:
            raise ValueError(f"{flag} tilestylegan2: it cuts its {side}² inputs into "
                             f"(crop_size // 4)² = {tile}² tiles, which do not divide them "
                             f"(the reference fails reshaping them)")


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
        elif known.model.lower() == "pix2pix":
            _pix2pix_model_flags(parser, self.isTrain)
            known, _ = parser.parse_known_args(args)
        elif known.model.lower() == "pix2pixhd":
            _pix2pixhd_model_flags(parser, self.isTrain)
            known, _ = parser.parse_known_args(args)
        elif known.model.lower() == "spade":
            _spade_model_flags(parser, self.isTrain)
            known, _ = parser.parse_known_args(args)
        if known.dataset_mode.lower() == "skit":
            _skit_dataset_flags(parser)
        elif known.dataset_mode.lower() == "template":
            parser.add_argument("--new_dataset_option", type=float, default=1.0,
                                help="the template dataset's example flag (read by nothing)")
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
        from ..networks.discriminators import split_spectral
        spectral, sub = split_spectral(opt.normD)
        if sub not in _NORMS or (spectral and opt.model.lower() not in _PATCH_MODELS):
            _refuse("--normD", repr(opt.normD))
        if opt.use_diffaug:
            policy = opt.diffaugment
            if set(policy) - set("bscton"):
                raise ValueError(f"--diffaugment {policy!r}: the letters are b, s, c, t, o, n")
