"""The port's options and drivers against ``vts_tpu``'s on the CPU, with no
JAX compile:

  * every option string of ``vts_tpu``'s sinskit train and test parsers
    (found by walking their actions) parses in the port's parser of the same
    phase or raises ``NotImplementedError`` naming the flag — with its
    default, each of its choices, and with no value where it takes none;
    never an argparse error — and has the reference's default there; the
    same for the skit parsers (``--model skit``, which adds the style-code
    and skit-dataset flags).  The round-5 production commands (the
    ``sched_prod`` and ``sched_anneal`` arms and their best-checkpoint
    tests, ``scripts/round5_queue.sh``, ``scripts/r5_anneal.sh``) parse
    unmodified, with ``--device`` added;
  * ``--suffix`` renames the run as the reference does; model and dataset
    names are looked up lowercased;
  * the test driver runs at batch 1 whatever ``--batch_size`` says;
  * the port's ``apply_anneal`` makes the reference's changes and raises on
    the reference's bad specs, and also on a bad ``lpips_fold_axis`` or
    ``lpips_head``, which the reference applies;
  * a CPU training run at batch 2 with ``--lpips_crop 128`` crosses an
    ``--anneal_set "lpips_crop=0,batch_size=1"`` switch;
  * a value outside the reference's ``choices`` of ``--remat_g``,
    ``--lpips_remat``, ``--lpips_head``, ``--lpips_fold_axis``,
    ``--lpips_conv`` or ``--step_mode`` is the same argparse error in both.
"""

import argparse
import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = "synthetic://opts?size=320&center_w=192&center_h=128&patches=6&val_patches=3"
SMALL = ["--dataroot", DATA, "--crop_size", "256", "--center_w", "192", "--center_h", "128",
         "--ngf", "4", "--ndf", "4", "--batch_size_G2", "4"]

# scripts/round5_queue.sh:50-56, 68-70 and scripts/r5_anneal.sh:29-45, as run
PROD_TRAIN = ["--model", "sinskit", "--name", "sched_prod", "--dataroot",
              "synthetic://learncheck?size=1800", "--data_len", "100", "--cache_data_device",
              "--dtype", "bfloat16", "--batch_size", "4", "--lpips_crop", "768",
              "--remat_g", "off", "--lpips_remat", "off", "--print_freq", "1000",
              "--display_freq", "5000", "--save_latest_freq", "5000"]
ANNEAL_TRAIN = [a.replace("sched_prod", "sched_anneal") for a in PROD_TRAIN] + [
    "--anneal_epoch", "300", "--anneal_set", "lpips_crop=0,batch_size=2,remat_g=on,lpips_remat=off"]
PROD_TEST = ["--model", "sinskit", "--name", "sched_prod", "--epoch", "best", "--dataroot",
             "synthetic://learncheck?size=1800", "--data_len", "4", "--num_test", "4",
             "--dtype", "bfloat16"]


def _jax_parser(phase, tmp, extra=()):
    from vts_tpu.config import TestOptions as JTest
    from vts_tpu.config import TrainOptions as JTrain
    opts = (JTrain if phase == "train" else JTest)()
    opts.gather_options(["--checkpoints_dir", str(tmp), *extra])
    return opts.parser


def _port(phase):
    from vts_torch.config import TestOptions, TrainOptions
    return TrainOptions() if phase == "train" else TestOptions()


def _values(action):
    """The argv tails to try for one reference action."""
    if action.nargs == 0:
        return [[]]
    vals = [[c] for c in action.choices] if action.choices else []
    if action.default is not None and action.default != "" and not action.choices:
        vals.append([str(action.default)])
    if not vals:
        vals.append(["3"] if action.type is int else ["x"])
    if action.nargs == "?":
        vals.append([])
    return vals


def _walk(phase, tmp_path, model=(), min_tried=150):
    parser = _jax_parser(phase, tmp_path / "jax", model)
    port = _port(phase)
    base = ["--checkpoints_dir", str(tmp_path / "port"), "--device", "cpu", *model]
    tried = refused = 0
    for action in parser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        for flag in action.option_strings:
            for tail in _values(action):
                if flag == "--checkpoints_dir":
                    tail = [str(tmp_path / "port")]
                tried += 1
                try:
                    port.parse(base + [flag] + tail, quiet=True)
                except NotImplementedError as e:
                    refused += 1
                    assert flag in str(e), (flag, tail, str(e))
                except SystemExit:
                    pytest.fail(f"{phase}: {flag} {tail} is an argparse error in the port")
    assert tried > min_tried and 0 < refused < tried / 4, (tried, refused)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_every_reference_option_parses_or_is_refused_by_name(phase, tmp_path):
    _walk(phase, tmp_path)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_every_reference_skit_option_parses_or_is_refused_by_name(phase, tmp_path):
    """``--model skit``'s parsers: the sinskit flags, the style-code flags and
    the skit dataset's."""
    _walk(phase, tmp_path, ("--model", "skit"))


@pytest.mark.parametrize("phase", ["train", "test"])
def test_every_reference_pix2pix_option_parses_or_is_refused_by_name(phase, tmp_path):
    """``--model pix2pix``'s parsers: the base flags, pix2pix's and the
    patchskit dataset's (a netG other than the ResNets is refused); it
    declares fewer flags than sinskit's (142 tries in training, 119 in the test phase)."""
    _walk(phase, tmp_path, ("--model", "pix2pix"), min_tried=110)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_pix2pix_defaults_match_the_reference(phase, tmp_path):
    """``--model pix2pix``: every flag of the reference's pix2pix parser of
    each phase has the reference's default (the base parser's where sinskit
    overrides it, then pix2pix's own); what the port adds besides
    ``--device`` are the sinskit flags, which pix2pix's step does not read."""
    from vts_torch.config import options as o
    jp = _jax_parser(phase, tmp_path, ("--model", "pix2pix"))
    ref = {a.dest: jp.get_default(a.dest) for a in jp._actions
           if a.option_strings and a.dest != "help"}
    parser = (o._train_parser if phase == "train" else o._test_parser)()
    o._pix2pix_model_flags(parser, phase == "train")
    port = {a.dest: parser.get_default(a.dest) for a in parser._actions
            if a.option_strings and a.dest != "help"}
    assert {k: (v, port.get(k)) for k, v in ref.items() if port.get(k, "missing") != v} == {}
    sinskit = {a.dest for a in _jax_parser(phase, tmp_path)._actions if a.option_strings}
    assert set(port) - set(ref) <= sinskit | {"device", "use_style_code"}
    opt = _port(phase).parse(["--model", "pix2pix", "--checkpoints_dir", str(tmp_path),
                              "--device", "cpu"], quiet=True)
    assert (opt.netG, opt.ngf, opt.dataset_mode, opt.return_patch, opt.batch_size) == \
        ("resnet_9blocks", 64, "patchskit", phase == "train", 32 if phase == "train" else 1)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_every_reference_pix2pixhd_option_parses_or_is_refused_by_name(phase, tmp_path):
    """``--model pix2pixHD``'s parsers: pix2pix's flags and pix2pixHD's (the
    depths, the losses, the schedule, the VGG weights and the flags the
    reference reads nowhere); a netG other than the patch baselines' is
    refused."""
    _walk(phase, tmp_path, ("--model", "pix2pixHD"), min_tried=130)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_pix2pixhd_defaults_match_the_reference(phase, tmp_path):
    """``--model pix2pixhd``: every flag of the reference's pix2pixHD parser
    of each phase has the reference's default (pix2pix's, then pix2pixHD's
    own); the port adds only ``--device`` and the sinskit flags, which the
    step does not read."""
    from vts_torch.config import options as o
    jp = _jax_parser(phase, tmp_path, ("--model", "pix2pixhd"))
    ref = {a.dest: jp.get_default(a.dest) for a in jp._actions
           if a.option_strings and a.dest != "help"}
    parser = (o._train_parser if phase == "train" else o._test_parser)()
    o._pix2pixhd_model_flags(parser, phase == "train")
    port = {a.dest: parser.get_default(a.dest) for a in parser._actions
            if a.option_strings and a.dest != "help"}
    assert {k: (v, port.get(k)) for k, v in ref.items() if port.get(k, "missing") != v} == {}
    sinskit = {a.dest for a in _jax_parser(phase, tmp_path)._actions if a.option_strings}
    assert set(port) - set(ref) <= sinskit | {"device", "use_style_code"}
    opt = _port(phase).parse(["--model", "pix2pixHD", "--checkpoints_dir", str(tmp_path),
                              "--device", "cpu"], quiet=True)
    assert (opt.netG, opt.netD, opt.normG, opt.n_downsample_global, opt.n_blocks_global,
            opt.num_D_D1, opt.num_D_D2, opt.getIntermFeat_D, opt.lambda_vgg, opt.gan_mode) \
        == ("global", "multiscale", "instance", 4, 9, 2, 2, True, 10.0, "lsgan")
    assert (opt.return_patch, opt.batch_size) == ((True, 32) if phase == "train" else (False, 1))
    if phase == "train":
        assert (opt.n_epochs, opt.n_epochs_decay, opt.pool_size) == (50, 150, 0)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_every_reference_spade_option_parses_or_is_refused_by_name(phase, tmp_path):
    """``--model spade``'s parsers: pix2pixHD's flags and SPADE's (the VAE,
    TTUR, the upsampling depth, the output width); a netG other than
    ``spade`` is refused by name."""
    _walk(phase, tmp_path, ("--model", "spade"), min_tried=130)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_spade_defaults_match_the_reference(phase, tmp_path):
    """``--model spade``: every flag of the reference's SPADE parser of each
    phase has the reference's default (pix2pixHD's, then SPADE's own); the
    port adds only ``--device`` and the sinskit flags, which the step does
    not read."""
    from vts_torch.config import options as o
    jp = _jax_parser(phase, tmp_path, ("--model", "spade"))
    ref = {a.dest: jp.get_default(a.dest) for a in jp._actions
           if a.option_strings and a.dest != "help"}
    parser = (o._train_parser if phase == "train" else o._test_parser)()
    o._spade_model_flags(parser, phase == "train")
    port = {a.dest: parser.get_default(a.dest) for a in parser._actions
            if a.option_strings and a.dest != "help"}
    assert {k: (v, port.get(k)) for k, v in ref.items() if port.get(k, "missing") != v} == {}
    sinskit = {a.dest for a in _jax_parser(phase, tmp_path)._actions if a.option_strings}
    assert set(port) - set(ref) <= sinskit | {"device", "use_style_code"}
    opt = _port(phase).parse(["--model", "spade", "--checkpoints_dir", str(tmp_path),
                              "--device", "cpu"], quiet=True)
    assert (opt.netG, opt.netD, opt.normG, opt.normD, opt.num_upsampling_layers, opt.ngf,
            opt.num_D_D1, opt.num_D_D2, opt.getIntermFeat_D, opt.lambda_vgg, opt.gan_mode,
            opt.use_vae, opt.no_TTUR) \
        == ("spade", "multiscale", "spectralspadesyncbatch3x3", "spectralinstance", 3, 64, 2,
            2, True, 10.0, "hinge", False, False)
    if phase == "train":
        assert (opt.return_patch, opt.batch_size, opt.output_width, opt.lr, opt.beta1,
                opt.beta2, opt.n_epochs, opt.n_epochs_decay) \
            == (True, 16, 32, 0.0002, 0.0, 0.9, 50, 0)
    else:
        assert (opt.return_patch, opt.batch_size, opt.output_width, opt.load_size) \
            == (False, 1, 1536, 1800)


# Settings that parse and build their model, and the refusals that stand
PORTED = [["--T_resolution_multiplier", "2"], ["--T_resolution_multiplier", "4"],
          ["--gan_mode", "wgan"], ["--gan_mode", "wgangp"], ["--gan_mode", "hinge"],
          ["--normD", "instance"], ["--normD", "none"], ["--normG", "batch"],
          ["--netD", "basic"], ["--netD", "n_layers"], ["--netD", "pixel"], ["--netD", "patch"],
          ["--netD2", "pixel"], ["--diffaugment", "bscton"], ["--lr_policy", "plateau"],
          ["--init_type", "xavier_uniform"], ["--init_type", "orthogonal"],
          ["--init_type", "none"], ["--positional_encoding_mode", "csg"],
          ["--no_dropout", "false"], ["--preprocess", "zoom_and_crop"],
          ["--use_style_code", "true"], ["--model", "skit"], ["--eval_mode", "legacy"],
          ["--dataset_mode", "skit"], ["--display_id", "1", "--display_port", "0"],
          ["--model", "pix2pix"], ["--model", "pix2pixhd"], ["--model", "spade"],
          ["--netD", "stylegan2"], ["--diffaugment", "bsb"], ["--mesh", "data:2"]]
STILL_REFUSED = [["--netD2", "tilestylegan2"]]
# refused with the reference's own failure (its tiles do not divide the 32²
# patches), not as a setting still to port
FAILS_IN_THE_REFERENCE = [["--netD2", "tilestylegan2"]]


@pytest.mark.parametrize("argv", PORTED + STILL_REFUSED,
                         ids=[" ".join(a) for a in PORTED + STILL_REFUSED])
def test_ported_flags_parse_and_the_rest_are_refused_by_name(argv, tmp_path):
    """Each newly ported setting parses in training (and builds its model:
    under ``--mesh data:2``, at batch 2, in each of two spawned CPU ranks,
    which join one data group); each standing refusal raises
    ``NotImplementedError`` naming its flag at parse, or, where the
    reference cannot run it, a ``ValueError`` naming it at model creation."""
    from vts_torch.models import create_model
    port = _port("train")
    base = SMALL + ["--checkpoints_dir", str(tmp_path), "--device", "cpu"]
    if argv in FAILS_IN_THE_REFERENCE:
        with pytest.raises(ValueError, match=argv[0]):
            create_model(port.parse(base + argv, quiet=True))
        return
    if argv in STILL_REFUSED:
        with pytest.raises(NotImplementedError, match=argv[0]):
            port.parse(base + argv, quiet=True)
        return
    if argv[0] == "--mesh":
        from tests.torch_port_ranks import setup_rank
        from vts_torch.platform import spawn_ranks
        opt = port.parse(base + argv + ["--batch_size", "2"], quiet=True)
        assert opt.mesh == "data:2"
        assert spawn_ranks(setup_rank, (opt,), ["cpu", "cpu"], threads=1,
                           tmp_dir=str(tmp_path)) == [(0, 2), (1, 2)]
        return
    opt = port.parse(base + argv, quiet=True)
    assert str(getattr(opt, argv[0][2:])).lower() == argv[1]
    create_model(opt).setup()


# the reference's refusals of a --mesh, each made at the model's set-up (and
# by the training driver before it starts ranks), each naming the flag
MESH_REFUSALS = {
    "unknown_axis": (["--mesh", "pipe:2"], ValueError, "--mesh pipe:2: unknown mesh axis 'pipe'"),
    "too_few_devices": (["--mesh", "data:4096", "--batch_size", "4096"], AssertionError,
                        "--mesh data:4096: mesh needs 4096 devices, have "),
    "odd_batch": (["--mesh", "data:2", "--batch_size", "3"], ValueError,
                  "--mesh data:2 needs batch_size divisible by 2 (got 3)"),
    "steps_per_dispatch": (["--mesh", "data:2", "--batch_size", "2", "--steps_per_dispatch", "2"],
                           ValueError, "--mesh data parallelism and --steps_per_dispatch > 1 are "
                                       "mutually exclusive"),
}


@pytest.mark.parametrize("case", sorted(MESH_REFUSALS))
def test_mesh_refusals_are_the_references_naming_the_flag(case, tmp_path):
    """An unknown axis, more devices than the CPU's cores, a batch that the
    data axis does not divide, ``--steps_per_dispatch`` > 1: the
    reference's refusals (its ``parse_mesh_spec``'s and ``build_mesh``'s
    texts, its ``_setup_dp_mesh``'s), at the model's set-up and from the
    training driver before any rank or data, each naming ``--mesh``."""
    from vts_torch.models import create_model
    from vts_torch.train import rank_devices
    from vts_tpu.parallel.mesh import build_mesh, parse_mesh_spec
    argv, err, text = MESH_REFUSALS[case]
    opt = _port("train").parse(SMALL + ["--checkpoints_dir", str(tmp_path), "--device", "cpu"]
                               + argv, quiet=True)
    with pytest.raises(err, match=re.escape(text)):
        create_model(opt).setup()
    with pytest.raises(err, match=re.escape(text)):
        rank_devices(opt)
    if case == "unknown_axis":
        with pytest.raises(ValueError, match=re.escape(text.split(": ", 1)[1])):
            parse_mesh_spec("pipe:2")
    if case == "too_few_devices":
        with pytest.raises(AssertionError, match="mesh needs 4096 devices, have 8"):
            build_mesh("data:4096")


def test_multihost_flags_parse_and_join_nothing_without_multihost(tmp_path, monkeypatch):
    """``--multihost``, ``--coordinator_address``, ``--num_processes`` and
    ``--process_id`` parse in both phases with the reference's defaults;
    without ``--multihost`` nothing joins, as in the reference; with it and
    neither those flags nor torchrun's variables, a ``ValueError`` names
    them before any rendezvous."""
    from vts_torch.platform import init_multihost, world
    for phase in ("train", "test"):
        opt = _port(phase).parse(SMALL + ["--checkpoints_dir", str(tmp_path), "--device", "cpu",
                                          "--coordinator_address", "127.0.0.1:1",
                                          "--num_processes", "2", "--process_id", "1"],
                                 quiet=True)
        assert (opt.multihost, opt.coordinator_address, opt.num_processes,
                opt.process_id) == (False, "127.0.0.1:1", 2, 1)
        assert init_multihost(opt) is False and world() is None
        opt = _port(phase).parse(SMALL + ["--checkpoints_dir", str(tmp_path), "--device", "cpu",
                                          "--multihost"], quiet=True)
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(ValueError, match="--multihost: set --coordinator_address"):
            init_multihost(opt)
        assert world() is None


@pytest.mark.parametrize("flag,bad", [
    ("--remat_g", "True"), ("--lpips_remat", "yes"), ("--lpips_head", "fused"),
    ("--lpips_fold_axis", "h"), ("--lpips_conv", "cudnn"), ("--step_mode", "fast")])
def test_pipeline_and_layout_flags_refuse_what_the_reference_refuses(flag, bad, tmp_path,
                                                                    capsys):
    """A value outside the reference's ``choices`` is an argparse error in
    both packages, with the same message."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    errors = []
    for parse in (lambda a: JaxTrainOptions().parse(a, quiet=True),
                  lambda a: _port("train").parse(a + ["--device", "cpu"], quiet=True)):
        with pytest.raises(SystemExit):
            parse(["--checkpoints_dir", str(tmp_path), flag, bad])
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert errors[0] == errors[1] and f"invalid choice: '{bad}'" in errors[0]


@pytest.mark.parametrize("phase", ["train", "test"])
def test_defaults_match_the_reference(phase, tmp_path):
    """Every flag the reference declares has the reference's default for that
    phase; the port adds only ``--device`` and ``--use_style_code``."""
    from vts_torch.config.options import _test_parser, _train_parser
    ref = {a.dest: a.default for a in _jax_parser(phase, tmp_path)._actions
           if a.option_strings and a.dest != "help"}
    port = {a.dest: a.default for a in (_train_parser if phase == "train" else _test_parser)()
            ._actions if a.option_strings and a.dest != "help"}
    assert {k: (v, port.get(k)) for k, v in ref.items() if port.get(k, "missing") != v} == {}
    assert set(port) - set(ref) == {"device", "use_style_code"}


@pytest.mark.parametrize("phase", ["train", "test"])
def test_skit_defaults_match_the_reference(phase, tmp_path):
    """``--model skit``: every flag of the reference's skit parser of each
    phase has the reference's default (the style code on, one style level,
    the skit dataset); the port adds only ``--device``."""
    from vts_torch.config import options as o
    ref = {a.dest: a.default for a in _jax_parser(phase, tmp_path, ("--model", "skit"))._actions
           if a.option_strings and a.dest != "help"}
    parser = (o._train_parser if phase == "train" else o._test_parser)()
    o._skit_model_flags(parser)
    o._skit_dataset_flags(parser)
    port = {a.dest: parser.get_default(a.dest) for a in parser._actions
            if a.option_strings and a.dest != "help"}
    assert {k: (v, port.get(k)) for k, v in ref.items() if port.get(k, "missing") != v} == {}
    assert set(port) - set(ref) == {"device"}
    opt = _port(phase).parse(["--model", "skit", "--checkpoints_dir", str(tmp_path),
                              "--device", "cpu"], quiet=True)
    assert (opt.use_style_code, opt.num_layer_style_code, opt.dataset_mode,
            opt.style_code_dim) == (True, 1, "skit", 512)


@pytest.mark.parametrize("argv", [PROD_TRAIN, ANNEAL_TRAIN, PROD_TEST],
                         ids=["sched_prod", "sched_anneal", "best_checkpoint_test"])
def test_round5_production_commands_parse(argv, tmp_path):
    phase = "test" if "--num_test" in argv else "train"
    opt = _port(phase).parse(argv + ["--device", "cpu", "--checkpoints_dir", str(tmp_path)],
                             quiet=True)
    assert opt.dtype == "bfloat16" and opt.name.startswith("sched_")
    if phase == "train":
        assert (opt.batch_size, opt.lpips_crop, opt.cache_data_device) == (4, 768, True)


def test_suffix_renames_the_run_as_the_reference(tmp_path):
    argv = ["--name", "run", "--suffix", "b{batch_size}_{dtype}", "--batch_size", "2",
            "--checkpoints_dir", str(tmp_path)]
    from vts_tpu.config import TrainOptions as JTrain
    want = JTrain().parse(argv, quiet=True).name
    got = _port("train").parse(argv + ["--device", "cpu"], quiet=True).name
    assert got == want == "run_b2_float32"
    assert os.path.exists(tmp_path / "run_b2_float32" / "train_opt.txt")


def test_model_and_dataset_names_are_case_insensitive(tmp_path):
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model
    from vts_torch.models.sinskit import SinSKITModel
    opt = _port("test").parse(SMALL + ["--model", "sinskitG", "--dataset_mode", "SingleSkit",
                                       "--device", "cpu", "--checkpoints_dir", str(tmp_path)],
                              quiet=True)
    assert isinstance(create_model(opt), SinSKITModel)
    assert len(create_dataset(opt)) == 1
    opt.model = "SINSKIT"
    assert isinstance(create_model(opt), SinSKITModel)
    from vts_torch.models.spade import SPADEModel
    opt = _port("test").parse(SMALL + ["--model", "SPADE", "--device", "cpu",
                                       "--checkpoints_dir", str(tmp_path)], quiet=True)
    assert (opt.netG, opt.normG) == ("spade", "spectralspadesyncbatch3x3")
    assert isinstance(create_model(opt), SPADEModel)
    with pytest.raises(NotImplementedError, match="--model 'gaugan'"):
        _port("test").parse(["--model", "gaugan", "--checkpoints_dir", str(tmp_path)],
                            quiet=True)


def test_test_driver_forces_batch_one(tmp_path, monkeypatch):
    """``--batch_size 2 --data_len 2 --num_test 2`` scores two samples of one
    each (at batch 2 it would score one batch)."""
    from vts_torch.models import create_model
    from vts_torch.models.sinskit import SinSKITModel
    from vts_torch.test import test as port_test
    argv = SMALL + ["--name", "b1", "--epoch", "best", "--device", "cpu",
                    "--checkpoints_dir", str(tmp_path / "ck"),
                    "--results_dir", str(tmp_path / "res")]
    model = create_model(_port("test").parse(argv, quiet=True))
    model.setup()
    model.save_networks("best")
    seen, real = [], SinSKITModel.set_input
    monkeypatch.setattr(SinSKITModel, "set_input",
                        lambda self, batch, phase="train": (seen.append(batch["S"].shape[0]),
                                                            real(self, batch, phase))[1])
    metrics = port_test(argv + ["--batch_size", "2", "--data_len", "2", "--num_test", "2"])
    assert seen == [1, 1] and len(metrics) == 2
    assert all(len(m) == 8 and all(np.isfinite(v) for v in m.values()) for m in metrics)


ANNEAL_SPECS = ["lpips_crop=0,batch_size=2,remat_g=on,lpips_remat=off", "lpips_crop=256",
                " batch_size = 3 ,", "lpips_fold_axis=hw,lpips_head=factored", "",
                "lpips_crop=24", "batch_size=0", "remat_g=sometimes", "lr=0.1",
                "lpips_crop", "lpips_remat=True"]


@pytest.mark.parametrize("spec", ANNEAL_SPECS)
def test_apply_anneal_matches_the_reference(spec):
    from vts_torch.train import apply_anneal
    from vts_tpu.train import apply_anneal as jax_apply_anneal
    base = argparse.Namespace(lpips_crop=768, batch_size=4, remat_g="off", lpips_remat="off",
                              lpips_fold_axis="w", lpips_head="composed")
    a, b = copy.copy(base), copy.copy(base)
    try:
        want = jax_apply_anneal(a, spec)
    except ValueError:
        with pytest.raises(ValueError):
            apply_anneal(b, spec)
        return
    assert apply_anneal(b, spec) == want and vars(a) == vars(b)


@pytest.mark.parametrize("spec", ["lpips_fold_axis=W", "lpips_head=fused"])
def test_apply_anneal_refuses_what_the_reference_applies_silently(spec):
    from vts_torch.train import apply_anneal
    from vts_tpu.train import apply_anneal as jax_apply_anneal
    ns = argparse.Namespace(lpips_fold_axis="w", lpips_head="composed")
    jax_apply_anneal(copy.copy(ns), spec)
    with pytest.raises(ValueError, match=spec.split("=")[0]):
        apply_anneal(copy.copy(ns), spec)


def test_cpu_train_crosses_the_anneal(tmp_path):
    """Batch 2 with a 128² LPIPS window in epoch 1, then the full canvas at
    batch 1 from epoch 2: the ``[anneal]`` line, finite losses on both sides,
    and epoch 2 stepping sample by sample (iters 3, 4 after 2)."""
    out = subprocess.run(
        [sys.executable, "-m", "vts_torch.train", *SMALL, "--name", "anneal", "--device", "cpu",
         "--batch_size_G2_val", "3", "--add_fake_T_sample_size", "3", "--data_len", "2",
         "--n_epochs", "2", "--n_epochs_decay", "0", "--use_vision_aided_loss", "false",
         "--no_html", "--print_freq", "1", "--batch_size", "2", "--lpips_crop", "128",
         "--anneal_epoch", "2", "--anneal_set", "lpips_crop=0,batch_size=1",
         "--checkpoints_dir", str(tmp_path / "ck"), "--results_dir", str(tmp_path / "res")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "[anneal] epoch 2: applied {'lpips_crop': 0, 'batch_size': 1}" in lines
    iters = [(int(e), int(i)) for e, i in
             (re.match(r"\(epoch: (\d+), iters: (\d+)", ln).groups()
              for ln in lines if ln.startswith("(epoch: ") and "iters" in ln)]
    assert iters == [(1, 2), (2, 3), (2, 4)], iters
    for ln in lines:
        if ln.startswith("(epoch: ") and "iters" in ln:
            vals = re.findall(r"(\w+): (-?[\d.]+|nan|inf)", ln.split(")", 1)[1])
            assert vals and all(np.isfinite(float(v)) for _, v in vals), ln
