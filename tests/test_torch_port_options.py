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
    ``--anneal_set "lpips_crop=0,batch_size=1"`` switch.
"""

import argparse
import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest

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


def _walk(phase, tmp_path, model=()):
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
    assert tried > 150 and 0 < refused < tried / 4, (tried, refused)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_every_reference_option_parses_or_is_refused_by_name(phase, tmp_path):
    _walk(phase, tmp_path)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_every_reference_skit_option_parses_or_is_refused_by_name(phase, tmp_path):
    """``--model skit``'s parsers: the sinskit flags, the style-code flags and
    the skit dataset's."""
    _walk(phase, tmp_path, ("--model", "skit"))


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
          ["--dataset_mode", "skit"], ["--display_id", "1", "--display_port", "0"]]
STILL_REFUSED = [["--mesh", "data:2"], ["--netD", "stylegan2"],
                 ["--netD2", "tilestylegan2"], ["--diffaugment", "bsb"]]


@pytest.mark.parametrize("argv", PORTED + STILL_REFUSED,
                         ids=[" ".join(a) for a in PORTED + STILL_REFUSED])
def test_ported_flags_parse_and_the_rest_are_refused_by_name(argv, tmp_path):
    """Each newly ported setting parses in training (and builds its model);
    each standing refusal raises ``NotImplementedError`` naming its flag."""
    from vts_torch.models import create_model
    port = _port("train")
    base = SMALL + ["--checkpoints_dir", str(tmp_path), "--device", "cpu"]
    if argv in STILL_REFUSED:
        with pytest.raises(NotImplementedError, match=argv[0]):
            port.parse(base + argv, quiet=True)
        return
    opt = port.parse(base + argv, quiet=True)
    assert str(getattr(opt, argv[0][2:])).lower() == argv[1]
    create_model(opt).setup()


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
    with pytest.raises(NotImplementedError, match="--model"):
        _port("test").parse(["--model", "pix2pix", "--checkpoints_dir", str(tmp_path)], quiet=True)


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
