"""The legacy datasets (``vts_torch/data/legacy.py``) and their preprocess
chains (``vts_torch/data/base_transforms.py``) against ``vts_tpu`` on the
CPU, on images the test writes.  Both packages are numpy and PIL here, so
with the same seed the samples are equal, not close:

  * ``get_params`` and ``apply_transform`` for every ``--preprocess`` chain
    the reference handles (resize, scale_width, zoom, crop, make-power-2
    (``none`` and a chain naming ``power``), flip on and off, with params,
    without, and in grayscale), on odd-sized images;
  * ``single``, ``unaligned`` (random and serial B), ``singleimage`` (with
    and without B) and ``template`` (with images and empty), item by item,
    and through each package's option parser and ``create_dataset`` for an
    epoch of shuffled batches (``template`` with ``--new_dataset_option``);
  * what the reference does when a model trains or tests on them: each of
    its models fails reading ``S`` at setup (a ``KeyError``), which the port
    turns into a ``ValueError`` naming ``--dataset_mode`` at model creation.
"""

import os
import types

import numpy as np
import pytest
from PIL import Image

from vts_torch.data import base_transforms as port_bt
from vts_torch.data import legacy as port_legacy
from vts_tpu.data import base_transforms as jax_bt
from vts_tpu.data import legacy as jax_legacy
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

CHAINS = ["resize_and_crop", "scale_width_and_crop", "resize", "scale_width", "crop",
          "zoom_and_crop", "scale_width_and_zoom_and_crop", "none", "crop_and_power",
          "resize_power"]
MODES = ["single", "unaligned", "singleimage", "template"]


def _opt(**kw):
    base = dict(preprocess="resize_and_crop", load_size=40, crop_size=32, no_flip=False,
                random_scale_max=3.0, seed=3, phase="train", serial_batches=False,
                data_len=5, max_dataset_size=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _write(path, size, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One root a dataset: odd-sized RGB images (37×29 to 51×45)."""
    tmp = tmp_path_factory.mktemp("legacy")
    sizes = [(37, 29), (51, 45), (44, 33)]
    for i, s in enumerate(sizes):
        _write(str(tmp / "single" / f"im{i}.png"), s, i)
        _write(str(tmp / "template" / f"im{i}.png"), s, 10 + i)
    for ph in ("train", "test"):
        for i, s in enumerate(sizes):
            _write(str(tmp / "unaligned" / f"{ph}A" / f"a{i}.png"), s, 20 + i)
        for i, s in enumerate(sizes[:2]):
            _write(str(tmp / "unaligned" / f"{ph}B" / f"b{i}.png"), s[::-1], 30 + i)
        _write(str(tmp / "singleimage" / f"{ph}A" / "a.png"), sizes[1], 40)
        _write(str(tmp / "singleimage" / f"{ph}B" / "b.png"), sizes[0], 41)
        _write(str(tmp / "singleimage_a" / f"{ph}A" / "a.png"), sizes[2], 42)
    os.makedirs(tmp / "template_empty")
    return tmp


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("chain", CHAINS)
def test_transform_chains_equal_the_reference(chain, flip, roots):
    opt = _opt(preprocess=chain, no_flip=not flip)
    for i in range(3):
        img = Image.open(roots / "single" / f"im{i}.png").convert("RGB")
        want_p = jax_bt.get_params(opt, img.size, np.random.default_rng(i))
        got_p = port_bt.get_params(opt, img.size, np.random.default_rng(i))
        assert got_p == want_p
        for params in (want_p, None):
            for gray in (False, True):
                want = jax_bt.apply_transform(opt, img, params, grayscale=gray)
                got = port_bt.apply_transform(opt, img, params, grayscale=gray)
                assert got.dtype == want.dtype == np.float32
                assert got.shape == want.shape and np.array_equal(got, want), (params, gray)
        raw = port_bt.apply_transform(opt, img, want_p, normalize=False)
        assert np.array_equal(raw, jax_bt.apply_transform(opt, img, want_p, normalize=False))


def _pairs(roots):
    """(name, dataset mode, opt) of each legacy dataset case."""
    return [("single", "single", _opt(dataroot=str(roots / "single"))),
            ("single_capped", "single", _opt(dataroot=str(roots / "single"),
                                              max_dataset_size=2)),
            ("unaligned", "unaligned", _opt(dataroot=str(roots / "unaligned"))),
            ("unaligned_serial", "unaligned", _opt(dataroot=str(roots / "unaligned"),
                                                   serial_batches=True, phase="test")),
            ("singleimage", "singleimage", _opt(dataroot=str(roots / "singleimage"),
                                                preprocess="zoom_and_crop")),
            ("singleimage_a", "singleimage", _opt(dataroot=str(roots / "singleimage_a"),
                                                  preprocess="none")),
            ("template", "template", _opt(dataroot=str(roots / "template"),
                                          preprocess="scale_width_and_crop")),
            ("template_empty", "template", _opt(dataroot=str(roots / "template_empty")))]


@pytest.mark.parametrize("case", ["single", "single_capped", "unaligned", "unaligned_serial",
                                  "singleimage", "singleimage_a", "template", "template_empty"])
def test_legacy_dataset_items_equal_the_reference(case, roots):
    _, mode, opt = next(p for p in _pairs(roots) if p[0] == case)
    jax_cls = {"single": jax_legacy.SingleDataset, "unaligned": jax_legacy.UnalignedDataset,
               "singleimage": jax_legacy.SingleImageDataset,
               "template": jax_legacy.TemplateDataset}[mode]
    want_ds, got_ds = jax_cls(opt), port_legacy.LEGACY_DATASETS[mode](opt)
    assert len(got_ds) == len(want_ds) > 0
    for want, got in zip(want_ds, got_ds):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_legacy_datasets_refuse_what_the_reference_asserts(roots):
    with pytest.raises(ValueError, match="no images"):
        port_legacy.SingleDataset(_opt(dataroot=str(roots / "template_empty")))
    with pytest.raises(ValueError, match="exactly one A image"):
        port_legacy.SingleImageDataset(_opt(dataroot=str(roots / "unaligned")))
    for cls, opt in ((jax_legacy.SingleDataset, _opt(dataroot=str(roots / "template_empty"))),
                     (jax_legacy.SingleImageDataset, _opt(dataroot=str(roots / "unaligned")))):
        with pytest.raises(AssertionError):
            cls(opt)


def _argv(tmp, mode, root, *extra):
    return ["--dataroot", str(root), "--dataset_mode", mode, "--name", f"legacy_{mode}",
            "--checkpoints_dir", str(tmp / "ckpt"), "--preprocess", "resize_and_crop",
            "--load_size", "40", "--crop_size", "32", "--no_flip", "false", "--batch_size", "2",
            "--seed", "5", "--data_len", "4", *extra]


@pytest.mark.parametrize("mode", MODES)
def test_legacy_loaders_through_the_parsers_equal_the_reference(mode, roots, tmp_path):
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.data import create_dataset as jax_create_dataset
    extra = ("--new_dataset_option", "2.5") if mode == "template" else ()
    argv = _argv(tmp_path, mode, roots / mode, *extra)
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jopt.num_threads = 0
    opt = TrainOptions().parse(argv + ["--device", "cpu"], quiet=True)
    if mode == "template":
        assert opt.new_dataset_option == jopt.new_dataset_option == 2.5
    want_loader, got_loader = jax_create_dataset(jopt), create_dataset(opt)
    assert len(got_loader) == len(want_loader) > 0
    for epoch in (1, 2):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        for want, got in zip(want_loader, got_loader):
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), (epoch, k)


MODELS = ["sinskit", "skit", "pix2pix", "pix2pixHD", "spade"]


@pytest.mark.parametrize("model", MODELS)
def test_models_on_a_legacy_dataset_fail_in_the_reference_and_are_refused(model, roots,
                                                                          tmp_path):
    """The reference parses and loads, then its model's setup reads the
    sketch the legacy samples do not hold (``sinskit.py:390``,
    ``pix2pix.py:113``): a ``KeyError 'S'``, in training and in testing
    alike (both entry points call ``setup`` on the first batch).  The port
    refuses each legacy mode by name at model creation."""
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.models import create_model
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.data import create_dataset as jax_create_dataset
    from vts_tpu.models import create_model as jax_create_model
    argv = _argv(tmp_path, "single", roots / "single", "--model", model, "--ngf", "4",
                 "--ndf", "4")
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jopt.num_threads = 0
    batch = next(iter(jax_create_dataset(jopt)))
    with pytest.raises(KeyError, match="'S'"):
        jax_create_model(jopt).setup(batch)
    for mode in MODES:
        for cls in (TrainOptions, TestOptions):
            opt = cls().parse(_argv(tmp_path, mode, roots / mode, "--model", model,
                                    "--device", "cpu"), quiet=True)
            with pytest.raises(ValueError, match=f"--dataset_mode {mode} with --model {model}"):
                create_model(opt)
