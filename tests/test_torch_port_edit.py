"""Edited sketches without ground truth against ``vts_tpu`` on the CPU, at
256² with ngf 4: the ``ours_edit`` path of the launcher (a trained generator
on a new sketch; galleries and raw touch maps written, metrics skipped).

  * an on-disk ``*_edit_*`` root holding only the sketch and the mask
    (``vts_tpu/data/singleskit.py:135-143``): the port's samples have the
    reference's keys (no ``I``, no touch records) and are bit for bit its
    samples, in the test phase and, through the zoom and the random crop, in
    training; a root without ``I`` whose name lacks ``edit`` is refused with
    the reference's message;
  * the skit dataset over two edit roots gives no ``style_image``, as the
    reference's (``vts_tpu/data/skit.py:82-95``); the skit model then fails
    with the reference's message, and runs with ``--style_image_dir``;
  * the test driver on an edit root, from one checkpoint: both
    packages write the same gallery files, ``eval_metrics.pkl`` holds ``{}``
    and no ``eval_metrics_per_material.pkl`` is written; the raw touch maps
    agree within 1e-4 of their max (the generator's fp32 forward, as
    ``tests/test_torch_port_slice.py`` holds it);
  * ``save_garment`` writes the reference's on-disk garment (PNG pixels and
    touch records equal), and the on-disk dataset over it gives the samples
    of the in-memory ``synthetic://`` garment bit for bit.
"""

import os
import pickle

import numpy as np
import pytest
from PIL import Image, ImageOps

SIZE, CW, CH = 320, 192, 128
MATERIALS = ("synthA", "synthB")


def _common(dataroot, tmp, phase="test"):
    argv = ["--model", "sinskit", "--dataroot", str(dataroot), "--crop_size", "256",
            "--center_w", str(CW), "--center_h", str(CH), "--ngf", "4",
            "--batch_size_G2", "4", "--name", "edit",
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res")]
    if phase == "test":
        argv += ["--epoch", "best"]
    return argv


def write_edit_root(base, material, full_root):
    """``singleskit_<material>_edit_padded_<P>_x1``: the garment's sketch and
    mask, mirrored (the edit), in both phases' folders."""
    root = os.path.join(base, f"singleskit_{material}_edit_padded_{SIZE}_x1")
    for phase in ("train", "test"):
        for sub in ("S", "M"):
            src_dir = os.path.join(full_root, f"{phase}{sub}")
            (name,) = os.listdir(src_dir)
            os.makedirs(os.path.join(root, f"{phase}{sub}"), exist_ok=True)
            ImageOps.mirror(Image.open(os.path.join(src_dir, name))).save(
                os.path.join(root, f"{phase}{sub}", name))
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The reference's on-disk garments (synthA, synthB) and their edit twins."""
    from vts_tpu.data.synthetic import generate_garment
    tmp = tmp_path_factory.mktemp("edit")
    full, edit = {}, {}
    for i, m in enumerate(MATERIALS):
        full[m] = generate_garment(str(tmp / "full"), m, padded_size=SIZE, center_w=CW,
                                   center_h=CH, n_train_patches=6, n_val_patches=3, seed=i)
        edit[m] = write_edit_root(str(tmp / "edit"), m, full[m])
    return tmp, full, edit


def _datasets(argv, phase):
    from vts_tpu.config import TestOptions as JaxTestOptions
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.data import create_dataset
    jopt_cls, opt_cls = ((JaxTestOptions, TestOptions) if phase == "test"
                         else (JaxTrainOptions, TrainOptions))
    jopt = jopt_cls().parse(argv, quiet=True)
    opt = opt_cls().parse(argv + ["--device", "cpu"], quiet=True)
    return jopt, create_dataset(opt).dataset


def _assert_same_samples(jds, ds, n):
    assert len(ds) == len(jds) == n
    for i in range(n):
        want, got = jds[i], ds[i]
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"item {i} {k}")


@pytest.mark.parametrize("phase,extra", [("test", []), ("test", ["--preprocess", "zoom"]),
                                         ("train", ["--data_len", "3"])],
                         ids=["test", "test-zoom", "train-zoom-crop"])
def test_edit_root_samples_match_jax(roots, phase, extra):
    """No ``I`` and no touch keys; S, M and the augmentation parameters bit
    for bit the reference's, through zoom, crop and power-of-2."""
    from vts_tpu.data.singleskit import SingleSkitDataset as JaxSingleSkit
    tmp, _, edit = roots
    argv = _common(edit["synthA"], tmp, phase) + extra
    jopt, ds = _datasets(argv, phase)
    jds = JaxSingleSkit(jopt)
    _assert_same_samples(jds, ds, len(jds))
    sample = ds[0]
    assert "I" not in sample and not any("T_" in k for k in sample)
    assert sample["S"].shape == (256, 256, 1) and sample["M"].shape == (256, 256, 1)


def test_root_without_I_must_be_an_edit_root(roots, tmp_path):
    """Both packages refuse a root with no visual image unless its name says
    ``edit``, with the same message."""
    from vts_tpu.data.singleskit import SingleSkitDataset as JaxSingleSkit
    _, full, edit = roots
    plain = tmp_path / f"singleskit_synthA_padded_{SIZE}_x1"
    for sub in ("testS", "testM"):
        os.makedirs(plain / sub)
        (name,) = os.listdir(os.path.join(edit["synthA"], sub))
        Image.open(os.path.join(edit["synthA"], sub, name)).save(plain / sub / name)
    jopt, _ = _datasets(_common(full["synthA"], tmp_path), "test")
    jopt.dataroot = str(plain)
    msg = "I and T data required for non-edited sketches"
    with pytest.raises(AssertionError, match=msg):
        JaxSingleSkit(jopt)
    with pytest.raises(ValueError, match=msg):
        _datasets(_common(plain, tmp_path), "test")


def _skit_argv(tmp, edit, extra=()):
    base = os.path.dirname(edit["synthA"])
    return ["--model", "skit", "--dataroot", os.path.join(base, "unused"),
            "--material_list", ",".join(MATERIALS),
            "--dataroot_suffix", f"_edit_padded_{SIZE}_x1", "--crop_size", "256",
            "--center_w", str(CW), "--center_h", str(CH), "--ngf", "4",
            "--batch_size_G2", "4", "--name", "skit_edit", "--epoch", "best",
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res"), *extra]


def test_skit_dataset_over_edit_roots_has_no_style_image(roots):
    from vts_tpu.data.skit import SkitDataset as JaxSkitDataset
    tmp, _, edit = roots
    jopt, ds = _datasets(_skit_argv(tmp, edit), "test")
    jds = JaxSkitDataset(jopt)
    assert ds.materials == jds.materials == list(MATERIALS)
    _assert_same_samples(jds, ds, 2)
    assert "style_image" not in ds[0] and "I" not in ds[1]


def test_skit_model_needs_a_style_image_without_I(roots, tmp_path):
    """Without ``--style_image_dir`` both packages' skit models fail on an
    edit batch with the reference's message; with it the port's encodes the
    style image and runs the generator."""
    import torch
    from vts_tpu.models import create_model as jax_create_model
    from vts_torch.data import create_dataset
    from vts_torch.config import TestOptions
    from vts_torch.models import create_model
    tmp, full, edit = roots
    jopt, ds = _datasets(_skit_argv(tmp, edit), "test")
    batch = {k: np.asarray(v)[None] for k, v in ds[0].items()}
    msg = "skitG needs a style image or visual image"
    with pytest.raises(AssertionError, match=msg):
        jax_create_model(jopt).set_input(batch)
    opt = TestOptions().parse(_skit_argv(tmp, edit) + ["--device", "cpu"], quiet=True)
    model = create_model(opt)
    with pytest.raises(ValueError, match=msg):
        model.set_input(batch)
    style_dir = tmp_path / "style"
    style_dir.mkdir()
    (name,) = os.listdir(os.path.join(full["synthB"], "testI"))
    Image.open(os.path.join(full["synthB"], "testI", name)).save(style_dir / name)
    opt = TestOptions().parse(_skit_argv(tmp, edit, ("--style_image_dir", str(style_dir),
                                                      "--device", "cpu")), quiet=True)
    loader = create_dataset(opt)
    batch = next(iter(loader))
    assert batch["style_image"].shape == (1, 224, 224, 3) and "I" not in batch
    model = create_model(opt)
    model.setup()
    model.set_input(batch)
    model.test()
    assert model._input["style_code"].shape == (1, 512)
    assert torch.isfinite(model._outputs["fake_I"]).all()


def _gallery(web_dir):
    return sorted(os.listdir(os.path.join(web_dir, "images")))


def test_test_driver_on_edit_root_matches_jax(roots):
    """``vts_tpu.test`` and ``vts_torch.test --device cpu`` on an edit root from
    one checkpoint: no metrics (``{}`` pickled), the same gallery
    files, the raw touch maps within 1e-4 of their max."""
    from vts_tpu.test import test as jax_test
    from vts_torch.config import TestOptions
    from vts_torch.models import create_model
    from vts_torch.test import test as port_test
    tmp, _, edit = roots
    argv = _common(edit["synthA"], tmp)
    _, ds = _datasets(argv, "test")
    # the checkpoint, written by the port (msgpack, read by both), with a
    # larger init gain than the default so that the output is far from zero
    model = create_model(TestOptions().parse(argv + ["--device", "cpu", "--init_gain", "0.5"],
                                             quiet=True))
    model.setup()
    model.save_networks("best")
    dirs = {}
    for pkg, run in (("jax", jax_test), ("port", port_test)):
        res = tmp / f"res_{pkg}"
        got = run(argv=argv + ["--results_dir", str(res)]
                  + (["--device", "cpu"] if pkg == "port" else []))
        assert got == [{}], (pkg, got)
        web = res / "edit" / "test_best"
        with open(web / "eval_metrics.pkl", "rb") as f:
            assert pickle.load(f) == {}, pkg
        assert not (web / "eval_metrics_per_material.pkl").exists(), pkg
        dirs[pkg] = web
    files = _gallery(dirs["port"])
    assert files == _gallery(dirs["jax"])
    stem = f"{ds.name}_0"
    assert {f"{stem}_fake_gxgy_raw.npz", f"{stem}_patch_coords.json", f"{stem}_fake_I.png",
            f"{stem}_real_S.png"} <= set(files)
    assert not any("real_I" in f for f in files)
    raw = {pkg: np.load(os.path.join(d, "images", f"{stem}_fake_gxgy_raw.npz"))
           for pkg, d in dirs.items()}
    for k in ("gx", "gy"):
        want, got = raw["jax"][k], raw["port"][k]
        assert got.shape == want.shape == (256, 256)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k
        assert np.abs(want).max() > 1e-2
    assert (dirs["port"] / "index.html").exists()


def test_save_garment_writes_the_reference_root(tmp_path):
    """The port's on-disk garment is the reference's, file for file, and the
    on-disk dataset over it gives the in-memory garment's samples."""
    from vts_tpu.data.synthetic import generate_garment
    from vts_torch.data.npz import list_touch_npz, load_touch_npz
    from vts_torch.data.synthetic import generate_garment as port_garment
    from vts_torch.data.synthetic import save_garment
    kw = dict(padded_size=SIZE, center_w=CW, center_h=CH, n_train_patches=6,
              n_val_patches=3, seed=5)
    want = generate_garment(str(tmp_path / "jax"), "synthC", **kw)
    got = save_garment(port_garment("synthC", **kw), str(tmp_path / "port"))
    assert os.path.basename(got) == os.path.basename(want)
    listing = {r: sorted(os.path.relpath(os.path.join(d, f), r) for d, _, fs in os.walk(r)
                         for f in fs if not f.startswith(".")) for r in (want, got)}
    assert listing[got] == listing[want]
    for rel in listing[want]:
        a, b = os.path.join(want, rel), os.path.join(got, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
    for sub in ("trainT", "valT", "testT"):
        for a, b in zip(list_touch_npz(os.path.join(want, sub)),
                        list_touch_npz(os.path.join(got, sub))):
            ra, rb = load_touch_npz(a), load_touch_npz(b)
            for f in ("gx", "gy", "touch_mask", "touch_center_mask"):
                np.testing.assert_array_equal(getattr(rb, f), getattr(ra, f))
            assert (rb.roi_x, rb.roi_y, rb.roi_h, rb.roi_w) == (ra.roi_x, ra.roi_y,
                                                                ra.roi_h, ra.roi_w)
    from vts_torch.config import TestOptions
    from vts_torch.data.singleskit import SingleSkitDataset
    uri = f"synthetic://synthC?size={SIZE}&patches=6&val_patches=3&seed=5"
    mem, disk = (SingleSkitDataset(TestOptions().parse(
        _common(root, tmp_path) + ["--device", "cpu"], quiet=True)) for root in (uri, got))
    for k, v in mem[0].items():
        np.testing.assert_array_equal(disk[0][k], v, err_msg=k)
