"""The port's visuals and HTML galleries against ``vts_tpu`` on the CPU:

  * after the same training step from the same weights
    (``tests/torch_port_step.py``, 256², batch 1), ``get_current_visuals``
    has JAX's keys, in its order, and shapes; the float visuals (the inputs,
    fake_I/gx/gy/N, the augmented images, D1's logit map and the
    full-canvas D2 pass) agree within rtol 1e-4, atol 1e-5; the uint8
    panels (box overlays, patch collages) within one level, since
    ``tensor2im`` truncates and a round-off difference can cross a level;
    the real patch panels, cut from the data, are equal;
  * the port's ``tensor2im``, ``patch_collage``, ``bbox_overlay`` and
    ``HTML`` give the bytes of ``vts_tpu.utils``'s on the same arrays;
  * ``python -m vts_torch.train --device cpu`` without ``--no_html``
    crosses D3's warmup epoch in one run and writes its gallery, and
    ``vts_torch.test`` then writes the test gallery.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import run_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = "synthetic://vis?size=320&center_w=192&center_h=128&patches=6&val_patches=3"
COMMON = ["--dataroot", DATA, "--crop_size", "256", "--center_w", "192", "--center_h", "128",
          "--ngf", "4", "--name", "vis", "--device", "cpu"]


@pytest.fixture(scope="module")
def visuals(env):  # noqa: F811
    jmodel, _, model = run_step(env, 1)
    return jmodel.get_current_visuals(), model.get_current_visuals()


def test_visuals_match_jax_after_a_step(visuals):
    want, got = visuals
    assert list(got) == list(want)
    assert {"pred_fake_I", "pred_fake_T_full", "aug_fake_I", "fake_N", "train_I_bb",
            "val_gx_bb", "train_fake_gx_patches", "val_real_gx_patches"} <= set(want)
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        assert b.shape == a.shape and b.dtype == a.dtype, (k, b.shape, a.shape, b.dtype)
        if a.dtype == np.uint8:
            d = np.abs(b.astype(np.int16) - a.astype(np.int16))
            if "real_gx_patches" in k:
                assert d.max() == 0, k
            assert d.max() <= 1, (k, d.max())
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def image_arrays():
    rng = np.random.default_rng(0)
    return {"nhwc3": rng.uniform(-1.2, 1.2, (2, 40, 48, 3)).astype(np.float32),
            "hwc1": rng.uniform(-1, 1, (40, 48, 1)).astype(np.float32),
            "hw": rng.normal(size=(40, 48)).astype(np.float64),
            "uint8": rng.integers(0, 256, (40, 48, 3)).astype(np.uint8),
            "patches": rng.uniform(-1, 1, (7, 32, 32, 1)).astype(np.float32)}


@pytest.mark.parametrize("what", ["tensor2im", "patch_collage", "bbox_overlay", "html"])
def test_gallery_utils_equal_vts_tpu(image_arrays, what, tmp_path):
    import vts_tpu.utils.collage as jc
    import vts_tpu.utils.html as jh
    import vts_tpu.utils.image as ji
    from vts_torch.utils import collage as tc
    from vts_torch.utils import html as th
    from vts_torch.utils import image as ti
    a = image_arrays
    if what == "tensor2im":
        pairs = [(ji.tensor2im(v), ti.tensor2im(v)) for v in a.values()]
    elif what == "patch_collage":
        pairs = [(jc.patch_collage(p), tc.patch_collage(p))
                 for p in (a["patches"], a["patches"][:5], a["patches"][:0])]
    elif what == "bbox_overlay":
        ox, oy = np.array([-5, 3, 30, 44]), np.array([2, -3, 20, 37])
        pairs = [(jc.bbox_overlay(a["nhwc3"], ox, oy, s, color),
                  tc.bbox_overlay(a["nhwc3"], ox, oy, s, color))
                 for s, color in ((8, (255, 0, 0)), (np.array([4, 9, 16, 32]), (0, 255, 0)))]
    else:
        pages = []
        for page in (jh.HTML(str(tmp_path / "jax"), "Experiment <x>", refresh=0),
                     th.HTML(str(tmp_path / "port"), "Experiment <x>")):
            page.add_header("epoch [2]")
            page.add_images(["a.png", "b.png"], ["a", "b&c"], ["a.png", "b.png"], width=128)
            with open(page.save()) as f:
                pages.append(f.read())
        pairs = [tuple(pages)]
    for want, got in pairs:
        if isinstance(want, str):
            assert got == want
        else:
            assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """``python -m vts_torch.train --device cpu`` at 256² without ``--no_html``,
    D3 from epoch 2 of 2, the visuals after every sample."""
    tmp = tmp_path_factory.mktemp("vis_run")
    dirs = ["--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res")]
    out = subprocess.run(
        [sys.executable, "-m", "vts_torch.train", *COMMON, *dirs, "--ndf", "4",
         "--batch_size_G2", "4", "--batch_size_G2_val", "3", "--add_fake_T_sample_size", "3",
         "--data_len", "2", "--n_epochs", "2", "--n_epochs_decay", "0",
         "--vision_aided_warmup_epoch", "2", "--display_freq", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return tmp, dirs, out.stdout


def _loss_values(line):
    return dict((k, float(v)) for k, v in re.findall(r"(\w+): (-?[\d.]+|nan|inf)", line))


def test_cpu_train_crosses_d3_warmup_with_gallery(cpu_run):
    tmp, _, stdout = cpu_run
    lines = {e: [ln for ln in stdout.splitlines() if ln.startswith(f"(epoch: {e}, iters:")]
             for e in (1, 2)}
    assert lines[1] and lines[2]
    for ln in lines[1]:
        assert "G_D3" not in ln and "D3_loss" not in ln, ln
    for ln in lines[2]:
        vals = _loss_values(ln)
        assert {"G_D3", "D3_loss", "G_total"} <= set(vals), ln
        assert all(np.isfinite(v) for v in vals.values()), ln
        assert vals["G_D3"] > 0 and vals["D3_loss"] > 0
    web = tmp / "ckpt" / "vis" / "web"
    page = (web / "index.html").read_text()
    for e in (1, 2):
        pngs = sorted(p.name for p in (web / "images").glob(f"epoch{e:03d}_*.png"))
        assert f"epoch{e:03d}_pred_fake_T_full.png" in pngs and len(pngs) == 19, pngs
        assert f"epoch [{e}]" in page


def test_cpu_test_writes_gallery(cpu_run):
    from vts_torch.test import test as port_test
    tmp, dirs, _ = cpu_run
    metrics = port_test(COMMON + dirs + ["--epoch", "best", "--batch_size_G2", "4",
                                         "--save_raw_arr_vis", "true"])[0]
    assert len(metrics) == 8
    web = tmp / "res" / "vis" / "test_best"
    assert (web / "index.html").exists()
    images = web / "images"
    raw = list(images.glob("*_fake_gxgy_raw.npz"))
    assert len(raw) == 1 and len(list(images.glob("*_fake_gxgy_raw.npy"))) == 1
    with np.load(raw[0]) as f:
        assert f["gx"].shape == f["gy"].shape == (256, 256)
    coords = list(images.glob("*_patch_coords.json"))
    assert len(coords) == 1
    with open(coords[0]) as f:
        c = json.load(f)
    assert c["coords"] and all(b[1] == 256 - a[1] - a[3]
                               for a, b in zip(c["coords"], c["coords_y_flipped"]))
    assert len(list(images.glob("*.png"))) == 11
