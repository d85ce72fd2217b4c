"""The host tools of the port against ``vts_tpu`` on the CPU, on the same
inputs (numpy, from a seed; results trees written here):

  * ``postprocess_gz`` bit for bit the reference's for every mode and the
    quantiles 0.3 and 0.5, on random gx/gy with zeros in them, with OpenCV's
    CLAHE and with its histogram fallback (``sys.modules["cv2"] = None`` for
    both packages); the CLI writes the same PNG; an unknown mode raises;
  * the metric roll-up, its markdown, the CSV table and the comparison page
    byte for byte the reference's on a results tree with two materials, one
    missing and one with only an older epoch;
  * the launcher: the reference's presets and materials, its commands with
    ``vts_tpu.`` → ``vts_torch.`` (``commands``, ``--dry_run``), the same
    comparison pages, the fleet as the default (on cuda; a baseline refused by
    name), the first non-zero
    child exit code, a baseline's child failing; and on the CPU the whole
    edit → render workflow through it (train two garments in two processes,
    test them, test their edited sketches, roll up, compare, postprocess);
  * ``save_images`` under ``--save_raw_arr_vis``: the ``.npy`` stack and the
    array handed to OpenCV for the ``.exr`` equal to the reference's, and the
    reference's note where OpenCV or its EXR codec is missing.
"""

import io
import os
import pickle
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
from PIL import Image

import vts_torch.launch as port_launch
import vts_tpu.launch as jax_launch
from vts_torch import postprocess as port_pp
from vts_tpu import postprocess as jax_pp
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gxgy(seed=0, shape=(96, 128)):
    rng = np.random.default_rng(seed)
    gx, gy = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    gx[rng.random(shape) < 0.3] = 0
    gy[gx == 0] = 0                      # a third of gz exactly 0
    return gx, gy


@pytest.mark.parametrize("cv2", ["cv2", "no_cv2"])
@pytest.mark.parametrize("quantile", [0.3, 0.5])
@pytest.mark.parametrize("mode", port_pp.MODES)
def test_postprocess_matches_jax(mode, quantile, cv2, monkeypatch):
    if cv2 == "no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    gx, gy = _gxgy(len(mode))
    want = jax_pp.postprocess_gz(gx, gy, mode, quantile)
    got = port_pp.postprocess_gz(gx, gy, mode, quantile)
    assert got.dtype == want.dtype == np.float32 and got.shape == (800, 1280)
    np.testing.assert_array_equal(got, want)
    assert 0 <= got.min() and got.max() <= 1 and got.max() > 0


def test_postprocess_cli_and_unknown_mode(tmp_path):
    gx, gy = _gxgy(7)
    npz = tmp_path / "x_fake_gxgy_raw.npz"
    np.savez(npz, gx=gx, gy=gy)
    want = jax_pp.main(["--input", str(npz), "--mode", "log10", "--output",
                        str(tmp_path / "want.png")])
    got = port_pp.main(["--input", str(npz), "--mode", "log10", "--width", "640",
                        "--height", "400"])
    assert got == str(tmp_path / "x_fake_gxgy_raw_friction_log10.png")
    port_pp.main(["--input", str(npz), "--mode", "log10", "--output", got])
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))
    for pp in (jax_pp, port_pp):
        with pytest.raises(NotImplementedError, match="sobel"):
            pp.postprocess_gz(gx, gy, "sobel")
        with pytest.raises(SystemExit):
            pp.main(["--input", str(npz), "--mode", "sobel"])


METRICS = ("I_SIFID", "I_LPIPS", "I_PSNR", "I_SSIM", "T_SIFID", "T_LPIPS", "T_AE", "T_MSE")


@pytest.fixture
def results(tmp_path):
    """matA at test_best, matB with only test_100 (the fallback), matC absent;
    two methods' galleries for the comparison pages."""
    rng = np.random.default_rng(3)
    res = tmp_path / "results"
    for mat, epoch in (("matA", "best"), ("matB", "100")):
        d = res / f"{mat}_sinskitG_baseline_ours" / f"test_{epoch}"
        d.mkdir(parents=True)
        with open(d / "eval_metrics.pkl", "wb") as f:
            pickle.dump({f"metric_{k}": float(rng.random()) for k in METRICS}, f)
        for suffix, names in (("sinskitG_baseline_ours", ("a_fake_I.png", "a_fake_gx.png")),
                              ("skitG", ("a_fake_I.png", "b_fake_I.png"))):
            img = res / f"{mat}_{suffix}" / f"test_{epoch}" / "images"
            img.mkdir(parents=True, exist_ok=True)
            for n in names:
                (img / n).write_bytes(b"png")
    return res


def _run(fn, *args):
    out = io.StringIO()
    with redirect_stdout(out):
        ret = fn(*args)
    return ret, out.getvalue()


def test_compile_metrics_and_tables_match_jax(results, tmp_path):
    from vts_torch.utils import compile_metrics as port_cm
    from vts_torch.utils import misc as port_misc
    from vts_tpu.utils import compile_metrics as jax_cm
    from vts_tpu.utils import misc as jax_misc
    assert port_cm.METRIC_ORDER == jax_cm.METRIC_ORDER
    outs = {}
    for key, cm, misc in (("jax", jax_cm, jax_misc), ("port", port_cm, port_misc)):
        md = tmp_path / f"{key}.md"
        table, text = _run(cm.main, ["--results_dir", str(results), "--materials",
                                     "matA,matB,matC", "--out", str(md)])
        rows = [dict(material=m, **v) for m, v in table.items()]
        csv = misc.upload_metrics_table(rows, "roll", out_dir=str(tmp_path / key),
                                        credentials="creds.json")
        outs[key] = (table, text, md.read_bytes(), open(csv, "rb").read())
    assert outs["port"] == outs["jax"]
    table, text = outs["port"][:2]
    assert list(table) == ["matA", "matB", "MEAN"] and "missing metrics for matC" in text
    assert table["MEAN"]["T_MSE"] == pytest.approx((table["matA"]["T_MSE"]
                                                    + table["matB"]["T_MSE"]) / 2)
    assert port_cm.format_table({}) == jax_cm.format_table({}) == "(no metrics found)"
    assert os.path.isdir(port_misc.create_log_dir_by_date(str(tmp_path / "logs")))
    assert port_misc.equalize_this is port_pp.equalize_adaptive


def _pages(results, launch, *extra):
    """``launch ours compare``: its return code, output and pages."""
    ret, out = _run(launch.main, ["ours", "compare", "--materials", "matA,matB",
                                  "--results_dir", str(results), *extra])
    pages = {m: (results / f"comparison_{m}" / "index.html").read_bytes()
             for m in ("matA", "matB")}
    return ret, out, pages


@pytest.mark.parametrize("extra", [[], ["--against", "skit", "--filter", "fake_I",
                                        "--epoch", "100"]], ids=["ours", "against-skit"])
def test_compare_pages_match_jax(results, extra):
    from vts_torch.utils.compare import create_comparison_html
    want = _pages(results, jax_launch, *extra)
    got = _pages(results, port_launch, *extra)
    assert got == want
    assert (b"&mdash;" in got[2]["matB"]) == bool(extra)      # b_fake_I: skit's only
    with pytest.raises(ValueError, match="2 dirs but 1 labels"):
        create_comparison_html(str(results / "x"), ["a", "b"], ["a"])


def test_launcher_commands_and_presets_match_jax(tmp_path):
    assert port_launch.DEFAULT_MATERIALS == jax_launch.DEFAULT_MATERIALS
    assert len(port_launch.DEFAULT_MATERIALS) == 20
    assert port_launch.METHOD_PRESETS == jax_launch.METHOD_PRESETS
    dirs = ["--checkpoints_dir", str(tmp_path / "c"), "--results_dir", str(tmp_path / "r")]
    for argv in (["ours", "commands", "--materials", "a,b", *dirs, "--", "--n_epochs", "1"],
                 ["pix2pix", "commands"],
                 ["ours", "launch", "--mode", "process", "--dry_run", "--materials", "a,b"],
                 ["ours_edit", "test", "--dry_run", "--materials", "a", "--epoch", "7",
                  "--dataroot-template", "/d/singleskit_{material}_edit_padded_1800_x1/"]):
        want = _run(jax_launch.main, argv)
        got = _run(port_launch.main, argv)
        assert got[0] == want[0] == 0
        assert got[1] == want[1].replace("vts_tpu.", "vts_torch."), argv
    # the default mode is now the fleet, which runs on cuda unless told otherwise
    # (there is none here) and refuses a baseline's preset by name
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_launch.main(["ours", "launch", "--materials", "a", *dirs])
    with pytest.raises(ValueError, match="--mode fleet cannot train 'pix2pix'"):
        port_launch.main(["pix2pix", "launch", "--materials", "a"])
    with pytest.raises(SystemExit):
        port_launch.main(["ours", "compare", "--against", "nope"])


def test_process_mode_returns_the_first_failing_child(monkeypatch, tmp_path):
    """One child per garment; the launcher waits for all and returns the first
    non-zero code in the materials' order.  A child given a refused flag
    after ``--`` fails naming it (spade's, past its own options, on a
    ``--netG`` that SPADE does not take); pix2pix's child gets past the
    options (its garment root does not exist here, so it fails on the
    data)."""
    codes = {"a": 0, "b": 3, "c": 5}
    monkeypatch.setattr(port_launch, "garment_command", lambda method, m, args: [
        sys.executable, "-c", f"import sys; sys.exit({codes[m]})"])
    rc, out = _run(port_launch.main, ["ours", "launch", "--mode", "process",
                                      "--materials", "a,b,c"])
    assert rc == 3 and "[c] exited 5" in out
    monkeypatch.undo()
    rc = subprocess.run([sys.executable, "-m", "vts_torch.launch", "spade", "launch",
                         "--mode", "process", "--materials", "a",
                         "--checkpoints_dir", str(tmp_path), "--", "--device", "cpu",
                         "--netG", "unet_256"],
                        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert rc.returncode == 1 and "NotImplementedError: --netG" in rc.stderr
    assert "--model 'spade'" not in rc.stderr
    rc = subprocess.run([sys.executable, "-m", "vts_torch.launch", "pix2pix", "launch",
                         "--mode", "process", "--materials", "a",
                         "--checkpoints_dir", str(tmp_path), "--", "--device", "cpu"],
                        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert "pix2pix_baseline" in rc.stdout + rc.stderr
    assert "NotImplementedError: --model 'pix2pix'" not in rc.stderr


@pytest.mark.parametrize("cv2", ["fake", "installed", "missing"])
def test_raw_export_matches_jax(cv2, monkeypatch, tmp_path, capsys):
    """``--save_raw_arr_vis``: the ``.npz``, the ``.npy`` stack, the patch
    coords and the (H, W, 3) float32 array written as ``.exr`` are the
    reference's; without OpenCV, or with an OpenCV that has no EXR writer
    (this one), both print the reference's note."""
    from vts_torch.utils.html import HTML as PortHTML
    from vts_torch.utils.visualizer import save_images as port_save
    from vts_tpu.utils.html import HTML as JaxHTML
    from vts_tpu.utils.visualizer import save_images as jax_save
    written = []
    if cv2 == "fake":
        class FakeCV2:
            error = RuntimeError

            @staticmethod
            def imwrite(path, arr):
                written.append((os.path.basename(path), arr.copy()))
                return True
        monkeypatch.setitem(sys.modules, "cv2", FakeCV2)
    elif cv2 == "missing":
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(11)
    visuals = {"real_S": rng.uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32),
               "fake_gx": rng.uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32),
               "fake_gy": rng.uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32)}
    coords = rng.integers(0, 32, (3, 4)).astype(np.float32)
    notes = {}
    for key, html, save in (("jax", JaxHTML, jax_save), ("port", PortHTML, port_save)):
        page = html(str(tmp_path / key), "t")
        save(page, visuals, "g_0.png", width=64, patch_coords=coords, image_height=64,
             save_raw_arr_vis=True)
        notes[key] = [ln for ln in capsys.readouterr().out.splitlines() if "exr" in ln]
    img = {k: tmp_path / k / "images" for k in ("jax", "port")}
    assert sorted(os.listdir(img["port"])) == sorted(os.listdir(img["jax"]))
    want, got = (np.load(img[k] / "g_0_fake_gxgy_raw.npy") for k in ("jax", "port"))
    assert got.shape == (2, 64, 64)
    np.testing.assert_array_equal(got, want)
    for k in ("gx", "gy"):
        np.testing.assert_array_equal(np.load(img["port"] / "g_0_fake_gxgy_raw.npz")[k],
                                      np.load(img["jax"] / "g_0_fake_gxgy_raw.npz")[k])
    assert ((img["port"] / "g_0_patch_coords.json").read_text()
            == (img["jax"] / "g_0_patch_coords.json").read_text())
    if cv2 == "fake":
        (name_j, arr_j), (name_p, arr_p) = written
        assert name_j == name_p == "g_0_fake_gxgy_raw.exr" and not notes["port"]
        assert arr_p.dtype == np.float32 and arr_p.shape == (64, 64, 3)
        np.testing.assert_array_equal(arr_p, arr_j)
    else:
        assert len(notes["port"]) == 1 and notes["port"] == notes["jax"]
        assert notes["port"][0].startswith("[save_images] exr export unavailable: ")


# the CPU edit → render workflow through the launcher, at 256² with ngf 4:
# one training step a garment without the epoch's validation (so the test
# phases load ``latest``), one test patch (the metrics' VGG runs on the CPU)
WORKFLOW_FLAGS = ["--device", "cpu", "--crop_size", "256", "--center_w", "192",
                  "--center_h", "128", "--ngf", "4", "--batch_size_G2", "1"]
TRAIN_FLAGS = ["--ndf", "4", "--batch_size_G2_val", "1", "--add_fake_T_sample_size", "1",
               "--data_len", "1", "--n_epochs", "1", "--n_epochs_decay", "0",
               "--use_vision_aided_loss", "false", "--no_html", "--val_for_each_epoch", "false"]


def test_edit_render_workflow_through_the_launcher(tmp_path):
    """Two garments trained in two processes, tested, their edited sketches
    tested (no metrics), the roll-up with its MEAN row, the comparison pages,
    and every raw touch map through the postprocess."""
    from tests.test_torch_port_edit import write_edit_root
    from vts_torch.data.synthetic import generate_garment, save_garment
    from vts_torch.utils import compile_metrics
    mats = "synthA,synthB"
    for i, m in enumerate(mats.split(",")):
        full = save_garment(generate_garment(m, padded_size=320, center_w=192, center_h=128,
                                             n_train_patches=6, n_val_patches=3, seed=i),
                            str(tmp_path / "data"))
        write_edit_root(str(tmp_path / "data"), m, full)
    common = ["--materials", mats, "--checkpoints_dir", str(tmp_path / "ckpt"),
              "--epoch", "latest"]
    full_t = ["--dataroot-template", str(tmp_path / "data" / "singleskit_{material}_padded_320_x1")]
    edit_t = ["--dataroot-template",
              str(tmp_path / "data" / "singleskit_{material}_edit_padded_320_x1")]
    res, res_edit = str(tmp_path / "res"), str(tmp_path / "res_edit")
    for argv in (["ours", "launch", "--mode", "process", *full_t, "--results_dir", res, "--",
                  *WORKFLOW_FLAGS, *TRAIN_FLAGS],
                 ["ours", "test", *full_t, "--results_dir", res, "--", *WORKFLOW_FLAGS],
                 ["ours_edit", "test", *edit_t, "--results_dir", res_edit, "--",
                  *WORKFLOW_FLAGS]):
        out = subprocess.run([sys.executable, "-m", "vts_torch.launch", *argv[:2], *common,
                              *argv[2:]], cwd=ROOT, capture_output=True, text=True, timeout=600,
                             env={**os.environ, "OMP_NUM_THREADS": "2"})
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        # both children write to the one pipe: match their reports, not lines
        devices = re.findall(r"\[device\] \S+ (?:trains|tests) on (cpu|cuda:\d+)", out.stdout)
        assert devices == ["cpu", "cpu"], devices
    for m in mats.split(","):
        name = f"{m}_sinskitG_baseline_ours"
        assert (tmp_path / "ckpt" / name / "latest_net_G.msgpack").exists()
        with open(os.path.join(res, name, "test_latest", "eval_metrics.pkl"), "rb") as f:
            got = pickle.load(f)
        assert len(got) == 8 and all(np.isfinite(v) for v in got.values())
        web = os.path.join(res_edit, name, "test_latest")
        with open(os.path.join(web, "eval_metrics.pkl"), "rb") as f:
            assert pickle.load(f) == {}
        (raw,) = [f for f in os.listdir(os.path.join(web, "images")) if f.endswith(".npz")]
        for mode in port_pp.MODES:
            png = port_pp.main(["--input", os.path.join(web, "images", raw), "--mode", mode])
            assert np.asarray(Image.open(png)).shape == (800, 1280)
    table, _ = _run(compile_metrics.main, ["--results_dir", res, "--materials", mats,
                                           "--epoch", "latest"])
    assert list(table) == ["synthA", "synthB", "MEAN"]
    rc, _ = _run(port_launch.main, ["ours", "compare", "--materials", mats, "--results_dir", res,
                                    "--epoch", "latest"])
    assert rc == 0 and os.path.exists(os.path.join(res, "comparison_synthB", "index.html"))
