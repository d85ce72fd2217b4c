"""(h) The slice end to end on the CPU: the port's synthetic test batch equals
the JAX ``create_dataset`` batch exactly, and ``vts_tpu.test.test`` and
``vts_torch.test.test --device cpu`` on one JAX-written checkpoint give the
same 8 metrics.  (i) ``vts_torch``, its test and train entry points, the
training modules and the host tools (postprocess, launcher, metric roll-up,
comparison pages, dashboard) import without JAX and without vts_tpu."""

import os
import subprocess
import sys

import numpy as np
import pytest
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATAROOT = "synthetic://portslice?size=320&center_w=192&center_h=128&patches=6&val_patches=3"


def _argv(tmp):
    return ["--model", "sinskit", "--epoch", "best", "--dataroot", DATAROOT,
            "--crop_size", "256", "--center_w", "192", "--center_h", "128",
            "--ngf", "4", "--batch_size_G2", "4", "--name", "slice",
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res")]


@pytest.fixture(scope="module")
def slice_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    old = os.environ.get("VTS_SYNTH_DIR")
    os.environ["VTS_SYNTH_DIR"] = str(tmp / "synth")
    try:
        yield tmp
    finally:
        if old is None:
            os.environ.pop("VTS_SYNTH_DIR", None)
        else:
            os.environ["VTS_SYNTH_DIR"] = old


def _batches(tmp):
    from vts_tpu.config import TestOptions as JaxTestOptions
    from vts_tpu.data import create_dataset as jax_create_dataset
    from vts_torch.config import TestOptions
    from vts_torch.data import create_dataset
    jopt = JaxTestOptions().parse(_argv(tmp), quiet=True)
    jopt.serial_batches, jopt.num_threads = True, 0
    opt = TestOptions().parse(_argv(tmp) + ["--device", "cpu"], quiet=True)
    return jopt, next(iter(jax_create_dataset(jopt))), next(iter(create_dataset(opt)))


def test_synthetic_test_batch_matches_jax(slice_env):
    _, want, got = _batches(slice_env)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["T_valid"].sum() > 0 and want["S"].shape == (1, 256, 256, 1)


def test_test_entry_point_matches_jax(slice_env):
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.test import test as jax_test
    from vts_torch.test import test as port_test
    tmp = slice_env
    jopt, jbatch, _ = _batches(tmp)
    # a JAX-written checkpoint with a larger init gain than the default, so
    # the generator's output is far from zero
    jopt.init_gain = 0.5
    model = jax_create_model(jopt)
    model.setup(jbatch)
    model.save_networks("best")
    want = jax_test(argv=_argv(tmp))[0]
    got = port_test(_argv(tmp) + ["--device", "cpu"])[0]
    assert got.keys() == want.keys() and len(got) == 8
    for key in want:
        rtol = 1e-3 if "SIFID" in key else 1e-4
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)
    pkl = tmp / "res" / "slice" / "test_best" / "eval_metrics.pkl"
    assert pkl.exists()


def test_port_imports_without_jax_or_vts_tpu():
    """(i) with ``sys.modules['jax'] = None`` the port still imports, and no
    vts_tpu module is loaded."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None; "
            "sys.modules['optax'] = None; "
            "import vts_torch, vts_torch.test, vts_torch.train; "
            "import vts_torch.kernels.build, vts_torch.utils.convert_jax; "
            "import vts_torch.models.base, vts_torch.networks.discriminators; "
            "import vts_torch.losses.gan, vts_torch.losses.gan_masked, vts_torch.ops.diffaug; "
            "import vts_torch.utils.profiler, vts_torch.utils.visualizer; "
            "import vts_torch.networks.clip_vit, vts_torch.losses.vision_aided; "
            "import vts_torch.ops.resize_mm, vts_torch.utils.collage, vts_torch.utils.html; "
            "import vts_torch.postprocess, vts_torch.launch, vts_torch.utils.misc; "
            "import vts_torch.utils.compile_metrics, vts_torch.utils.compare; "
            "import vts_torch.utils.live, vts_torch.data.synthetic; "
            "import vts_torch.models.pix2pix, vts_torch.networks.resnet_gen; "
            "import vts_torch.data.patchskit, vts_torch.utils.convert_torch; "
            "import vts_torch.models.pix2pixhd, vts_torch.networks.pix2pixhd_nets; "
            "import vts_torch.losses.vgg, vts_torch.utils.image_pool; "
            "import vts_torch.models.spade, vts_torch.networks.spade_nets; "
            "import vts_torch.parallel, vts_torch.parallel.fleet, vts_torch.parallel.packing; "
            "import vts_torch.networks.unet_plain, vts_torch.networks.visgel; "
            "import vts_torch.networks.munit, vts_torch.networks.stylegan2; "
            "import vts_torch.networks.cut_heads, vts_torch.losses.normal; "
            "import vts_torch.data.base_transforms, vts_torch.data.legacy; "
            "bad = [m for m in sys.modules if m.startswith('vts_tpu') "
            "or m.split('.')[0] in ('jax', 'flax', 'optax') and sys.modules[m] is not None]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
