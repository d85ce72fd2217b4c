"""Port parity for the metric modules: LPIPS (with K1 inside), Inception
block 0, PSNR/SSIM, normals and angle error, nearest resize, the batched
8-metric evaluation, the legacy per-metric evaluation (``--eval_mode
legacy``, T_FID included) and T_FID's two reductions — the same numpy inputs
through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vts_tpu.losses.lpips import init_lpips_params as jax_init_lpips
from vts_tpu.losses.lpips import lpips as jax_lpips
from vts_tpu.losses.normal import surface_normal_angle_error as jax_ae
from vts_tpu.metrics.evaluate_batch import \
    compute_evaluation_metrics_batched as jax_eval_batched
from vts_tpu.metrics.inception import inception_block0 as jax_block0
from vts_tpu.metrics.inception import init_inception_params as jax_init_inception
from vts_tpu.metrics.psnr_ssim import psnr as jax_psnr
from vts_tpu.metrics.psnr_ssim import ssim as jax_ssim
from vts_tpu.ops.normal import compute_normal as jax_normal
from vts_tpu.ops.resize import resize_nearest as jax_resize
from vts_torch.losses.lpips import LPIPS, init_lpips_params
from vts_torch.losses.normal import surface_normal_angle_error
from vts_torch.metrics.evaluate_batch import compute_evaluation_metrics_batched
from vts_torch.metrics.inception import InceptionBlock0, init_inception_params
from vts_torch.metrics.psnr_ssim import psnr, ssim
from vts_torch.ops.normal import compute_normal
from vts_torch.ops.resize import resize_nearest
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

T = torch.from_numpy


@pytest.fixture(scope="module")
def lpips_pair():
    jp = jax_init_lpips(0)
    return jp, LPIPS(init_lpips_params(0))


def test_fallback_weights_are_bit_exact(lpips_pair):
    jp, _ = lpips_pair
    ours = init_lpips_params(0)
    for a, b in zip(jp["conv"], ours["conv"]):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])
        np.testing.assert_array_equal(np.asarray(a["b"]), b["b"])
    for a, b in zip(jp["lin"], ours["lin"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    ji, oi = jax_init_inception(0), init_inception_params(0)
    for name in ji:
        for f in ji[name]:
            np.testing.assert_array_equal(np.asarray(ji[name][f]), oi[name][f])


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", ["rgb256", "gray224"])
def test_lpips_matches_jax(lpips_pair, backend, case):
    """(e) a 3-channel 256² pair and 1-channel 224² patches: rtol 1e-4."""
    jp, net = lpips_pair
    rng = np.random.default_rng(7)
    shape = (1, 256, 256, 3) if case == "rgb256" else (2, 224, 224, 1)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    want = np.asarray(jax_lpips(jp, jnp.asarray(x), jnp.asarray(y), conv_backend=backend))
    got = net(T(x), T(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("normalize", [True, False])
def test_inception_block0_matches(normalize):
    """(f) block-0 features: rtol 1e-5 (atol for the ReLU zeros)."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 67, 59, 3)).astype(np.float32)
    want = np.asarray(jax_block0(jax_init_inception(0), jnp.asarray(x), normalize))
    got = InceptionBlock0(init_inception_params(0))(T(x), normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_psnr_ssim_match():
    """(f) rtol 1e-5."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (1, 64, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(psnr(T(a), T(b))),
                               float(jax_psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(float(ssim(T(a), T(b))),
                               float(jax_ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


def test_normal_and_angle_error_match():
    """(f) rtol 1e-5."""
    rng = np.random.default_rng(5)
    r = rng.uniform(-1, 1, (3, 32, 32, 2)).astype(np.float32)
    f = np.clip(r + rng.normal(0, 0.2, r.shape), 0, 1).astype(np.float32)
    rn, fn = compute_normal(T(r), 1.0), compute_normal(T(f), 1.0)
    jrn, jfn = jax_normal(jnp.asarray(r), 1.0), jax_normal(jnp.asarray(f), 1.0)
    np.testing.assert_allclose(rn.numpy(), np.asarray(jrn), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(surface_normal_angle_error(rn, fn).numpy(),
                               np.asarray(jax_ae(jrn, jfn)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("size", [(224, 224), (299, 299), (17, 50)])
def test_resize_nearest_exact(size):
    """(f) exact, index floor(dst·in/out) in fp32."""
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 2)).astype(np.float32)
    np.testing.assert_array_equal(resize_nearest(T(x), size).numpy(),
                                  np.asarray(jax_resize(jnp.asarray(x), size)))


def test_batched_eval_matches_jax(lpips_pair):
    """The 8-metric batched evaluation on one sample with a partly-valid
    patch set: rtol 1e-4, SIFIDs 1e-3 (host sqrtm)."""
    jp, net = lpips_pair
    rng = np.random.default_rng(8)
    h = 64
    real_I = rng.uniform(-1, 1, (1, h, h, 3)).astype(np.float32)
    fake_I = np.clip(real_I + rng.normal(0, 0.3, real_I.shape), -1, 1).astype(np.float32)
    fake_T = rng.uniform(-0.5, 1, (1, h, h, 2)).astype(np.float32)
    k = 4
    coords = np.zeros((1, k, 8), np.float32)
    coords[0, :, 0] = [0, 10, 30, 40]
    coords[0, :, 1] = [5, 20, 32, 50]          # the last window runs off the canvas
    coords[0, :, 4], coords[0, :, 5] = 32, 1.0
    real_T = rng.uniform(-1, 1, (1, k, 32, 32, 2)).astype(np.float32)
    valid = np.array([[1, 1, 0, 1]], bool)
    ji = jax_init_inception(0)
    want = jax_eval_batched(real_I, fake_I, fake_T, coords, real_T, valid,
                            lpips_params=jp, inception_params=ji)[0]
    got = compute_evaluation_metrics_batched(
        T(real_I), T(fake_I), T(fake_T), T(coords), T(real_T), T(valid),
        lpips_net=net, inception=InceptionBlock0(init_inception_params(0)))[0]
    assert got.keys() == want.keys() and len(got) == 8
    for key in want:
        rtol = 1e-3 if "SIFID" in key else 1e-4
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)


def _legacy_inputs(k):
    rng = np.random.default_rng(11)
    h = 64
    real_I = rng.uniform(-1, 1, (1, h, h, 3)).astype(np.float32)
    fake_I = np.clip(real_I + rng.normal(0, 0.3, real_I.shape), -1, 1).astype(np.float32)
    real_T = rng.uniform(-1, 1, (k, 32, 32, 2)).astype(np.float32)
    fake_T = np.clip(real_T + rng.normal(0, 0.4, real_T.shape), -1.2, 1.2).astype(np.float32)
    return real_I, fake_I, real_T, fake_T


def test_legacy_eval_matches_jax(lpips_pair):
    """``--eval_mode legacy``: the reference's per-metric loop on one sample's
    valid patches, T_FID included: rtol 1e-4, the Fréchet metrics (SIFIDs,
    T_FID) 1e-3 (host sqrtm)."""
    from vts_tpu.metrics.evaluate import DEFAULT_EVAL_METRICS as JAX_DEFAULT
    from vts_tpu.metrics.evaluate import compute_evaluation_metrics as jax_legacy
    from vts_torch.metrics.evaluate import DEFAULT_EVAL_METRICS, compute_evaluation_metrics
    jp, net = lpips_pair
    names = tuple(DEFAULT_EVAL_METRICS) + ("T_FID",)
    assert tuple(JAX_DEFAULT) == tuple(DEFAULT_EVAL_METRICS)
    real_I, fake_I, real_T, fake_T = _legacy_inputs(2)
    want = jax_legacy(jnp.asarray(real_I), jnp.asarray(fake_I), jnp.asarray(real_T),
                      jnp.asarray(fake_T), eval_metrics=names, lpips_params=jp,
                      inception_params=jax_init_inception(0), prefix="x_")
    got = compute_evaluation_metrics(T(real_I), T(fake_I), T(real_T), T(fake_T),
                                     eval_metrics=names, lpips_net=net,
                                     inception=InceptionBlock0(init_inception_params(0)),
                                     prefix="x_")
    assert list(got) == list(want) and len(got) == 9 and "metric_x_T_FID" in got
    for key in want:
        rtol = 1e-3 if "FID" in key else 1e-4
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)


def test_legacy_lpips_runs_in_chunks_of_16():
    """LPIPS pairs go 16 at a time, the last chunk short (the T_LPIPS K1
    shapes (≤ 16·2, 224², ·) on the card), the distances in order."""
    from vts_torch.metrics.evaluate import lpips_chunked
    seen = []

    def net(x, y):
        seen.append(x.shape[0])
        return (x - y).flatten(1).mean(1)
    x, y = torch.randn(37, 4, 4, 1), torch.randn(37, 4, 4, 1)
    got = lpips_chunked(net, x, y)
    assert seen == [16, 16, 5]
    torch.testing.assert_close(got, (x - y).flatten(1).mean(1), rtol=0, atol=0)


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_tactile_fid_matches_jax(reduction):
    """T_FID, both reductions, float64 on the host in both: rtol 1e-6."""
    from vts_tpu.metrics.tactile_fid import im2col_3x3 as jax_im2col
    from vts_tpu.metrics.tactile_fid import tactile_patch_fid as jax_fid
    from vts_torch.metrics.tactile_fid import im2col_3x3, tactile_patch_fid
    _, _, real_T, fake_T = _legacy_inputs(6)
    np.testing.assert_array_equal(im2col_3x3(real_T[0]), jax_im2col(real_T[0]))
    want = jax_fid(real_T, fake_T, reduction)
    got = tactile_patch_fid(real_T, fake_T, reduction)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
