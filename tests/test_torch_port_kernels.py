"""Port parity for the two kernel modules: the plain versions of K1 (3×3 conv
+ bias + ReLU) and K2 (patch gather) against the JAX package, on the CPU.

The plain versions are what the port's wrappers run for CPU tensors, and
what the CUDA kernels are held against on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vts_tpu.ops.pallas_conv import conv3x3_relu
from vts_tpu.ops.pallas_gather import gather_patches_pallas
from vts_tpu.ops.patch import gather_patches as jax_gather
from vts_tpu.ops.patch import gather_patches_from_coords as jax_gather_coords
from vts_torch.ops import conv3x3 as k1
from vts_torch.ops import patch as k2
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)


def _lax_conv(x, w, b, relu):
    y = jax.lax.conv_general_dilated(x, w, (1, 1), [(1, 1), (1, 1)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = y + b
    return jnp.maximum(y, 0.0) if relu else y


@pytest.mark.parametrize("cin,cout,dtype", [(64, 128, "float32"), (128, 128, "float32"),
                                             (64, 64, "float32"), (64, 128, "bfloat16"),
                                             (128, 128, "bfloat16")],
                         ids=["64-128", "128-128", "64-64", "64-128-bf16", "128-128-bf16"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_plain_matches_pallas_and_lax(cin, cout, dtype, relu):
    """(a) K1's plain version vs the Pallas kernel (interpret) and lax.conv at
    the tests/test_pallas.py shapes plus 64→64; 1e-5.  In bf16 (x and w
    bf16, b fp32) vs the Pallas kernel only: both sum exact products in fp32,
    in different orders, and round once to bf16, so they differ by at most
    one bf16 rounding of each, 2^-7·|ref| + 1e-5."""
    rng = np.random.default_rng(cin + cout + relu)
    x = rng.normal(size=(2, 16, 24, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    if dtype == "bfloat16":
        xt, wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
        got = k1.conv3x3_bias_relu_plain(xt, wt, torch.from_numpy(b), relu=relu)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        pallas = np.asarray(conv3x3_relu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                         jnp.asarray(b), relu=relu, th=8, interpret=True)
                            ).astype(np.float32)
        assert np.all(np.abs(got - pallas) <= 2 ** -7 * np.abs(pallas) + 1e-5)
        return
    got = k1.conv3x3_bias_relu_plain(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), relu=relu).numpy()
    pallas = np.asarray(conv3x3_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     relu=relu, th=8, interpret=True))
    lax = np.asarray(_lax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, lax, rtol=1e-5, atol=1e-5)


def test_conv3x3_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes to the plain version (no launch); odd sizes are fine."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 7, 5, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 6)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))
    before = k1.conv3x3_bias_relu.launches
    got = k1.conv3x3_bias_relu(x, w, b)
    assert k1.conv3x3_bias_relu.launches == before
    torch.testing.assert_close(got, k1.conv3x3_bias_relu_plain(x, w, b), rtol=0, atol=0)
    with pytest.raises(ValueError):
        k1.conv3x3_bias_relu(x, w[:, :, :2], b)


_IMG = np.random.default_rng(0).normal(size=(128, 128, 5)).astype(np.float32)
_OX = np.array([0, 10, 60, 96, -7, 120], np.int32)      # last two: out of bounds
_OY = np.array([5, 0, 20, 90, 110, -3], np.int32)


@pytest.mark.parametrize("mode", ["gather", "slice"])
def test_gather_plain_matches_jax_gather(mode):
    """(b) K2's plain version vs gather_patches, in-bounds and OOB windows: exact."""
    got = k2.gather_patches_plain(torch.from_numpy(_IMG), torch.from_numpy(_OX),
                                  torch.from_numpy(_OY), 32, mode=mode).numpy()
    want = np.asarray(jax_gather(jnp.asarray(_IMG), jnp.asarray(_OX), jnp.asarray(_OY),
                                 32, mode=mode))
    np.testing.assert_array_equal(got, want)


def test_gather_plain_matches_pallas_slice():
    """(b) slice mode vs the Pallas kernel (interpret), with OOB clamps: exact."""
    got = k2.gather_patches_plain(torch.from_numpy(_IMG), torch.from_numpy(_OX),
                                  torch.from_numpy(_OY), 32, mode="slice").numpy()
    want = np.asarray(gather_patches_pallas(jnp.asarray(_IMG), jnp.asarray(_OX),
                                            jnp.asarray(_OY), 32, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 3])
def test_gather_from_coords_batched_matches_jax(n):
    """(b) the (N, K, 8) coord form, including rounding and OOB windows: exact."""
    rng = np.random.default_rng(n)
    img = rng.normal(size=(n, 64, 80, 2)).astype(np.float32)
    k = 5
    coords = np.zeros((n, k, 8), np.float32)
    coords[..., 0] = rng.integers(-10, 60, size=(n, k))
    coords[..., 1] = rng.integers(-10, 50, size=(n, k))
    coords[..., 4] = 32
    coords[..., 5] = 1.0
    coords[..., 6] = rng.choice([0.5, 1.5, 2.5, 3.0], size=(n, k))   # half-even rounding
    coords[..., 7] = rng.choice([0.5, 1.0, 2.5], size=(n, k))
    got = k2.gather_patches_from_coords(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    if n == 1:
        want = np.asarray(jax_gather_coords(jnp.asarray(img), jnp.asarray(coords), 32))
    else:
        want = np.asarray(jax.vmap(lambda im, c: jax_gather_coords(im[None], c, 32))(
            jnp.asarray(img), jnp.asarray(coords))).reshape(n * k, 32, 32, 2)
    np.testing.assert_array_equal(got, want)


def test_patch_offsets_round_half_even():
    coords = torch.tensor([[10, 20, 64, 64, 32, 1.0, 0.5, 1.5],
                           [10, 20, 64, 64, 32, 1.0, 2.5, 3.5]])
    ox, oy, cut = k2.patch_offsets(coords)
    assert ox.tolist() == [10, 12] and oy.tolist() == [22, 24] and cut.tolist() == [32, 32]
