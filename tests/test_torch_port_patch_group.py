"""The grouped patch gather of the port (K2, ``gather_patches_group``) on the
CPU, against the JAX package's gathers; and the summation order of the
scatter-add that K2's backward kernel is held to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vts_tpu.ops.patch import gather_patches as jax_gather
from vts_tpu.ops.patch import gather_patches_from_coords as jax_gather_coords
from vts_torch.ops import patch as k2
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

_CHANNELS = (1, 2, 3)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _images(rng, n, h=64, w=80):
    return [rng.normal(size=(n, h, w, c)).astype(np.float32) for c in _CHANNELS]


def _coords(rng, n, k, h=64, w=80):
    """(n, k, 8) packed coords, some windows out of bounds, crop offsets on
    .5 ties (round half to even)."""
    coords = np.zeros((n, k, 8), np.float32)
    coords[..., 0] = rng.integers(-10, w - 20, size=(n, k))
    coords[..., 1] = rng.integers(-10, h - 14, size=(n, k))
    coords[..., 4] = 32
    coords[..., 5] = 1.0
    coords[..., 6] = rng.choice([0.5, 1.5, 2.5, -0.5, 3.0], size=(n, k))
    coords[..., 7] = rng.choice([0.5, 1.0, 2.5, -1.5], size=(n, k))
    return coords


def _jax_per_image(fn, img, n):
    """A JAX gather of one image, vmapped over the batch and flattened
    sample-major; ``fn(image (1, H, W, C), i)``."""
    if n == 1:
        return np.asarray(fn(jnp.asarray(img), 0))
    return np.concatenate([np.asarray(fn(jnp.asarray(img[i:i + 1]), i)) for i in range(n)])


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("n", [1, 3])
def test_group_from_coords_matches_jax(mode, n):
    """Each source of a 1/2/3-channel group at (N, K, 8) coords with .5 ties
    equals vts_tpu's gather_patches_from_coords of that image: exact."""
    rng = np.random.default_rng(10 + n)
    imgs, coords = _images(rng, n), _coords(rng, n, 6)
    got = k2.gather_patches_group([_t(a) for a in imgs], coords=_t(coords), cutout=32,
                                  mode=mode)
    assert len(got) == len(imgs)
    for img, out in zip(imgs, got):
        want = _jax_per_image(lambda im, i: jax_gather_coords(
            im, jnp.asarray(coords[i]), 32, mode=mode), img, n)
        assert out.shape == (n * 6, 32, 32, img.shape[-1])
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("n", [1, 3])
def test_group_from_offsets_matches_jax(mode, n):
    """Each source of a group at (N, K) int offsets (overlapping and out of
    bounds) equals vts_tpu's gather_patches of that image: exact."""
    rng = np.random.default_rng(20 + n)
    imgs = _images(rng, n)
    ox = rng.integers(-12, 70, size=(n, 7)).astype(np.int32)
    oy = rng.integers(-12, 50, size=(n, 7)).astype(np.int32)
    ox[:, :2], oy[:, :2] = 20, 10
    got = k2.gather_patches_group([_t(a) for a in imgs], offset_x=_t(ox), offset_y=_t(oy),
                                  cutout=32, mode=mode)
    for img, out in zip(imgs, got):
        want = _jax_per_image(lambda im, i: jax_gather(
            im, jnp.asarray(ox[i]), jnp.asarray(oy[i]), 32, mode=mode), img, n)
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("mode", ["gather", "slice"])
def test_group_single_image_forms(mode):
    """A single image as (H, W, C) or (1, H, W, C), with (K, 8) or (1, K, 8)
    coords, gives what gather_patches_from_coords gave: the same patches."""
    rng = np.random.default_rng(3)
    img, coords = _images(rng, 1)[1], _coords(rng, 1, 5)
    want = np.asarray(jax_gather_coords(jnp.asarray(img), jnp.asarray(coords), 32, mode=mode))
    for im in (_t(img), _t(img[0])):
        for c in (_t(coords), _t(coords[0])):
            got = k2.gather_patches_from_coords(im, c, 32, mode=mode)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("n", [1, 2])
def test_group_grad_matches_jax_vjp(mode, n):
    """In a group where one source requires grad, that source's image
    gradient equals jax.vjp of vts_tpu's gather at the same coords (1e-6 of
    the max: the sums of overlapping windows run in another order); the
    other sources get none, and their outputs need no grad."""
    rng = np.random.default_rng(30 + n)
    imgs, coords = _images(rng, n), _coords(rng, n, 6)
    coords[:, :3, 0], coords[:, :3, 1] = 20.0, 10.0            # overlapping windows
    cot = rng.normal(size=(n * 6, 32, 32, 2)).astype(np.float32)
    src = [_t(a) for a in imgs]
    src[1].requires_grad_()
    outs = k2.gather_patches_group(src, coords=_t(coords), cutout=32, mode=mode)
    assert [o.requires_grad for o in outs] == [False, True, False]
    (got,) = torch.autograd.grad((outs[1] * _t(cot)).sum(), src[1])

    def fwd(im):
        if n == 1:
            return jax_gather_coords(im, jnp.asarray(coords), 32, mode=mode)
        return jax.vmap(lambda a, c: jax_gather_coords(a[None], c, 32, mode=mode))(
            im, jnp.asarray(coords)).reshape(n * 6, 32, 32, 2)

    _, vjp = jax.vjp(fwd, jnp.asarray(imgs[1]))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["gather", "slice"])
def test_group_at_padded_coords_matches_jax(mode):
    """A padded patch has all-zero coords, so its crop offset is 0/0 = NaN;
    XLA (and the kernels' decoding) convert that to the origin 0, and so does
    patch_offsets: the patches equal the JAX gather's, exact."""
    rng = np.random.default_rng(6)
    imgs, coords = _images(rng, 2), _coords(rng, 2, 5)
    coords[0, 3:] = 0.0
    coords[1, 0] = 0.0
    got = k2.gather_patches_group([_t(a) for a in imgs], coords=_t(coords), cutout=32,
                                  mode=mode)
    for img, out in zip(imgs, got):
        want = _jax_per_image(lambda im, i: jax_gather_coords(
            im, jnp.asarray(coords[i]), 32, mode=mode), img, 2)
        np.testing.assert_array_equal(out.numpy(), want)


def test_patch_offsets_convert_like_xla():
    """NaN → 0 and ±inf saturated, as jnp's astype(int32) gives them."""
    from vts_tpu.ops.patch import patch_offsets_jnp
    coords = np.zeros((4, 8), np.float32)
    coords[0, 5] = 1.0
    coords[2, 6], coords[3, 6] = 1.0, -1.0                  # c / 0 = ±inf
    got = k2.patch_offsets(_t(coords))
    want = patch_offsets_jnp(jnp.asarray(coords))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_group_cpu_launches_nothing():
    """On the CPU a group takes the plain version: no kernel launch counted,
    forward or backward."""
    rng = np.random.default_rng(4)
    imgs = [_t(a).requires_grad_() for a in _images(rng, 1)]
    before = (k2.gather_patches.launches, k2.scatter_patches.launches)
    outs = k2.gather_patches_group(imgs, coords=_t(_coords(rng, 1, 3)), cutout=32)
    sum(o.sum() for o in outs).backward()
    assert (k2.gather_patches.launches, k2.scatter_patches.launches) == before
    assert all(im.grad.shape == im.shape for im in imgs)


def test_group_raises_on_what_one_launch_cannot_take():
    """Images of another size or element size, more than 4 sources, windows
    that do not match the batch, or both kinds of window: each raises."""
    a = torch.zeros(2, 40, 40, 2)
    ox = torch.zeros(2, 3, dtype=torch.int32)
    coords = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        k2.gather_patches_group((a, torch.zeros(2, 40, 41, 1)), offset_x=ox, offset_y=ox,
                                cutout=8)
    with pytest.raises(TypeError):
        k2.gather_patches_group((a, torch.zeros(2, 40, 40, 1, dtype=torch.uint8)),
                                offset_x=ox, offset_y=ox, cutout=8)
    with pytest.raises(ValueError):
        k2.gather_patches_group((a,) * 5, offset_x=ox, offset_y=ox, cutout=8)
    with pytest.raises(ValueError):
        k2.gather_patches_group((a,), offset_x=ox[:1], offset_y=ox[:1], cutout=8)
    with pytest.raises(ValueError):
        k2.gather_patches_group((a,), coords=coords[:1], cutout=8)
    with pytest.raises(ValueError):
        k2.gather_patches_group((a,), offset_x=ox, offset_y=ox, coords=coords, cutout=8)


def _serial_scatter(g, ox, oy, shape, mode):
    """The scatter-add one addition at a time, in fp32, window k ascending,
    then row i, then column j: the order K2's backward kernel adds in."""
    n, h, w, c = shape
    k, cut = ox.shape[1], g.shape[1]
    out = np.zeros(shape, np.float32)
    g = g.reshape(n, k, cut, cut, c)
    for b in range(n):
        for kk in range(k):
            x0, y0 = int(ox[b, kk]), int(oy[b, kk])
            if mode == "slice":
                x0, y0 = min(max(x0, 0), w - cut), min(max(y0, 0), h - cut)
            for i in range(cut):
                yy = min(max(y0 + i, 0), h - 1)
                for j in range(cut):
                    xx = min(max(x0 + j, 0), w - 1)
                    out[b, yy, xx] = out[b, yy, xx] + g[b, kk, i, j]
    return out


@pytest.mark.parametrize("mode", ["gather", "slice"])
def test_scatter_plain_deterministic_is_the_serial_sum(mode):
    """Under torch.use_deterministic_algorithms(True), scatter_patches_plain
    on the CPU adds in the serial (k, i, j) order, bit for bit, also above
    PyTorch's parallel grain (here 2·17·32²·2 = 69,632 elements), where it
    otherwise adds with atomics in parallel.  This is the reference that K2
    backward's kernel is held to, bit-exactly, on the card."""
    rng = np.random.default_rng(5)
    ox = rng.integers(-20, 90, size=(2, 17)).astype(np.int32)
    oy = rng.integers(-20, 70, size=(2, 17)).astype(np.int32)
    ox[:, :6], oy[:, :6] = 30, 20
    g = (rng.normal(size=(34, 32, 32, 2))
         * np.exp(3 * rng.normal(size=(34, 32, 32, 2)))).astype(np.float32)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = k2.scatter_patches_plain(_t(g), _t(ox), _t(oy), (2, 70, 90, 2), mode).numpy()
    finally:
        torch.use_deterministic_algorithms(was)
    np.testing.assert_array_equal(got, _serial_scatter(g, ox, oy, (2, 70, 90, 2), mode))
