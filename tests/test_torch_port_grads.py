"""Port parity of the training path's modules against the JAX package, on the
CPU: the backward of K1 (dx) and K2 (scatter-add), the LPIPS input gradient
with ``y_no_grad`` (pinning the reshape + max pool tie split), the
discriminators with their batch statistics, DiffAugment "bs" (the other
letters: ``test_torch_port_surface.py``), the mask
sampler and Adam.  Inputs are made from numpy seeds; each test states its
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vts_tpu.losses.lpips import init_lpips_params as jax_init_lpips
from vts_tpu.losses.lpips import lpips as jax_lpips
from vts_tpu.networks.discriminators import MultiscaleDiscriminator as JaxMSD
from vts_tpu.ops.diffaug import diff_augment as jax_diff_augment
from vts_tpu.ops.pallas_conv import conv3x3_relu
from vts_tpu.ops.patch import dilate_mask as jax_dilate
from vts_tpu.ops.patch import gather_patches as jax_gather
from vts_tpu.ops.patch import sample_offsets_in_mask as jax_sample
from vts_torch.losses.lpips import LPIPS, init_lpips_params
from vts_torch.models.base import Adam
from vts_torch.networks.discriminators import MultiscaleDiscriminator
from vts_torch.ops import conv3x3 as k1
from vts_torch.ops import diffaug
from vts_torch.ops import patch as k2
from vts_torch.utils.convert_jax import d_params_to_torch, d_stats_to_torch
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("cin,cout,dtype", [(64, 128, "float32"), (128, 128, "float32"),
                                             (64, 64, "float32"), (64, 128, "bfloat16"),
                                             (128, 64, "bfloat16")],
                         ids=["64-128", "128-128", "64-64", "64-128-bf16", "128-64-bf16"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_dx_plain_matches_pallas_vjp(cin, cout, dtype, relu):
    """K1 dx: the plain version and the CPU autograd path vs the VJP of the
    Pallas kernel (interpret) at the tests/test_pallas.py shapes; 1e-5 of the
    max |dx|.  dw/db of the autograd path vs the reference's einsums too.
    In bf16 (x, w and gy bf16, b fp32; dx only): the plain dx on the Pallas
    output vs the VJP's, both exact products summed in fp32 in different
    orders and rounded once to bf16, 2^-7·|ref| + 1e-5; the CPU autograd
    path returns the plain dx bit for bit."""
    rng = np.random.default_rng(cin * 7 + cout + relu)
    x = rng.normal(size=(2, 16, 24, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    gy = rng.normal(size=(2, 16, 24, cout)).astype(np.float32)
    if dtype == "bfloat16":
        xj, wj, gyj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, gy))
        y, vjp = jax.vjp(lambda a: conv3x3_relu(a, wj, jnp.asarray(b), relu=relu, th=8,
                                                interpret=True), xj)
        (dx,) = vjp(gyj)
        dx = np.asarray(dx).astype(np.float32)
        bf = torch.bfloat16
        gyt, wt = _t(gy).to(bf), _t(w).to(bf)
        yt = _t(np.asarray(y).astype(np.float32)).to(bf)
        plain = k1.conv3x3_dx_plain(gyt, yt, wt, relu=relu)
        assert plain.dtype == bf
        assert np.all(np.abs(plain.float().numpy() - dx) <= 2 ** -7 * np.abs(dx) + 1e-5)
        xt = _t(x).to(bf).requires_grad_()
        out = k1.conv3x3_bias_relu(xt, wt, _t(b), relu=relu)
        (gx,) = torch.autograd.grad(out, xt, gyt)
        assert torch.equal(gx, k1.conv3x3_dx_plain(gyt, out.detach(), wt, relu=relu))
        return
    y, vjp = jax.vjp(lambda a, c, d: conv3x3_relu(a, c, d, relu=relu, th=8, interpret=True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = (np.asarray(t) for t in vjp(jnp.asarray(gy)))
    plain = k1.conv3x3_dx_plain(_t(gy), _t(np.asarray(y)), _t(w), relu=relu).numpy()
    np.testing.assert_allclose(plain, dx, rtol=0, atol=1e-5 * np.abs(dx).max())
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, w, b))
    out = k1.conv3x3_bias_relu(xt, wt, bt, relu=relu)
    gx, gw, gb = torch.autograd.grad(out, (xt, wt, bt), _t(gy))
    np.testing.assert_allclose(gx.numpy(), dx, rtol=0, atol=1e-5 * np.abs(dx).max())
    np.testing.assert_allclose(gw.numpy(), dw, rtol=0, atol=1e-5 * np.abs(dw).max())
    np.testing.assert_allclose(gb.numpy(), db, rtol=0, atol=1e-5 * np.abs(db).max())


def test_conv3x3_backward_counts_dx_only_for_cuda():
    """On the CPU the backward takes the plain dx (no launch is counted)."""
    x = torch.randn(1, 8, 8, 4, requires_grad=True)
    before = k1.conv3x3_dx.launches
    k1.conv3x3_bias_relu(x, torch.randn(3, 3, 4, 6), torch.randn(6)).sum().backward()
    assert k1.conv3x3_dx.launches == before and x.grad.shape == x.shape


_OX = np.array([[0, 10, 10, 96, -7, 120, 50]], np.int32)   # overlapping and OOB windows
_OY = np.array([[5, 0, 0, 90, 110, -3, 60]], np.int32)


@pytest.mark.parametrize("mode", ["gather", "slice"])
def test_scatter_plain_matches_jax_gather_vjp(mode):
    """K2 backward: the plain scatter-add and the CPU autograd of
    gather_patches vs jax.vjp of vts_tpu.ops.patch.gather_patches; 1e-6
    of the max (sums of up to 4 overlapping windows, in another order)."""
    rng = np.random.default_rng(1)
    img = rng.normal(size=(128, 128, 3)).astype(np.float32)
    g = rng.normal(size=(7, 32, 32, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda im: jax_gather(im, jnp.asarray(_OX[0]), jnp.asarray(_OY[0]), 32,
                                           mode=mode), jnp.asarray(img))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = k2.scatter_patches_plain(_t(g), _t(_OX), _t(_OY), (1, 128, 128, 3), mode)[0].numpy()
    tol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    im = _t(img).requires_grad_()
    (k2.gather_patches(im, _t(_OX[0]), _t(_OY[0]), 32, mode=mode) * _t(g)).sum().backward()
    np.testing.assert_allclose(im.grad.numpy(), want, rtol=0, atol=tol)


def test_scatter_batched_matches_per_image():
    """The (N, K) form is the per-image scatter stacked, sample-major."""
    rng = np.random.default_rng(2)
    ox = np.concatenate([_OX, _OX[:, ::-1]])
    oy = np.concatenate([_OY, _OY[:, ::-1]])
    g = _t(rng.normal(size=(14, 32, 32, 2)).astype(np.float32))
    both = k2.scatter_patches_plain(g, _t(ox), _t(oy), (2, 128, 128, 2))
    for i in range(2):
        one = k2.scatter_patches_plain(g[7 * i:7 * i + 7], _t(ox[i:i + 1]), _t(oy[i:i + 1]),
                                       (1, 128, 128, 2))
        torch.testing.assert_close(both[i:i + 1], one, rtol=0, atol=0)


def _masked_canvas(rng, n, h, c):
    x = rng.uniform(-1, 1, size=(n, h, h, c)).astype(np.float32)
    y = rng.uniform(-1, 1, size=(n, h, h, c)).astype(np.float32)
    m = np.zeros((n, h, h, 1), np.float32)
    m[:, h // 4:3 * h // 4, h // 8:5 * h // 8] = 1.0        # large zero regions outside
    return x * m, y * m


@pytest.mark.parametrize("shape", [(1, 64, 3), (6, 32, 1)], ids=["canvas64", "patches32"])
def test_lpips_x_grad_matches_jax(shape):
    """d LPIPS / dx with y_no_grad against jax.grad of lpips(..., y_no_grad=True)
    on masked inputs, where 2×2 pool windows tie: 1e-4 of the max |g|; the
    distances within rtol 1e-5."""
    n, h, c = shape
    x, y = _masked_canvas(np.random.default_rng(h), n, h, c)
    params = jax_init_lpips(0)
    want_d = np.asarray(jax_lpips(params, jnp.asarray(x), jnp.asarray(y), y_no_grad=True))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jax_lpips(
        params, a, jnp.asarray(y), y_no_grad=True)))(jnp.asarray(x)))
    net = LPIPS(init_lpips_params(0))
    xt = _t(x).requires_grad_()
    d = net(xt, _t(y), y_no_grad=True)
    (g,) = torch.autograd.grad(d.sum(), xt)
    np.testing.assert_allclose(d.detach().numpy(), want_d, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-4 * np.abs(want_g).max())
    # the joint 2N pass gives the same values
    np.testing.assert_allclose(net(_t(x), _t(y)).numpy(), want_d, rtol=1e-5)


@pytest.mark.parametrize("in_c,h,n", [(4, 64, 1), (7, 32, 6)], ids=["D1", "D2"])
def test_discriminator_logits_and_batch_stats_match_jax(in_c, h, n):
    """Two threaded passes (stats fake → real) vs MultiscaleDiscriminator.apply
    with mutable batch_stats: logits 1e-5·max + 1e-6, updated running stats
    rtol 1e-5 atol 1e-6; a pass with update_stats=False leaves them as they
    were."""
    rng = np.random.default_rng(in_c)
    xa = rng.normal(size=(n, h, h, in_c)).astype(np.float32)
    xb = rng.normal(size=(n, h, h, in_c)).astype(np.float32)
    xa[:, :h // 3] = 0.0
    jd = JaxMSD(ndf=4, n_layers=3, num_D=3, init_gain=0.5)
    v = jd.init(jax.random.key(in_c), jnp.asarray(xa))
    oa, m = jd.apply(v, jnp.asarray(xa), mutable=["batch_stats"])
    ob, m = jd.apply({"params": v["params"], "batch_stats": m["batch_stats"]},
                     jnp.asarray(xb), mutable=["batch_stats"])
    td = MultiscaleDiscriminator(in_c, ndf=4, n_layers=3, num_D=3)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)     # noqa: E731
    sd = dict(d_params_to_torch(np_tree(v["params"])))
    sd.update(d_stats_to_torch(np_tree(v["batch_stats"])))
    td.load_state_dict(sd)
    td.train()
    with torch.no_grad():
        ta, tb = td(_t(xa)), td(_t(xb))
        stats = {k: t.clone() for k, t in td.state_dict().items() if k.endswith(("mean", "var"))}
        td(_t(xa), update_stats=False)
    for jo, to in ((oa, ta), (ob, tb)):
        for js, ts in zip(jo, to):
            want = np.asarray(js[-1])
            np.testing.assert_allclose(ts[-1].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max() + 1e-6)
    want_stats = d_stats_to_torch(np_tree(m["batch_stats"]))
    for k, t in want_stats.items():
        np.testing.assert_allclose(stats[k].numpy(), t.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        torch.testing.assert_close(td.state_dict()[k], stats[k], rtol=0, atol=0)


def test_diffaug_bs_matches_jax_given_the_same_draws():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(3, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jax_diff_augment(key, jnp.asarray(x), "bs"))
    kb, ks = jax.random.split(key, 2)
    draws = [_t(np.asarray(jax.random.uniform(kb, (3, 1, 1, 1))).reshape(3)),
             _t(np.asarray(jax.random.uniform(ks, (3, 1, 1, 1))).reshape(3))]
    got = diffaug.diff_augment(_t(x), "bs", draws=draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):              # a letter DiffAugment does not have
        diffaug.diff_augment(_t(x), "bsx")


def test_sample_offsets_in_mask_matches_jax_given_the_same_uniforms():
    """The dilated-mask CDF sampler: identical offsets from identical
    uniforms (exact: 0/1 weights keep every cumulative sum an integer)."""
    rng = np.random.default_rng(6)
    m = (rng.uniform(size=(96, 80)) > 0.97).astype(np.float32)
    m[40:70, 20:50] = 1.0
    np.testing.assert_array_equal(k2.dilate_mask(_t(m), 17).numpy(),
                                  np.asarray(jax_dilate(jnp.asarray(m), 17)))
    key = jax.random.key(4)
    want_x, want_y = (np.asarray(t) for t in jax_sample(key, jnp.asarray(m), 9, 32))
    k_row, k_col = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(k_row, (9,))),
                  np.asarray(jax.random.uniform(k_col, (9,)))])
    got_x, got_y = k2.sample_offsets_in_mask(_t(m), 9, 32, uniforms=_t(u))
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    gx, gy = k2.sample_offsets_in_mask(_t(m), 50, 32, generator=torch.Generator().manual_seed(0))
    assert (gx <= 80 - 32).all() and (gy <= 96 - 32).all()


@pytest.mark.parametrize("mode", ["nonsaturating", "vanilla", "lsgan"])
def test_gan_losses_match_jax(mode):
    """gan_loss, per_sample_gan_loss (on a multiscale prediction and on one
    logit map), the masked reductions and feature matching against
    vts_tpu.losses: rtol 1e-6, atol 1e-7."""
    from vts_tpu.losses import gan as jgan
    from vts_tpu.losses import gan_masked as jgm
    from vts_torch.losses import gan, gan_masked
    rng = np.random.default_rng(8)
    sizes = ((9, 9), (6, 6), (4, 4))
    fake = [[rng.normal(size=(5, h, w, c)).astype(np.float32) for c in (3, 1)]
            for h, w in sizes]
    real = [[rng.normal(size=(5, h, w, c)).astype(np.float32) for c in (3, 1)]
            for h, w in sizes]
    valid = np.array([1, 0, 1, 1, 0], np.float32)
    jt = lambda tree: [[jnp.asarray(a) for a in s] for s in tree]     # noqa: E731
    tt = lambda tree: [[_t(a) for a in s] for s in tree]              # noqa: E731
    close = lambda got, want: np.testing.assert_allclose(             # noqa: E731
        np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    for is_real, lbl in ((True, 0.8), (False, 0.8), (True, 1.0)):
        for pred in (fake, fake[0][-1]):
            jp = jt(pred) if isinstance(pred, list) else jnp.asarray(pred)
            tp = tt(pred) if isinstance(pred, list) else _t(pred)
            close(gan.gan_loss(tp, is_real, mode, lbl), jgan.gan_loss(jp, is_real, mode, lbl))
            vec = gan_masked.per_sample_gan_loss(tp, is_real, mode, lbl)
            jvec = jgm.per_sample_gan_loss(jp, is_real, mode, lbl)
            close(vec, jvec)
            close(gan_masked.masked_mean(vec, _t(valid)), jgm.masked_mean(jvec, valid))
            close(gan_masked.masked_patch_sum(vec, _t(valid)), jgm.masked_patch_sum(jvec, valid))
    close(gan.feature_matching_loss(tt(fake), tt(real), 3, 3),
          jgan.feature_matching_loss(jt(fake), jt(real), 3, 3))


def test_adam_matches_optax_scale_by_adam():
    """Three steps of the port's Adam vs optax.scale_by_adam(0, 0.99, 1e-8)
    with the lr applied outside: rtol 1e-6."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    tx = optax.scale_by_adam(b1=0.0, b2=0.99, eps=1e-8)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = {"w": _t(p0)}
    adam = Adam(tp.items(), 0.0, 0.99)
    for i in range(3):
        g = rng.normal(size=(5, 4)).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, -jnp.float32(1e-3) * upd)
        adam.step(tp, {"w": _t(g)}, 1e-3)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(adam.nu["w"].numpy(), np.asarray(st.nu), rtol=1e-6)
    assert adam.count == int(st.count) == 3
