"""Tactile super-resolution (``--T_resolution_multiplier`` 2 and 4) of the port
against ``vts_tpu`` on the CPU, at 256² with ngf/ndf 4:

  * ``resize_bicubic`` against ``jax.image.resize(..., "cubic")``, up and
    down, odd sizes: within 1e-6 of the output's largest magnitude (the
    weight matrices are equal; XLA's CPU dot rounds its sums differently,
    up to ~1e-6 from the exact product, where the port's matmuls stay
    within 2e-7);
  * ``CustomUNet`` at ×2 and ×4 from converted weights: both heads within
    1e-4 of JAX's (``up0_T_extra{j}`` carried both ways bit for bit), and a
    multiplier that is not a power of two refused by both;
  * the ×2 training batch of a ``synthetic://…&mult=2`` garment, bit for
    bit;
  * one ×2 training step against ``_train_step`` (touch canvas 512², 64²
    patches), from the same weights, batch and draws, under the limits of
    ``tests/test_torch_port_train.py`` (losses rtol 1e-4; D and D2
    gradients per leaf by ``_grad_tol``; params and stats as there), with 5
    patch-gather groups a step (3 at ×1).  G's gradient: per leaf 4e-4 of
    the leaf's max |g| (4× ``_grad_tol``; the worst leaf reads 1.8× here,
    3.0× at most on the card against the CPU), and 1e-4 over the whole
    network in the 2-norm (3.7e-5 here).  The touch LPIPS now runs VGG's max pools and ReLUs on
    64² patches, where fp32 rounding decides near-ties and near-zero
    pre-activations differently in any two fp32 implementations: each such
    flip moves a whole unit of gradient to another pixel.  Against a float64
    evaluation of the same math (``test_touch_lpips_grad_at_64_is_fp32_
    accurate``) the JAX and port fp32 gradients each stray by up to ~2e-3 of
    the max, on different inputs; at 32² by ~1e-6.  The extra stages'
    biases, which an instance norm follows, are among the round-off leaves;
  * the ×2 eval metrics and visuals of that stepped model against JAX's
    (metrics rtol 1e-4, SIFID 1e-3; visuals as ``test_torch_port_visuals``);
  * checkpoints of ×2 and ×4 G, a batch-norm G and instance/none-norm Ds
    crossing both ways through ``convert_jax``, bit for bit.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_lanes import _port_tree
from tests.test_torch_port_train import CANCELLING, _grad_tol
from tests.test_torch_port_visuals import _assert_visuals_match
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import argv as _argv
from tests.torch_port_step import flat, jax_batch, port_model, run_step

X2 = ["--dataroot", "synthetic://portx2?size=320&center_w=192&center_h=128&patches=6"
      "&val_patches=3&mult=2", "--T_resolution_multiplier", "2"]
# the zero-gradient biases of test_torch_port_train, and the extra tactile
# up stages', which an instance norm follows too
ZERO_GRAD = re.compile(r"(down[1-6]|up[1-7](_T)?|up0_T_extra\d|Conv4x4_[123])\W.*bias")


@pytest.mark.parametrize("shape,size", [((2, 32, 32, 3), (64, 64)), ((1, 17, 23, 2), (9, 40)),
                                        ((3, 64, 64, 1), (32, 32)), ((1, 5, 7, 4), (13, 3)),
                                        ((4, 32, 32, 4), (128, 128)), ((9, 31, 2), (62, 17))])
def test_resize_bicubic_matches_jax(shape, size):
    """NHWC and HWC, up and down, edges included (taps outside the input
    dropped and renormalised, as jax does)."""
    from vts_torch.ops.resize import resize_bicubic
    from vts_tpu.ops.resize import resize_bicubic as jax_resize_bicubic
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_resize_bicubic(jnp.asarray(x), size))
    got = resize_bicubic(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def _unet_pair(t_mult, **kw):
    from vts_tpu.networks.unet_custom import CustomUNet as JaxCustomUNet
    jnet = JaxCustomUNet(ngf=4, num_downs=8, num_layer_separate=4, train=False, init_gain=0.5,
                         t_mult=t_mult, **kw)
    x = np.random.default_rng(t_mult).uniform(-1, 1, (1, 256, 256, 9)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.key(t_mult),
                                                             jnp.asarray(x)))
    return jnet, variables, x


@pytest.mark.parametrize("t_mult", [2, 4])
def test_custom_unet_tmult_matches_jax(t_mult):
    from vts_torch.networks.unet_custom import CustomUNet
    from vts_torch.utils.convert_jax import torch_to_unet_params, unet_params_to_torch
    jnet, variables, x = _unet_pair(t_mult)
    params = variables["params"]
    assert {f"up0_T_extra{j}" for j in range(t_mult.bit_length() - 1)} <= set(params)
    net = CustomUNet(9, ngf=4, t_mult=t_mult)
    net.load_state_dict(unet_params_to_torch(params))
    a, b = flat(params), flat(torch_to_unet_params(net.state_dict()))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    want = jnet.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(want) == 2
    for w_, g_, hw in zip(want, got, (256, 256 * t_mult)):
        w_, g_ = np.asarray(w_), g_.numpy()
        assert g_.shape == w_.shape and g_.shape[1:3] == (hw, hw)
        np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-4 * max(1.0, np.abs(w_).max()))


def test_tmult_not_a_power_of_two_is_refused():
    from vts_torch.config import TrainOptions
    from vts_torch.networks.unet_custom import CustomUNet
    from vts_tpu.networks.unet_custom import CustomUNet as JaxCustomUNet
    with pytest.raises(ValueError):
        JaxCustomUNet(ngf=4, t_mult=3).init(jax.random.key(0), jnp.zeros((1, 256, 256, 9)))
    with pytest.raises(ValueError):
        CustomUNet(9, ngf=4, t_mult=3)
    with pytest.raises(ValueError, match="--T_resolution_multiplier"):
        TrainOptions().parse(["--T_resolution_multiplier", "3", "--device", "cpu",
                              "--checkpoints_dir", "/nonexistent/never"], quiet=True)


def test_synthetic_x2_train_batch_matches_jax(env):  # noqa: F811
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    _, want = jax_batch(env, 1, extra=X2)
    opt = TrainOptions().parse(_argv(env, extra=X2) + ["--device", "cpu"], quiet=True)
    loader = create_dataset(opt)
    loader.set_epoch(0)
    got = next(iter(loader))
    assert set(got) == set(want) and want["T_images"].shape[-3:-1] == (64, 64)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["T_valid"].sum() > 0 and want["val_T_valid"].sum() > 0


@pytest.fixture(scope="module")
def step_x2(env):  # noqa: F811
    """One ×2 JAX step and one port step from the same weights, batch and draws."""
    jmodel, losses, model = run_step(env, 1, extra=X2)
    return jmodel, losses, model


def test_x2_step_losses(step_x2):
    jmodel, want, model = step_x2
    got = model.get_current_losses()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_x2_step_grads_params_and_stats(step_x2, net):
    """Adam μ = the gradient (β1 = 0) per leaf within ``_grad_tol`` (the
    round-off leaves being exactly :data:`ZERO_GRAD`'s); params and running
    stats as in ``test_torch_port_train.py``."""
    jmodel, _, model = step_x2
    st = jmodel.states[net]
    got = _port_tree(model)[net]
    a, b = flat(st.opt_state.mu), got["mu"]
    assert a.keys() == b.keys()
    net_max = max(np.abs(v).max() for v in a.values())
    at_roundoff = {k for k, v in a.items() if np.abs(v).max() <= 1e-5 * net_max}
    assert at_roundoff == {k for k in a if ZERO_GRAD.search(k)}, sorted(at_roundoff)
    if net == "G":
        assert {k for k in a if "up0_T_extra0" in k and "bias" in k} <= at_roundoff
    assert len([k for k in a if CANCELLING.search(k)]) == (0 if net == "G" else 3)
    scale = 4.0 if net == "G" else 1.0      # see the module docstring

    def tol_of(k):
        return 1e-5 * net_max if ZERO_GRAD.search(k) else scale * _grad_tol(k, a[k], net_max)
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= tol_of(k), (net, k, np.abs(a[k] - b[k]).max(),
                                                        tol_of(k))
    if net == "G":
        num = sum(float(((a[k] - b[k]).astype(np.float64) ** 2).sum()) for k in a)
        den = sum(float((a[k].astype(np.float64) ** 2).sum()) for k in a)
        assert np.sqrt(num / den) <= 1e-4, np.sqrt(num / den)
    lr = 1e-3 if net in ("G", "D") else 5e-4
    p_want = flat(st.params)
    assert p_want.keys() == got["params"].keys()
    for k in p_want:
        bound = np.where(np.abs(a[k]) <= tol_of(k), 2 * lr + 1e-6,
                         1e-6 + 1e-5 * np.abs(p_want[k]))
        assert (np.abs(p_want[k] - got["params"][k]) <= bound).all(), (net, k)
    s_want = flat(st.stats)
    assert s_want.keys() == got["stats"].keys()
    for k in s_want:
        np.testing.assert_allclose(got["stats"][k], s_want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_x2_step_gathers_in_five_groups(step_x2, monkeypatch):
    """The tactile stacks are cut at 64² from the touch canvas and their
    conditioning at 32² from the canvas: 5 gather groups a step (one K2
    launch each on the card), the 64² ones at the 512² touch canvas."""
    from vts_torch.ops import patch as k2
    model = copy.deepcopy(step_x2[2])
    seen, real = [], k2._gather_group

    def counted(images, win, cutout, mode):
        seen.append((tuple(images[0].shape[-3:-1]), cutout, len(images)))
        return real(images, win, cutout, mode)
    monkeypatch.setattr(k2, "_gather_group", counted)
    model.optimize_parameters(1)
    assert sorted(seen) == sorted([((512, 512), 64, 1), ((256, 256), 32, 3),
                                   ((512, 512), 64, 1), ((256, 256), 32, 2),
                                   ((512, 512), 64, 1)]), seen


def _lpips_fp64(x, y):
    """The LPIPS distance's sum in float64 (the port's math, ``F.conv2d`` for
    every conv), and its gradient in x."""
    from vts_torch.losses.lpips import (_TAPS, _VGG16_PLAN, LPIPS, _max_pool_2x2, _normalize,
                                        conv_nhwc, init_lpips_params)
    net = LPIPS(init_lpips_params(0)).double()

    def taps(h):
        w0, b0 = net._scale_folded_conv1(h.shape[-1])
        out = []
        for i, (_, pool) in enumerate(_VGG16_PLAN):
            w, b = (w0, b0) if i == 0 else (getattr(net, f"conv{i}_weight"),
                                            getattr(net, f"conv{i}_bias"))
            h = torch.relu(conv_nhwc(h, w, b))
            if i in _TAPS:
                out.append(h)
            if pool and i != len(_VGG16_PLAN) - 1:
                h = _max_pool_2x2(h)
        return out
    xt = torch.from_numpy(x).double().requires_grad_(True)
    with torch.no_grad():
        ty = taps(torch.from_numpy(y).double())
    total = sum(torch.mean(torch.sum((_normalize(a) - _normalize(b)) ** 2
                                     * getattr(net, f"lin{i}"), -1), dim=(1, 2))
                for i, (a, b) in enumerate(zip(taps(xt), ty))).sum()
    return float(total.detach()), torch.autograd.grad(total, xt)[0].numpy()


@pytest.mark.parametrize("hw", [32, 64])
def test_touch_lpips_grad_at_64_is_fp32_accurate(hw):
    """The touch LPIPS on 1-channel patches, as G2 runs it (x with a
    gradient, y without), the port's and JAX's, each against float64: the
    distances within rtol 1e-5; the gradients at 32² within 1e-5 of the
    max, at 64² within 1e-2 of the max and 2e-3 in the 2-norm (fp32
    max-pool near-ties and ReLU near-zeros flip there, see the module
    docstring; measured up to 4.5e-3 and 6.8e-4 for the port, 3.1e-3 and
    3.4e-4 for JAX, over four seeds)."""
    from vts_torch.losses.lpips import LPIPS, init_lpips_params
    from vts_tpu.losses.lpips import init_lpips_params as jax_init
    from vts_tpu.losses.lpips import lpips as jax_lpips
    rng = np.random.default_rng(hw)
    x = np.tanh(rng.normal(size=(8, hw, hw, 1))).astype(np.float32)
    y = np.tanh(rng.normal(size=(8, hw, hw, 1))).astype(np.float32)
    y[:, :, hw // 2:] = 0.0                          # masked, as the touch patches are
    want_d, want_g = _lpips_fp64(x, y)
    xt = torch.from_numpy(x).requires_grad_(True)
    d = LPIPS(init_lpips_params(0))(xt, torch.from_numpy(y), y_no_grad=True)
    (g,) = torch.autograd.grad(d.sum(), xt)

    def jax_sum(a):
        return jnp.sum(jax_lpips(jax_init(0), a, jnp.asarray(y), y_no_grad=True))
    jd, jg = jax.value_and_grad(jax_sum)(jnp.asarray(x))
    for what, dist, grad in (("port", float(d.sum()), g.numpy()),
                             ("jax", float(jd), np.asarray(jg))):
        assert abs(dist - want_d) <= 1e-5 * abs(want_d), what
        err = np.abs(grad - want_g)
        assert err.max() <= (1e-5 if hw == 32 else 1e-2) * np.abs(want_g).max(), (what, err.max())
        assert np.linalg.norm(err) <= (1e-5 if hw == 32 else 2e-3) * np.linalg.norm(want_g), what


def test_x2_eval_metrics_and_visuals_match_jax(step_x2):
    """The visuals after the step; then, with JAX's updated weights and stats
    in the port (the two updates differ where a gradient is at round-off:
    Adam moves such an element by ±lr either way), ``test()``, the 16
    metrics and the visuals again."""
    from tests.torch_port_step import load_jax_states
    jmodel, _, stepped = step_x2
    want_vis, got_vis = jmodel.get_current_visuals(), stepped.get_current_visuals()
    assert want_vis["fake_gx"].shape[1:3] == (512, 512)
    _assert_visuals_match(want_vis, got_vis)
    model = copy.deepcopy(stepped)
    load_jax_states(model, jmodel.states)
    jmodel.test()
    model.test()
    assert model._outputs["fake_T"].shape[1:3] == (512, 512)
    want, got = jmodel.compute_metrics(), model.compute_metrics()
    assert set(got) == set(want) and len(want) == 16
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3 if "SIFID" in k else 1e-4,
                                   err_msg=k)
    _assert_visuals_match(jmodel.get_current_visuals(), model.get_current_visuals())


CKPT_CASES = {"g_x2": ["--T_resolution_multiplier", "2"],
              "g_x4": ["--T_resolution_multiplier", "4"],
              "g_batchnorm": ["--normG", "batch"],
              "d_instance": ["--normD", "instance"],
              "d_none": ["--normD", "none", "--netD2", "pixel"]}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_checkpoints_cross_both_ways(env, case):  # noqa: F811
    """G, D, D2 with their stats and Adam state: written by vts_tpu, read by
    the port, written again by the port, read by vts_tpu, equal bit for bit."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.models.base import load_net as jax_load_net
    extra = CKPT_CASES[case] + ["--name", f"ck_{case}"]
    jopt = JaxTrainOptions().parse(_argv(env, extra=extra), quiet=True)
    jmodel = jax_create_model(jopt)
    jmodel.setup({"S": np.zeros((1, 256, 256, 1), np.float32)})
    key = jax.random.key(5)
    for name, st in jmodel.states.items():
        noise = lambda t: jax.random.normal(key, t.shape, t.dtype)   # noqa: E731
        jmodel.states[name] = st.replace(
            params=jax.tree_util.tree_map(lambda t: t + noise(t), st.params),
            stats=jax.tree_util.tree_map(lambda t: t + noise(t) ** 2, st.stats),
            opt_state=st.opt_state._replace(
                count=jnp.int32(3), mu=jax.tree_util.tree_map(noise, st.opt_state.mu),
                nu=jax.tree_util.tree_map(lambda t: noise(t) ** 2, st.opt_state.nu)))
    if case == "g_batchnorm":
        assert jmodel.states["G"].stats
    jmodel.save_networks("x")
    model = port_model(env, 1, extra=extra)
    model.load_networks("x")
    model.opt.name = f"ck_{case}_port"
    model.save_networks("y")
    ckpt = str(env / "ckpt" / f"ck_{case}_port")
    for name, st in jmodel.states.items():
        back = jax_load_net(ckpt, "y", name, st)
        for part in ("params", "stats"):
            a, b = flat(getattr(st, part)), flat(getattr(back, part))
            assert a.keys() == b.keys(), (name, part)
            assert all(np.array_equal(a[k], b[k]) for k in a), (name, part)
        for part in ("mu", "nu"):
            a, b = flat(getattr(st.opt_state, part)), flat(getattr(back.opt_state, part))
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
