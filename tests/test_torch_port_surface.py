"""The rest of the sinskit training surface of the port against ``vts_tpu`` on
the CPU, module by module, then one training step that combines the new
settings:

  * every GAN mode's loss, as a scalar or a per-sample vector, on a
    multiscale and a single-scale prediction: rtol 1e-6;
  * WGAN-GP's ``gradient_penalty`` on a small D with the interpolation
    weights replayed from JAX's key: the penalty rtol 1e-5, its gradient in
    D's parameters (the double backward) per leaf within 1e-4 of the leaf's
    max |g| (the biases a norm follows, whose exact gradient is zero, within
    1e-5 of the network's max);
  * each D (basic, n_layers, pixel, patch, multiscale) under each norm
    (batch, instance, none): the logits within 1e-5 of their max (+1e-6),
    the input gradient within 1e-4 of its max, the running stats rtol 1e-5;
  * each DiffAugment letter, and the whole ``bscton`` policy, with JAX's
    draws replayed: atol 1e-6;
  * ``PlateauTracker`` on a metric sequence: the same lr scales;
  * the ``csg`` encoding within 2^-22 (see ``vts_torch/networks/
    positional.py``) and the G input width it implies;
  * each ``--init_type``: the moments the reference's initializer has (the
    std within 5% of its formula, the bounds, the orthogonality);
  * a ``--normG batch`` G: the training forward (outputs, updated running
    stats, parameter gradients) and the eval forward on running stats;
  * ``--no_dropout false`` builds no dropout and gives the reference's
    outputs (its dropout layers never run);
  * ``--preprocess zoom_and_crop``: the training batch bit for bit;
  * ``--netD2 patch`` with D2 trained: the reference's step fails to trace
    and the port refuses the model; with ``--lambda_G2_GAN 0`` both build;
  * one 256² training step with ``--gan_mode wgangp --normD instance
    --diffaugment bscton`` against ``_train_step``, under the limits of
    ``tests/test_torch_port_train.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import _grad_tol
from tests.torch_port_step import K, env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)
from tests.torch_port_step import flat, jax_aug_draws, jax_batch, np_tree, run_step
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

GAN_MODES = ["lsgan", "vanilla", "wgan", "wgangp", "nonsaturating", "hinge"]
ZERO_GRAD = re.compile(r"(Conv4x4_[123]|conv1)\W.*bias")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("mode", GAN_MODES)
@pytest.mark.parametrize("real", [True, False])
def test_gan_losses_match_jax(mode, real):
    from vts_torch.losses.gan import gan_loss
    from vts_torch.losses.gan_masked import per_sample_gan_loss
    from vts_tpu.losses.gan import gan_loss as jax_gan_loss
    from vts_tpu.losses.gan_masked import per_sample_gan_loss as jax_per_sample
    rng = np.random.default_rng(len(mode) + real)
    multi = [[rng.normal(size=(3, s, s, 1)).astype(np.float32) * 2] for s in (9, 6, 4)]
    single = rng.normal(size=(5, 7, 7, 1)).astype(np.float32)
    for pred in (multi, single):
        jpred = jax.tree_util.tree_map(jnp.asarray, pred)
        tpred = [[_t(p) for p in s] for s in pred] if isinstance(pred, list) else _t(pred)
        for jf, tf in ((jax_gan_loss, gan_loss), (jax_per_sample, per_sample_gan_loss)):
            want = np.asarray(jf(jpred, real, mode, 0.8))
            got = tf(tpred, real, mode, 0.8).numpy()
            assert got.shape == want.shape, (mode, got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _jax_d(net, norm, in_c, x, key=0):
    """A JAX D of the port's factory names, initialized on x."""
    from vts_tpu.networks import define_D as jax_define_D
    opt = _Opt(norm)
    jd = jax_define_D(opt, in_c, netD=net, n_layers=3, num_D=2)
    return jd, jax.tree_util.tree_map(np.asarray, jd.init(jax.random.key(key), jnp.asarray(x)))


class _Opt:
    def __init__(self, norm):
        self.ndf, self.normD, self.init_type, self.init_gain = 4, norm, "xavier", 0.5
        self.n_layers_D, self.gan_mode = 3, "nonsaturating"


def _port_d(net, norm, in_c, variables):
    from vts_torch.networks import define_D
    from vts_torch.utils.convert_jax import d_params_to_torch, d_stats_to_torch
    td = define_D(_Opt(norm), in_c, netD=net, n_layers=3, num_D=2)
    sd = dict(d_params_to_torch(variables["params"]))
    sd.update(d_stats_to_torch(variables.get("batch_stats", {})))
    td.load_state_dict(sd)
    return td.train()


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in _leaves(o)]
    return [out]


@pytest.mark.parametrize("norm", ["batch", "instance", "none"])
@pytest.mark.parametrize("net", ["basic", "n_layers", "pixel", "patch", "multiscale"])
def test_discriminator_variants_match_jax(net, norm):
    in_c = 5
    x = np.random.default_rng(len(net) + len(norm)).normal(size=(3, 32, 32, in_c)).astype(
        np.float32)
    jd, v = _jax_d(net, norm, in_c, x)
    assert ("batch_stats" in v) == (norm == "batch")

    def jax_fn(a):
        if "batch_stats" in v:
            out, mut = jd.apply(v, a, mutable=["batch_stats"])
        else:
            out, mut = jd.apply(v, a), {}
        return sum(jnp.sum(t) for t in jax.tree_util.tree_leaves(out)), (out, mut)
    (_, (jout, jmut)), jg = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(x))
    td = _port_d(net, norm, in_c, v)
    xt = _t(x).requires_grad_(True)
    tout = td(xt)
    (tg,) = torch.autograd.grad(sum(t.sum() for t in _leaves(tout)), xt)
    for a, b in zip(jax.tree_util.tree_leaves(jout), _leaves(tout)):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0,
                                   atol=1e-5 * np.abs(a).max() + 1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())
    if norm == "batch":
        from vts_torch.utils.convert_jax import d_stats_to_torch
        for k, t in d_stats_to_torch(np_tree(jmut["batch_stats"])).items():
            np.testing.assert_allclose(td.state_dict()[k].numpy(), t.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("net,norm", [("multiscale", "batch"), ("n_layers", "instance")])
def test_gradient_penalty_matches_jax(net, norm):
    from vts_torch.losses.gan import gradient_penalty
    from vts_tpu.losses.gan import gradient_penalty as jax_gradient_penalty
    in_c = 4
    rng = np.random.default_rng(7)
    real = rng.normal(size=(3, 32, 32, in_c)).astype(np.float32)
    fake = rng.normal(size=(3, 32, 32, in_c)).astype(np.float32)
    jd, v = _jax_d(net, norm, in_c, real, key=3)
    key = jax.random.key(9)

    def jax_gp(params):
        def d_fn(z):
            if "batch_stats" in v:
                return jd.apply({"params": params, "batch_stats": v["batch_stats"]}, z,
                                mutable=["batch_stats"])[0]
            return jd.apply({"params": params}, z)
        return jax_gradient_penalty(d_fn, jnp.asarray(real), jnp.asarray(fake), key)
    want, jgrads = jax.value_and_grad(jax_gp)(v["params"])
    alpha = _t(np.asarray(jax.random.uniform(key, (3, 1, 1, 1))).reshape(3))
    td = _port_d(net, norm, in_c, v)
    stats = {k: t.clone() for k, t in td.state_dict().items() if k.endswith(("mean", "var"))}
    params = dict(td.named_parameters())
    gp = gradient_penalty(lambda z: td(z, update_stats=False), _t(real), _t(fake), alpha=alpha)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(
        params, torch.autograd.grad(gp, list(params.values()), allow_unused=True))}
    np.testing.assert_allclose(float(gp.detach()), float(want), rtol=1e-5)
    for k, t in stats.items():          # the penalty's pass keeps the running stats
        assert torch.equal(td.state_dict()[k], t), k
    from vts_torch.utils.convert_jax import torch_to_d_params
    a, b = flat(jgrads), flat(torch_to_d_params(grads)[0])
    assert a.keys() == b.keys()
    net_max = max(np.abs(g).max() for g in a.values())
    for k in a:
        tol = 1e-5 * net_max if ZERO_GRAD.search(k) and norm != "none" \
            else 1e-4 * np.abs(a[k]).max() + 1e-7 * net_max
        assert np.abs(a[k] - b[k]).max() <= tol, (k, np.abs(a[k] - b[k]).max(), tol)


@pytest.mark.parametrize("policy", ["b", "s", "c", "t", "o", "n", "bscton",
                                    "bb", "ss", "cc", "tt", "oo", "nn", "btbt", "bscbsc"])
def test_diffaug_letters_match_jax_given_the_same_draws(policy):
    """Each letter, alone, all six, and repeated: a repeated letter takes the
    draws of its own position (the reference splits one key per position).
    Tolerance 1e-6 absolute on [-1, 1] inputs."""
    from vts_torch.ops import diffaug
    from vts_tpu.ops.diffaug import diff_augment as jax_diff_augment
    x = np.random.default_rng(len(policy)).uniform(-1, 1, size=(3, 24, 20, 3)).astype(np.float32)
    key = jax.random.key(13)
    want = np.asarray(jax_diff_augment(key, jnp.asarray(x), policy))
    got = diffaug.diff_augment(_t(x), policy, draws=jax_aug_draws(key, policy, x.shape)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the port's own draws have the shapes and ranges the letters take
    drawn = diffaug.draw(policy, x.shape, torch.Generator().manual_seed(0))
    assert diffaug.diff_augment(_t(x), policy, draws=drawn).shape == x.shape


def test_plateau_tracker_matches_jax():
    from vts_torch.models.base import PlateauTracker, lr_factor
    from vts_tpu.models.base import PlateauTracker as JaxPlateauTracker
    seq = [5.0, 4.0, 3.99, 3.98, 4.1, 3.97, 3.96, 3.95, 3.95, 2.0, 2.5, 2.4, 2.3, 2.2,
           2.1, 2.05, 2.02, 2.01, 2.0, 1.99, 1.985]
    a, b = PlateauTracker(), JaxPlateauTracker()
    scales = [(a.update(m), b.update(m)) for m in seq]
    assert [s for s, _ in scales] == [s for _, s in scales]
    assert scales[-1][0] < 1.0 and lr_factor("plateau", 7, None) == 1.0


@pytest.mark.parametrize("h,w", [(256, 256), (7, 13), (1, 5), (96, 160)])
def test_csg_encoding_matches_jax(h, w):
    from vts_torch.networks.positional import positional_encoding
    from vts_tpu.networks.positional import positional_encoding as jax_pe
    got = positional_encoding(h, w, "csg", batch=2).numpy()
    want = np.asarray(jax_pe(h, w, "csg", batch=2))
    assert got.shape == want.shape == (2, h, w, 2)
    assert np.abs(got - want).max() <= 2.0 ** -22


def test_csg_sets_the_g_input_width(tmp_path):
    from vts_torch.config import TestOptions
    from vts_torch.models import create_model
    from vts_tpu.config import TestOptions as JaxTestOptions
    from vts_tpu.models import create_model as jax_create_model
    argv = ["--positional_encoding_mode", "csg", "--checkpoints_dir", str(tmp_path)]
    port = create_model(TestOptions().parse(argv + ["--device", "cpu"], quiet=True))
    ref = jax_create_model(JaxTestOptions().parse(argv, quiet=True))
    assert port.input_nc == ref.input_nc == 3
    assert port.netG.down["down0"].conv.weight.shape[1] == 3


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "xavier_uniform",
                                       "orthogonal", "none"])
def test_init_types_have_the_reference_moments(init_type):
    """On a (4, 4, 96, 64) conv kernel (fan_in 1536, fan_out 1024) and its
    transposed-conv twin: the reference's distribution, by its moments."""
    from vts_torch.networks.blocks import Conv4x4, ConvT4x4, make_initializer
    from vts_tpu.networks.blocks import make_initializer as jax_make_initializer
    gain = 0.5
    fi, fo = 96 * 16, 64 * 16
    ref = np.asarray(jax_make_initializer(init_type, gain)(jax.random.key(0), (4, 4, 96, 64)))
    init = make_initializer(init_type, gain)
    for mod, out_axis in ((Conv4x4(96, 64), 0), (ConvT4x4(96, 64), 1)):
        mod.reset_parameters(init, torch.Generator().manual_seed(1))
        w = mod.weight.detach().double()
        np.testing.assert_allclose(float(w.std()), float(ref.std()), rtol=0.05)
        assert abs(float(w.mean())) <= 0.05 * float(ref.std())
        if init_type == "xavier_uniform":
            assert float(w.abs().max()) <= np.sqrt(6.0 / (fi + fo))
        if init_type == "none":
            assert float(w.abs().max()) <= 2.0 * np.sqrt(1.0 / fi) / .87962566103423978 + 1e-7
        if init_type == "orthogonal":
            m = w.movedim(out_axis, -1).reshape(-1, 64)       # (receptive·in, out)
            np.testing.assert_allclose((m.T @ m).numpy(), gain ** 2 * np.eye(64), atol=1e-6)
        assert mod.bias is None or float(mod.bias.abs().max()) == 0.0


def test_normG_batch_forward_matches_jax():
    """Training forward (batch statistics, running ones updated) with its
    parameter gradient, then the eval forward on the running statistics."""
    from vts_torch.networks.unet_custom import CustomUNet
    from vts_torch.utils.convert_jax import (torch_to_unet_params, unet_params_to_torch,
                                             unet_stats_to_torch)
    from vts_tpu.networks.unet_custom import CustomUNet as JaxCustomUNet
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 256, 256, 9)).astype(np.float32)
    r = rng.normal(size=(2, 256, 256, 5)).astype(np.float32)
    jnet = JaxCustomUNet(ngf=4, norm_type="batch", train=True, init_gain=0.5)
    v = np_tree(jnet.init(jax.random.key(0), jnp.asarray(x)))
    assert v["batch_stats"] and "bias" not in v["params"]["down1"]["Conv4x4_0"]["Conv_0"]

    def loss(params):
        out, mut = jnet.apply({"params": params, "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mut["batch_stats"])
    (_, (jout, jstats)), jg = jax.value_and_grad(loss, has_aux=True)(v["params"])
    net = CustomUNet(9, ngf=4, norm_type="batch")
    sd = dict(unet_params_to_torch(v["params"]))
    sd.update(unet_stats_to_torch(v["batch_stats"]))
    net.load_state_dict(sd)
    net.train()
    params = dict(net.named_parameters())
    out = torch.cat(net(_t(x)), dim=-1)
    grads = dict(zip(params, torch.autograd.grad((out * _t(r)).sum(), list(params.values()))))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-4)
    for k, t in unet_stats_to_torch(np_tree(jstats)).items():
        np.testing.assert_allclose(net.state_dict()[k].numpy(), t.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    a, b = flat(jg), flat(torch_to_unet_params(grads))
    assert a.keys() == b.keys()
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 1e-4 * np.abs(a[k]).max() + 1e-6, k
    jeval = JaxCustomUNet(ngf=4, norm_type="batch", train=False, init_gain=0.5)
    want = np.asarray(jeval.apply({"params": v["params"], "batch_stats": jstats}, jnp.asarray(x)))
    net.eval()
    with torch.no_grad():
        np.testing.assert_allclose(torch.cat(net(_t(x)), dim=-1).numpy(), want, rtol=0,
                                   atol=1e-4)


def test_dropout_flag_builds_no_dropout_and_matches_jax(tmp_path):
    from vts_torch.config import TrainOptions
    from vts_torch.networks.unet_custom import CustomUNet
    from vts_torch.utils.convert_jax import unet_params_to_torch
    from vts_tpu.networks.unet_custom import CustomUNet as JaxCustomUNet
    x = np.random.default_rng(3).uniform(-1, 1, (1, 256, 256, 9)).astype(np.float32)
    jnet = JaxCustomUNet(ngf=4, use_dropout=True, train=True, init_gain=0.5)
    v = np_tree(jnet.init(jax.random.key(1), jnp.asarray(x)))
    want = np.asarray(jnet.apply(v, jnp.asarray(x)))
    net = CustomUNet(9, ngf=4, use_dropout=True)
    assert not any(isinstance(m, torch.nn.Dropout) for m in net.modules())
    net.load_state_dict(unet_params_to_torch(v["params"]))
    with torch.no_grad():
        np.testing.assert_allclose(torch.cat(net(_t(x)), dim=-1).numpy(), want, rtol=0,
                                   atol=1e-4)
    opt = TrainOptions().parse(["--no_dropout", "false", "--device", "cpu",
                                "--checkpoints_dir", str(tmp_path)], quiet=True)
    assert opt.no_dropout is False


def test_zoom_train_batch_matches_jax(env):  # noqa: F811
    from tests.torch_port_step import argv as _argv
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    # a garment of its own: the reference caches a dataset's samples on disk
    # under a key that does not hold --preprocess
    zoom = ["--preprocess", "zoom_and_crop", "--name", "zoom", "--dataroot",
            "synthetic://portzoom?size=320&center_w=192&center_h=128&patches=6&val_patches=3"]
    _, want = jax_batch(env, 1, extra=zoom)
    opt = TrainOptions().parse(_argv(env, extra=zoom) + ["--device", "cpu"], quiet=True)
    ds = create_dataset(opt)
    ds.set_epoch(0)
    got = next(iter(ds))
    assert set(got) == set(want)
    params = dict(zip(("H", "W", "crop_pos_x", "crop_pos_y", "crop_size_h", "crop_size_w",
                       "patch_crop_size", "resize_ratio", "resize_ratio_h", "resize_ratio_w",
                       "scale_factor_h", "scale_factor_w"), want["augmentation_params"][0]))
    assert params["scale_factor_h"] < 1.0 and params["resize_ratio"] > 1.0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("lam", ["1", "0"])
def test_netD2_patch_fails_in_the_reference_and_is_refused(env, lam):  # noqa: F811
    """The patch D2 gives one loss per 16² tile, which the reference's D2 step
    multiplies by the (K,) validity mask: the broadcast fails whenever D2 is
    trained, and the port refuses the model there."""
    import functools
    from tests.torch_port_step import port_model
    from vts_tpu.models import create_model as jax_create_model
    extra = ["--netD2", "patch", "--lambda_G2_GAN", lam]
    jopt, batch = jax_batch(env, 1, extra=extra)
    jmodel = jax_create_model(jopt)
    jmodel.setup(batch)
    jmodel.set_input(batch)
    s = jmodel.states
    args = (s["G"], s["D"], s["D2"], jmodel._input, jmodel.rng, jnp.float32(jopt.lr),
            jnp.float32(jopt.lr_G2), jnp.int32(1), {"lpips": jmodel.lpips_params})
    trace = functools.partial(jax.jit(functools.partial(jmodel._train_step, use_d3=False)).trace,
                              *args)
    if lam == "0":
        trace()
        assert "D2" not in port_model(env, 1, extra=extra).model_names
        return
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        trace()
    with pytest.raises(ValueError, match="--netD2 patch"):
        port_model(env, 1, extra=extra)


SURFACE = ["--gan_mode", "wgangp", "--normD", "instance", "--diffaugment", "bscton"]


@pytest.fixture(scope="module")
def surface_step(env):  # noqa: F811
    return run_step(env, 1, extra=SURFACE,
                    draw_kw=dict(policy="bscton", shape=(1, 256, 256, 3), gp_k=K))


def test_surface_step_losses(surface_step):
    _, want, model = surface_step
    got = model.get_current_losses()
    assert set(got) == set(want) and want["D_I_grad_penalty"] > 0 and want["D_T_grad_penalty"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_surface_step_grads_and_params(surface_step, net):
    """Adam μ = the gradient (β1 = 0), per leaf within ``_grad_tol``; the
    updated params as in ``test_torch_port_train.py``; no D has batch
    statistics."""
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_unet_params
    jmodel, _, model = surface_step
    st = jmodel.states[net]
    to_flax = (lambda sd: torch_to_unet_params(sd)) if net == "G" \
        else (lambda sd: torch_to_d_params(sd)[0])
    a = flat(st.opt_state.mu)
    b = flat(to_flax(dict(model.adam[net].mu)))
    assert a.keys() == b.keys() and not flat(st.stats)
    net_max = max(np.abs(v).max() for v in a.values())
    for k in a:
        tol = _grad_tol(k, a[k], net_max)
        assert np.abs(a[k] - b[k]).max() <= tol, (net, k, np.abs(a[k] - b[k]).max(), tol)
    lr = 1e-3 if net in ("G", "D") else 5e-4
    p_want = flat(st.params)
    p_got = flat(to_flax(getattr(model, f"net{net}").state_dict()))
    for k in p_want:
        tiny = np.abs(a[k]) <= _grad_tol(k, a[k], net_max)
        bound = np.where(tiny, 2 * lr + 1e-6, 1e-6 + 1e-5 * np.abs(p_want[k]))
        assert (np.abs(p_want[k] - p_got[k]) <= bound).all(), (net, k)
