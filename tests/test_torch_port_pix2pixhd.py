"""The pix2pixHD slice of the port — the global, local and encoder
generators, the VGG19 loss, the image pool, two multiscale Ds with
intermediate features and the two-stage schedule — against ``vts_tpu`` on
the CPU, at ngf/ndf 4 with 2 downsamplings and 2 blocks:

  * VGG19: ``init_vgg19_params(0)`` holds the reference's arrays bit for bit;
    ``vgg_loss`` at (4, 32, 32, 3), value within rtol 1e-5 and x-gradient
    within 1e-4 of its max, and the step's touch form (fake_I, gx and gy
    each tiled to 3 channels, one pass) against the reference's three
    calls; ``--vgg_weights`` from a torchvision-keyed state dict and from a
    pickled module, identical arrays, and into the model;
  * ``GlobalGenerator``, ``LocalEnhancer`` (one enhancer) and ``Encoder``
    on the port's seeded weights carried by ``convert_jax`` into a tree of
    the reference module's paths and shapes (its ``jax.eval_shape``d init)
    and back bit for bit: the output within 1e-5 of its max from JAX's fp32
    forward, instance norm (the batch-norm local G too, in eval mode, which
    pins the names of the norms across levels); ``instance_average``
    within 1e-6;
  * ``pool_query`` with JAX's draws injected, in its insert and its swap /
    pass phases: the buffer, the count and the batch exactly; the host
    ``ImagePool`` against the reference's, exactly;
  * one training step (shared, module scope) with ``--no_vgg_loss
    --correct_gan_feat true --pool_size 2`` at batch 4 on random patches as
    ``tests/test_baselines.py`` draws them, the pool's draws JAX's, both
    models on the port's seeded weights (JAX's states built from them, as
    its ``setup`` builds them from its own init, which would compile the
    initializers op by op): the
    losses within rtol 1e-4, the gradients (Adam's first moment over 1 −
    β1) per leaf within ``_grad_tol`` (every bias of a conv that an instance
    norm follows has an exactly zero gradient: held to 1e-5 of the
    network's max), the params after Adam as ``test_torch_port_pix2pix.py``
    holds them, the pool's buffer within 1e-5 of its max and its count;
  * the same step under ``--dtype bfloat16`` in both packages, from the same
    weights, batch and draws, held by the bf16 lane's rules with the fp32
    JAX step as the reference (``tests/torch_port_step.py``): per loss
    |port16 − jax16| ≤ 2·|jax16 − jax32| + 1e-3·|jax32|, per network
    ‖port16 − jax16‖/‖jax32‖ ≤ 2·‖jax16 − jax32‖/‖jax32‖ + 1e-3 over
    Adam's first moment (no VGG, so no near-tie rule);
  * port-only: the reference's GAN-feat term is exactly 0 and leaves the
    step equal to a ``--no_ganFeat_loss`` step; the step's G_VGG equals
    λ_vgg times the ported ``vgg_loss`` of its outputs; the same step with
    the VGG loss on against JAX's (``slow``, as the reference's own);
  * ``update_fixed_params`` on a local G against JAX: frozen from the
    first step, the global leaves hold their values while Adam's count
    advances, the rest agree; at ``niter_fix_global`` the printed line and
    every leaf trains; port-only, frozen after an unmasked step (the
    training driver's order), the global leaves move on their Adam moments;
  * the msgpack checkpoints both ways, the test forward within 1e-5;
  * the reference's ``.pth`` global, local and encoder generators through
    both packages' converters and the CLI: identical arrays;
  * ``--pool_size`` > 0 a ValueError for the other models, the x2 refusal,
    CUDA asked for by default, the reference's visuals fault;
  * the port's drivers alone: one epoch of 2 steps of ``vts_torch.train
    --model pix2pixHD`` (no validation), then ``vts_torch.test`` on its
    latest G over the 256² canvas: 8 finite metrics.
"""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_pix2pix import _adam_spread, _copy, _patch_batch, _port_model
from tests.test_torch_port_train import ZERO_GRAD, _grad_tol
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)
from tests.torch_port_step import assert_bf16_losses, assert_bf16_tree, flat
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

DATA = "synthetic://p2phd?size=320&center_w=192&center_h=128&patches=6&val_patches=3"
SMALL_G = ["--n_downsample_global", "2", "--n_blocks_global", "2"]
STEP_ARGS = ["--no_vgg_loss", "--correct_gan_feat", "true", "--pool_size", "2"]


def _argv(tmp, *extra, phase="train"):
    return ["--model", "pix2pixHD", "--name", "p2phd", "--dataroot", DATA,
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res"),
            "--batch_size", "4", "--ngf", "4", "--ndf", "4", "--crop_size", "256",
            "--center_w", "192", "--center_h", "128", "--data_len", "2", *SMALL_G,
            *(["--n_epochs", "1", "--n_epochs_decay", "0"] if phase == "train" else []), *extra]


def _to_flax(net):
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_resnet_params
    return torch_to_resnet_params if net == "G" else torch_to_d_params


def _jax_setup(jm, model):
    """The reference model's ``setup`` on the port model's seeded weights (its
    own ``init`` would compile the networks' initializers op by op): each
    network's state from the port's state dict, fresh Adam states, the
    jitted step and eval forward."""
    from vts_tpu.models.base import NetState
    txs = {"G": jm.tx_g, "D": jm.tx_d, "D2": jm.tx_d2}
    for name in model.model_names:
        params, stats = _to_flax(name)(getattr(model, f"net{name}").state_dict())
        params = jax.tree_util.tree_map(jnp.asarray, params)
        jm.states[name] = NetState(params=params, stats=jax.tree_util.tree_map(jnp.asarray, stats),
                                   opt_state=txs[name].init(params))
    jm._jit_step = jax.jit(jm._train_step, donate_argnums=(0, 1, 2))
    jm._jit_forward = jax.jit(jm._forward_eval)


def flat_shapes(tree):
    """``flat`` for a tree of ``jax.ShapeDtypeStruct`` (``jax.eval_shape``)."""
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _g_zero(name, head="['Conv_0']['bias']"):
    """A bias of an instance-norm pix2pixHD G whose gradient is exactly zero:
    every one but the head's (a norm follows each of those convs)."""
    return name.endswith("['bias']") and name != head


def _tol(name, g, net_max, head="['Conv_0']['bias']"):
    """``_grad_tol``, with :func:`_g_zero`'s leaves held to 1e-5 of the
    network's max |g| (D's are among ``_grad_tol``'s own)."""
    if head is not None and _g_zero(name, head):
        return 1e-5 * net_max
    return _grad_tol(name, g, net_max)


def _query_draws(key, n, pool_size):
    """The draws of the reference's ``pool_query(..., key)``: per image
    ``k`` of ``split(key, n)``, ``k1, k2 = split(k)``, ``uniform(k1)`` and
    ``randint(k2, (), 0, P)``."""
    keys = jax.random.split(key, n)
    u, rid = [], []
    for k in keys:
        k1, k2 = jax.random.split(k)
        u.append(float(jax.random.uniform(k1)))
        rid.append(int(jax.random.randint(k2, (), 0, pool_size)))
    return {"pool_u": torch.tensor(u), "pool_rid": torch.tensor(rid)}


def _pool_draws(step_key, n, pool_size):
    """The pool draws of a reference step: its key for the pool is the second
    of ``split(step_key)``."""
    return _query_draws(jax.random.split(step_key)[1], n, pool_size)


# ------------------------------------------------------------------ VGG19 ---

@pytest.fixture(scope="module")
def vgg_jax():
    """The reference's VGG19 params and its jitted value-and-x-gradient."""
    from vts_tpu.losses.vgg import init_vgg19_params, vgg_loss
    params = init_vgg19_params(0)
    fn = jax.jit(jax.value_and_grad(lambda p, x, y: vgg_loss(p, x, y), argnums=1))
    return params, fn


def test_vgg19_init_matches_jax(vgg_jax):
    from vts_torch.losses.vgg import init_vgg19_params
    got = init_vgg19_params(0)["conv"]
    want = vgg_jax[0]["conv"]
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert np.array_equal(g["w"].numpy().transpose(2, 3, 1, 0), np.asarray(w["w"]))
        assert np.array_equal(g["b"].numpy(), np.asarray(w["b"]))


def _vgg_inputs(seed=0, c=3):
    r = np.random.default_rng(seed)
    return [r.uniform(-1, 1, (4, 32, 32, c)).astype(np.float32) for _ in range(2)]


def test_vgg_loss_matches_jax(vgg_jax):
    """Value within rtol 1e-5, x-gradient within 1e-4 of its max; the y branch
    takes no gradient and the weights none."""
    from vts_torch.losses.vgg import VGG19, init_vgg19_params, vgg_loss
    params, fn = vgg_jax
    x, y = _vgg_inputs()
    want, want_g = fn(params, jnp.asarray(x), jnp.asarray(y))
    vgg = VGG19(init_vgg19_params(0))
    assert not any(b.requires_grad for b in vgg.buffers()) and not list(vgg.parameters())
    xt, yt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    loss = vgg_loss(vgg, xt, yt)
    g, g_y = torch.autograd.grad(loss, (xt, yt), allow_unused=True)
    g = g.numpy()
    assert g_y is None and len(vgg.taps(xt)) == 5
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    assert np.abs(g - want_g).max() <= _grad_tol("x", want_g, np.abs(want_g).max())


def test_vgg_touch_form_matches_jax(vgg_jax):
    """The step's term: fake_I, gx and gy tiled to 3 channels, one VGG pass
    (``Pix2PixHDModel.vgg_term``) against the reference's three calls; the
    gradients w.r.t. fake_I and the 2-channel fake_T."""
    from vts_torch.losses.vgg import VGG19, init_vgg19_params
    from vts_torch.models.pix2pixhd import Pix2PixHDModel
    params, fn = vgg_jax
    fake_I, I = _vgg_inputs(1)
    fake_T, real_T = _vgg_inputs(2, c=2)
    tile = lambda t, c: np.repeat(t[..., c:c + 1], 3, -1)  # noqa: E731
    want, grads = 0.0, []
    for x, y in ((fake_I, I), (tile(fake_T, 0), tile(real_T, 0)),
                 (tile(fake_T, 1), tile(real_T, 1))):
        v, g = fn(params, jnp.asarray(x), jnp.asarray(y))
        want, grads = want + float(v), grads + [np.asarray(g)]
    want_gT = np.stack([grads[1].sum(-1), grads[2].sum(-1)], -1)
    model = types.SimpleNamespace(vgg=VGG19(init_vgg19_params(0)))
    fi, ft = (torch.from_numpy(a).requires_grad_(True) for a in (fake_I, fake_T))
    loss = Pix2PixHDModel.vgg_term(model, fi, ft, torch.from_numpy(I), torch.from_numpy(real_T))
    g_I, g_T = (g.numpy() for g in torch.autograd.grad(loss, (fi, ft)))
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    for got, ref in ((g_I, grads[0]), (g_T, want_gT)):
        assert np.abs(got - ref).max() <= _grad_tol("x", ref, np.abs(ref).max())


def _torchvision_vgg19(seed=3):
    """A torchvision-layout ``vgg19``: ``features.{i}`` convs, ReLU and pools
    between, small random weights."""
    from vts_torch.losses.vgg import _TV_INDEX, _VGG19_PLAN
    g = torch.Generator().manual_seed(seed)
    layers, in_c = [], 3
    for idx, (out_c, _) in zip(_TV_INDEX, _VGG19_PLAN):
        while len(layers) < idx:
            layers.append(torch.nn.ReLU())
        conv = torch.nn.Conv2d(in_c, out_c, 3, padding=1)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.01)
            conv.bias.copy_(torch.randn(out_c, generator=g) * 0.01)
        layers.append(conv)
        in_c = out_c
    net = torch.nn.Module()
    net.features = torch.nn.Sequential(*layers)
    return net


@pytest.mark.parametrize("form", ["state_dict", "module"])
def test_vgg_weights_load_as_the_reference(form, tmp_path, env):  # noqa: F811
    """``--vgg_weights``: a torchvision-keyed checkpoint, saved as a state
    dict or as the module, gives the reference loader's arrays exactly, and
    the model's VGG holds them."""
    from vts_torch.losses.vgg import load_vgg19_weights
    from vts_tpu.losses.vgg import load_vgg19_weights as jax_load
    net = _torchvision_vgg19()
    path = str(tmp_path / "vgg19.pth")
    torch.save(net.state_dict() if form == "state_dict" else net, path)
    got, want = load_vgg19_weights(path)["conv"], jax_load(path)["conv"]
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert np.array_equal(g["w"].numpy().transpose(2, 3, 1, 0), np.asarray(w["w"]))
        assert np.array_equal(g["b"].numpy(), np.asarray(w["b"]))
    model = _port_model(_argv(env, "--vgg_weights", path))
    assert torch.equal(model.vgg.w12, got[12]["w"]) and not hasattr(model.vgg, "w13")


# ------------------------------------------------------------- generators ---

G_VARIANTS = {
    "global": ("global", "instance"),
    "local": ("local", "instance"),
    "encoder": ("encoder", "instance"),
    "local_batch": ("local", "batch"),
}


def _jax_net(kind, norm):
    from vts_tpu.networks.pix2pixhd_nets import Encoder, GlobalGenerator, LocalEnhancer
    kw = dict(ngf=4, out_nc=5, norm_type=norm, init_gain=0.5, train=norm != "batch")
    if kind == "global":
        return GlobalGenerator(n_downsampling=2, n_blocks=2, **kw)
    if kind == "local":
        return LocalEnhancer(n_downsample_global=2, n_blocks_global=2, n_local_enhancers=1,
                             n_blocks_local=2, **kw)
    return Encoder(n_downsampling=2, **kw)


def _port_net(kind, norm):
    from vts_torch.networks.pix2pixhd_nets import Encoder, GlobalGenerator, LocalEnhancer
    kw = dict(ngf=4, out_nc=5, norm_type=norm, init_gain=0.5)
    if kind == "global":
        return GlobalGenerator(1, n_downsampling=2, n_blocks=2, **kw)
    if kind == "local":
        return LocalEnhancer(1, n_downsample_global=2, n_blocks_global=2, n_local_enhancers=1,
                             n_blocks_local=2, **kw)
    return Encoder(1, n_downsampling=2, **kw)


@pytest.mark.parametrize("variant", list(G_VARIANTS))
def test_generator_matches_jax(variant):
    """The port's seeded weights through ``convert_jax`` into the reference
    module's tree (the same paths and shapes as its ``init``) and back bit
    for bit; the forward within 1e-5 of its max (the batch-norm G in eval
    mode, on running statistics away from their init)."""
    from vts_torch.utils.convert_jax import resnet_params_to_torch, torch_to_resnet_params
    kind, norm = G_VARIANTS[variant]
    x = np.random.default_rng(len(variant)).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    net = _port_net(kind, norm).train(norm != "batch")
    net.reset_parameters(torch.Generator().manual_seed(len(variant)))
    with torch.no_grad():
        for k, t in net.state_dict().items():
            if k.endswith((".mean", ".var")):
                t.copy_(torch.rand(t.shape) * 0.5 + (0.75 if k.endswith("var") else -0.25))
    params, stats = torch_to_resnet_params(net.state_dict())
    jnet = _jax_net(kind, norm)
    shapes = jax.eval_shape(jnet.init, jax.random.key(1), jnp.asarray(x))
    for got, want in ((params, shapes["params"]), (stats, shapes.get("batch_stats", {}))):
        a, b = flat(got), {k: v.shape for k, v in flat_shapes(want).items()}
        assert {k: v.shape for k, v in a.items()} == b
    back = {k: v for k, v in resnet_params_to_torch(params).items()}
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items() if k in back)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    torch.tanh(torch.zeros(want.shape))        # see test_torch_port_pix2pix's tanh note
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 5)
    scale = np.abs(want).max()
    assert scale > 1e-3 and np.abs(got - want).max() <= 1e-5 * scale


def test_instance_average_matches_jax():
    from vts_torch.networks.pix2pixhd_nets import instance_average
    from vts_tpu.networks.pix2pixhd_nets import instance_average as jax_average
    r = np.random.default_rng(0)
    feats = r.normal(size=(2, 8, 8, 3)).astype(np.float32)
    inst = r.integers(0, 4, (2, 8, 8, 1))              # label 4 of 5 unused
    want = np.asarray(jax_average(jnp.asarray(feats), jnp.asarray(inst), 5))
    got = instance_average(torch.from_numpy(feats), torch.from_numpy(inst), 5).numpy()
    assert np.abs(got - want).max() <= 1e-6
    means = [feats[0][inst[0, ..., 0] == k].mean(0) for k in range(4)]
    assert np.allclose(got[0][inst[0, ..., 0] == 2], means[2], atol=1e-6)


# ------------------------------------------------------------------- pool ---

def test_pool_query_matches_jax():
    """A pool of 3 and batches of 4: inserts then a swap or pass decision in
    the first call, swaps or passes only in the next two; JAX's draws."""
    from vts_torch.utils.image_pool import pool_query
    from vts_tpu.utils.image_pool import pool_query as jax_query
    p, b = 3, 4
    jbuf, jn = jnp.zeros((p, 2, 2, 4)), jnp.int32(0)
    buf, n = torch.zeros((p, 2, 2, 4)), 0
    swaps = 0
    for step in range(3):
        imgs = np.random.default_rng(step).normal(size=(b, 2, 2, 4)).astype(np.float32)
        key = jax.random.key(10 + step)
        jbuf, jn, jout = jax.jit(jax_query)(jbuf, jn, jnp.asarray(imgs), key)
        d = _query_draws(key, b, p)
        buf, n, out = pool_query(buf, n, torch.from_numpy(imgs), d["pool_u"], d["pool_rid"])
        assert n == int(jn) == min(p, b * (step + 1))
        assert np.array_equal(buf.numpy(), np.asarray(jbuf))
        assert np.array_equal(out.numpy(), np.asarray(jout))
        swaps += int(sum(not np.array_equal(o, i) for o, i in zip(out.numpy(), imgs)))
    assert swaps > 0


def test_image_pool_matches_the_reference():
    from vts_torch.utils.image_pool import ImagePool
    from vts_tpu.utils.image_pool import ImagePool as JaxImagePool
    ours, ref = ImagePool(3, seed=5), JaxImagePool(3, seed=5)
    for step in range(4):
        imgs = np.random.default_rng(step).normal(size=(2, 2, 2, 1)).astype(np.float32)
        assert np.array_equal(ours.query(imgs), ref.query(imgs))
    assert all(np.array_equal(a, b) for a, b in zip(ours.images, ref.images))
    assert ImagePool(0).query(imgs) is not None


# ------------------------------------------------------------------- step ---

def _run_step(env, extra, jax_init=False):  # noqa: F811
    """One JAX step (``optimize_parameters``) and one port step from the same
    weights (the port's seeded ones, or with ``jax_init`` the reference's
    own init), batch and pool draws."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    argv = _argv(env, *extra)
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jmodel = jax_create_model(jopt)
    batch = _patch_batch()
    model = _port_model(argv)
    if jax_init:
        from vts_torch.utils.convert_jax import d_params_to_torch, resnet_params_to_torch
        jmodel.setup(batch)
        for name, net in model.nets().items():
            net.load_state_dict((resnet_params_to_torch if name == "G" else d_params_to_torch)(
                jmodel.states[name].params))
    else:
        _jax_setup(jmodel, model)
    states0 = {k: (_copy(s.params), _copy(s.stats)) for k, s in jmodel.states.items()}
    key = jmodel.rng
    jmodel.set_input(batch)
    jmodel.optimize_parameters(1)
    model.set_input(batch)
    draws = _pool_draws(key, 4, jopt.pool_size) if jopt.pool_size else {}
    model.optimize_parameters(1, draws=draws)
    return types.SimpleNamespace(
        jopt=jopt, jmodel=jmodel, batch=batch, states0=states0, model=model,
        losses=jmodel.get_current_losses(), outputs=dict(jmodel._outputs),
        port_outputs=dict(model._outputs),
        states1={k: (_copy(s.params), _copy(s.opt_state.mu)) for k, s in jmodel.states.items()})


@pytest.fixture(scope="module")
def step(env):  # noqa: F811
    return _run_step(env, STEP_ARGS)


def _check_losses(step):
    got = step.model.get_current_losses()
    assert set(got) == set(step.losses)
    for k, v in step.losses.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    return got


def _check_grads(step, net):
    b1 = step.jopt.beta1
    a = {k: v / (1 - b1) for k, v in flat(step.states1[net][1]).items()}
    b = {k: v / (1 - b1) for k, v in flat(_to_flax(net)(step.model.adam[net].mu)[0]).items()}
    assert a.keys() == b.keys() and step.model.adam[net].count == 1
    net_max = max(np.abs(v).max() for v in a.values())
    for k in a:
        tol = _tol(k, a[k], net_max, "['Conv_0']['bias']" if net == "G" else None)
        assert np.abs(a[k] - b[k]).max() <= tol, (net, k, np.abs(a[k] - b[k]).max(), tol)
    return a


def _check_params(step, net):
    b1 = step.jopt.beta1
    lr = step.jopt.lr if net != "D2" else step.jopt.lr_G2
    p_got = flat(_to_flax(net)(getattr(step.model, f"net{net}").state_dict())[0])
    p0, p1, g = (flat(t) for t in (step.states0[net][0], step.states1[net][0],
                                   step.states1[net][1]))
    assert p1.keys() == p_got.keys()
    net_max = max(np.abs(v).max() for v in g.values()) / (1 - b1)
    for k in p1:
        delta = np.abs(p1[k] - p0[k]).max()
        gk = g[k] / (1 - b1)
        tol = _tol(k, gk, net_max, "['Conv_0']['bias']" if net == "G" else None)
        bound = 1e-4 * delta + _adam_spread(gk, tol, lr)
        assert (np.abs(p_got[k] - p1[k]) <= bound).all(), \
            (net, k, np.abs(p_got[k] - p1[k]).max(), delta)
    return p0, p_got


def test_step_losses(step):
    got = _check_losses(step)
    assert set(got) == {"D_fake", "D_real", "D2_fake", "D2_real", "G_GAN", "G_GAN_Feat",
                        "G_total"}
    assert got["G_GAN_Feat"] > 0


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_step_grads(step, net):
    """Per leaf within ``_grad_tol``; the leaves at round-off are exactly the
    biases of the convs that an instance norm follows."""
    a = _check_grads(step, net)
    net_max = max(np.abs(v).max() for v in a.values())
    at_roundoff = {k for k, v in a.items() if np.abs(v).max() <= 1e-5 * net_max}
    want = {k for k in a if (_g_zero(k) if net == "G" else ZERO_GRAD.search(k))}
    # G: the stem, 2 downs, 2 blocks × 2 convs, 2 ups; D: Conv4x4_{1,2,3} at 2 scales
    assert at_roundoff == want and len(want) == (9 if net == "G" else 6), sorted(at_roundoff)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_step_params(step, net):
    _check_params(step, net)


def test_step_pool_state(step):
    """The pool after the step: the count, and the buffer (cat(S, fake_I) of
    the inserted images) within 1e-5 of its max."""
    want_buf = np.asarray(step.jmodel._pool_state["pool_buf"])
    buf, n = step.model._pool
    assert n == int(step.jmodel._pool_state["pool_n"]) == 2
    assert np.abs(buf.numpy() - want_buf).max() <= 1e-5 * np.abs(want_buf).max()


@pytest.fixture(scope="module")
def step16(env, step):  # noqa: F811
    """The shared step under ``--dtype bfloat16``: a JAX and a port step from
    the shared step's weights, batch and pool draws."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    argv = _argv(env, *STEP_ARGS, "--dtype", "bfloat16")
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jmodel = jax_create_model(jopt)
    model = _port_model(argv)
    for name in model.model_names:      # the seeded weights of the shared step
        params = _to_flax(name)(getattr(model, f"net{name}").state_dict())[0]
        assert all(np.array_equal(v, flat(step.states0[name][0])[k])
                   for k, v in flat(params).items()), name
    _jax_setup(jmodel, model)
    key = jmodel.rng
    jmodel.set_input(step.batch)
    jmodel.optimize_parameters(1)
    model.set_input(step.batch)
    model.optimize_parameters(1, draws=_pool_draws(key, 4, jopt.pool_size))
    return types.SimpleNamespace(
        jax16={"losses": jmodel.get_current_losses(),
               **{n: flat(s.opt_state.mu) for n, s in jmodel.states.items()}},
        port16={"losses": model.get_current_losses(),
                **{n: flat(_to_flax(n)(model.adam[n].mu)[0]) for n in model.model_names}})


def test_bf16_step_losses(step, step16):
    assert_bf16_losses(step.losses, step16.jax16["losses"], step16.port16["losses"])


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_bf16_step_grads(step, step16, net):
    """Adam's first moment after one step, (1 − β1)·g, of each network by
    the bf16 lane's 2-norm rule."""
    assert_bf16_tree(flat(step.states1[net][1]), step16.jax16[net], step16.port16[net], net)


@pytest.fixture(scope="module")
def port_steps(env):  # noqa: F811
    """Port-only steps from one set of seeded weights: the default settings
    (the VGG loss on, the reference's GAN-feat term) and ``--no_ganFeat_loss``."""
    out = {}
    for name, extra in (("default", ()), ("no_feat", ("--no_ganFeat_loss",))):
        model = _port_model(_argv(env, *extra))
        model.set_input(_patch_batch())
        model.optimize_parameters(1)
        out[name] = model
    return out


def test_gan_feat_quirk_is_zero_and_inert(port_steps):
    a, b = port_steps["default"], port_steps["no_feat"]
    losses = a.get_current_losses()
    assert losses["G_GAN_Feat"] == 0.0 and "G_GAN_Feat" not in b.get_current_losses()
    for name in ("G", "D", "D2"):
        sa, sb = (getattr(m, f"net{name}").state_dict() for m in (a, b))
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name


def test_step_vgg_term_is_the_ported_loss(port_steps):
    from vts_torch.losses.vgg import vgg_loss
    m = port_steps["default"]
    fake_I, fake_T = m._outputs["fake_I"], m._outputs["fake_T"]
    I, real_T = m._input["I"], m._input["T_images"]
    tile = lambda t, c: t[..., c:c + 1].repeat(1, 1, 1, 3)  # noqa: E731
    with torch.no_grad():
        want = m.opt.lambda_vgg * (vgg_loss(m.vgg, fake_I, I)
                                   + sum(vgg_loss(m.vgg, tile(fake_T, c), tile(real_T, c))
                                         for c in (0, 1)))
    got = m.get_current_losses()["G_VGG"]
    assert got > 0
    np.testing.assert_allclose(got, float(want), rtol=1e-5)


@pytest.mark.slow
def test_step_with_vgg_matches_jax(env):  # noqa: F811
    """The step with the VGG loss on (the pool and the corrected GAN-feat
    term too) against JAX's, held as the shared step is, from the
    reference's own init: an untrained G's outputs are near-constant
    (std ~0.01), so the VGG's fp32 max-pool near-ties depend on the draw,
    and at the port's seeded init one of them routes the gx term's gradient
    differently in the two packages (ROADMAP C)."""
    s = _run_step(env, ["--correct_gan_feat", "true", "--pool_size", "2"], jax_init=True)
    assert "G_VGG" in _check_losses(s)
    for net in ("G", "D", "D2"):
        _check_grads(s, net)
        _check_params(s, net)


# ------------------------------------------------------- two-stage schedule ---

def test_update_fixed_params_matches_jax(env, capsys):  # noqa: F811
    """A local G, ``--niter_fix_global 2``.  Masked from the first step (epoch
    0): the leaves under ``global`` hold their values in both packages while
    Adam's count advances, and the others agree with JAX's as the shared
    step's params do.  At epoch 2 both print the reference's line and drop
    the mask, and the port's next step moves every kernel (an unmasked
    step's parity is the shared step's)."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    argv = _argv(env, "--netG", "local", "--n_blocks_global", "1", "--n_blocks_local", "1",
                 "--niter_fix_global", "2", "--no_vgg_loss", "--name", "fix", "--num_D_D1", "1",
                 "--num_D_D2", "1", "--n_layers_D", "1")
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jm = jax_create_model(jopt)
    batch = _patch_batch()
    model = _port_model(argv)
    _jax_setup(jm, model)
    glob = {k for k, _ in model.netG.named_parameters() if k.startswith("global.")}
    g0 = flat(_copy(jm.states["G"].params))
    for m in (jm, model):
        m.update_fixed_params(0)
        m.set_input(batch)
        m.optimize_parameters(1)
    assert set(model.frozen) == glob and jm._g_frozen_mask is not None
    j1 = flat(jm.states["G"].params)
    p1 = flat(_to_flax("G")(model.netG.state_dict())[0])
    assert int(jm.states["G"].opt_state.count) == model.adam["G"].count == 1
    grads = {k: v / (1 - jopt.beta1) for k, v in flat(jm.states["G"].opt_state.mu).items()}
    net_max = max(np.abs(v).max() for v in grads.values())
    for k in j1:
        if k.startswith("['global']"):
            assert np.array_equal(j1[k], g0[k]) and np.array_equal(p1[k], g0[k]), k
            continue
        tol = _tol(k, grads[k], net_max, "['Conv_2']['bias']")
        bound = 1e-4 * np.abs(j1[k] - g0[k]).max() + _adam_spread(grads[k], tol, jopt.lr)
        assert (np.abs(p1[k] - j1[k]) <= bound).all(), (k, np.abs(p1[k] - j1[k]).max())
    for m in (jm, model):
        m.update_fixed_params(2)
    assert capsys.readouterr().out.count("Now also finetuning global generator") == 2
    assert not model.frozen and jm._g_frozen_mask is None
    before = {k: v.clone() for k, v in model.netG.state_dict().items()}
    model.optimize_parameters(1)
    after = model.netG.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items() if k.endswith("weight"))


def test_schedule_masks_only_after_the_first_epoch(env):  # noqa: F811
    """The training driver calls ``update_fixed_params`` after each epoch, as
    the reference's does, so epoch 1 trains every leaf and the mask starts
    with Adam moments in place: the masked global leaves go on moving
    (upstream pix2pixHD leaves them out of G's optimizer from the start).
    The port keeps the reference's order; with ``--niter_fix_global 1``
    nothing is ever masked."""
    argv = _argv(env, "--netG", "local", "--n_blocks_global", "1", "--n_blocks_local", "1",
                 "--niter_fix_global", "3", "--no_vgg_loss", "--name", "fix2")
    model = _port_model(argv)
    model.set_input(_patch_batch())
    model.optimize_parameters(1)                  # epoch 1, before the driver's first call
    model.update_fixed_params(1)
    assert model.frozen
    before = {k: v.clone() for k, v in model.netG.state_dict().items()}
    model.optimize_parameters(1)                  # (epoch 1's lr: the run has one epoch)
    after = model.netG.state_dict()
    still = [k for k in model.frozen if k.endswith("weight") and torch.equal(after[k], before[k])]
    assert not still, still
    model.update_fixed_params(3)
    assert not model.frozen
    once = _port_model(_argv(env, "--netG", "local", "--niter_fix_global", "1", "--name", "f3"))
    once.update_fixed_params(1)
    assert not once.frozen


# ------------------------------------------------------------- checkpoints ---

def test_checkpoints_cross_both_ways(step, env):  # noqa: F811
    """JAX's G, D and D2 into the port and the port's into JAX: identical
    arrays and Adam counts, the test forwards within 1e-5 of their max."""
    jm, model = step.jmodel, step.model
    jm.save_networks("jax")
    ported = _port_model(_argv(env, *STEP_ARGS, "--epoch", "jax"))
    ported.load_networks("jax")
    for name in ("G", "D", "D2"):
        a = flat(jm.states[name].params)
        b = flat(_to_flax(name)(getattr(ported, f"net{name}").state_dict())[0])
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), name
        assert int(jm.states[name].opt_state.count) == ported.adam[name].count == 1
    model.save_networks("port")
    jm.load_networks("port")
    for m in (jm, model):
        m.set_input(step.batch)
        m.test()
    for k in ("fake_I", "fake_T"):
        got = model._outputs[k].numpy()
        assert np.abs(np.asarray(jm._outputs[k]) - got).max() <= 1e-5 * np.abs(got).max(), k
    assert not any("pool" in f for f in os.listdir(env / "ckpt" / "p2phd"))


# ------------------------------------------------------------- .pth import ---

def _reference_state(arch, ngf=4, nd=2, nb=2, nbl=1, seed=0):
    """A reference pix2pixHD generator's state dict (instance norm): the
    convs at their ``model.{j}`` (``model{n}_1``, ``model{n}_2``) indices."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, o, i, k, transposed=False):
        sd[f"{key}.weight"] = torch.randn((i, o, k, k) if transposed else (o, i, k, k),
                                          generator=g)
        sd[f"{key}.bias"] = torch.randn((o,), generator=g)

    def trunk(c, blocks):
        conv("model.1", c, 1, 7)
        for i in range(nd):
            conv(f"model.{4 + 3 * i}", c * 2 ** (i + 1), c * 2 ** i, 3)
        s0 = 4 + 3 * nd
        for b in range(blocks):
            for j in (1, 5):
                conv(f"model.{s0 + b}.conv_block.{j}", c * 2 ** nd, c * 2 ** nd, 3)
        for i in range(nd):
            conv(f"model.{s0 + blocks + 3 * i}", c * 2 ** (nd - i - 1), c * 2 ** (nd - i), 3,
                 transposed=True)
        return s0 + blocks + 3 * nd
    if arch == "local":
        trunk(2 * ngf, nb)
        conv("model1_1.1", ngf, 1, 7)
        conv("model1_1.4", 2 * ngf, ngf, 3)
        for b in range(nbl):
            for j in (1, 5):
                conv(f"model1_2.{b}.conv_block.{j}", 2 * ngf, 2 * ngf, 3)
        conv(f"model1_2.{nbl}", ngf, 2 * ngf, 3, transposed=True)
        conv(f"model1_2.{nbl + 4}", 5, ngf, 7)
    else:
        end = trunk(ngf, nb if arch == "global" else 0)
        conv(f"model.{end + 1}", 5, ngf, 7)
    return sd


PTH = {"global": dict(n_downsampling=2, n_blocks=2), "encoder": dict(n_downsampling=2),
       "local": dict(n_local_enhancers=1, n_downsample_global=2, n_blocks_global=2,
                     n_blocks_local=1)}


@pytest.mark.parametrize("arch", list(PTH))
def test_pth_pix2pixhd_import_matches_jax(arch, tmp_path):
    """The port's converter and CLI (``--arch <arch> --set ...``) against
    ``vts_tpu``'s: identical arrays, and the tree loads into the port's G."""
    from vts_torch.utils.convert_jax import resnet_params_to_torch
    from vts_torch.utils.convert_torch import convert_checkpoint, main
    from vts_torch.utils.msgpack import msgpack_restore
    from vts_tpu.utils.convert_torch import convert_checkpoint as jax_convert
    sd = _reference_state(arch)
    path = str(tmp_path / "best_net_G.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    want = jax_convert(path, arch, **PTH[arch])
    got = convert_checkpoint(path, arch, **PTH[arch])
    out = str(tmp_path / "ckpt" / "best_net_G.msgpack")
    main(["--input", path, "--output", out, "--arch", arch]
         + [a for k, v in PTH[arch].items() for a in ("--set", f"{k}={v}")])
    with open(out, "rb") as f:
        cli = msgpack_restore(f.read())
    a = flat(want["params"])
    for tree in (got, cli):
        b = flat(tree["params"])
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
        assert tree["stats"] == {} == want["stats"]
    net = {"global": lambda: _port_net("global", "instance"),
           "encoder": lambda: _port_net("encoder", "instance")}.get(arch)
    if net is None:
        from vts_torch.networks.pix2pixhd_nets import LocalEnhancer
        net = lambda: LocalEnhancer(1, ngf=4, out_nc=5, n_downsample_global=2,  # noqa: E731
                                    n_blocks_global=2, n_local_enhancers=1, n_blocks_local=1)
    net().load_state_dict(resnet_params_to_torch(cli["params"]))


# ------------------------------------------------- visuals and refusals ---

@pytest.mark.parametrize("model", ["pix2pix", "sinskit"])
def test_pool_size_is_a_value_error_for_the_other_models(model, tmp_path):
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    argv = ["--model", model, "--pool_size", "50", "--checkpoints_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="pool_size"):
        jax_create_model(JaxTrainOptions().parse(argv, quiet=True))
    with pytest.raises(ValueError, match="pool_size"):
        create_model(TrainOptions().parse(argv + ["--device", "cpu"], quiet=True))


def test_reference_visuals_fail_and_the_port_leaves_the_d2_map_out(step):
    """As pix2pix's: pix2pixHD's parser declares no ``lambda_G2_GAN`` either,
    so the reference's training visuals raise; with it at 0 its panels equal
    the port's, neither with ``pred_fake_T_full``."""
    jm, model = step.jmodel, step.model
    jm.set_input(step.batch)
    jm._outputs = dict(step.outputs)
    with pytest.raises(AttributeError, match="lambda_G2_GAN"):
        jm.get_current_visuals()
    jm.opt.lambda_G2_GAN = 0
    try:
        want = jm.get_current_visuals()
    finally:
        del jm.opt.lambda_G2_GAN
    model.set_input(step.batch)
    model._outputs = dict(step.port_outputs)
    got = model.get_current_visuals()
    assert set(got) == set(want) and "pred_fake_T_full" not in got
    for k in want:
        w = np.asarray(want[k], np.float32)
        assert np.abs(got[k] - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), k


def test_t_resolution_multiplier_is_refused(env):  # noqa: F811
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    with pytest.raises(ValueError, match="--T_resolution_multiplier"):
        create_model(TrainOptions().parse(
            _argv(env, "--T_resolution_multiplier", "2") + ["--device", "cpu"], quiet=True))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where CUDA is absent")
@pytest.mark.parametrize("phase", ["train", "test"])
def test_pix2pixhd_runs_on_cuda_unless_asked_for_the_cpu(phase, tmp_path):
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.models import create_model
    opt = (TrainOptions() if phase == "train" else TestOptions()).parse(
        ["--model", "pix2pixHD", "--checkpoints_dir", str(tmp_path)], quiet=True)
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        create_model(opt)


# --------------------------------------------------------------- drivers ---

def test_cpu_train_then_test_drivers(env):  # noqa: F811
    """``vts_torch.train --model pix2pixHD`` for one epoch of 2 steps of one
    patch (no validation: pix2pixHD's default), then ``vts_torch.test`` on
    its best G over the 256² canvas."""
    from vts_torch.test import test as port_test
    from vts_torch.train import train as port_train
    tmp = env / "drivers"
    common = ["--model", "pix2pixHD", "--name", "drv", "--dataroot", DATA, "--device", "cpu",
              "--ngf", "4", "--ndf", "4", "--crop_size", "256", "--center_w", "192",
              "--center_h", "128", *SMALL_G, "--checkpoints_dir", str(tmp / "ckpt"),
              "--results_dir", str(tmp / "res")]
    model = port_train(common + ["--batch_size", "1", "--batch_size_G2", "2", "--n_epochs", "1",
                                 "--n_epochs_decay", "0", "--no_html", "--print_freq", "1"])
    losses = model.get_current_losses()
    assert model.adam["G"].count == 2 and all(np.isfinite(v) for v in losses.values())
    assert losses["G_GAN_Feat"] == 0 and losses["G_VGG"] > 0
    ck = tmp / "ckpt" / "drv"
    for name in ("G", "D", "D2"):
        assert (ck / f"latest_net_{name}.msgpack").exists()
    metrics = port_test(common + ["--epoch", "latest", "--batch_size_G2", "1"])
    assert len(metrics) == 1 and len(metrics[0]) == 8
    assert all(np.isfinite(v) for v in metrics[0].values())
    with open(tmp / "res" / "drv" / "test_latest" / "eval_metrics.pkl", "rb") as f:
        assert pickle.load(f).keys() == metrics[0].keys()
