"""The SPADE slice of the port — the spectral-norm conv, the SPADE norm,
block and generator, the VAE encoder, the spectral multiscale Ds, the
hinge step under TTUR, the checkpoints and the ``spade`` ``.pth`` import —
against ``vts_tpu`` on the CPU, at ngf/ndf 4 and 3 upsamplings:

  * ``SpectralConv`` at a 3×3 and a 4×4 stride-2 conv from the same kernel
    and ``u``: the output within 1e-6 of its max, σ and ``u'`` within 1e-6;
    the x- and kernel-gradients within 1e-5 of their max with σ outside the
    gradient; in eval σ iterated and ``u`` kept; ``update_stats=False``
    writes nothing;
  * ``SPADENorm`` (batch and instance), ``SPADEResnetBlock`` (with and
    without the learned shortcut) and ``SPADEGenerator`` (train mode with
    every ``u`` and running statistic after the pass, eval mode, the VAE
    stem with a given z) on the port's seeded weights carried into a tree
    of the reference module's paths and shapes (its ``jax.eval_shape``d
    init): within 1e-5 of the output's max; the stats within 1e-6;
  * ``ConvEncoder`` (the JAX side with ``mutable=["batch_stats"]``) and
    ``kld_loss``; the spectral multiscale D's features, logits and ``u``;
  * one training step (shared, module scope) with ``--no_vgg_loss
    --pool_size 2``, one D scale each, at batch 4 on random patches as ``tests/test_baselines.py``
    draws them, the pool's draws JAX's (``fold_in(rng, 1)``), JAX's states
    built from the port's seeded weights and ``u`` (no flax init): losses
    within rtol 1e-4, gradients per leaf within ``_grad_tol`` (the biases
    that a batch or instance norm follows at the round-off floor), params
    after Adam at TTUR's three rates, every ``u`` and running statistic
    after the step within 1e-6, the pool's buffer and count;
  * the same step under ``--dtype bfloat16`` in both packages, from the same
    weights, ``u``, batch and draws, held by the bf16 lane's rules with the
    fp32 JAX step as the reference (``tests/torch_port_step.py``): per loss
    |port16 − jax16| ≤ 2·|jax16 − jax32| + 1e-3·|jax32|, per network
    ‖port16 − jax16‖/‖jax32‖ ≤ 2·‖jax16 − jax32‖/‖jax32‖ + 1e-3 over
    Adam's first moment and over every ``u`` and running statistic (no VGG,
    so no near-tie rule);
  * port-only: G_VGG equals λ_vgg times ``Pix2PixHDModel.vgg_term`` of the
    step's outputs; ``--no_TTUR`` hands lr to all three Adams (TTUR: lr/2,
    2·lr, 2·lr); ``--correct_gan_feat`` changes nothing;
  * the msgpack checkpoints both ways with ``u`` and the running stats;
  * the reference's ``.pth`` SPADE generator, plain and VAE, through both
    packages' converters and the CLI: identical arrays;
  * the refusals: ``--use_vae true`` (and the reference's two failures),
    the x2 multiplier; the pool accepted; CUDA asked for by default; the
    reference's visuals fault;
  * the port's drivers alone: one epoch of 2 steps of ``vts_torch.train
    --model spade``; then (``slow``) ``vts_torch.test`` on its latest G over
    the 256² canvas: 8 finite metrics.
"""

import os
import pickle
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_pix2pix import _adam_spread, _copy, _patch_batch, _port_model
from tests.test_torch_port_pix2pixhd import _query_draws, _to_flax, flat_shapes
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)
from tests.torch_port_step import assert_bf16_losses, assert_bf16_tree, flat
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

DATA = "synthetic://spade?size=320&center_w=192&center_h=128&patches=6&val_patches=3"
# the shared step: one D scale each (the 2-scale D is held to JAX alone,
# below; a second scale costs the JAX compile of the step ~7 of its ~21 s)
STEP_ARGS = ["--no_vgg_loss", "--pool_size", "2", "--num_D_D1", "1", "--num_D_D2", "1"]
KEY = jax.random.key(7)


def _argv(tmp, *extra, phase="train"):
    return ["--model", "spade", "--name", "spade", "--dataroot", DATA,
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res"),
            "--batch_size", "4", "--ngf", "4", "--ndf", "4", "--crop_size", "256",
            "--center_w", "192", "--center_h", "128", "--data_len", "2",
            *(["--n_epochs", "1", "--n_epochs_decay", "0"] if phase == "train" else []), *extra]


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * max(scale, 1e-30), \
        (what, np.abs(got - want).max(), scale)


def _jax_vars(net, jmod, *args, **kw):
    """The port module's state dict as the reference module's variables,
    checked leaf for leaf against the paths and shapes of its init."""
    from vts_torch.networks.spade_nets import SpectralConv
    from vts_torch.utils.convert_jax import torch_to_resnet_params
    if isinstance(net, SpectralConv):           # a bare conv: the converters take a scope
        params, stats = (t["c"] for t in torch_to_resnet_params(
            {f"c.{k}": v for k, v in net.state_dict().items()}))
    else:
        params, stats = torch_to_resnet_params(net.state_dict())
    shapes = jax.eval_shape(lambda: jmod.init(KEY, *args, **kw))
    for got, want in ((params, shapes["params"]), (stats, shapes.get("batch_stats", {}))):
        assert {k: v.shape for k, v in flat(got).items()} == \
            {k: v.shape for k, v in flat_shapes(want).items()}
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    if stats:
        variables["batch_stats"] = jax.tree_util.tree_map(jnp.asarray, stats)
    return variables


def _port_stats(net):
    from vts_torch.utils.convert_jax import torch_to_resnet_params
    return flat(torch_to_resnet_params(net.state_dict())[1])


def _init(net, seed):
    """Xavier at gain 0.5 (outputs well away from 0), each ``u`` drawn, the
    running statistics moved off 0 and 1."""
    from vts_torch.networks.blocks import BatchNorm, Conv, make_initializer
    from vts_torch.networks.spade_nets import Dense
    init = make_initializer("xavier", 0.5)
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, (Conv, Dense, BatchNorm)):
            m.reset_parameters(init, gen)
    with torch.no_grad():                 # running statistics away from their init
        for k, t in net.state_dict().items():
            if k.endswith((".mean", ".var")):
                t.copy_(torch.rand(t.shape, generator=gen) * 0.5
                        + (0.75 if k.endswith("var") else -0.25))
    return net


# ------------------------------------------------------------ SpectralConv ---

CONVS = {"3x3": (3, 1, 1, (2, 8, 8, 3), 6), "4x4s2": (4, 2, 2, (2, 9, 9, 4), 5)}


def _jax_sigma(kernel, u):
    """σ as the reference module computes it, from the HWIO kernel."""
    w2d = jnp.asarray(kernel).reshape(-1, kernel.shape[-1])
    v = w2d @ jnp.asarray(u)
    v = v / (jnp.linalg.norm(v) + 1e-12)
    u2 = w2d.T @ v
    u2 = u2 / (jnp.linalg.norm(u2) + 1e-12)
    return float(v @ (w2d @ u2))


def _spectral_pair(kind):
    from vts_torch.networks.spade_nets import SpectralConv
    from vts_tpu.networks.spade_nets import SpectralConv as JaxSpectralConv
    k, s, p, xshape, out = CONVS[kind]
    conv = _init(SpectralConv(xshape[-1], out, k, stride=s, padding=p), 3)
    jconv = lambda train: JaxSpectralConv(out, (k, k), strides=(s, s),  # noqa: E731
                                          padding=((p, p), (p, p)), train=train)
    x = _rand(xshape, 4)
    return conv, jconv, x, _jax_vars(conv, jconv(True), jnp.asarray(x))


@pytest.mark.parametrize("kind", list(CONVS))
def test_spectral_conv_matches_jax(kind):
    """Training mode: the output, σ and the written ``u'``; eval mode: σ
    iterated from the stored ``u``, which stays."""
    conv, jconv, x, variables = _spectral_pair(kind)
    u0 = conv.u.clone()
    want, mut = jax.jit(lambda v, x: jconv(True).apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    sigma = _jax_sigma(variables["params"]["kernel"], variables["batch_stats"]["u"])
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    assert abs(conv.power_iteration()[1].item() - _jax_sigma(
        variables["params"]["kernel"], mut["batch_stats"]["u"])) <= 1e-6 * sigma
    _close(got.numpy(), want, 1e-6, "y")
    assert np.abs(conv.u.numpy() - np.asarray(mut["batch_stats"]["u"])).max() <= 1e-6
    assert not torch.equal(conv.u, u0)
    with torch.no_grad():                       # σ of the pass, from u0
        conv.u.copy_(u0)
        assert abs(conv.power_iteration()[1].item() - sigma) <= 1e-6 * sigma
    conv.eval()
    want_eval = jax.jit(jconv(False).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got_eval = conv(torch.from_numpy(x))
    _close(got_eval.numpy(), want_eval, 1e-6, "eval y")
    assert torch.equal(conv.u, u0)


@pytest.mark.parametrize("kind", list(CONVS))
def test_spectral_conv_gradient_matches_jax(kind):
    """The x- and kernel-gradients of Σ y·r, σ outside the gradient (the
    kernel gradient is r's correlation over σ, no σ term)."""
    conv, jconv, x, variables = _spectral_pair(kind)
    r = _rand(conv(torch.from_numpy(x)).shape, 5)
    with torch.no_grad():
        conv.u.copy_(torch.from_numpy(np.array(variables["batch_stats"]["u"])))

    def loss(params, x):
        y, _ = jconv(True).apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, mutable=["batch_stats"])
        return jnp.sum(y * r)
    g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    gx, gw = torch.autograd.grad((conv(xt) * torch.from_numpy(r)).sum(), (xt, conv.weight))
    _close(gx.numpy(), g_x, 1e-5, "dx")
    _close(gw.numpy().transpose(2, 3, 1, 0), g_p["kernel"], 1e-5, "dkernel")


def test_spectral_conv_keeps_u_without_update_stats():
    """A training-mode pass given ``update_stats=False`` (G's pass through a
    D) uses σ from the stored ``u`` and writes nothing; the next pass that
    keeps its stats advances it."""
    conv, _, x, _ = _spectral_pair("4x4s2")
    u0 = conv.u.clone()
    sigma0 = conv.power_iteration()[1]
    y = conv(torch.from_numpy(x), update_stats=False)
    assert torch.equal(conv.u, u0)
    with torch.no_grad():
        want = conv._conv(torch.from_numpy(x), conv.weight / sigma0, torch.float32)
    assert torch.equal(y.detach(), want)
    conv(torch.from_numpy(x))
    assert not torch.equal(conv.u, u0)


# ------------------------------------------------------- norm, block and G ---

def _check_module(net, jmod_train, jmod_eval, args, jargs, what, rel=1e-5):
    """Train mode (stats after the pass) and eval mode of one module."""
    variables = _jax_vars(net, jmod_train, *jargs)
    want, mut = jax.jit(lambda v, *a: jmod_train.apply(v, *a, mutable=["batch_stats"]))(
        variables, *jargs)
    with torch.no_grad():
        got = net.train()(*args)
    _close(got.numpy(), want, rel, what)
    stats = _port_stats(net)
    for k, v in flat(mut.get("batch_stats", {})).items():
        assert np.abs(stats[k] - v).max() <= 1e-6 * max(1.0, np.abs(v).max()), (what, k)
    variables = _jax_vars(net, jmod_train, *jargs)
    want = jax.jit(jmod_eval.apply)(variables, *jargs)
    with torch.no_grad():
        got = net.eval()(*args)
    _close(got.numpy(), want, rel, what + " eval")


@pytest.mark.parametrize("pf", ["syncbatch", "instance"])
def test_spade_norm_matches_jax(pf):
    from vts_torch.networks.spade_nets import SPADENorm
    from vts_tpu.networks.spade_nets import SPADENorm as JaxSPADENorm
    net = _init(SPADENorm(6, 1, pf, 3, nhidden=8), 1)
    x, seg = _rand((4, 4, 4, 6), 2, -2, 3), _rand((4, 32, 32, 1), 3)
    jm = lambda train: JaxSPADENorm(6, param_free=pf, nhidden=8, train=train)  # noqa: E731
    _check_module(net, jm(True), jm(False), (torch.from_numpy(x), torch.from_numpy(seg)),
                  (jnp.asarray(x), jnp.asarray(seg)), f"SPADENorm {pf}")


@pytest.mark.parametrize("fin,fout", [(8, 8), (8, 4)], ids=["identity", "learned_shortcut"])
def test_spade_resnet_block_matches_jax(fin, fout):
    from vts_torch.networks.spade_nets import SPADEResnetBlock
    from vts_tpu.networks.spade_nets import SPADEResnetBlock as JaxBlock
    net = _init(SPADEResnetBlock(fin, fout), fin + fout)
    x, seg = _rand((4, 8, 8, fin), 6), _rand((4, 32, 32, 1), 7)
    jm = lambda train: JaxBlock(fin, fout, train=train)  # noqa: E731
    assert ("conv_s.u" in dict(net.state_dict())) == (fin != fout)
    _check_module(net, jm(True), jm(False), (torch.from_numpy(x), torch.from_numpy(seg)),
                  (jnp.asarray(x), jnp.asarray(seg)), "block")


def _generator(use_vae=False, seed=0):
    from vts_torch.networks.spade_nets import SPADEGenerator
    net = SPADEGenerator(1, ngf=4, out_nc=5, use_vae=use_vae, z_dim=8, crop_size=32,
                         init_gain=0.5)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return _init(net, seed + 1) if use_vae else net


def test_spade_generator_matches_jax():
    """ngf 4, 3 upsamplings, 32² input (the stem at 4²): train mode with
    every ``u`` and running statistic after the pass, then eval mode."""
    from vts_tpu.networks.spade_nets import SPADEGenerator as JaxG
    net = _generator()
    seg = _rand((4, 32, 32, 1), 8)
    jm = lambda train: JaxG(ngf=4, out_nc=5, train=train)  # noqa: E731
    _check_module(net, jm(True), jm(False), (torch.from_numpy(seg),), (jnp.asarray(seg),),
                  "G")
    assert sum(p.numel() for p in net.parameters()) == 1714453


def test_spade_generator_vae_stem_matches_jax():
    """``use_vae``: the Dense stem on a given z, reshaped NHWC (eval mode)."""
    from vts_tpu.networks.spade_nets import SPADEGenerator as JaxG
    net = _generator(use_vae=True, seed=3).eval()
    seg, z = _rand((2, 32, 32, 1), 9), _rand((2, 8), 10)
    jm = JaxG(ngf=4, out_nc=5, use_vae=True, z_dim=8, train=False)
    variables = _jax_vars(net, jm, jnp.asarray(seg), jnp.asarray(z))
    want = jax.jit(jm.apply)(variables, jnp.asarray(seg), jnp.asarray(z))
    with torch.no_grad():
        got = net(torch.from_numpy(seg), torch.from_numpy(z))
    _close(got.numpy(), want, 1e-5, "VAE G")
    with pytest.raises(ValueError, match="z sample"):
        net(torch.from_numpy(seg))


def test_conv_encoder_and_kld_match_jax():
    """The encoder on a 64² image (resized to 256² bilinearly, as the
    reference's), train mode with its ``u`` after the pass; the KLD loss."""
    from vts_torch.networks.spade_nets import ConvEncoder, kld_loss, reparameterize
    from vts_tpu.networks.spade_nets import ConvEncoder as JaxEncoder
    from vts_tpu.networks.spade_nets import kld_loss as jax_kld
    net = ConvEncoder(3, ndf=4, z_dim=8, init_gain=0.5)
    net.reset_parameters(torch.Generator().manual_seed(4))
    x = _rand((2, 64, 64, 3), 11)
    jm = JaxEncoder(ndf=4, z_dim=8)
    variables = _jax_vars(net, jm, jnp.asarray(x))
    (mu_w, lv_w), mut = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        mu, lv = net(torch.from_numpy(x))
    _close(mu.numpy(), mu_w, 1e-5, "mu")
    _close(lv.numpy(), lv_w, 1e-5, "logvar")
    stats = _port_stats(net)
    assert all(np.abs(stats[k] - v).max() <= 1e-6 for k, v in flat(mut["batch_stats"]).items())
    np.testing.assert_allclose(float(kld_loss(mu, lv)), float(jax_kld(mu_w, lv_w)), rtol=1e-5)
    z = reparameterize(mu, lv, torch.Generator().manual_seed(0))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(0))
    assert torch.allclose(z, mu + torch.exp(0.5 * lv) * eps)


def test_spectral_multiscale_d_matches_jax():
    """Two scales, ``--normD spectralinstance``, intermediate features: every
    feature map and logit, and each ``u`` after the pass."""
    from vts_torch.networks.discriminators import MultiscaleDiscriminator
    from vts_torch.networks.discriminators import reset_parameters as reset_d
    from vts_torch.networks.blocks import make_initializer
    from vts_torch.utils.convert_jax import d_params_to_torch, d_stats_to_torch, torch_to_d_params
    from vts_tpu.networks.discriminators import MultiscaleDiscriminator as JaxD
    net = MultiscaleDiscriminator(4, ndf=4, n_layers=3, num_D=2, norm_type="spectralinstance",
                                  get_interm_feat=True)
    reset_d(net, make_initializer("xavier", 0.5), torch.Generator().manual_seed(5))
    x = _rand((4, 32, 32, 4), 12)
    jm = JaxD(ndf=4, n_layers=3, num_D=2, norm_type="spectralinstance", get_interm_feat=True)
    params, stats = torch_to_d_params(net.state_dict())
    shapes = jax.eval_shape(lambda: jm.init(KEY, jnp.asarray(x)))
    assert {k: v.shape for k, v in flat(params).items()} == \
        {k: v.shape for k, v in flat_shapes(shapes["params"]).items()}
    assert {k: v.shape for k, v in flat(stats).items()} == \
        {k: v.shape for k, v in flat_shapes(shapes["batch_stats"]).items()}
    assert flat(stats)["['scale0']['SpectralConv_4']['u']"].shape == (1,)
    back = dict(d_params_to_torch(params))
    back.update(d_stats_to_torch(stats))
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items())
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    want, mut = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == 5
        for g, w in zip(gs, ws):
            _close(g.numpy(), w, 1e-5, "D feature")
    new = flat(torch_to_d_params(net.state_dict())[1])
    assert all(np.abs(new[k] - v).max() <= 1e-6 for k, v in flat(mut["batch_stats"]).items())


# ------------------------------------------------------------------- step ---

def _jax_setup(jm, model):
    """The reference model's ``setup`` on the port model's seeded weights and
    ``u`` (its own init would compile the initializers op by op)."""
    from vts_tpu.models.base import NetState
    txs = {"G": jm.tx_g, "D": jm.tx_d, "D2": jm.tx_d2}
    for name in model.model_names:
        params, stats = _to_flax(name)(getattr(model, f"net{name}").state_dict())
        params = jax.tree_util.tree_map(jnp.asarray, params)
        jm.states[name] = NetState(params=params, stats=jax.tree_util.tree_map(jnp.asarray, stats),
                                   opt_state=txs[name].init(params))
    jm._jit_step = jax.jit(jm._train_step, donate_argnums=(0, 1, 2))
    jm._jit_forward = jax.jit(jm._forward_eval)


@pytest.fixture(scope="module")
def step(env):  # noqa: F811
    """One JAX step and one port step from the same weights, ``u``, batch and
    pool draws; ``base``, a copy of the port model before its step, for the
    tests below that need a fresh one."""
    import copy

    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    argv = _argv(env, *STEP_ARGS)
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jmodel = jax_create_model(jopt)
    batch = _patch_batch()
    model = _port_model(argv)
    base = copy.deepcopy(model)
    _jax_setup(jmodel, model)
    states0 = {k: (_copy(s.params), _copy(s.stats)) for k, s in jmodel.states.items()}
    draws = _query_draws(jax.random.fold_in(jmodel.rng, 1), 4, jopt.pool_size)
    jmodel.set_input(batch)
    jmodel.optimize_parameters(1)
    model.set_input(batch)
    model.optimize_parameters(1, draws=draws)
    return types.SimpleNamespace(
        jopt=jopt, jmodel=jmodel, batch=batch, states0=states0, model=model, base=base,
        losses=jmodel.get_current_losses(), outputs=dict(jmodel._outputs),
        port_outputs=dict(model._outputs),
        states1={k: (_copy(s.params), _copy(s.opt_state.mu), _copy(s.stats))
                 for k, s in jmodel.states.items()})


# the biases whose gradient is exactly zero: those whose per-channel
# constant meets a batch norm on every path on.  In G: each conv_0's (norm_1
# follows), and since up_0 and up_1 batch-normalize both of their inputs'
# paths, fc's, conv_1's of head_0, G_middle_{0,1} and up_0, and the mlp_beta
# bias of up_0's norm_s (through the 1×1 conv_s a constant stays one); in
# the Ds SpectralConv_{1,2,3}'s (an instance norm follows).  The D logit
# head's bias sums fake and real terms of opposite sign (held as
# test_torch_port_train's CANCELLING leaves)
SPADE_ZERO = re.compile(r"\['fc'\]\['bias'\]|\['conv_0'\]\['bias'\]"
                        r"|\['(head_0|G_middle_[01]|up_0)'\]\['conv_1'\]\['bias'\]"
                        r"|\['up_0'\]\['norm_s'\]\['mlp_beta'\]\['bias'\]"
                        r"|SpectralConv_[123]'\]\['bias'\]")
SPADE_CANCELLING = re.compile(r"SpectralConv_4'\]\['bias'\]")


def _tol(name, g, net_max):
    if SPADE_ZERO.search(name):
        return 1e-5 * net_max
    return 1e-4 * np.abs(g).max() + (1e-5 * net_max if SPADE_CANCELLING.search(name) else 0.0)


def _rates(jopt):
    return {"G": jopt.lr / 2, "D": jopt.lr * 2, "D2": jopt.lr * 2}


def test_step_losses(step):
    got = step.model.get_current_losses()
    assert set(got) == set(step.losses) == {"D_fake", "D_real", "D2_fake", "D2_real", "G_GAN",
                                            "G_GAN_Feat", "G_total"}
    for k, v in step.losses.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert got["G_GAN_Feat"] > 0


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_step_grads_and_params(step, net):
    """Gradients (Adam's first moment: β1 = 0) per leaf within their limit;
    the named biases (G: 11, see :data:`SPADE_ZERO`; D: SpectralConv_{1,2,3})
    are at round-off in both, every other leaf within 1e-4 of
    its own max (some of G's are 1e-6 of its max); the params after Adam
    at the net's TTUR rate within 1e-4 of each leaf's move plus
    :func:`_adam_spread`."""
    b1, lr = step.jopt.beta1, _rates(step.jopt)[net]
    assert b1 == 0.0 and step.model.adam[net].count == 1
    a = flat(step.states1[net][1])
    b = flat(_to_flax(net)(step.model.adam[net].mu)[0])
    assert a.keys() == b.keys()
    net_max = max(np.abs(v).max() for v in a.values())
    for k in a:
        tol = _tol(k, a[k], net_max)
        assert np.abs(a[k] - b[k]).max() <= tol, (net, k, np.abs(a[k] - b[k]).max(), tol)
    zero = [k for k in a if SPADE_ZERO.search(k)]
    assert len(zero) == (11 if net == "G" else 3), zero
    assert all(max(np.abs(a[k]).max(), np.abs(b[k]).max()) <= 1e-6 * net_max for k in zero)
    p_got = flat(_to_flax(net)(getattr(step.model, f"net{net}").state_dict())[0])
    p0, p1 = flat(step.states0[net][0]), flat(step.states1[net][0])
    for k in p1:
        bound = 1e-4 * np.abs(p1[k] - p0[k]).max() + _adam_spread(a[k], _tol(k, a[k], net_max),
                                                                   lr)
        assert (np.abs(p_got[k] - p1[k]) <= bound).all(), (net, k, np.abs(p_got[k] - p1[k]).max())


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_step_u_and_running_stats(step, net):
    """Every ``u`` (G: once; D, D2: fake then real pass) and running
    statistic after the step within 1e-6; each ``u`` moved."""
    s0, s1 = flat(step.states0[net][1]), flat(step.states1[net][2])
    got = flat(_to_flax(net)(getattr(step.model, f"net{net}").state_dict())[1])
    assert got.keys() == s1.keys() and any(k.endswith("['u']") for k in got)
    for k, v in s1.items():
        assert np.abs(got[k] - v).max() <= 1e-6 * max(1.0, np.abs(v).max()), (net, k)
        if k.endswith("['u']") and v.size > 1:
            assert not np.array_equal(v, s0[k]), k


def test_step_pool_state(step):
    want_buf = np.asarray(step.jmodel._pool_state["pool_buf"])
    buf, n = step.model._pool
    assert n == int(step.jmodel._pool_state["pool_n"]) == 2
    _close(buf.numpy(), want_buf, 1e-5, "pool")


@pytest.fixture(scope="module")
def step16(env, step):  # noqa: F811
    """The shared step under ``--dtype bfloat16``: a JAX and a port step from
    the shared step's weights, ``u``, batch and pool draws."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    argv = _argv(env, *STEP_ARGS, "--dtype", "bfloat16")
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jmodel = jax_create_model(jopt)
    model = _port_model(argv)
    for name in model.model_names:
        getattr(model, f"net{name}").load_state_dict(getattr(step.base, f"net{name}").state_dict())
    _jax_setup(jmodel, model)
    draws = _query_draws(jax.random.fold_in(jmodel.rng, 1), 4, jopt.pool_size)
    jmodel.set_input(step.batch)
    jmodel.optimize_parameters(1)
    model.set_input(step.batch)
    model.optimize_parameters(1, draws=draws)
    return {"losses": (jmodel.get_current_losses(), model.get_current_losses()),
            "jax16": {n: (flat(st.opt_state.mu), flat(st.stats))
                      for n, st in jmodel.states.items()},
            "port16": {n: (flat(_to_flax(n)(model.adam[n].mu)[0]),
                           flat(_to_flax(n)(getattr(model, f"net{n}").state_dict())[1]))
                       for n in model.model_names}}


def test_bf16_step_losses(step, step16):
    assert_bf16_losses(step.losses, *step16["losses"])


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_bf16_step_grads_u_and_running_stats(step, step16, net):
    """Adam's first moment, and every ``u`` and running statistic, of each
    network by the bf16 lane's 2-norm rule."""
    for i, part in enumerate(("mu", "stats")):
        assert_bf16_tree(flat(step.states1[net][1 + i]), step16["jax16"][net][i],
                         step16["port16"][net][i], f"{part} {net}")


@pytest.fixture(scope="module")
def port_steps(step):
    """Port-only steps from copies of the shared step's model before its step
    (``--no_vgg_loss --pool_size 2``): as built, with ``--correct_gan_feat
    true``, and with the seeded VGG19 loss on under ``--no_TTUR``; each
    Adam's lr recorded."""
    import copy

    from vts_torch.losses.vgg import VGG19, init_vgg19_params
    base = copy.deepcopy(step.base)
    base.set_input(_patch_batch())
    out = {}
    for name, flags in (("plain", {}), ("correct", {"correct_gan_feat": True}),
                        ("vgg_no_ttur", {"no_vgg_loss": False, "no_TTUR": True})):
        model = copy.deepcopy(base)
        for k, v in flags.items():
            setattr(model.opt, k, v)
        if name == "vgg_no_ttur":
            model.vgg = VGG19(init_vgg19_params(0))
        model.rates = {}
        for net, adam in model.adam.items():
            adam.step = (lambda step_, net_, m: lambda p, g, lr: (
                m.rates.__setitem__(net_, lr), step_(p, g, lr)))(adam.step, net, model)
        model.optimize_parameters(1)
        out[name] = model
    return out


def test_step_vgg_term_is_the_ported_loss(port_steps):
    m = port_steps["vgg_no_ttur"]
    with torch.no_grad():
        want = m.opt.lambda_vgg * m.vgg_term(m._outputs["fake_I"], m._outputs["fake_T"],
                                             m._input["I"], m._input["T_images"])
    got = m.get_current_losses()["G_VGG"]
    assert got > 0
    np.testing.assert_allclose(got, float(want), rtol=1e-5)


def test_no_ttur_hands_lr_to_every_adam(port_steps, env):  # noqa: F811
    """TTUR: G at lr/2, D and D2 at 2·lr (``--lr_G2`` unread); ``--no_TTUR``
    (here set on a copy, and as parsed): lr for all three."""
    from vts_torch.config import TrainOptions
    lr = port_steps["plain"].opt.lr
    assert port_steps["plain"].rates == {"G": lr / 2, "D": 2 * lr, "D2": 2 * lr}
    assert port_steps["vgg_no_ttur"].rates == {"G": lr, "D": lr, "D2": lr}
    assert port_steps["plain"].opt.lr_G2 != 2 * lr
    opt = TrainOptions().parse(_argv(env, "--no_TTUR") + ["--device", "cpu"], quiet=True)
    assert opt.no_TTUR and port_steps["plain"]._rates.__func__(
        types.SimpleNamespace(opt=opt), lr, 0.0) == (lr, lr, lr)


def test_correct_gan_feat_changes_nothing(port_steps):
    a, b = port_steps["plain"], port_steps["correct"]
    assert a.get_current_losses() == b.get_current_losses()
    for name in ("G", "D", "D2"):
        sa, sb = (getattr(m, f"net{name}").state_dict() for m in (a, b))
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name


# ------------------------------------------------------------- checkpoints ---

def test_checkpoints_cross_both_ways(step, env):  # noqa: F811
    """JAX's G, D and D2 into the port and the port's into JAX: identical
    params, ``u`` and running stats, Adam counts; the test forwards within
    1e-5 of their max."""
    import copy
    jm, model = step.jmodel, step.model
    jm.save_networks("jax")
    ported = copy.deepcopy(step.base)
    ported.load_networks("jax")
    for name in ("G", "D", "D2"):
        got = _to_flax(name)(getattr(ported, f"net{name}").state_dict())
        for want, tree in ((jm.states[name].params, got[0]), (jm.states[name].stats, got[1])):
            a, b = flat(want), flat(tree)
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), name
        assert int(jm.states[name].opt_state.count) == ported.adam[name].count == 1
    model.save_networks("port")
    jm.load_networks("port")
    for name in ("G", "D", "D2"):
        a = flat(jm.states[name].stats)
        b = flat(_to_flax(name)(getattr(model, f"net{name}").state_dict())[1])
        assert all(np.array_equal(a[k], b[k]) for k in a) and any("['u']" in k for k in a)
    for m in (jm, model):
        m.set_input(step.batch)
        m.test()
    for k in ("fake_I", "fake_T"):
        _close(model._outputs[k].numpy(), jm._outputs[k], 1e-5, k)


# ------------------------------------------------------------- .pth import ---

def _reference_spade_state(vae=False, ngf=4, z_dim=8, sw=4, seed=0):
    """A reference ``SPADEGenerator`` state dict (3 upsamplings, spectral
    convs, sync batch norm), as torch's ``spectral_norm`` leaves it."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rnd(*shape):
        return torch.randn(shape, generator=g) * 0.1

    def conv(key, o, i, k, spectral=False, bias=True):
        if spectral:
            sd[f"{key}.weight_orig"] = rnd(o, i, k, k)
            sd[f"{key}.weight_u"] = rnd(o)
            sd[f"{key}.weight_v"] = rnd(i * k * k)
        else:
            sd[f"{key}.weight"] = rnd(o, i, k, k)
        if bias:
            sd[f"{key}.bias"] = rnd(o)

    nf = ngf
    if vae:
        sd["fc.weight"], sd["fc.bias"] = rnd(16 * nf * sw * sw, z_dim), rnd(16 * nf * sw * sw)
    else:
        conv("fc", 16 * nf, 1, 3)
    for blk, fin, fout in (("head_0", 16, 16), ("G_middle_0", 16, 16), ("G_middle_1", 16, 16),
                           ("up_0", 16, 8), ("up_1", 8, 4)):
        fin, fout = fin * nf, fout * nf
        fm = min(fin, fout)
        conv(f"{blk}.conv_0", fm, fin, 3, True)
        conv(f"{blk}.conv_1", fout, fm, 3, True)
        norms = [("norm_0", fin), ("norm_1", fm)]
        if fin != fout:
            conv(f"{blk}.conv_s", fout, fin, 1, True, bias=False)
            norms.append(("norm_s", fin))
        for nm, c in norms:
            conv(f"{blk}.{nm}.mlp_shared.0", 128, 1, 3)
            conv(f"{blk}.{nm}.mlp_gamma", c, 128, 3)
            conv(f"{blk}.{nm}.mlp_beta", c, 128, 3)
            sd[f"{blk}.{nm}.param_free_norm.running_mean"] = rnd(c)
            sd[f"{blk}.{nm}.param_free_norm.running_var"] = rnd(c).abs() + 0.5
            sd[f"{blk}.{nm}.param_free_norm.num_batches_tracked"] = torch.tensor(3)
    conv("conv_img", 5, 4 * nf, 3)
    return sd


@pytest.mark.parametrize("vae", [False, True], ids=["plain", "vae"])
def test_pth_spade_import_matches_jax(vae, tmp_path):
    """The port's converter and CLI (``--arch spade --set ...``) against
    ``vts_tpu``'s: identical params and stats (``u``, ``BatchNorm_0``), the
    VAE ``fc`` permuted from (C, H, W) to (H, W, C); the tree loads into the
    port's G; a 2-D ``fc`` without ``use_vae`` is the reference's
    ``ValueError`` in both."""
    from vts_torch.utils.convert_jax import resnet_params_to_torch, resnet_stats_to_torch
    from vts_torch.utils.convert_torch import convert_checkpoint, main
    from vts_torch.utils.msgpack import msgpack_restore
    from vts_tpu.utils.convert_torch import convert_checkpoint as jax_convert
    path = str(tmp_path / "best_net_G.pth")
    torch.save({f"module.{k}": v for k, v in _reference_spade_state(vae).items()}, path)
    kw = dict(use_vae=True, ngf=4, sh=4, sw=4) if vae else {}
    want = jax_convert(path, "spade", **kw)
    got = convert_checkpoint(path, "spade", **kw)
    out = str(tmp_path / "ckpt" / "best_net_G.msgpack")
    main(["--input", path, "--output", out, "--arch", "spade"]
         + [a for k, v in kw.items() for a in ("--set", f"{k}={int(v)}")])
    with open(out, "rb") as f:
        cli = msgpack_restore(f.read())
    for part in ("params", "stats"):
        a = flat(want[part])
        for tree in (got, cli):
            b = flat(tree[part])
            assert a.keys() == b.keys() and a
            assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    net = _generator(use_vae=vae)
    sd = dict(resnet_params_to_torch(cli["params"]))
    sd.update(resnet_stats_to_torch(cli["stats"]))
    net.load_state_dict(sd)
    if not vae:
        return
    with pytest.raises(ValueError, match="use_vae"):
        jax_convert(path, "spade")
    with pytest.raises(ValueError, match="use_vae"):
        convert_checkpoint(path, "spade")


# ------------------------------------------------- visuals and refusals ---

def test_use_vae_is_refused_and_the_reference_cannot_run_it(env):  # noqa: F811
    """The port refuses ``--use_vae true`` at model creation; the reference's
    ``setup`` initializes its VAE G with the sketch alone
    (``vts_tpu/models/pix2pix.py:115``), which fails on the G's assertion,
    and the train-mode encoder that its step applies without a mutable
    collection raises on ``u`` (both traced abstractly here)."""
    import flax
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_tpu.networks import define_G as jax_define_G
    from vts_tpu.networks.spade_nets import ConvEncoder as JaxEncoder
    opt = TrainOptions().parse(_argv(env, "--use_vae", "true") + ["--device", "cpu"], quiet=True)
    with pytest.raises(ValueError, match="--use_vae"):
        create_model(opt)
    jg = jax_define_G(opt, 1, 5, train=True)
    with pytest.raises(AssertionError, match="VAE mode needs a z sample"):
        jax.eval_shape(lambda: jg.init(KEY, jnp.zeros((1, 32, 32, 1))))
    enc = JaxEncoder(ndf=4, z_dim=8, train=True)
    x = jnp.zeros((1, 256, 256, 3))
    variables = jax.eval_shape(lambda: enc.init(KEY, x))
    with pytest.raises(flax.errors.ModifyScopeVariableError, match="batch_stats"):
        jax.eval_shape(lambda v: enc.apply(v, x), variables)


def test_t_resolution_multiplier_is_refused_and_the_pool_accepted(step, env):  # noqa: F811
    """The x2 multiplier is pix2pix's ``ValueError``; the shared step's
    models, both packages', were built and stepped with ``--pool_size 2``."""
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    with pytest.raises(ValueError, match="--T_resolution_multiplier"):
        create_model(TrainOptions().parse(
            _argv(env, "--T_resolution_multiplier", "2") + ["--device", "cpu"], quiet=True))
    assert type(step.jmodel).__name__ == type(step.model).__name__ == "SPADEModel"
    assert step.jopt.pool_size == step.model.pool_size == 2 and step.model._pool[1] == 2


def test_reference_visuals_fail_and_the_port_leaves_the_d2_map_out(step):
    """As pix2pixHD's: SPADE's parser declares no ``lambda_G2_GAN``, so the
    reference's training visuals raise; with it at 0 its panels equal the
    port's, neither with ``pred_fake_T_full``."""
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


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where CUDA is absent")
@pytest.mark.parametrize("phase", ["train", "test"])
def test_spade_runs_on_cuda_unless_asked_for_the_cpu(phase, tmp_path):
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.models import create_model
    opt = (TrainOptions() if phase == "train" else TestOptions()).parse(
        ["--model", "spade", "--checkpoints_dir", str(tmp_path)], quiet=True)
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        create_model(opt)


# --------------------------------------------------------------- drivers ---

def _drive_argv(tmp):
    return ["--model", "spade", "--name", "drv", "--dataroot", DATA, "--device", "cpu",
            "--ngf", "4", "--ndf", "4", "--crop_size", "256", "--center_w", "192",
            "--center_h", "128", "--checkpoints_dir", str(tmp / "ckpt"),
            "--results_dir", str(tmp / "res")]


def _train_drive(tmp):
    """``vts_torch.train --model spade`` for one epoch of 2 steps of one patch
    (no validation): finite losses, G_GAN_Feat and G_VGG > 0, ``u`` in every
    checkpoint's stats."""
    from vts_torch.train import train as port_train
    from vts_torch.utils.msgpack import msgpack_restore
    model = port_train(_drive_argv(tmp) + ["--batch_size", "1", "--batch_size_G2", "2",
                                           "--n_epochs", "1", "--val_for_each_epoch", "false",
                                           "--no_html", "--print_freq", "1"])
    losses = model.get_current_losses()
    assert model.adam["G"].count == 2 and all(np.isfinite(v) for v in losses.values())
    assert losses["G_GAN_Feat"] > 0 and losses["G_VGG"] > 0
    for name in ("G", "D", "D2"):
        with open(tmp / "ckpt" / "drv" / f"latest_net_{name}.msgpack", "rb") as f:
            stats = flat(msgpack_restore(f.read())["stats"])
        assert any(k.endswith("['u']") for k in stats), name


def test_cpu_train_driver(env):  # noqa: F811
    _train_drive(env / "train_drive")


@pytest.mark.slow
def test_cpu_train_then_test_drivers(env):  # noqa: F811
    """The training drive, then ``vts_torch.test`` on its latest G over the
    256² canvas: 8 finite metrics (``slow``: the metric suite costs tens of
    seconds under the suite's workers; :func:`test_cpu_train_driver` runs
    the training half)."""
    from vts_torch.test import test as port_test
    tmp = env / "drivers"
    _train_drive(tmp)
    metrics = port_test(_drive_argv(tmp) + ["--epoch", "latest", "--batch_size_G2", "1"])
    assert len(metrics) == 1 and len(metrics[0]) == 8
    assert all(np.isfinite(v) for v in metrics[0].values())
    with open(tmp / "res" / "drv" / "test_latest" / "eval_metrics.pkl", "rb") as f:
        assert pickle.load(f).keys() == metrics[0].keys()
    assert os.path.exists(tmp / "res" / "drv" / "test_latest" / "index.html")
