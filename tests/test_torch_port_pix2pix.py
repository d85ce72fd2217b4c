"""The pix2pix slice of the port — the ResNet-9 generator with the blur
resamplers, two ``basic`` PatchGAN Ds and the patchskit dataset — against
``vts_tpu`` on the CPU, at ngf/ndf 4:

  * the blur resamplers against JAX's at odd and even sizes, 1-8 channels
    and every filter size: within 1e-6;
  * ``ResnetGenerator`` on weights carried across by ``convert_jax`` (bit for
    bit both ways): 9 blocks at 64², antialias on and off,
    ``no_antialias_up``, 6 and 4 blocks with replicate and zero padding,
    dropout (inert unless asked for, as in the reference) and the
    ``generate_T_imgs`` x2 stage, batch norm in train and eval mode: the
    output within 1e-5 of its max from JAX's fp32 forward in eval mode; in
    train mode from the reference module's float64 forward (JAX with x64
    on), and from JAX's fp32 forward within that limit plus JAX's own
    distance from float64 (its fp32 batch-stat reductions stray there); the
    running statistics within 1e-6;
  * the patchskit dataset against JAX's on one synthetic garment: every
    patch item, the length and the ``return_patch`` false record, exactly;
  * one training step (shared, module scope: ``TrainOptions`` as
    ``tests/test_baselines.py::build_opt`` builds them, 32² patches at batch
    4, drawn as its ``patch_batch`` draws them, ``resnet_9blocks``): every
    loss within rtol 1e-4; the gradients (Adam's first moment over 1 − β1)
    per leaf within ``_grad_tol`` of ``test_torch_port_train.py`` (the conv
    biases a batch norm follows have an exactly zero gradient, held to 1e-5
    of the network's max); G, D and D2 after the Adam step within 1e-4 of
    each leaf's max |Δ|, except where the gradient itself is within its
    tolerance of zero: Adam's first step moves an element by lr·g/(|g| +
    1e-8), so round-off there may move it the other way, by up to 2·lr (the
    rule of ``test_torch_port_train.py``); the running statistics of all
    three networks within 1e-5;
  * on the dataset's own patches (two or three distinct sketch values a
    patch) G's gradient in fp32 against float64 (JAX with x64 on): the
    port's within 1e-5 of each leaf's max, JAX's own fp32 gradient over
    1e-3 away in some leaf (the reference's fp32 batch-norm backward loses
    accuracy on near-constant inputs) — why the step above runs on random
    patches;
  * the msgpack checkpoints both ways: JAX's G, D and D2 load into the port
    and the port's into JAX (``load_networks``), and the eval forwards agree
    within 1e-5 of their max;
  * the reference's ``.pth`` ResNet generators (9 blocks, with and without
    ``no_antialias``, ``no_antialias_up`` and dropout) through both
    packages' converters: identical arrays;
  * the reference's visuals fault: after a step JAX's ``get_current_visuals``
    raises ``AttributeError`` (``lambda_G2_GAN``); with that option set to 0
    on its ``opt``, its panels equal the port's (within 1e-5), and neither
    has ``pred_fake_T_full``;
  * ``--T_resolution_multiplier 2``: the JAX step fails to trace, the port
    refuses; without ``--device cpu`` the model raises where CUDA is absent;
  * the port's drivers alone at 256²: two epochs of ``vts_torch.train
    --model pix2pix`` with the full-image validation write ``best`` and the
    gallery, and ``vts_torch.test`` on it gives 8 finite metrics.
"""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import CANCELLING, ZERO_GRAD, _grad_tol
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)
from tests.torch_port_step import flat
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

DATA = "synthetic://p2p?size=320&center_w=192&center_h=128&patches=6&val_patches=3"


def _argv(tmp, *extra, phase="train"):
    return ["--model", "pix2pix", "--name", "p2p", "--dataroot", DATA,
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res"),
            "--batch_size", "4", "--ngf", "4", "--ndf", "4", "--crop_size", "256",
            "--center_w", "192", "--center_h", "128", "--data_len", "2",
            *(["--n_epochs", "1", "--n_epochs_decay", "0"] if phase == "train" else []), *extra]


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _patch_batch(b=4, seed=0):
    """``tests/test_baselines.py::patch_batch``."""
    r = np.random.default_rng(seed)
    return {"S": r.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32),
            "I": r.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
            "M": np.ones((b, 32, 32, 1), np.float32),
            "T_images": r.uniform(-1, 1, (b, 1, 32, 32, 2)).astype(np.float32),
            "I_masks": np.ones((b, 1, 32, 32, 1), np.float32)}


def _load_jax_states(model, states):
    from vts_torch.utils.convert_jax import (d_params_to_torch, d_stats_to_torch,
                                             resnet_params_to_torch, resnet_stats_to_torch)
    for name, (params, stats) in states.items():
        to_sd = (resnet_params_to_torch, resnet_stats_to_torch) if name == "G" else \
            (d_params_to_torch, d_stats_to_torch)
        sd = dict(to_sd[0](params))
        sd.update(to_sd[1](stats))
        getattr(model, f"net{name}").load_state_dict(sd)


def _port_model(argv, phase="train"):
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.models import create_model
    opts = TrainOptions() if phase == "train" else TestOptions()
    model = create_model(opts.parse(argv + ["--device", "cpu", "--no_html"], quiet=True))
    model.setup()
    return model


# ------------------------------------------------------------------ blur ---

@pytest.mark.parametrize("h,w,c,filt,pad_type,pad_off",
                         [(16, 16, 1, 3, "reflect", 0), (17, 13, 3, 3, "reflect", 0),
                          (15, 20, 8, 2, "reflect", 0), (12, 9, 5, 4, "replicate", 0),
                          (11, 11, 2, 5, "zero", 1), (14, 18, 4, 7, "reflect", 0),
                          (9, 10, 6, 1, "reflect", 0), (9, 10, 6, 1, "repl", 1)])
def test_blur_downsample_matches_jax(h, w, c, filt, pad_type, pad_off):
    from vts_torch.networks.blocks import blur_downsample
    from vts_tpu.networks.blocks import blur_downsample as jax_blur
    x = np.random.default_rng(h * w + c).uniform(-1, 1, (2, h, w, c)).astype(np.float32)
    want = np.asarray(jax_blur(jnp.asarray(x), filt, 2, pad_type, pad_off))
    got = blur_downsample(torch.from_numpy(x), filt, 2, pad_type, pad_off).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("h,w,c,filt,pad_type",
                         [(8, 8, 1, 4, "repl"), (9, 7, 3, 4, "repl"), (16, 15, 8, 4, "repl"),
                          (6, 11, 2, 3, "reflect"), (7, 7, 4, 2, "zero"),
                          (10, 5, 5, 6, "replicate")])
def test_blur_upsample_matches_jax(h, w, c, filt, pad_type):
    from vts_torch.networks.blocks import blur_upsample
    from vts_tpu.networks.blocks import blur_upsample as jax_blur
    x = np.random.default_rng(h * w + c).uniform(-1, 1, (2, h, w, c)).astype(np.float32)
    want = np.asarray(jax_blur(jnp.asarray(x), filt, 2, pad_type))
    got = blur_upsample(torch.from_numpy(x), filt, 2, pad_type).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


# ------------------------------------------------------------- generator ---

G_VARIANTS = {
    "antialias": dict(),
    "no_antialias": dict(no_antialias=True),
    "no_antialias_up": dict(no_antialias_up=True),
    "replicate_6blocks": dict(padding_type="replicate", n_blocks=6),
    "zero_4blocks_instance": dict(padding_type="zero", n_blocks=4, norm_type="instance"),
    "dropout": dict(use_dropout=True),
    "generate_T_imgs_x2": dict(generate_T_imgs=True, t_resolution_multiplier=2),
}


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("variant", list(G_VARIANTS))
def test_resnet_generator_matches_jax(variant, mode):
    from vts_torch.networks.resnet_gen import ResnetGenerator
    from vts_torch.utils.convert_jax import (resnet_params_to_torch, resnet_stats_to_torch,
                                             torch_to_resnet_params)
    from vts_tpu.networks.resnet_gen import ResnetGenerator as JaxResnetGenerator
    kw = {"n_blocks": 9, "norm_type": "batch", **G_VARIANTS[variant]}
    train = mode == "train"
    x = np.random.default_rng(len(variant)).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    jnet = JaxResnetGenerator(ngf=4, out_nc=5, train=train, init_gain=0.5, **kw)
    v = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.key(1), jnp.asarray(x)))
    stats = v.get("batch_stats", {})
    if stats:                                 # running stats away from their init
        r = np.random.default_rng(7)
        stats = jax.tree_util.tree_map_with_path(
            lambda path, a: (a * r.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                             else a + r.uniform(-0.05, 0.05, a.shape)).astype(np.float32), stats)
        variables = {"params": v["params"], "batch_stats": stats}
    else:
        variables = {"params": v["params"]}
    def apply(dtype):
        vs = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
        if train and stats:
            out, mut = jnet.apply(vs, jnp.asarray(x, dtype), mutable=["batch_stats"])
            return np.asarray(out), jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
        return np.asarray(jnet.apply(vs, jnp.asarray(x, dtype))), stats
    want, want_stats = apply(jnp.float32)
    if train:
        with jax.enable_x64(True):
            exact = apply(jnp.float64)[0]
    else:
        exact = want
    net = ResnetGenerator(1, ngf=4, out_nc=5, **kw).train(train)
    sd = dict(resnet_params_to_torch(variables["params"]))
    sd.update(resnet_stats_to_torch(stats))
    net.load_state_dict(sd)
    params = torch_to_resnet_params(net.state_dict())[0]
    a, b = flat(variables["params"]), flat(params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    # in some processes torch's CPU tanh is off exact by more than this
    # test's limit on its first call, never after: call it once beforehand
    torch.tanh(torch.zeros(want.shape))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    side = 128 if "t_resolution_multiplier" in kw else 64
    assert got.shape == want.shape == (2, side, side, 5)
    scale = np.abs(exact).max()
    assert scale > 1e-3
    assert np.abs(got - exact).max() <= 1e-5 * scale
    # in train mode JAX's own fp32 forward strays from float64 (its batch-stat
    # reductions): the two fp32 forwards are held to the limit plus that stray
    own = np.abs(want - exact).max()
    assert np.abs(got - want).max() <= 1e-5 * scale + own
    ws, gs = flat(want_stats), flat(torch_to_resnet_params(net.state_dict())[1])
    assert ws.keys() == gs.keys() and (len(ws) > 0) == (kw["norm_type"] == "batch")
    for k in ws:
        assert np.abs(ws[k] - gs[k]).max() <= 1e-6, k
    if variant == "dropout":
        with torch.no_grad():
            dropped = net(torch.from_numpy(x), deterministic=False).numpy()
        assert np.isfinite(dropped).all() and np.abs(dropped - got).max() > 1e-3


# --------------------------------------------------------------- dataset ---

@pytest.mark.parametrize("phase", ["train", "test"])
def test_patchskit_dataset_matches_jax(env, phase):  # noqa: F811
    """Training (``return_patch`` true): every patch item and the length;
    the test phase (false): the full record, ``data_len`` of them."""
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.data import create_dataset
    from vts_tpu.config import TestOptions as JaxTestOptions
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.data.patchskit import PatchSkitDataset as JaxPatchSkitDataset
    argv = _argv(env, "--batch_size_G2", "16", phase=phase)
    jopts, opts = (JaxTrainOptions, TrainOptions) if phase == "train" else \
        (JaxTestOptions, TestOptions)
    jds = JaxPatchSkitDataset(jopts().parse(argv, quiet=True))
    ds = create_dataset(opts().parse(argv + ["--device", "cpu"], quiet=True)).dataset
    assert ds.return_patch == (phase == "train") == jds.return_patch
    assert len(ds) == len(jds) == (16 if phase == "train" else 2)
    for i in range(len(jds)):
        want, got = jds[i], ds[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"item {i} {k}")
    if phase == "train":
        assert ds[0]["S"].shape == (32, 32, 1) and ds[0]["T_images"].shape == (1, 32, 32, 2)
        assert not np.array_equal(ds[0]["S"], ds[1]["S"])
    else:
        assert ds[0]["S"].shape == (256, 256, 1) and "T_coords" in ds[0]


# ------------------------------------------------------------------ step ---

@pytest.fixture(scope="module")
def step(env):  # noqa: F811
    """One JAX pix2pix step (``optimize_parameters``) and one port step from
    the same weights and patch batch."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    jopt = JaxTrainOptions().parse(_argv(env), quiet=True)
    jmodel = jax_create_model(jopt)
    batch = _patch_batch()
    jmodel.setup(batch)
    states0 = {k: (_copy(s.params), _copy(s.stats)) for k, s in jmodel.states.items()}
    jmodel.set_input(batch)
    jmodel.optimize_parameters(1)
    losses = jmodel.get_current_losses()
    outputs = dict(jmodel._outputs)
    model = _port_model(_argv(env))
    _load_jax_states(model, states0)
    model.set_input(batch)
    model.optimize_parameters(1)
    return types.SimpleNamespace(jopt=jopt, jmodel=jmodel, batch=batch, states0=states0,
                                 losses=losses, outputs=outputs, model=model,
                                 port_outputs=dict(model._outputs),
                                 states1={k: (_copy(s.params), _copy(s.stats),
                                              _copy(s.opt_state.mu))
                                          for k, s in jmodel.states.items()})


def _to_flax(net):
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_resnet_params
    return torch_to_resnet_params if net == "G" else torch_to_d_params


def test_step_losses(step):
    got = step.model.get_current_losses()
    assert set(got) == set(step.losses) == {"D_fake", "D_real", "D2_fake", "D2_real",
                                            "G_GAN_I", "G_GAN_T", "G_L1", "G_total"}
    for k, v in step.losses.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_step_grads(step, net):
    """Adam's first moment over 1 − β1 (the gradient) per leaf within
    ``_grad_tol``; the leaves at round-off are exactly the D conv biases that
    a batch norm follows."""
    b1 = step.jopt.beta1
    a = {k: v / (1 - b1) for k, v in flat(step.states1[net][2]).items()}
    b = {k: v / (1 - b1) for k, v in flat(_to_flax(net)(step.model.adam[net].mu)[0]).items()}
    assert a.keys() == b.keys()
    assert step.model.adam[net].count == 1
    net_max = max(np.abs(v).max() for v in a.values())
    at_roundoff = {k for k, v in a.items() if np.abs(v).max() <= 1e-5 * net_max}
    assert at_roundoff == {k for k in a if ZERO_GRAD.search(k)}, sorted(at_roundoff)
    assert len(at_roundoff) == (0 if net == "G" else 3)
    assert len([k for k in a if CANCELLING.search(k)]) == (0 if net == "G" else 1)
    for k in a:
        tol = _grad_tol(k, a[k], net_max)
        assert np.abs(a[k] - b[k]).max() <= tol, (net, k, np.abs(a[k] - b[k]).max(), tol)


def _adam_spread(g, tol, lr):
    """How far Adam's first step, lr·g/(|g| + 1e-8), can move between two
    gradients ``tol`` apart around ``g`` (up to 2·lr where |g| ≤ tol)."""
    def u(t):
        return t / (np.abs(t) + 1e-8)
    g = g.astype(np.float64)
    return lr * np.maximum(np.abs(u(g + tol) - u(g)), np.abs(u(g - tol) - u(g)))


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_step_params_and_stats(step, net):
    """Params after the Adam step within 1e-4 of each leaf's max |Δ| plus what
    Adam's first step makes of the gradient tolerance at each element
    (:func:`_adam_spread`: near |g| ≈ 1e-8 the step's normalization turns the
    gradient's round-off into a visible move, and where |g| is within its
    tolerance of zero, into either sign); running statistics within 1e-5."""
    b1 = step.jopt.beta1
    lr = step.jopt.lr if net != "D2" else step.jopt.lr_G2
    params, stats = _to_flax(net)(getattr(step.model, f"net{net}").state_dict())
    p0, p1, g = (flat(t) for t in (step.states0[net][0], step.states1[net][0],
                                   step.states1[net][2]))
    p_got = flat(params)
    assert p1.keys() == p_got.keys()
    net_max = max(np.abs(v).max() for v in g.values()) / (1 - b1)
    for k in p1:
        delta = np.abs(p1[k] - p0[k]).max()
        gk = g[k] / (1 - b1)
        bound = 1e-4 * delta + _adam_spread(gk, _grad_tol(k, gk, net_max), lr)
        assert (np.abs(p_got[k] - p1[k]) <= bound).all(), \
            (net, k, np.abs(p_got[k] - p1[k]).max(), delta)
    s_want, s_got = flat(step.states1[net][1]), flat(stats)
    assert s_want.keys() == s_got.keys() and len(s_want) > 0
    for k in s_want:
        assert np.abs(s_got[k] - s_want[k]).max() <= 1e-5, k


# ------------------------------------------------------- the VisGel step ---

@pytest.fixture(scope="module")
def visgel_step(env):  # noqa: F811
    """One JAX pix2pix step with ``--netG visgel`` (the zoo's cheapest model
    path) and one port step, from the same weights and patch batch: the JAX
    states built from the port's seeded weights (no flax init), as
    ``tests/test_torch_port_pix2pixhd.py`` builds them."""
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_resnet_params
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.models.base import NetState
    argv = _argv(env, "--netG", "visgel")
    jopt = JaxTrainOptions().parse(argv, quiet=True)
    jmodel = jax_create_model(jopt)
    batch = _patch_batch()
    model = _port_model(argv)
    states0 = {}
    for name in ("G", "D", "D2"):
        to_flax = torch_to_resnet_params if name == "G" else torch_to_d_params
        states0[name] = _copy(to_flax(getattr(model, f"net{name}").state_dict()))
    tx = {"G": jmodel.tx_g, "D": jmodel.tx_d, "D2": jmodel.tx_d2}
    jmodel.states = {k: NetState(params=jax.tree_util.tree_map(jnp.asarray, p),
                                 stats=jax.tree_util.tree_map(jnp.asarray, st),
                                 opt_state=tx[k].init(p))
                     for k, (p, st) in states0.items()}
    jmodel._jit_step = jax.jit(jmodel._train_step)
    jmodel.set_input(batch)
    jmodel.optimize_parameters(1)
    # the G loss's cotangent at G's output, for the float64 reference below
    cot = []
    def keep(module, inputs, out):
        out.register_hook(lambda g: cot.append(g.numpy().copy()))
    hook = model.netG.register_forward_hook(keep)
    model.set_input(batch)
    model.optimize_parameters(1)
    hook.remove()
    (ct,) = cot

    def g_vjp(dtype):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
        f = jax.jit(lambda p, x, c: jax.vjp(lambda q: jmodel.netG.apply({"params": q}, x),
                                            p)[1](c)[0])
        return flat(f(cast(states0["G"][0]), jnp.asarray(batch["S"], dtype),
                      jnp.asarray(ct, dtype)))
    g32 = g_vjp(jnp.float32)
    with jax.enable_x64(True):
        g64 = g_vjp(jnp.float64)
    return types.SimpleNamespace(jopt=jopt, jmodel=jmodel, model=model, states0=states0,
                                 losses=jmodel.get_current_losses(),
                                 g_stray={k: np.abs(g32[k] - g64[k]).max() for k in g64},
                                 states1={k: (_copy(s.params), _copy(s.stats),
                                              _copy(s.opt_state.mu))
                                          for k, s in jmodel.states.items()})


def test_visgel_step_losses(visgel_step):
    got = visgel_step.model.get_current_losses()
    assert set(got) == set(visgel_step.losses)
    for k, v in visgel_step.losses.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_visgel_step_grads_params_and_moments(visgel_step, net):
    """Gradients (Adam's first moment over 1 − β1) per leaf within
    ``_grad_tol``, where a leaf whose gradient is round-off (VisGel's
    decoder conv biases, which an instance norm follows, and the D biases of
    :data:`ZERO_GRAD`) is held to 1e-5 of the network's max; G's leaves with
    3× the reference's own fp32 stray from float64 on top (G's vjp at the
    step's weights, patches and G-loss cotangent, in both precisions): an
    instance norm of a near-constant 16² channel in the encoder's s1b3
    amplifies round-off, and there JAX's fp32 gradient is 7% off float64,
    the encoder's earlier leaves ~1%, as the port's; the second moments
    within 2e-4 of their leaf's max plus what the gradient's tolerance makes
    of a square; the params after Adam within :func:`_adam_spread` of JAX's;
    the running statistics within 1e-5."""
    st = visgel_step
    b1 = st.jopt.beta1
    to_flax = _to_flax(net)
    mu = flat(st.states1[net][2])
    a = {k: v / (1 - b1) for k, v in mu.items()}
    adam = st.model.adam[net]
    b = {k: v / (1 - b1) for k, v in flat(to_flax(adam.mu)[0]).items()}
    assert a.keys() == b.keys() and adam.count == 1
    net_max = max(np.abs(v).max() for v in a.values())
    tols = {k: (1e-5 * net_max if np.abs(v).max() <= 1e-5 * net_max
                else _grad_tol(k, v, net_max)) + (3 * st.g_stray[k] if net == "G" else 0.0)
            for k, v in a.items()}
    if net == "G":
        assert {k for k, v in a.items() if np.abs(v).max() <= 1e-5 * net_max} == {
            f"['{c}']['bias']" for c in ("conv_00", "conv_01")}
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= tols[k], (net, k, np.abs(a[k] - b[k]).max(), tols[k])
    nu_want = flat(st.jmodel.states[net].opt_state.nu)
    nu_got = flat(to_flax(adam.nu)[0])
    for k in nu_want:
        assert np.abs(nu_got[k] - nu_want[k]).max() <= 2e-4 * np.abs(nu_want[k]).max() + \
            2 * (1 - st.jopt.beta2) * tols[k] * np.abs(a[k]).max(), k
    lr = st.jopt.lr if net != "D2" else st.jopt.lr_G2
    params, stats = to_flax(getattr(st.model, f"net{net}").state_dict())
    p0, p1, p_got = flat(st.states0[net][0]), flat(st.states1[net][0]), flat(params)
    for k in p1:
        bound = 1e-4 * np.abs(p1[k] - p0[k]).max() + _adam_spread(a[k], tols[k], lr)
        assert (np.abs(p_got[k] - p1[k]) <= bound).all(), (net, k)
    s_want, s_got = flat(st.states1[net][1]), flat(stats)
    assert s_want.keys() == s_got.keys() and (len(s_want) > 0) == (net != "G")
    for k in s_want:
        assert np.abs(s_got[k] - s_want[k]).max() <= 1e-5, k


def test_g_gradient_on_dataset_patches_is_fp64_accurate(step, env):  # noqa: F811
    """G at the step's initial weights on the patchskit dataset's first batch,
    a random cotangent: the port's fp32 gradient within 1e-5 of float64's per
    leaf, JAX's fp32 gradient more than 1e-3 from it in some leaf."""
    from vts_torch.data import create_dataset
    from vts_torch.config import TrainOptions
    batch = next(iter(create_dataset(TrainOptions().parse(
        _argv(env) + ["--device", "cpu"], quiet=True))))
    x = (batch["S"] * batch["M"]).astype(np.float32)
    assert max(np.unique(x[i]).size for i in range(len(x))) <= 4      # near-constant patches
    ct = np.random.default_rng(0).normal(size=x.shape[:3] + (5,)).astype(np.float32)
    jnet = step.jmodel.netG
    params, stats = step.states0["G"]

    def jax_grad(dtype):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731

        @jax.jit
        def grad(p, s, x, ct):
            return jax.vjp(lambda q: jnet.apply({"params": q, "batch_stats": s}, x,
                                                mutable=["batch_stats"])[0], p)[1](ct)[0]
        return flat(grad(cast(params), cast(stats), jnp.asarray(x, dtype), jnp.asarray(ct, dtype)))
    g32 = jax_grad(jnp.float32)
    with jax.enable_x64(True):
        g64 = jax_grad(jnp.float64)
    net = step.model.netG.__class__(1, ngf=4, out_nc=5, norm_type="batch").train()
    _load_jax_states(types.SimpleNamespace(netG=net), {"G": (params, stats)})
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(net(torch.from_numpy(x)), list(net.parameters()),
                                torch.from_numpy(ct))
    gp = flat(_to_flax("G")(dict(zip(names, grads)))[0])
    err_port = {k: np.abs(gp[k] - g64[k]).max() / np.abs(g64[k]).max() for k in g64}
    err_jax = {k: np.abs(g32[k] - g64[k]).max() / np.abs(g64[k]).max() for k in g64}
    assert max(err_port.values()) <= 1e-5, max(err_port.items(), key=lambda kv: kv[1])
    assert max(err_jax.values()) > 1e-3, max(err_jax.values())


# ----------------------------------------------------------- checkpoints ---

def test_checkpoints_cross_both_ways(step, env):  # noqa: F811
    """JAX's G, D and D2 (after its step) into the port, and the port's into
    JAX: the same eval forward (``test()``) within 1e-5 of its max."""
    jm, model = step.jmodel, step.model
    jm.save_networks("jax")
    ported = _port_model(_argv(env, "--epoch", "jax"))
    ported.load_networks("jax")
    for name in ("G", "D", "D2"):
        a = flat(jm.states[name].params)
        b = flat(_to_flax(name)(getattr(ported, f"net{name}").state_dict())[0])
        assert all(np.array_equal(a[k], b[k]) for k in a), name
        assert int(jm.states[name].opt_state.count) == ported.adam[name].count == 1
    jm.set_input(step.batch)
    jm.test()
    ported.set_input(step.batch)
    ported.test()
    for k in ("fake_I", "fake_T"):
        want = np.asarray(jm._outputs[k])
        assert np.abs(ported._outputs[k].numpy() - want).max() <= 1e-5 * np.abs(want).max(), k
    model.save_networks("port")
    jm.load_networks("port")
    jm.test()
    model.set_input(step.batch)
    model.test()
    for k in ("fake_I", "fake_T"):
        got = model._outputs[k].numpy()
        assert np.abs(np.asarray(jm._outputs[k]) - got).max() <= 1e-5 * np.abs(got).max(), k
    assert os.path.exists(env / "ckpt" / "p2p" / "port_opt_D2.msgpack")


# ------------------------------------------------------------ .pth import ---

def _reference_resnet_state(no_antialias, no_antialias_up, use_dropout, ngf=4, n_blocks=9):
    """A reference ``ResnetGenerator`` (instance norm) state dict: conv weights
    and biases at their ``model.{j}`` indices, the blur filters' buffers."""
    g = torch.Generator().manual_seed(int(no_antialias) + 2 * int(no_antialias_up)
                                      + 4 * int(use_dropout))
    sd = {}

    def conv(key, o, i, k, transposed=False):
        sd[f"{key}.weight"] = torch.randn((i, o, k, k) if transposed else (o, i, k, k),
                                          generator=g)
        sd[f"{key}.bias"] = torch.randn((o,), generator=g)
    conv("model.1", ngf, 1, 7)
    per_down = 3 if no_antialias else 4
    for i in range(2):
        conv(f"model.{4 + per_down * i}", ngf * 2 ** (i + 1), ngf * 2 ** i, 3)
        if not no_antialias:
            sd[f"model.{4 + per_down * i + 3}.filt"] = torch.ones(ngf * 2 ** (i + 1), 1, 3, 3)
    s0 = 4 + per_down * 2
    for b in range(n_blocks):
        conv(f"model.{s0 + b}.conv_block.1", 4 * ngf, 4 * ngf, 3)
        conv(f"model.{s0 + b}.conv_block.{6 if use_dropout else 5}", 4 * ngf, 4 * ngf, 3)
    s1 = s0 + n_blocks
    for i in range(2):
        cin, cout = ngf * 2 ** (2 - i), ngf * 2 ** (1 - i)
        if no_antialias_up:
            conv(f"model.{s1 + 3 * i}", cout, cin, 3, transposed=True)
        else:
            sd[f"model.{s1 + 4 * i}.filt"] = torch.ones(cin, 1, 4, 4)
            conv(f"model.{s1 + 4 * i + 1}", cout, cin, 3)
    conv(f"model.{s1 + (3 if no_antialias_up else 4) * 2 + 1}", 5, ngf, 7)
    return sd


@pytest.mark.parametrize("no_antialias,no_antialias_up,use_dropout",
                         [(False, False, False), (True, False, False), (False, True, False),
                          (True, True, True)],
                         ids=["antialias", "no_antialias", "no_antialias_up", "all_dropout"])
def test_pth_resnet_import_matches_jax(no_antialias, no_antialias_up, use_dropout, tmp_path):
    """The port's converter and CLI (``--arch resnet_9blocks --set ...``)
    against ``vts_tpu``'s: identical arrays, and the tree loads into the
    port's instance-norm ResnetGenerator."""
    from vts_torch.networks.resnet_gen import ResnetGenerator
    from vts_torch.utils.convert_jax import resnet_params_to_torch
    from vts_torch.utils.convert_torch import convert_resnet, main
    from vts_torch.utils.msgpack import msgpack_restore
    from vts_tpu.utils.convert_torch import convert_checkpoint as jax_convert_checkpoint
    from vts_tpu.utils.convert_torch import convert_resnet as jax_convert_resnet
    kw = dict(no_antialias=no_antialias, no_antialias_up=no_antialias_up,
              use_dropout=use_dropout)
    sd = _reference_resnet_state(**kw)
    want, got = flat(jax_convert_resnet(sd, n_blocks=9, **kw)), flat(convert_resnet(sd, 9, **kw))
    assert want.keys() == got.keys()
    assert all(np.array_equal(want[k], got[k]) and want[k].dtype == got[k].dtype for k in want)
    path = str(tmp_path / "best_net_G.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    out = str(tmp_path / "ckpt" / "best_net_G.msgpack")
    main(["--input", path, "--output", out, "--arch", "resnet_9blocks"]
         + [a for k, v in kw.items() for a in ("--set", f"{k}={'1' if v else 'false'}")])
    with open(out, "rb") as f:
        payload = msgpack_restore(f.read())
    ref = jax_convert_checkpoint(path, "resnet_9blocks", **kw)
    a, b = flat(ref["params"]), flat(payload["params"])
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert payload["stats"] == {} == ref["stats"]
    net = ResnetGenerator(1, ngf=4, out_nc=5, norm_type="instance", **kw)
    net.load_state_dict(resnet_params_to_torch(payload["params"]))


# ------------------------------------------------- visuals and refusals ---

def test_reference_visuals_fail_and_the_port_leaves_the_d2_map_out(step):
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
    assert {"real_S", "real_I", "M", "fake_I", "fake_gx", "fake_gy", "fake_N"} <= set(got)
    for k in want:
        w = np.asarray(want[k], np.float32)
        assert np.abs(got[k] - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), k


def test_t_resolution_multiplier_fails_in_the_reference_and_is_refused(env):  # noqa: F811
    """At x2 JAX's G keeps the touch output at the patch size while it
    multiplies it by the 2× mask: the step does not trace.  The port raises
    ValueError at model creation."""
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.models.base import init_net_state
    argv = _argv(env, "--T_resolution_multiplier", "2")
    jm = jax_create_model(JaxTrainOptions().parse(argv, quiet=True))
    s = jnp.zeros((4, 32, 32, 1))
    key = jax.random.key(0)
    states = [jax.eval_shape(lambda k, n=net, t=tx, c=c: init_net_state(n, k, t, jnp.zeros(
        (4, 32 * m, 32 * m, c))), key)
        for net, tx, c, m in ((jm.netG, jm.tx_g, 1, 1), (jm.netD, jm.tx_d, 4, 1),
                              (jm.netD2, jm.tx_d2, 3, 2))]
    batch = {k: jnp.zeros(v.shape) for k, v in _patch_batch().items()}
    batch["T_images"] = jnp.zeros((4, 64, 64, 2))
    batch["I_masks"] = jnp.zeros((4, 64, 64, 1))
    with pytest.raises((TypeError, ValueError), match="shapes|broadcast|Incompatible"):
        jax.eval_shape(jm._train_step, *states, batch, key, jnp.float32(1e-3),
                       jnp.float32(5e-4), jnp.int32(1))
    assert s.shape[1] * 2 == batch["T_images"].shape[1]
    with pytest.raises(ValueError, match="--T_resolution_multiplier"):
        create_model(TrainOptions().parse(argv + ["--device", "cpu"], quiet=True))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where CUDA is absent")
@pytest.mark.parametrize("phase", ["train", "test"])
def test_pix2pix_runs_on_cuda_unless_asked_for_the_cpu(phase, tmp_path):
    """Without ``--device cpu`` the model asks for CUDA and raises where there
    is none; it never falls back to the CPU."""
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.models import create_model
    opt = (TrainOptions() if phase == "train" else TestOptions()).parse(
        ["--model", "pix2pix", "--checkpoints_dir", str(tmp_path)], quiet=True)
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        create_model(opt)


# --------------------------------------------------------------- drivers ---

def test_cpu_train_then_test_drivers(env):  # noqa: F811
    """``vts_torch.train --model pix2pix`` for 2 epochs of 2 steps of one
    patch (2 touch squares), the full-image validation each epoch, the
    gallery; then ``vts_torch.test`` on its best G over the 256² canvas."""
    from vts_torch.test import test as port_test
    from vts_torch.train import train as port_train
    tmp = env / "drivers"
    common = ["--model", "pix2pix", "--name", "drv", "--dataroot", DATA, "--device", "cpu",
              "--ngf", "4", "--ndf", "4", "--crop_size", "256", "--center_w", "192",
              "--center_h", "128", "--checkpoints_dir", str(tmp / "ckpt"),
              "--results_dir", str(tmp / "res")]
    model = port_train(common + ["--batch_size", "1", "--batch_size_G2", "2",
                                 "--batch_size_G2_val", "1", "--n_epochs", "2",
                                 "--n_epochs_decay", "0",
                                 "--val_for_each_epoch", "true", "--display_freq", "2",
                                 "--print_freq", "1"])
    assert all(np.isfinite(v) for v in model.get_current_losses().values())
    ck = tmp / "ckpt" / "drv"
    for name in ("G", "D", "D2"):
        assert all((ck / f"best_{kind}_{name}.msgpack").exists() for kind in ("net", "opt"))
    images = os.listdir(ck / "web" / "images")
    assert any("fake_I" in f for f in images) and not any("pred_fake_T_full" in f for f in images)
    metrics = port_test(common + ["--epoch", "best", "--batch_size_G2", "1"])
    assert len(metrics) == 1 and len(metrics[0]) == 8
    assert all(np.isfinite(v) for v in metrics[0].values())
    web = tmp / "res" / "drv" / "test_best"
    with open(web / "eval_metrics.pkl", "rb") as f:
        assert pickle.load(f).keys() == metrics[0].keys()
    assert (web / "index.html").exists()
    assert any(f.endswith("_fake_gxgy_raw.npz") for f in os.listdir(web / "images"))
