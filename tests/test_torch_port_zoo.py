"""The rest of the network zoo in the port — the plain U-Net, VisGel, MUNIT's
``resnet_cat`` and the StyleGAN2 G and Ds — against ``vts_tpu`` on the CPU:

  * each network on the port's seeded weights carried by ``convert_jax`` into
    a tree of the reference module's paths and shapes (its
    ``jax.eval_shape``d init): the forward within 1e-5 of its max, the input
    gradient and every parameter's gradient (a random cotangent) within 1e-4
    of each leaf's max, a leaf whose gradient is round-off (a conv bias that
    an instance norm follows) within 1e-5 of the network's max, and the batch
    statistics after a train forward within 1e-6; the U-Nets (256, 128) in
    train and eval mode under batch norm and under instance norm, VisGel ×1
    and ×2, ``GResnet`` with no z and with a z of width 0 (a z of width 8
    fails in both), both StyleGAN2 Gs (the full one with the reference's
    ``normal(key(0))`` noise injected and a nonzero strength) and both Ds;
  * the resamplers alone: ``fir_filter`` up, down and padded, ``blur``,
    ``upsample2``, ``downsample2``, and VisGel's bilinear resize (×2 and odd
    sizes), within 1e-6;
  * the checkpoints: a port-written ``latest_net_G.msgpack`` (and D's) of
    each family loads in ``vts_tpu`` with the same forward, ``vts_tpu``'s
    load in the port, and the converters' round trip is exact;
  * the refusals: each combination the reference cannot run raises naming
    its flag, with the reference's own failure beside it; the ones it runs
    parse and build;
  * sinskit's ``--dtype bfloat16`` step at batch 1 with ``--netG unet_256``
    and with ``--netG visgel`` (D3 off) against JAX's bf16 step, both from
    the port's seeded weights (JAX's states built from them, no flax init),
    by the bf16 lane's rules (``tests/torch_port_step.py``) with JAX's fp32
    step as the reference: per loss |port16 − jax16| ≤ 2·|jax16 − jax32| +
    1e-3·|jax32|, per network ‖port16 − jax16‖/‖jax32‖ ≤ 2·‖jax16 −
    jax32‖/‖jax32‖ + 1e-3 over Adam's first moment and the running stats
    and the running stats, G's bound plus the 2-norm near-tie rule: how far
    JAX's own fp32 G gradient moves under a 1e-6 relative change of G's
    weights (the canvas and touch LPIPS's max-pool near-ties: under VisGel
    it moves by ~1.7e-2, and the port's fp32 step sits ~6e-3 from JAX's);
    VisGel's convs stay fp32 under bf16 in both;
  * the port's drivers alone: one sinskit step of ``vts_torch.train`` with
    ``--netG unet_256 --netD stylegan2 --netD2 stylegan2`` at 256², then
    ``vts_torch.test`` on it: finite losses and 8 finite metrics.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)
from tests.torch_port_step import argv as sinskit_argv
from tests.torch_port_step import (assert_bf16_losses, assert_bf16_tree, flat, jax_batch,
                                   jax_draws, rel_norm)
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rng(seed):
    return np.random.default_rng(seed)


def _to_flax(net):
    """The port model's converters for ``net`` (a G or a D), by its family."""
    from vts_torch.models.sinskit import SinSKITModel
    name = "G" if "Generator" in type(net).__name__ or type(net).__name__ == "GResnet" else "D"
    return SinSKITModel._converters(types.SimpleNamespace(**{f"net{name}": net}), name)


# ----------------------------------------------------------- the networks ---

def _unet(nd, norm):
    from vts_torch.networks.unet_plain import UnetGenerator
    from vts_tpu.networks.unet_plain import UnetGenerator as J
    return (lambda train: J(ngf=4, out_nc=5, num_downs=nd, norm_type=norm, train=train),
            UnetGenerator(3, ngf=4, out_nc=5, num_downs=nd, norm_type=norm,
                          init_gain=0.5), (2, 2 ** nd, 2 ** nd, 3), ())


def _visgel(mult):
    from vts_torch.networks.visgel import VisGelGenerator
    from vts_tpu.networks.visgel import VisGelGenerator as J
    return (lambda train: J(out_nc=5, t_resolution_multiplier=mult, train=train),
            VisGelGenerator(1, out_nc=5, t_resolution_multiplier=mult),
            (2, 32, 32, 1), ())


def _gresnet(z):
    from vts_torch.networks.munit import GResnet
    from vts_tpu.networks.munit import GResnet as J
    extra = () if z is None else (np.zeros((2, z), np.float32),)
    return (lambda train: J(ngf=4, out_nc=5, train=train),
            GResnet(3, ngf=4, out_nc=5, init_gain=0.5), (2, 64, 64, 3), extra)


def _sg_g(small):
    from vts_torch.networks.stylegan2 import StyleGAN2Generator
    from vts_tpu.networks.stylegan2 import StyleGAN2Generator as J
    nb = 2 if small else None
    return (lambda train: J(ngf=4, out_nc=5, n_blocks=nb, crop_size=64),
            StyleGAN2Generator(3, ngf=4, out_nc=5, n_blocks=nb, crop_size=64),
            (2, 64, 64, 3), ())


def _sg_d(tile):
    from vts_torch.networks.stylegan2 import StyleGAN2Discriminator
    from vts_tpu.networks.stylegan2 import StyleGAN2Discriminator as J
    shape = (2, 64, 64, 4) if tile else (8, 32, 32, 7)
    return (lambda train: J(ndf=4, tile=tile, crop_size=64),
            StyleGAN2Discriminator(shape[-1], ndf=4, tile=tile, crop_size=64,
                                   input_size=shape[1:3]), shape, ())


NETS = {
    "unet_256_batch": lambda: _unet(8, "batch"),
    "unet_128_batch": lambda: _unet(7, "batch"),
    "unet_256_instance": lambda: _unet(8, "instance"),
    "visgel_x1": lambda: _visgel(1),
    "visgel_x2": lambda: _visgel(2),
    "resnet_cat": lambda: _gresnet(None),
    "resnet_cat_z0": lambda: _gresnet(0),
    "stylegan2_g": lambda: _sg_g(False),
    "smallstylegan2_g": lambda: _sg_g(True),
    "stylegan2_d": lambda: _sg_d(False),
    "tilestylegan2_d": lambda: _sg_d(True),
}
# the nets whose train and eval forwards differ (batch norm)
TWO_MODES = ("unet_256_batch", "unet_128_batch")


def _jax_noise(net, x_shape):
    """The reference's noise, ``normal(key(0), (n, h, w, 1))``, put into each
    StyledConv of the port's G at the shape it will see."""
    n, h, w = x_shape[:3]
    for m in net.styled_convs():
        m.noise[(n, h, w)] = torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.key(0), (n, h, w, 1), jnp.float32)))


def _seeded(name, train):
    make_j, net, shape, extra = NETS[name]()
    net.reset_parameters(torch.Generator().manual_seed(len(name)))
    if name == "stylegan2_g":
        with torch.no_grad():
            for m in net.styled_convs():
                m.noise_strength.fill_(0.3)
        _jax_noise(net, shape)
    if name.startswith("unet") and "batch" in name:     # running stats away from their init
        r = _rng(7)
        with torch.no_grad():
            for k, t in net.state_dict().items():
                if k.endswith(".mean"):
                    t.copy_(torch.from_numpy(r.uniform(-0.05, 0.05, t.shape).astype(np.float32)))
                elif k.endswith(".var"):
                    t.copy_(torch.from_numpy(r.uniform(0.5, 1.5, t.shape).astype(np.float32)))
    net.train(train)
    jnet = make_j(train)
    x = _rng(len(name) + 1).uniform(-1, 1, shape).astype(np.float32)
    to_flax = _to_flax(net)[0]
    params, stats = to_flax(net.state_dict())
    ref = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x), *extra)
    assert _shapes(ref["params"]) == _shapes(params)
    assert _shapes(ref.get("batch_stats", {})) == _shapes(stats)
    return jnet, net, x, extra, params, stats, to_flax


def _jax_vjp(jnet, params, stats, x, extra, ct, train):
    """The reference's forward, batch stats after a train forward, and the
    parameter and input gradients for the cotangent ``ct``, jitted."""

    @jax.jit
    def run(p, s, xx, e, c):
        def f(p, xx):
            vs = {"params": p, **({"batch_stats": s} if s else {})}
            if train and s:
                out, mut = jnet.apply(vs, xx, *e, mutable=["batch_stats"])
                return out, mut["batch_stats"]
            return jnet.apply(vs, xx, *e), s
        out, vjp, new_stats = jax.vjp(f, p, xx, has_aux=True)
        return out, vjp(c), new_stats

    out, (gp, gx), new_stats = run(params, stats, jnp.asarray(x),
                                   tuple(jnp.asarray(e) for e in extra), jnp.asarray(ct))
    return np.asarray(out), flat(gp), np.asarray(gx), flat(new_stats)


# VisGel's encoder (15 instance norms over shrinking maps) and a D's one logit
# a sample (a sum of 4·4·ch terms of either sign) are ill-conditioned: two
# fp32 forwards, each summing in its own order, differ there by up to 3.4e-5
# of the max (read), so those forwards are held to 1e-4 of it
ILL_CONDITIONED = ("visgel_x1", "visgel_x2", "stylegan2_d", "tilestylegan2_d")
# the tier-1 lane keeps one net of each kind within its budget; VisGel's
# forward and gradients are held there by the pix2pix VisGel step
# (tests/test_torch_port_pix2pix.py)
SLOW_NETS = ("unet_256_batch", "unet_256_instance", "visgel_x1", "visgel_x2", "resnet_cat_z0",
             "stylegan2_g", "stylegan2_d", "resnet_cat", "unet_128_batch_eval")
NET_CASES = ([pytest.param(n, "train", marks=[pytest.mark.slow] if n in SLOW_NETS else [])
              for n in NETS]
             + [pytest.param(n, "eval", marks=[pytest.mark.slow] if f"{n}_eval" in SLOW_NETS
                             or n in SLOW_NETS else []) for n in TWO_MODES])


@pytest.mark.parametrize("name,mode", NET_CASES)
def test_network_matches_jax(name, mode):
    """Forward, input gradient, every parameter gradient and the batch stats
    after a train forward against the reference module (the nets without
    batch statistics have one forward, taken in train mode): the forward
    within 1e-5 of its max (1e-4 for :data:`ILL_CONDITIONED`), the input
    gradient and each parameter's within 1e-4 of its max (a leaf whose
    gradient is round-off, a conv bias that an instance norm follows, within
    1e-5 of the network's max), the stats within 1e-6."""
    train = mode == "train"
    jnet, net, x, extra, params, stats, to_flax = _seeded(name, train)
    xt = torch.from_numpy(x).requires_grad_(True)
    names = [k for k, _ in net.named_parameters()]
    torch.tanh(torch.zeros(8))                 # torch's CPU tanh: once before a tight test
    got = net(xt, *(torch.from_numpy(e) for e in extra))
    ct = _rng(3).normal(size=got.shape).astype(np.float32)
    grads = torch.autograd.grad(got, [xt] + list(net.parameters()), torch.from_numpy(ct))
    got = got.detach().numpy()
    want, want_gp, want_gx, want_stats = _jax_vjp(jnet, params, stats, x, extra, ct, train)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1e-3
    rel = 1e-4 if name in ILL_CONDITIONED else 1e-5
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale
    assert np.abs(grads[0].numpy() - want_gx).max() <= 1e-4 * np.abs(want_gx).max()
    b = flat(to_flax(dict(zip(names, grads[1:])))[0])
    assert want_gp.keys() == b.keys() and len(b) == len(names)
    net_max = max(np.abs(v).max() for v in want_gp.values())
    for k, w in want_gp.items():
        leaf = np.abs(w).max()
        bound = 1e-5 * net_max if leaf <= 1e-5 * net_max else 1e-4 * leaf
        assert np.abs(b[k] - w).max() <= bound, (k, np.abs(b[k] - w).max(), leaf)
    gs = flat(to_flax(net.state_dict())[1])
    assert want_stats.keys() == gs.keys() and (len(gs) > 0) == (name in TWO_MODES)
    for k in want_stats:
        assert np.abs(want_stats[k] - gs[k]).max() <= 1e-6, k


def test_dropout_never_fires_by_default():
    """The plain U-Net's dropout (ups nd//2 ≤ i < nd−1) is off under the
    default ``deterministic=True``, which every model uses; asked for, it
    changes the output."""
    from vts_torch.networks.unet_plain import UnetGenerator
    net = UnetGenerator(3, ngf=4, out_nc=5, num_downs=7, norm_type="instance",
                        use_dropout=True, init_gain=0.5)
    net.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rng(0).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        a, b, c = net(x), net(x), net(x, deterministic=False)
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-3


def test_gresnet_with_a_z_fails_in_both():
    """A z of width 8: the first decoder block adds its (features + 8)-channel
    input to its output of ``features`` channels, in the reference and in
    the port alike (which names the fault)."""
    from vts_torch.networks.munit import GResnet
    from vts_tpu.networks.munit import GResnet as J
    x = np.zeros((2, 32, 32, 3), np.float32)
    z = np.ones((2, 8), np.float32)
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        jax.eval_shape(J(ngf=4, out_nc=5).init, jax.random.key(0), jnp.asarray(x),
                       jnp.asarray(z))
    with pytest.raises(ValueError, match="z of width 8"):
        GResnet(3, ngf=4, out_nc=5)(torch.from_numpy(x), torch.from_numpy(z))


def test_stylegan2_noise_is_fixed_and_not_saved():
    """One standard-normal map per shape, drawn once from the seeded module
    and the same on every call; none of it among the parameters or the
    state dict, so Adam never steps it and no checkpoint holds it."""
    from vts_torch.networks.stylegan2 import StyleGAN2Generator
    net = StyleGAN2Generator(3, ngf=4, out_nc=5, crop_size=64)
    net.reset_parameters(torch.Generator().manual_seed(0))
    sc = net.styled_convs()[0]
    a = sc.fixed_noise(2, 8, 8, "cpu")
    assert torch.equal(a, sc.fixed_noise(2, 8, 8, "cpu"))
    assert abs(float(a.mean())) < 0.5 and 0.5 < float(a.std()) < 1.5
    twin = StyleGAN2Generator(3, ngf=4, out_nc=5, crop_size=64)
    twin.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(a, twin.styled_convs()[0].fixed_noise(2, 8, 8, "cpu"))
    assert not any("noise" in k and "strength" not in k for k in net.state_dict())
    assert sum(p.numel() for p in net.parameters()) == sum(
        t.numel() for t in net.state_dict().values())


def test_stylegan2_stddev_is_group_major():
    """The minibatch stddev of 8 samples in 4 groups: sample i's value is
    the (i // 4)-th group statistic, taken over samples j ≡ i (mod 2), as the
    reference orders them."""
    from vts_torch.networks.stylegan2 import StyleGAN2Discriminator
    d = StyleGAN2Discriminator(3, ndf=4, input_size=(8, 8))
    seen = {}
    d.get_submodule(d.final).register_forward_hook(
        lambda m, inp, out: seen.update(h=inp[0]))
    d.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        d(torch.from_numpy(_rng(0).normal(size=(8, 8, 8, 3)).astype(np.float32)))
    s = seen["h"][..., -1]                        # (8, 4, 4), constant per sample
    h = seen["h"][..., :-1]
    g = h.reshape(4, 2, *h.shape[1:])
    want = torch.sqrt(torch.var(g, 0, unbiased=False) + 1e-8).mean(dim=(1, 2, 3))
    assert torch.allclose(s[:, 0, 0], want.repeat_interleave(4)[:8])
    assert not torch.allclose(s[:, 0, 0], want.repeat(4)[:8])


# ------------------------------------------------------------ resamplers ---

@pytest.mark.parametrize("up,down,pad,shape", [
    (1, 1, (2, 1), (2, 9, 7, 3)), (1, 1, (1, 1), (1, 8, 8, 2)), (2, 1, (2, 1), (2, 5, 6, 3)),
    (1, 2, (1, 1), (2, 10, 9, 4)), (2, 2, (1, 2), (1, 7, 7, 2)), (1, 1, (0, 0), (1, 6, 6, 1))])
def test_fir_filter_matches_jax(up, down, pad, shape):
    from vts_torch.networks.stylegan2 import _fir_kernel, fir_filter
    from vts_tpu.networks.stylegan2 import fir_filter as J
    x = _rng(sum(shape)).uniform(-1, 1, shape).astype(np.float32)
    k = _fir_kernel((1, 3, 3, 1), gain=up * up)
    want = np.asarray(J(jnp.asarray(x), k, up=up, down=down, pad=pad))
    got = fir_filter(torch.from_numpy(x), k, up=up, down=down, pad=pad).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("fn", ["blur", "upsample2", "downsample2"])
def test_stylegan2_resamplers_match_jax(fn):
    import vts_torch.networks.stylegan2 as P
    import vts_tpu.networks.stylegan2 as J
    x = _rng(5).uniform(-1, 1, (2, 12, 10, 3)).astype(np.float32)
    want = np.asarray(getattr(J, fn)(jnp.asarray(x)))
    got = getattr(P, fn)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((5, 7), (10, 14)),
                                     ((30, 30), (32, 32)), ((9, 6), (13, 11))])
def test_visgel_bilinear_matches_jax(src, dst):
    """``jax.image.resize(..., "linear")`` upward (the edge taps outside the
    image dropped and the weights renormalised) against ``F.interpolate``'s
    bilinear with half-pixel centers."""
    from vts_torch.networks.visgel import resize_linear
    x = _rng(src[0]).uniform(-1, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), "linear"))
    got = resize_linear(torch.from_numpy(x), dst).numpy()
    assert np.abs(got - want).max() <= 1e-6


# ----------------------------------------------------------- checkpoints ---

CKPT_NETS = [pytest.param(n, marks=[pytest.mark.slow])
             for n in ("unet_256_batch", "visgel_x1", "resnet_cat", "tilestylegan2_d",
                       "stylegan2_g")] + ["unet_128_batch"]


@pytest.mark.parametrize("name", CKPT_NETS)
def test_checkpoints_cross_both_ways(name, tmp_path):
    """The port's checkpoint writer → ``vts_tpu``'s ``load_net`` into a state
    of the reference module: the same eval forward within 1e-4 of its max (a
    mapping fault moves it by O(1); VisGel's fp32 forwards differ by ~3e-5);
    the reverse from a ``vts_tpu``-written file (its ``save_net`` of a tree of
    its module's paths and shapes); and the converters' round trip exact, on
    the port's tree and on JAX's."""
    from vts_torch.models.base import load_net, save_net
    from vts_tpu.models.base import NetState, load_net as jax_load_net
    from vts_tpu.models.base import save_net as jax_save_net
    jnet, net, x, extra, params, stats, to_flax = _seeded(name, False)
    _, params_to_torch, stats_to_torch = _to_flax(net)
    jx = (jnp.asarray(x),) + tuple(jnp.asarray(e) for e in extra)
    tx = (torch.from_numpy(x),) + tuple(torch.from_numpy(e) for e in extra)
    apply = jax.jit(lambda st, *a: jnet.apply(
        {"params": st.params, **({"batch_stats": st.stats} if st.stats else {})}, *a))
    tree = jax.eval_shape(jnet.init, jax.random.key(0), *jx)
    r = _rng(4)
    draw = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (0.05 * r.standard_normal(a.shape) + (1.0 if a.ndim == 1 else 0.0)
                   ).astype(np.float32), t)

    def same(state):
        want = np.asarray(apply(state, *jx))
        with torch.no_grad():
            got = net(*tx).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    ckpt = str(tmp_path)
    save_net(ckpt, "latest", "G", params, stats)
    template = NetState(params=tree["params"], stats=tree.get("batch_stats", {}), opt_state=None)
    same(jax_load_net(ckpt, "latest", "G", template))
    # a tree that vts_tpu writes: its module's paths and shapes, drawn values
    # (the 1-D leaves, running variances among them, near 1)
    jstate = NetState(params=draw(tree["params"]), stats=draw(tree.get("batch_stats", {})),
                      opt_state=None)
    jax_save_net(ckpt, "jax", "G", jstate)
    assert load_net(ckpt, "jax", "G", net, params_to_torch, stats_to_torch)
    same(jstate)
    sd = net.state_dict()
    back = dict(params_to_torch(to_flax(sd)[0]))
    if stats_to_torch is not None:
        back.update(stats_to_torch(to_flax(sd)[1]))
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    a, b = flat(jstate.params), flat(to_flax(params_to_torch(jstate.params))[0])
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# -------------------------------------------------------------- refusals ---
# Each combination the reference cannot run fails in its step at one module
# (traced in the whole step once, by hand); the tests show that module's
# failure, shapes only, beside the port's refusal by name.

# ------------------------------------------------------- the bf16 steps ---

@pytest.fixture(scope="module", params=["unet_256", "visgel"])
def zoo16(env, request):  # noqa: F811
    """{"jax32", "jax16", "port16"}: each {"losses", net: {"mu", "stats"}}
    after one sinskit step at batch 1 with the zoo G ``request.param``."""
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.models.base import NetState
    from tests.torch_port_step import port_model
    zoo = ["--netG", request.param]
    jopt, batch = jax_batch(env, 1, extra=zoo)
    jopt16, _ = jax_batch(env, 1, extra=zoo + ["--dtype", "bfloat16"])
    model = port_model(env, 1, extra=zoo + ["--dtype", "bfloat16"])
    jm = jax_create_model(jopt)
    txs = {"G": jm.tx_g, "D": jm.tx_d, "D2": jm.tx_d2}
    states0 = {}
    for name in ("G", "D", "D2"):
        params, stats = model._converters(name)[0](getattr(model, f"net{name}").state_dict())
        params = jax.tree_util.tree_map(jnp.asarray, params)
        states0[name] = NetState(params=params, stats=jax.tree_util.tree_map(jnp.asarray, stats),
                                 opt_state=txs[name].init(params))
    jm.set_input(batch)
    out = {}
    for key, m in (("jax32", jm), ("jax16", jax_create_model(jopt16))):
        fn = jax.jit(functools.partial(m._train_step, use_d3=False))
        gS, dS, d2S, losses, _ = fn(states0["G"], states0["D"], states0["D2"], jm._input, jm.rng,
                                    jnp.float32(jopt.lr), jnp.float32(jopt.lr_G2),
                                    jnp.int32(1), {"lpips": jm.lpips_params})
        out[key] = {"losses": {k: float(v) for k, v in losses.items()}}
        for name, st in (("G", gS), ("D", dS), ("D2", d2S)):
            out[key][name] = {"stats": flat(st.stats), "mu": flat(st.opt_state.mu)}
        if key == "jax32":       # the near-tie jump: G's weights × (1 + 1e-6·N(0, 1))
            noise = np.random.default_rng(0)
            params = jax.tree_util.tree_map(
                lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)),
                states0["G"].params)
            g1 = fn(states0["G"].replace(params=params, opt_state=txs["G"].init(params)),
                    states0["D"], states0["D2"], jm._input, jm.rng, jnp.float32(jopt.lr),
                    jnp.float32(jopt.lr_G2), jnp.int32(1), {"lpips": jm.lpips_params})[0]
            out["near_tie"] = rel_norm(flat(g1.opt_state.mu), out[key]["G"]["mu"])
    model.set_input(batch)
    draws = jax_draws(jm.rng, 1, jnp.bfloat16)
    if request.param == "visgel":
        # DiffAugment draws in its image's dtype: VisGel's fake stays fp32
        draws["aug_fake"] = jax_draws(jm.rng, 1, jnp.float32)["aug_fake"]
    model.optimize_parameters(epoch=1, draws=draws)
    out["port16"] = {"losses": model.get_current_losses()}
    for name in ("G", "D", "D2"):
        to_flax = model._converters(name)[0]
        out["port16"][name] = {
            "stats": flat(to_flax(getattr(model, f"net{name}").state_dict())[1]),
            "mu": flat(to_flax(dict(model.adam[name].mu))[0])}
    return out


def test_bf16_step_losses(zoo16):
    assert_bf16_losses(*(zoo16[k]["losses"] for k in ("jax32", "jax16", "port16")))


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_bf16_step_grads_and_stats(zoo16, net):
    ref, want, got = (zoo16[k][net] for k in ("jax32", "jax16", "port16"))
    for part in ("mu", "stats"):
        assert_bf16_tree(ref[part], want[part], got[part], f"{part} {net}",
                         near_tie=zoo16["near_tie"] if (net, part) == ("G", "mu") else 0.0)


def _port_opt(tmp, model, extra):
    from vts_torch.config import TrainOptions
    if model == "sinskit":
        argv = sinskit_argv(tmp, extra=["--batch_size_G2", "4"] + list(extra))
    else:
        from tests.test_torch_port_pix2pix import _argv
        argv = ["--model", model] + _argv(tmp)[2:] + list(extra)
    return TrainOptions().parse(argv + ["--device", "cpu"], quiet=True)


def _jax_unet_on_a_patch(nd):
    from vts_tpu.networks.unet_plain import UnetGenerator as J
    jax.eval_shape(J(ngf=4, out_nc=5, num_downs=nd).init, jax.random.key(0),
                   jnp.zeros((2, 32, 32, 1)))


def _jax_split(g_out_side):
    """The reference's ``_split_g_out`` of a zoo G's one map (at 256², or
    VisGel's at 512²) against the x2 step's masks (M at 256², M_T at 512²)."""
    from vts_tpu.models.sinskit import SinSKITModel as J
    me = types.SimpleNamespace(opt=types.SimpleNamespace(image_nc=3), dtype=None)
    J._split_g_out(me, jnp.zeros((1, g_out_side, g_out_side, 5)), jnp.ones((1, 256, 256, 1)),
                   jnp.ones((1, 512, 512, 1)))


def _jax_d(n, side, c, tile=False, crop=256, dtype=jnp.float32):
    from vts_tpu.networks.stylegan2 import StyleGAN2Discriminator as J
    jax.eval_shape(J(ndf=4, tile=tile, crop_size=crop).init, jax.random.key(0),
                   jnp.zeros((n, side, side, c), dtype))


REFUSED = {
    "pix2pix_unet_256": ("pix2pix", ["--netG", "unet_256"], "--netG unet_256",
                         lambda: _jax_unet_on_a_patch(8), TypeError, "Cannot concatenate"),
    "pix2pixHD_unet_128": ("pix2pixHD", ["--netG", "unet_128"], "--netG unet_128",
                           lambda: _jax_unet_on_a_patch(7), TypeError, "Cannot concatenate"),
    "tilestylegan2_d2": ("sinskit", ["--netD2", "tilestylegan2"], "--netD2 tilestylegan2",
                         lambda: _jax_d(1, 32, 7, tile=True), TypeError, "cannot reshape"),
    "unet_256_x2": ("sinskit", ["--netG", "unet_256", "--T_resolution_multiplier", "2"],
                    "--T_resolution_multiplier 2", lambda: _jax_split(256), TypeError,
                    "incompatible shapes"),
    "visgel_x2": ("sinskit", ["--netG", "visgel", "--T_resolution_multiplier", "2"],
                  "--T_resolution_multiplier 2", lambda: _jax_split(512), TypeError,
                  "incompatible shapes"),
    "stylegan2_d2_batch_6": ("sinskit", ["--netD2", "stylegan2", "--batch_size_G2", "6"],
                             "--netD2 stylegan2 on batches of 6", lambda: _jax_d(6, 32, 7),
                             ValueError, "Incompatible shapes for broadcasting"),
    "stylegan2_d_bf16": ("sinskit", ["--netD", "stylegan2", "--dtype", "bfloat16"],
                         "--netD stylegan2 with --dtype bfloat16",
                         lambda: _jax_d(1, 256, 4, dtype=jnp.bfloat16), TypeError,
                         "same dtypes"),
    "stylegan2_g_crop_1449": ("pix2pix", ["--netG", "stylegan2", "--crop_size", "1449"],
                              "--crop_size 1449", lambda: jax.eval_shape(
                                  _jax_sg_g(1449).init, jax.random.key(0),
                                  jnp.zeros((1, 32, 32, 1))), KeyError, "2048"),
}


def _jax_sg_g(crop):
    from vts_tpu.networks.stylegan2 import StyleGAN2Generator as J
    return J(ngf=4, out_nc=5, crop_size=crop)


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_where_the_reference_fails(case, env):  # noqa: F811
    model, extra, msg, jax_fails, jerr, jmsg = REFUSED[case]
    with pytest.raises(jerr, match=jmsg):
        jax_fails()
    from vts_torch.models import create_model
    opt = _port_opt(env, model, extra)                  # the reference parses it too
    with pytest.raises(ValueError, match=msg):
        create_model(opt)


def test_stylegan2_g_takes_crop_1448(env):  # noqa: F811
    """The width table's ceiling: ``--crop_size`` 1448 keys 1024 and builds in
    both packages."""
    from vts_torch.networks import define_G
    jax.eval_shape(_jax_sg_g(1448).init, jax.random.key(0), jnp.zeros((1, 32, 32, 1)))
    assert define_G(_port_opt(env, "pix2pix", ["--netG", "stylegan2", "--crop_size", "1448"]),
                    1, 5)


def test_style_code_with_a_zoo_g_fails_in_both(env):  # noqa: F811
    """skitG's G call passes the code positionally: the reference's plain
    U-Net takes none (a ``TypeError``); the port refuses at model creation."""
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_tpu.networks.unet_plain import UnetGenerator as J
    with pytest.raises(TypeError, match="positional"):
        jax.eval_shape(J(ngf=4, out_nc=5, num_downs=7).init, jax.random.key(0),
                       jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 512)))
    opt = TrainOptions().parse(["--model", "skit", "--netG", "unet_128", "--device", "cpu",
                                "--checkpoints_dir", str(env / "ckpt")], quiet=True)
    with pytest.raises(ValueError, match="--use_style_code with --netG unet_128"):
        create_model(opt)


def test_d2_canvas_visual_fails_in_the_reference_and_is_left_out(env):  # noqa: F811
    """A StyleGAN2 D2 built for 32² patches cannot take the canvas (its widths
    and its head follow its input's size): the reference's full-canvas
    visual fails; the port's gallery leaves ``pred_fake_T_full`` out."""
    import flax
    from vts_torch.models import create_model
    from vts_tpu.networks.stylegan2 import StyleGAN2Discriminator as J
    jd = J(ndf=4, crop_size=256)
    v = jax.eval_shape(jd.init, jax.random.key(0), jnp.zeros((4, 32, 32, 7)))
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jax.eval_shape(jd.apply, v, jnp.zeros((1, 256, 256, 7)))
    assert not create_model(_port_opt(env, "sinskit", ["--netD2", "stylegan2"])
                            ).pred_fake_T_full_visual
    assert create_model(_port_opt(env, "sinskit", [])).pred_fake_T_full_visual


ACCEPTED = [("sinskit", ["--netG", g]) for g in ("unet_256", "unet_128", "visgel", "resnet_cat",
                                                  "stylegan2", "smallstylegan2")] + [
    ("sinskit", ["--netD", "stylegan2", "--netD2", "stylegan2"]),
    ("sinskit", ["--netD", "tilestylegan2"]),
    ("sinskit", ["--netG", "unet_256", "--dtype", "bfloat16"]),
    ("sinskit", ["--netG", "visgel", "--dtype", "bfloat16"]),
] + [(m, ["--netG", g]) for m in ("pix2pix", "pix2pixHD")
     for g in ("visgel", "resnet_cat", "stylegan2", "smallstylegan2")] + [
    ("spade", ["--netG", "resnet_cat"])]


@pytest.mark.parametrize("model,extra", ACCEPTED, ids=[f"{m}_{'_'.join(e[1::2])}"
                                                       for m, e in ACCEPTED])
def test_what_the_reference_runs_parses_and_builds(model, extra, env):  # noqa: F811
    """Each combination the reference's step runs (traced in the whole step
    once, by hand) parses, and its G and Ds build."""
    from vts_torch.networks import define_D, define_G
    opt = _port_opt(env, model, extra)
    assert sum(p.numel() for p in define_G(opt, 3, 5).parameters()) > 0
    if model == "sinskit":
        for name, size in ((opt.netD, opt.crop_size), (opt.netD2, 32)):
            assert sum(p.numel() for p in define_D(opt, 7, netD=name,
                                                   input_size=(size, size)).parameters()) > 0


@pytest.mark.parametrize("g", ["visgel", "stylegan2", "unet_256"])
def test_spade_takes_only_resnet_cat_of_the_zoo(g, env):  # noqa: F811
    """The reference's SPADE step passes (S, z) to G: only ``resnet_cat`` of
    the zoo takes a second argument (the others fail with a ``TypeError``,
    the plain U-Net first on SPADE's ``--normG``); the port refuses them."""
    from vts_tpu.networks.blocks import make_norm_layer
    from vts_tpu.networks.stylegan2 import StyleGAN2Generator
    from vts_tpu.networks.visgel import VisGelGenerator
    if g == "unet_256":
        with pytest.raises(NotImplementedError, match="spectralspadesyncbatch3x3"):
            make_norm_layer("spectralspadesyncbatch3x3")
    else:
        jnet = (VisGelGenerator(out_nc=5) if g == "visgel"
                else StyleGAN2Generator(ngf=4, out_nc=5, crop_size=64))
        with pytest.raises(TypeError, match="positional"):
            jax.eval_shape(jnet.init, jax.random.key(0), jnp.zeros((1, 32, 32, 1)), None)
    with pytest.raises(NotImplementedError, match=f"--netG '{g}' with --model spade"):
        _port_opt(env, "spade", ["--netG", g])


# --------------------------------------------------------------- drivers ---

@pytest.mark.slow
def test_cpu_train_then_test_drivers_with_the_zoo(env):  # noqa: F811
    """One sinskit step with the plain U-Net and the StyleGAN2 D and D2
    through ``vts_torch.train`` (256², ngf/ndf 4), then ``vts_torch.test``
    on its latest G: finite losses, 8 finite metrics."""
    from tests.torch_port_step import DATAROOT
    from vts_torch.test import test as port_test
    from vts_torch.train import train as port_train
    tmp = env / "zoo_drivers"
    common = ["--name", "zoo", "--dataroot", DATAROOT, "--device", "cpu", "--netG", "unet_256",
              "--ngf", "4", "--ndf", "4", "--crop_size", "256", "--center_w", "192",
              "--center_h", "128", "--checkpoints_dir", str(tmp / "ckpt"),
              "--results_dir", str(tmp / "res")]
    model = port_train(common + ["--netD", "stylegan2", "--netD2", "stylegan2",
                                 "--batch_size_G2", "4", "--add_fake_T_sample_size", "4",
                                 "--data_len", "1", "--n_epochs", "1", "--n_epochs_decay", "0",
                                 "--use_vision_aided_loss", "false", "--no_html"])
    losses = model.get_current_losses()
    assert {"D_fake_I", "D_real_T_concat", "G_GAN", "G2_GAN"} <= set(losses)
    assert all(np.isfinite(v) for v in losses.values())
    assert os.path.exists(tmp / "ckpt" / "zoo" / "latest_net_D2.msgpack")
    metrics = port_test(common + ["--epoch", "latest", "--batch_size_G2", "2", "--data_len", "1"])
    assert len(metrics) == 1 and len(metrics[0]) == 8
    assert all(np.isfinite(v) for v in metrics[0].values())
