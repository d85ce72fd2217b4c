"""The training slice of the port against ``vts_tpu`` on the CPU, at 256² with
ngf/ndf 4 (8 downs reach a 1×1 latent, as at 1536²):

  * the synthetic training batch (train and ``val_*`` keys) is JAX's
    ``create_dataset`` batch bit for bit;
  * one full training step of the port against ``SinSKITModel._train_step``
    at batch 1 and 2, and at batch 1 with the vision-aided D3 active, from
    the same weights (carried across by ``convert_jax``) and the same random
    draws (``tests/torch_port_step.py``: the port replays JAX's).  The JAX
    side runs with ``--canvas_fold 1 --lpips_fold 1``, exact re-expressions
    of its default folds.  Compared: every loss (rtol 1e-4; ``G_D3`` and
    ``D3_loss`` in the D3 step), the Adam first
    moments — equal to the gradients, since β1 = 0 — per leaf within 1e-4
    of the leaf's max |g|, with two named sets of leaves held to a round-off
    floor instead (see :func:`_grad_tol`), the updated batch-norm running
    stats (rtol 1e-4, atol 1e-6), and the updated parameters (see the test
    for the bound);
  * checkpoints with batch stats and Adam state cross both ways;
  * ``python -m vts_torch.train --device cpu`` then ``vts_torch.test``.

One JAX step per configuration is shared by the step tests (module scope).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_step import argv as _argv
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import flat as _flat
from tests.torch_port_step import jax_batch as _jax_batch
from tests.torch_port_step import jax_draws
from tests.torch_port_step import port_model as _port_model
from tests.torch_port_step import run_step
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Leaves whose exact gradient is zero: the bias of a conv that an instance
# norm (G's inner blocks) or a batch norm (D's middle layers) follows, since
# the norm removes any per-channel constant.  Both frameworks return fp32
# round-off there (measured up to ~2.5e-6 of the network's max |g|).
ZERO_GRAD = re.compile(r"(down[1-6]|up[1-7](_T)?|Conv4x4_[123])\W.*bias")
# The logit head's bias: its gradient sums the fake and the real terms, of
# opposite sign, over every logit, so it is a small difference of large sums
# (measured 4.4e-4 of its own max, 4e-6 of the network's).
CANCELLING = re.compile(r"Conv4x4_4\W.*bias")


def _grad_tol(name, g, net_max):
    """|Δg| bound of one gradient leaf: 1e-4 of the leaf's max |g|.  The
    leaves of :data:`ZERO_GRAD` are held to 1e-5 of the network's max |g|
    instead, and those of :data:`CANCELLING` get that floor on top."""
    if ZERO_GRAD.search(name):
        return 1e-5 * net_max
    return 1e-4 * np.abs(g).max() + (1e-5 * net_max if CANCELLING.search(name) else 0.0)


_JAX_STEPS = {}


def _jax_step(env, n, d3):  # noqa: F811
    """:func:`run_step` once per configuration, with the JAX states it started
    from: (JAX model after its step, JAX losses, port model after its step,
    the initial states)."""
    import tests.torch_port_step as tps
    if (n, d3) not in _JAX_STEPS:
        kept = {}

        def keep(model, states):
            kept["states"] = states
            real(model, states)
        real = tps.load_jax_states
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tps, "load_jax_states", keep)
            _JAX_STEPS[(n, d3)] = run_step(env, n, d3) + (kept["states"],)
    return _JAX_STEPS[(n, d3)]


def _dp2_step(env, jmodel, states0, tmp):  # noqa: F811
    """The port's batch-2 step as two gloo ranks on the CPU, one sample each
    (``--mesh data:2``), from JAX's initial states and its whole batch's
    draws: each rank's losses, Adam first moments and state dicts."""
    from tests.torch_port_ranks import dp_step_rank
    from tests.torch_port_step import np_tree
    from vts_torch.platform import spawn_ranks
    from vts_torch.utils.convert_jax import (d_params_to_torch, d_stats_to_torch,
                                             unet_params_to_torch, unet_stats_to_torch)
    states = {"G": {**unet_params_to_torch(np_tree(states0["G"].params)),
                    **unet_stats_to_torch(np_tree(states0["G"].stats))}}
    for name in ("D", "D2"):
        states[name] = {**d_params_to_torch(np_tree(states0[name].params)),
                        **d_stats_to_torch(np_tree(states0[name].stats))}
    states = {n: {k: np.asarray(v) for k, v in sd.items()} for n, sd in states.items()}
    argv = _argv(env, 2) + ["--device", "cpu", "--no_html", "--mesh", "data:2"]
    return spawn_ranks(dp_step_rank, (argv, states, _jax_batch(env, 2)[1],
                                      jax_draws(jmodel.rng, 2)), ["cpu", "cpu"], threads=1,
                       tmp_dir=str(tmp))


@pytest.fixture(scope="module", params=[(1, False), (2, False), "dp2", (1, True)],
                ids=["batch1", "batch2", "dp2", "d3_batch1"])
def step(request, env, tmp_path_factory):  # noqa: F811
    """One JAX training step and one port step from the same weights, batch
    and draws: at batch 1 and 2 before D3's warmup epoch, and at batch 1 with
    D3 active (JAX ``use_d3=True``, the port at ``--vision_aided_warmup_epoch
    1``); ``dp2``: the batch-2 JAX step against the port's batch-2 step over
    two CPU ranks of one sample each (``--mesh data:2``), rank 0's result,
    the two ranks' states and moments asserted bit for bit the same."""
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_unet_params
    to_flax = {"G": lambda sd: (torch_to_unet_params(sd), {}), "D": torch_to_d_params,
               "D2": torch_to_d_params}
    if request.param == "dp2":
        jmodel, losses, _, states0 = _jax_step(env, 2, False)
        res = _dp2_step(env, jmodel, states0, tmp_path_factory.mktemp("dp2"))
        for part in ("state", "mu"):
            for name, sd in res[0][part].items():
                assert all(torch.equal(v, res[1][part][name][k]) for k, v in sd.items()), \
                    (part, name)
        got = {"losses": res[0]["losses"]}
        for name in ("G", "D", "D2"):
            params, stats = to_flax[name](res[0]["state"][name])
            got[name] = {"params": params, "stats": stats,
                         "mu": to_flax[name](res[0]["mu"][name])[0]}
        return {"losses": losses, **jmodel.states}, got
    n, d3 = request.param
    jmodel, losses, model, _ = _jax_step(env, n, d3)
    want = {"losses": losses, **jmodel.states}
    got = {"losses": model.get_current_losses()}
    for name in ("G", "D", "D2"):
        net = getattr(model, f"net{name}")
        params, stats = to_flax[name](net.state_dict())
        got[name] = {"params": params, "stats": stats,
                     "mu": to_flax[name]({k: v for k, v in model.adam[name].mu.items()})[0]}
    return want, got


def test_train_step_losses(step):
    want, got = step
    assert set(got["losses"]) == set(want["losses"])
    assert ("G_D3" in want["losses"]) == ("D3_loss" in want["losses"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_train_step_grads(step, net):
    """Adam mu = the gradient (β1 = 0), per leaf within :func:`_grad_tol`."""
    want, got = step
    a, b = _flat(want[net].opt_state.mu), _flat(got[net]["mu"])
    assert a.keys() == b.keys()
    assert int(want[net].opt_state.count) == 1
    net_max = max(np.abs(v).max() for v in a.values())
    # the exempted leaves are exactly those whose reference gradient is round-off
    at_roundoff = {k for k, v in a.items() if np.abs(v).max() <= 1e-5 * net_max}
    assert at_roundoff == {k for k in a if ZERO_GRAD.search(k)}, sorted(at_roundoff)
    assert len(at_roundoff) == (16 if net == "G" else 9)
    assert len([k for k in a if CANCELLING.search(k)]) == (0 if net == "G" else 3)
    for k in a:
        tol = _grad_tol(k, a[k], net_max)
        assert np.abs(a[k] - b[k]).max() <= tol, (net, k, np.abs(a[k] - b[k]).max(), tol)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_train_step_params_and_stats(step, net):
    """Updated params: Adam's first step moves every element by lr·g/(|g|+1e-8),
    ±lr unless |g| is tiny, so an element whose |g| is within the gradient
    tolerance (:func:`_grad_tol`) may move the other way in one framework:
    there the bound is 2·lr (+1e-6); elsewhere 1e-6 + 1e-5·|p|.  Running
    stats: rtol 1e-4, atol 1e-6."""
    want, got = step
    lr = 1e-3 if net in ("G", "D") else 5e-4
    p_want, p_got = _flat(want[net].params), _flat(got[net]["params"])
    g = _flat(want[net].opt_state.mu)
    net_max = max(np.abs(v).max() for v in g.values())
    assert p_want.keys() == p_got.keys()
    for k in p_want:
        tiny = np.abs(g[k]) <= _grad_tol(k, g[k], net_max)
        bound = np.where(tiny, 2 * lr + 1e-6, 1e-6 + 1e-5 * np.abs(p_want[k]))
        assert (np.abs(p_want[k] - p_got[k]) <= bound).all(), (net, k)
    s_want, s_got = _flat(want[net].stats), _flat(got[net]["stats"])
    assert s_want.keys() == s_got.keys()
    for k in s_want:
        np.testing.assert_allclose(s_got[k], s_want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_synthetic_train_batch_matches_jax(env):
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    _, want = _jax_batch(env, 1)
    opt = TrainOptions().parse(_argv(env) + ["--device", "cpu"], quiet=True)
    loader = create_dataset(opt)
    loader.set_epoch(0)
    got = next(iter(loader))
    assert set(got) == set(want)
    assert {"val_T_images", "val_T_coords", "val_I_masks", "val_T_valid"} <= set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["T_valid"].sum() > 0 and want["val_T_valid"].sum() > 0


def test_checkpoints_cross_both_ways(env):
    """G, D, D2 with batch stats and Adam state: JAX-written files load into
    the port, and port-written files load into vts_tpu, values intact."""
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.models.base import load_net as jax_load_net
    jopt, batch = _jax_batch(env, 1)
    jmodel = jax_create_model(jopt)
    jmodel.setup(batch)
    # make every Adam leaf and stat non-trivial before writing
    key = jax.random.key(3)
    for name, st in jmodel.states.items():
        noise = lambda t: jax.random.normal(key, t.shape, t.dtype)   # noqa: E731
        jmodel.states[name] = st.replace(
            stats=jax.tree_util.tree_map(lambda t: t + noise(t), st.stats),
            opt_state=st.opt_state._replace(
                count=jnp.int32(7), mu=jax.tree_util.tree_map(noise, st.opt_state.mu),
                nu=jax.tree_util.tree_map(lambda t: noise(t) ** 2, st.opt_state.nu)))
    jmodel.save_networks("x")
    model = _port_model(env, 1)
    model.load_networks("x")
    model.opt.name = "port_written"
    model.save_networks("y")
    ckpt = str(env / "ckpt" / "port_written")
    for name, st in jmodel.states.items():
        back = jax_load_net(ckpt, "y", name, st)
        for part in ("params", "stats"):
            a, b = _flat(getattr(st, part)), _flat(getattr(back, part))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {part} {k}")
        assert int(back.opt_state.count) == 7 and model.adam[name].count == 7
        for part in ("mu", "nu"):
            a = _flat(getattr(st.opt_state, part))
            b = _flat(getattr(back.opt_state, part))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {part} {k}")
    assert os.path.exists(os.path.join(ckpt, "y_opt_D2.msgpack"))


def test_cpu_train_then_test_smoke(tmp_path):
    """``python -m vts_torch.train --device cpu`` (the CPU smoke command), then
    ``vts_torch.test`` on the best G: finite losses, G/D/D2 checkpoints with
    their Adam files, 8 finite metrics."""
    data = "synthetic://smoke?size=320&center_w=192&center_h=128&patches=6&val_patches=3"
    common = ["--dataroot", data, "--crop_size", "256", "--center_w", "192",
              "--center_h", "128", "--ngf", "4", "--name", "smoke", "--device", "cpu",
              "--checkpoints_dir", str(tmp_path / "ckpt"),
              "--results_dir", str(tmp_path / "res")]
    out = subprocess.run(
        [sys.executable, "-m", "vts_torch.train", *common, "--ndf", "4",
         "--batch_size_G2", "4", "--batch_size_G2_val", "3", "--add_fake_T_sample_size", "3",
         "--data_len", "2", "--n_epochs", "1", "--n_epochs_decay", "0", "--no_html"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loss_lines = [ln for ln in out.stdout.splitlines() if ln.startswith("(epoch: 1, iters:")]
    assert loss_lines and "nan" not in loss_lines[0] and "G_total" in loss_lines[0]
    for name in ("G", "D", "D2"):
        for kind in ("net", "opt"):
            assert (tmp_path / "ckpt" / "smoke" / f"best_{kind}_{name}.msgpack").exists()
    from vts_torch.test import test as port_test
    metrics = port_test(common + ["--epoch", "best", "--batch_size_G2", "4"])[0]
    assert len(metrics) == 8 and all(np.isfinite(v) for v in metrics.values())


def test_train_requires_no_html_and_refuses_unported_settings(tmp_path):
    """The settings the port does not run raise naming the flag: a mesh
    with an unknown axis at the model's set-up (the reference's
    ``ValueError``), the tile StyleGAN2 D2 at model creation (a
    ``ValueError``: the reference cannot run it).  A data mesh parses.  The cropped
    LPIPS, bf16,
    the gallery (``--no_html`` is not required) and the settings ported since
    (the plateau schedule, the hinge and WGAN losses, the other D norms and
    nets, the other init types, the other DiffAugment letters, tactile
    super-resolution, the legacy evaluation, style codes, the skit model and
    dataset, the live dashboard) parse."""
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    base = ["--checkpoints_dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="--mesh pipe:2: unknown mesh axis"):
        create_model(TrainOptions().parse(base + ["--mesh", "pipe:2"], quiet=True)).setup()
    assert TrainOptions().parse(base + ["--mesh", "data:2"], quiet=True).mesh == "data:2"
    with pytest.raises(ValueError, match="--netD2 tilestylegan2"):
        create_model(TrainOptions().parse(base + ["--netD2", "tilestylegan2"], quiet=True))
    opt = TrainOptions().parse(base + ["--lpips_crop", "64", "--dtype", "bfloat16"], quiet=True)
    assert (opt.display_id, opt.lpips_crop, opt.dtype) == (0, 64, "bfloat16")
    for extra in (["--lr_policy", "plateau"], ["--gan_mode", "hinge"], ["--gan_mode", "wgangp"],
                  ["--normD", "instance"], ["--netD", "pixel"], ["--init_type", "orthogonal"],
                  ["--diffaugment", "bsc"], ["--T_resolution_multiplier", "2"],
                  ["--eval_mode", "legacy"], ["--use_style_code", "True"], ["--model", "skit"],
                  ["--dataset_mode", "skit"], ["--display_id", "1"]):
        opt = TrainOptions().parse(base + extra, quiet=True)
        assert str(getattr(opt, extra[0][2:])) == extra[1], extra
