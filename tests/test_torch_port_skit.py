"""The skitG slice of the port — the multi-garment model with a CLIP style
code — against ``vts_tpu`` on the CPU, at 256² with ngf/ndf 4:

  * the style-coded ``CustomUNet`` for tile/project × concat/adain at
    ``num_layer_style_code`` 1, 2 and -1, on weights carried across by
    ``convert_jax`` (which round-trips them bit for bit): the output within
    1e-4, as ``test_torch_port_networks.py`` holds the plain one; AdaIN at
    every level fails in both packages (the level-2 map has 4·ngf channels,
    the style 8·ngf), and so it must here;
  * the skit dataset against JAX's on two materials: ``material_index``, the
    round-robin order, ``style_image`` and every other key, bit for bit, but
    ``sample_idx``: the item's own index in the port, the garment's sample
    index in the reference;
  * one skitG training step against ``SinSKITModel._train_step`` (shared,
    module scope), the style code entering both as ``batch["style_code"]``
    (the port's own encoding of the batch's style image), so that JAX
    compiles no CLIP: losses (rtol 1e-4); D's and D2's gradients per leaf
    within ``_grad_tol`` of ``test_torch_port_train.py``; G's under the rule
    ``test_torch_port_tmult.py`` holds the x2 step's G to, for the same
    cause: 4× ``_grad_tol`` per leaf (the worst leaf, ``up7``'s kernel,
    reads 1.9×) and 1e-4 of the network's gradient in the 2-norm (4.2e-5).
    The two packages' fp32 G forwards hand the touch LPIPS fake patches 1e-6
    apart, and JAX's lie at a VGG max-pool near-tie: float64's own gradient
    moves by 3e-3 of its max between the two sets, while at the port's
    patches the port's fp32 gradient is within 1e-6 of float64's (JAX's too,
    measured 3.9e-7)
    (:func:`test_touch_lpips_gradient_jumps_between_the_packages_patches`);
    params and running stats as ``test_torch_port_train.py`` holds them;
  * after the step, with JAX's updated weights: ``test()`` (outputs within
    1e-4 of their max) and the 8 batched metrics of the test phase (rtol
    1e-4, SIFIDs 1e-3);
  * the port's test driver on two materials: ``eval_metrics_per_material
    .pkl`` holds, per material, the mean of its samples' pickles;
  * two style codes give two images; a skitG checkpoint (widened up stages,
    ``style_code_mapping{k}`` layers, Adam state) crosses both ways bit for
    bit, and ``--continue_train`` resumes it.
"""

import copy
import itertools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import CANCELLING, ZERO_GRAD, _grad_tol
from tests.torch_port_step import argv as _argv
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import flat, load_jax_states, port_model, run_step

SKIT = ["--model", "skit"]
TEST_DATA = "synthetic://portskit?size=320&center_w=192&center_h=128&patches=6&val_patches=3"


def _unet_case(mapping, mode, nls):
    from vts_tpu.networks.unet_custom import CustomUNet as JaxCustomUNet
    from vts_torch.networks.unet_custom import CustomUNet
    dim = 32          # 8·ngf, as AdaIN needs; the shipped 512 runs in the step below
    kw = dict(use_style_code=True, style_code_dim=dim, style_code_mode=mode,
              style_code_mapping_mode=mapping, num_layer_style_code=nls)
    jnet = JaxCustomUNet(ngf=4, num_downs=8, num_layer_separate=4, train=False, init_gain=0.5,
                         input_size=256, **kw)
    net = CustomUNet(9, ngf=4, input_size=256, **kw).eval()
    rng = np.random.default_rng(len(mapping) + len(mode) + nls)
    x = rng.uniform(-1, 1, (1, 256, 256, 9)).astype(np.float32)
    code = rng.normal(size=(1, dim)).astype(np.float32)
    return jnet, net, x, code


@pytest.mark.parametrize("mapping,mode,nls",
                         list(itertools.product(["tile", "project"], ["concat", "adain"],
                                                [1, 2, -1])))
def test_style_coded_unet_matches_jax(mapping, mode, nls):
    from vts_torch.utils.convert_jax import torch_to_unet_params, unet_params_to_torch
    jnet, net, x, code = _unet_case(mapping, mode, nls)
    if mode == "adain" and nls == -1:
        with pytest.raises(TypeError):
            jnet.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(code))
        with pytest.raises(RuntimeError):
            net(torch.from_numpy(x), torch.from_numpy(code))
        return
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.key(0), jnp.asarray(x),
                                                          jnp.asarray(code))["params"])
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(code)))
    net.load_state_dict(unet_params_to_torch(params))
    a, b = flat(params), flat(torch_to_unet_params(net.state_dict()))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    n_map = sum(k.startswith("style.") for k in net.state_dict())
    assert n_map == (0 if mapping == "tile" else 8 if nls == -1 else nls)
    with torch.no_grad():
        got = torch.cat(net(torch.from_numpy(x), torch.from_numpy(code)), dim=-1).numpy()
    assert got.shape == want.shape == (1, 256, 256, 5)
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(want).max() > 1e-2


def test_skit_dataset_matches_jax(env):  # noqa: F811
    """Two materials, data_len 2: items A0, B0, A1, B1, bit for bit."""
    from vts_tpu.config import TestOptions as JaxTestOptions
    from vts_tpu.data.skit import SkitDataset as JaxSkitDataset
    from vts_torch.config import TestOptions
    from vts_torch.data import create_dataset
    argv = SKIT + ["--dataroot", TEST_DATA, "--crop_size", "256", "--center_w", "192",
                   "--center_h", "128", "--batch_size_G2", "4", "--data_len", "2",
                   "--checkpoints_dir", str(env / "ckpt")]
    jds = JaxSkitDataset(JaxTestOptions().parse(argv, quiet=True))
    loader = create_dataset(TestOptions().parse(argv + ["--device", "cpu"], quiet=True))
    ds = loader.dataset
    assert ds.materials == jds.materials == ["synthA", "synthB"]
    assert len(ds) == len(jds) == 4 and ds.name == jds.name == "synthA+synthB"
    for i in range(4):
        want, got = jds[i], ds[i]
        assert set(got) == set(want)
        assert got["material_index"].dtype == np.int32 and int(got["material_index"]) == i % 2
        assert got["style_image"].shape == (224, 224, 3)
        # sample_idx, the per-sample caches' key, is the item's own index in
        # the port; the reference repeats each garment's (its garments collide)
        assert int(got["sample_idx"]) == i and int(want["sample_idx"]) == i // 2
        for k in want:
            if k != "sample_idx" and (isinstance(want[k], np.ndarray) or np.isscalar(want[k])):
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                              err_msg=f"item {i} {k}")
    assert not np.array_equal(ds[0]["style_image"], ds[1]["style_image"])
    batches = [b["material_index"].tolist() for b in loader]
    assert batches == [[0], [1], [0], [1]]


@pytest.fixture(scope="module")
def skit_step(env):  # noqa: F811
    """One skitG JAX step and one port step from the same weights, batch,
    style code and draws."""
    from vts_torch.networks.clip_vit import CLIPViT, clip_style_code, init_clip_params
    clip = CLIPViT(init_clip_params(0))

    def with_code(batch):
        with torch.no_grad():
            code = clip_style_code(clip, torch.from_numpy(batch["style_image"])).numpy()
        return {**batch, "style_code": code}
    return run_step(env, 1, extra=SKIT, batch_fn=with_code)


def test_skit_step_losses(skit_step):
    jmodel, want, model = skit_step
    assert jmodel.opt.use_style_code and model.opt.use_style_code
    assert model.netG.up["up7"].convt.weight.shape[0] == 4 * 8 + 512   # [h, style]
    got = model.get_current_losses()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_skit_step_grads_params_and_stats(skit_step, net):
    """Adam μ = the gradient (β1 = 0) per leaf within ``_grad_tol`` (G: 4×,
    and 1e-4 in the 2-norm; see the module docstring), the round-off leaves
    being exactly ``ZERO_GRAD``'s; the updated params and running stats as
    in ``test_torch_port_train.py``."""
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_unet_params
    jmodel, _, model = skit_step
    st = jmodel.states[net]
    to_flax = (lambda sd: (torch_to_unet_params(sd), {})) if net == "G" else torch_to_d_params
    params, stats = to_flax(getattr(model, f"net{net}").state_dict())
    a, b = flat(st.opt_state.mu), flat(to_flax(model.adam[net].mu)[0])
    assert a.keys() == b.keys()
    net_max = max(np.abs(v).max() for v in a.values())
    at_roundoff = {k for k, v in a.items() if np.abs(v).max() <= 1e-5 * net_max}
    assert at_roundoff == {k for k in a if ZERO_GRAD.search(k)}, sorted(at_roundoff)
    assert len([k for k in a if CANCELLING.search(k)]) == (0 if net == "G" else 3)
    scale = 4.0 if net == "G" else 1.0

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
    p_want, p_got = flat(st.params), flat(params)
    assert p_want.keys() == p_got.keys()
    for k in p_want:
        bound = np.where(np.abs(a[k]) <= tol_of(k), 2 * lr + 1e-6,
                         1e-6 + 1e-5 * np.abs(p_want[k]))
        assert (np.abs(p_want[k] - p_got[k]) <= bound).all(), (net, k)
    s_want, s_got = flat(st.stats), flat(stats)
    assert s_want.keys() == s_got.keys()
    for k in s_want:
        np.testing.assert_allclose(s_got[k], s_want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def _valid_gxgy(t, coords, valid):
    """The valid 32² patches of a (1, H, W, 2) canvas at the coords, gx then
    gy, as the G2 LPIPS takes them: (2·Kv, 32, 32, 1) float64."""
    from vts_torch.ops.patch import gather_patches_from_coords
    p = gather_patches_from_coords(torch.as_tensor(np.asarray(t)), coords, 32, 1)[valid]
    return torch.cat([p[..., 0:1], p[..., 1:2]], 0).double().numpy()


def test_touch_lpips_gradient_jumps_between_the_packages_patches(skit_step):
    """The step's touch LPIPS (the fake patches with a gradient, the real
    ones without), at the port's fake patches and at JAX's, which lie within
    1e-5 of each other: at the port's, the port's fp32 gradient is within
    1e-5 of float64's max (measured 7.5e-7; JAX's fp32 gradient there reads
    3.9e-7); yet float64's own gradient moves by more than 1e-4 of its max
    between the two sets (measured 3.0e-3): a VGG max-pool near-tie, which
    is why G's
    gradient is held to the x2 rule in
    :func:`test_skit_step_grads_params_and_stats`."""
    from tests.test_torch_port_tmult import _lpips_fp64
    from vts_torch.losses.lpips import LPIPS, init_lpips_params
    jmodel, _, model = skit_step
    inp = model._input
    valid = inp["T_valid"].reshape(-1) > 0
    real = inp["T_images"][valid]
    y = torch.cat([real[..., 0:1], real[..., 1:2]], 0).double().numpy()
    x_port = _valid_gxgy(model._outputs["fake_T"], inp["T_coords"], valid)
    x_jax = _valid_gxgy(jmodel._outputs["fake_T"], inp["T_coords"], valid)
    assert np.abs(x_port - x_jax).max() <= 1e-5
    xt = torch.from_numpy(x_port).float().requires_grad_(True)
    d = LPIPS(init_lpips_params(0))(xt, torch.from_numpy(y).float(), y_no_grad=True)
    g_port = torch.autograd.grad(d.sum(), xt)[0].numpy()
    ref_port, ref_jax = _lpips_fp64(x_port, y)[1], _lpips_fp64(x_jax, y)[1]
    scale = np.abs(ref_port).max()
    assert np.abs(g_port - ref_port).max() <= 1e-5 * scale
    assert np.abs(ref_port - ref_jax).max() > 1e-4 * scale


def test_skit_test_and_metrics_match_jax(skit_step):
    """With JAX's updated weights in the port: ``test()`` with the batch's
    style code, then the batched metrics as the test driver asks for them
    (the batch's patches, 8 metrics)."""
    jmodel, _, stepped = skit_step
    model = copy.deepcopy(stepped)
    load_jax_states(model, jmodel.states)
    jmodel.test()
    model.test()
    for k in ("fake_I", "fake_T"):
        want, got = np.asarray(jmodel._outputs[k]), model._outputs[k].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k
    want, got = jmodel.compute_metrics("test"), model.compute_metrics("test")
    assert set(got) == set(want) and len(want) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3 if "SIFID" in k else 1e-4,
                                   err_msg=k)


def test_two_style_codes_give_two_images(skit_step):
    model = copy.deepcopy(skit_step[2])
    outs = []
    for seed in (0, 1):
        model._input["style_code"] = torch.from_numpy(
            np.random.default_rng(seed).normal(size=(1, 512)).astype(np.float32))
        model.test()
        outs.append(model._outputs["fake_I"])
    assert (outs[0] - outs[1]).abs().max() > 1e-3


def test_test_driver_rolls_up_per_material(tmp_path):
    """``vts_torch.test --model skit`` on two materials, 3 samples (A, B, A):
    the per-material pickle holds each material's mean of its samples'
    ``eval_metrics_<i>.pkl``."""
    from vts_torch.config import TestOptions
    from vts_torch.models import create_model
    from vts_torch.test import test as port_test
    argv = SKIT + ["--dataroot", TEST_DATA, "--crop_size", "256", "--center_w", "192",
                   "--center_h", "128", "--ngf", "4", "--batch_size_G2", "1", "--name", "mat",
                   "--epoch", "best", "--device", "cpu", "--init_gain", "0.5",
                   "--checkpoints_dir", str(tmp_path / "ck"), "--results_dir", str(tmp_path / "r")]
    model = create_model(TestOptions().parse(argv, quiet=True))
    model.netG.reset_parameters(torch.Generator().manual_seed(0))   # no CLIP needed to save G
    model.save_networks("best")
    metrics = port_test(argv + ["--data_len", "2", "--num_test", "3"])
    web = tmp_path / "r" / "mat" / "test_best"
    with open(web / "eval_metrics_per_material.pkl", "rb") as f:
        per_mat = pickle.load(f)
    rows = []
    for i in range(3):
        with open(web / f"eval_metrics_{i}.pkl", "rb") as f:
            rows.append(pickle.load(f))
    assert rows == metrics and len(rows[0]) == 8
    assert sorted(per_mat) == ["synthA", "synthB"]
    for name, mine in (("synthA", rows[0::2]), ("synthB", rows[1::2])):
        assert set(per_mat[name]) == set(rows[0])
        for k, v in per_mat[name].items():
            assert v == float(np.mean([r[k] for r in mine])), (name, k)


def test_skit_checkpoints_cross_both_ways_and_resume(env):  # noqa: F811
    """A project/concat G at two style levels (``style_code_mapping0/1``,
    widened ``up7``/``up6``): written by vts_tpu with perturbed params and
    Adam state, read by the port, written again, read by vts_tpu — bit for
    bit; then a ``--continue_train`` model loads the port's files into the
    same weights and Adam state."""
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.models.base import load_net as jax_load_net
    extra = SKIT + ["--style_code_mapping_mode", "project", "--num_layer_style_code", "2",
                    "--use_vision_aided_loss", "false", "--name", "ck_skit"]
    jopt = JaxTrainOptions().parse(_argv(env, extra=extra), quiet=True)
    jmodel = jax_create_model(jopt)
    jmodel.setup({"S": np.zeros((1, 256, 256, 1), np.float32)})
    st = jmodel.states["G"]
    assert {"style_code_mapping0", "style_code_mapping1"} <= set(st.params)
    key = jax.random.key(9)
    noise = lambda t: jax.random.normal(key, t.shape, t.dtype)   # noqa: E731
    jmodel.states["G"] = st.replace(
        params=jax.tree_util.tree_map(lambda t: t + noise(t), st.params),
        opt_state=st.opt_state._replace(
            count=jnp.int32(3), mu=jax.tree_util.tree_map(noise, st.opt_state.mu),
            nu=jax.tree_util.tree_map(lambda t: noise(t) ** 2, st.opt_state.nu)))
    st = jmodel.states["G"]
    jmodel.save_networks("x")
    model = port_model(env, 1, extra=extra)
    model.load_networks("x")
    model.opt.name = "ck_skit_port"
    model.save_networks("y")
    back = jax_load_net(str(env / "ckpt" / "ck_skit_port"), "y", "G", st)
    for tree, got in ((st.params, back.params), (st.opt_state.mu, back.opt_state.mu),
                      (st.opt_state.nu, back.opt_state.nu)):
        a, b = flat(tree), flat(got)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    resumed = port_model(env, 1, extra=extra[:-1] + ["ck_skit_port", "--continue_train",
                                                    "--epoch", "y"])
    assert resumed.opt.continue_train
    resumed.load_networks(resumed.opt.epoch)
    for name in ("G", "D", "D2"):
        sa = getattr(model, f"net{name}").state_dict()
        sb = getattr(resumed, f"net{name}").state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
        assert resumed.adam[name].count == model.adam[name].count
        assert all(torch.equal(model.adam[name].mu[k], resumed.adam[name].mu[k])
                   for k in model.adam[name].mu)
    assert resumed.adam["G"].count == 3
