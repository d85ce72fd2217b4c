"""The perceptual towers' weight loaders of the port against ``vts_tpu``'s on
the CPU, on synthetic checkpoints that the tests write with ``torch.save``
(no weights are fetched):

  * LPIPS from a full ``lpips.LPIPS`` state dict (``net.slice*.N.*``,
    ``lin*.model.1.weight``) and from the ``{'vgg', 'lins'}`` layout
    (torchvision ``features.N.*``, ``lins.i.model.1.weight``);
  * Inception block 0 from a torchvision ``inception_v3`` state dict;

both packages' loaders give identical params, the LPIPS distances and the
block-0 features agree within rtol 1e-5, and ``--lpips_weights`` /
``--inception_weights`` reach the model in both phases.  And the reference's
generator checkpoints (``.pth``, a sinskitG G and a skitG G with
``style_code_mapping{i}`` layers) through ``vts_torch.utils.convert_torch``
and ``vts_tpu``'s converter: identical trees, G outputs within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

TV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
VGG_OUT = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
TAP_C = [64, 128, 256, 512, 512]
INCEPTION = [("Conv2d_1a_3x3", 3, 32), ("Conv2d_2a_3x3", 32, 32), ("Conv2d_2b_3x3", 32, 64)]


def _lpips_state(layout: str, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    vgg, lins = {}, {}
    in_c = 3
    for li, out_c in zip(TV_IDX, VGG_OUT):
        s = 1 + sum(li >= b for b in (4, 9, 16, 23))
        key = f"features.{li}" if layout == "vgg_lins" else f"net.slice{s}.{li}"
        vgg[f"{key}.weight"] = torch.randn(out_c, in_c, 3, 3, generator=g) * (2 / (9 * in_c)) ** .5
        vgg[f"{key}.bias"] = torch.randn(out_c, generator=g) * 0.05
        in_c = out_c
    for i, c in enumerate(TAP_C):
        key = f"lins.{i}.model.1.weight" if layout == "vgg_lins" else f"lin{i}.model.1.weight"
        lins[key] = torch.rand(1, c, 1, 1, generator=g) / c
    return {"vgg": vgg, "lins": lins} if layout == "vgg_lins" else {**vgg, **lins}


def _inception_state(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, ci, co in INCEPTION:
        sd[f"{name}.conv.weight"] = torch.randn(co, ci, 3, 3, generator=g) * (2 / (9 * ci)) ** .5
        sd[f"{name}.bn.weight"] = 1 + 0.1 * torch.randn(co, generator=g)
        sd[f"{name}.bn.bias"] = 0.1 * torch.randn(co, generator=g)
        sd[f"{name}.bn.running_mean"] = 0.1 * torch.randn(co, generator=g)
        sd[f"{name}.bn.running_var"] = 1 + torch.rand(co, generator=g)
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"] = torch.randn(10, 2048, generator=g)       # the rest of the network
    return sd


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


@pytest.mark.parametrize("layout", ["lpips_LPIPS", "vgg_lins"])
def test_lpips_loader_matches_jax(layout, tmp_path):
    from vts_torch.losses.lpips import LPIPS, load_lpips_weights
    from vts_tpu.losses.lpips import load_lpips_weights as jax_load
    from vts_tpu.losses.lpips import lpips as jax_lpips
    path = str(tmp_path / "lpips.pth")
    torch.save(_lpips_state(layout), path)
    got, want = load_lpips_weights(path), jax_load(path)
    _equal_trees(got, want)
    rng = np.random.default_rng(1)
    for shape in ((2, 48, 40, 3), (3, 32, 32, 1)):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        y = rng.uniform(-1, 1, shape).astype(np.float32)
        d = LPIPS(got)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(d, np.asarray(jax_lpips(want, jnp.asarray(x), jnp.asarray(y))),
                                   rtol=1e-5)


def test_inception_loader_matches_jax(tmp_path):
    from vts_torch.metrics.inception import InceptionBlock0, load_inception_weights
    from vts_tpu.metrics.inception import inception_block0
    from vts_tpu.metrics.inception import load_inception_weights as jax_load
    path = str(tmp_path / "inception_v3.pth")
    torch.save(_inception_state(), path)
    got, want = load_inception_weights(path), jax_load(path)
    _equal_trees(got, want)
    x = np.random.default_rng(2).uniform(0, 1, (2, 61, 53, 3)).astype(np.float32)
    feats = InceptionBlock0(got)(torch.from_numpy(x)).numpy()
    ref = np.asarray(inception_block0(want, jnp.asarray(x)))
    np.testing.assert_allclose(feats, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("phase", ["train", "test"])
def test_weight_flags_reach_the_model(phase, tmp_path):
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.losses.lpips import load_lpips_weights
    from vts_torch.metrics.inception import load_inception_weights
    from vts_torch.models import create_model
    lp, inc = str(tmp_path / "lpips.pth"), str(tmp_path / "inception.pth")
    torch.save(_lpips_state("lpips_LPIPS", seed=3), lp)
    torch.save(_inception_state(seed=4), inc)
    opts = TrainOptions() if phase == "train" else TestOptions()
    opt = opts.parse(["--device", "cpu", "--ngf", "4", "--ndf", "4", "--lpips_weights", lp,
                      "--inception_weights", inc, "--checkpoints_dir", str(tmp_path)], quiet=True)
    model = create_model(opt)
    w5 = load_lpips_weights(lp)["conv"][5]["w"]
    assert torch.equal(model.lpips_net.conv5_weight, torch.from_numpy(w5).permute(3, 2, 0, 1))
    assert torch.equal(model.lpips_net.lin4, torch.from_numpy(load_lpips_weights(lp)["lin"][4]))
    bn = load_inception_weights(inc)["Conv2d_2b_3x3"]["var"]
    assert torch.equal(model.inception.Conv2d_2b_3x3_var, torch.from_numpy(bn))


# The reference CustomUnetGenerator's state-dict names for the port's CustomUNet
# keys (models/networks.py:1430-1532, thirdparty/unet/unet_parts_custom.py)
def _reference_unet_state(net, seed):
    """A state dict in the reference's naming, with a ``module.`` prefix, of
    ``net``'s shapes, filled from a seeded generator."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in net.state_dict().items():
        group, name, *rest = key.split(".")
        leaf = rest[-1]
        if group == "style":
            ref = f"{name}.0.{leaf}"
        elif group == "down":
            ref = f"{name}.model.{0 if name == 'down0' else 1}.{leaf}"
        else:
            ref = f"{name}.model.1.{leaf}"
        sd["module." + ref] = torch.from_numpy(
            (rng.normal(size=tuple(t.shape)) * 0.1).astype(np.float32))
    return sd


PTH_CASES = {"sinskitG": {},
             "skitG_project": dict(use_style_code=True, style_code_mapping_mode="project",
                                   num_layer_style_code=2)}


@pytest.mark.parametrize("case", list(PTH_CASES))
def test_pth_generator_import_matches_jax(case, tmp_path):
    """A reference ``best_net_G.pth`` (a ``module.``-prefixed state dict,
    written here with ``torch.save``) through the port's converter CLI and
    through ``vts_tpu``'s ``convert_checkpoint``: identical trees (the
    msgpack file read by flax as well), and both G's give the same output
    from them within 1e-4 (as ``test_torch_port_networks.py`` holds G)."""
    import jax
    from flax.serialization import msgpack_restore as flax_restore
    from vts_tpu.networks.unet_custom import CustomUNet as JaxCustomUNet
    from vts_tpu.utils.convert_torch import convert_checkpoint as jax_convert
    from vts_torch.networks.unet_custom import CustomUNet
    from vts_torch.utils.convert_jax import unet_params_to_torch
    from vts_torch.utils.convert_torch import main
    from vts_torch.utils.msgpack import msgpack_restore
    kw = PTH_CASES[case]
    net = CustomUNet(9, ngf=4, input_size=256, **kw).eval()
    sd = _reference_unet_state(net, seed=len(case))
    assert any(k.startswith("module.up7.model.1.") for k in sd)
    assert any(".0.weight" in k and "style_code_mapping" in k for k in sd) == bool(kw)
    pth, out = str(tmp_path / "best_net_G.pth"), str(tmp_path / "ck" / "best_net_G.msgpack")
    torch.save(sd, pth)
    main(["--input", pth, "--output", out])
    with open(out, "rb") as f:
        raw = f.read()
    got, flax_got = msgpack_restore(raw), flax_restore(raw)
    want = jax_convert(pth, "unet256_custom")
    _equal_trees(got, want)
    _equal_trees(flax_got, want)
    jnet = JaxCustomUNet(ngf=4, num_downs=8, num_layer_separate=4, train=False, input_size=256,
                         **kw)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (1, 256, 256, 9)).astype(np.float32)
    args = (jnp.asarray(x),) + ((jnp.asarray(rng.normal(size=(1, 512)), jnp.float32),)
                                if kw else ())
    ref = np.asarray(jnet.apply({"params": jax.tree_util.tree_map(jnp.asarray, want["params"])},
                                *args))
    net.load_state_dict(unet_params_to_torch(got["params"]))
    with torch.no_grad():
        out_t = torch.cat(net(*(torch.from_numpy(np.asarray(a)) for a in args)), -1).numpy()
    assert np.abs(out_t - ref).max() <= 1e-4 and np.abs(ref).max() > 1e-2


def test_pth_import_refuses_the_archs_not_ported(tmp_path):
    """Every reference arch has a converter in both packages; an arch that
    neither converts is a ``NotImplementedError`` naming it in both."""
    from vts_torch.utils.convert_torch import convert_checkpoint
    from vts_tpu.utils.convert_torch import convert_checkpoint as jax_convert
    pth = str(tmp_path / "g.pth")
    torch.save({"model.1.weight": torch.zeros(4, 3, 7, 7)}, pth)
    for arch in ("stylegan2", "visgel"):
        for convert in (jax_convert, convert_checkpoint):
            with pytest.raises(NotImplementedError, match=arch):
                convert(pth, arch)
