"""The garment fleet and the garment packing of the port against ``vts_tpu``
on the CPU, on the same numpy inputs from a seed (the JAX trees come from the
port's seeded weights through the converters, no flax init):

  * packing: ``pack_*``/``unpack_*`` of ``vts_torch.parallel.packing``
    against ``vts_tpu.parallel.packing`` on the same garments, mapped
    through :func:`~vts_torch.utils.convert_jax.packed_unet_to_torch`, bit
    for bit (the transposed convs' grouped layout included), round trips
    both ways, images too;
  * the packed CustomUNet (``pack`` 2 and 3, and ``t_mult`` 2; 64²,
    num_downs 6, ngf 4, instance norm) against JAX's ``CustomUNet(pack=G)``
    on ``pack_tree`` of the same garments within rtol 2e-4 and atol 2e-5
    (as ``tests/test_packing.py``), and against the port's own ``pack=1``
    forwards; a loss on garment 0 leaves exactly zero gradient on garment
    1; a style code with ``pack > 1`` raises as in the reference;
  * ``stack_states``, ``unstack_state`` and ``stack_batches`` against the
    JAX functions, the batches' key intersection included;
  * the fleet: its garments initialize as single runs with ``--seed g``, and
    a fleet step equals the two single-garment port steps from the same
    weights, batches and draws bit for bit, before D3 and with D3 active
    (256², ngf/ndf 4: the U-Net's 8 downs need 256²); garment 0's update
    does not depend on garment 1's batch; the frozen towers are one copy;
    skitG (``--model skit``) through the fleet equals its two single runs
    bit for bit too;
  * the launcher's default mode on the CPU (two garments): the reference's
    ``[fleet]`` lines, each garment's ``latest`` files shaped as a single
    run's, the test driver on them, ``--epoch best`` after a fleet launch in
    both packages, the baselines refused by name (the reference's fleet
    cannot call their steps), ``ours_edit`` failing at the first loader in
    both;
  * ``slow``: one port fleet step against ``vts_tpu``'s ``FleetTrainer`` on
    the same states and draws, replayed as ``tests/torch_port_step.py`` does,
    for sinskit and for skitG (its G by the 2-norm near-tie rule).
"""

import functools
import inspect
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_step import argv as step_argv
from tests.torch_port_step import env  # noqa: F401  (fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)
from vts_torch.networks.unet_custom import CustomUNet
from vts_torch.parallel import fleet as port_fleet
from vts_torch.parallel import packing as port_packing
from vts_torch.utils.convert_jax import (packed_unet_to_torch, torch_to_unet_params,
                                         torch_to_unet_stats)
from vts_tpu.parallel import packing as jax_packing
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

SIZE, NDOWNS, NGF, IN_NC = 64, 6, 4, 9
RTOL, ATOL = 2e-4, 2e-5


def _garments(g, norm="instance", t_mult=1, pack=1):
    """g seeded port nets (seed i for garment i; running stats set off their
    init so that they are not all equal)."""
    nets = []
    for i in range(g):
        net = CustomUNet(IN_NC, ngf=NGF, num_downs=NDOWNS, num_layer_separate=4,
                         norm_type=norm, t_mult=t_mult, init_gain=0.5)
        net.reset_parameters(torch.Generator().manual_seed(i))
        with torch.no_grad():
            for k, v in net.state_dict().items():
                if k.endswith((".mean", ".var")):
                    v.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(100 + i))
        nets.append(net)
    return nets


def _flax(sd):
    """A port U-Net state dict → (flax params, flax batch_stats) of numpy."""
    return torch_to_unet_params(sd), torch_to_unet_stats(sd)


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _inputs(g, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (1, SIZE, SIZE, IN_NC)).astype(np.float32) for _ in range(g)]


def _assert_sd_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------- packing ---

@pytest.mark.parametrize("norm,t_mult", [("instance", 2), ("batch", 1)])
def test_packing_matches_jax_bit_for_bit(norm, t_mult):
    """The port's pack_tree of 3 garments' state dicts is JAX's pack_tree of
    the same garments' trees, through the packed converter (every conv, the
    grouped transposed convs, biases, norm params and running stats); both
    unpack back to the stack exactly; the leaves one by one too."""
    nets = _garments(3, norm, t_mult)
    sds = [n.state_dict() for n in nets]
    stacked = port_fleet.stack_states(sds)
    packed = port_packing.pack_tree(stacked)
    params, stats = zip(*(_flax(sd) for sd in sds))
    j_params, j_stats = jax_packing.pack_tree(_stack(params)), jax_packing.pack_tree(_stack(stats))
    want = packed_unet_to_torch(jax.tree_util.tree_map(np.asarray, j_params),
                                jax.tree_util.tree_map(np.asarray, j_stats), 3)
    _assert_sd_equal({k: packed[k] for k in want}, want)
    assert set(packed) == set(want)
    # a pack=3 net takes the packed dict as its own
    netp = CustomUNet(IN_NC, ngf=NGF, num_downs=NDOWNS, num_layer_separate=4, norm_type=norm,
                      t_mult=t_mult, pack=3)
    assert {k: v.shape for k, v in netp.state_dict().items()} == \
        {k: v.shape for k, v in packed.items()}
    # round trips: port both ways, and JAX's unpack through the converter
    _assert_sd_equal(port_packing.unpack_tree(packed, 3), stacked)
    _assert_sd_equal(port_packing.pack_tree(port_packing.unpack_tree(packed, 3)), packed)
    back = jax_packing.unpack_tree(j_params, 3)
    for g in range(3):
        got = torch_to_unet_params(port_fleet.unstack_state(port_packing.unpack_tree(packed, 3),
                                                            g))
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                               got, jax.tree_util.tree_map(lambda x: x[g], back))
    for k, v in stacked.items():
        assert torch.equal(port_packing.unpack_leaf(port_packing.pack_leaf(v), 3), v)
    with pytest.raises(ValueError, match="cannot pack"):
        port_packing.pack_leaf(torch.zeros(3))


def test_pack_images_match_jax():
    xs = _inputs(3)
    got = port_packing.pack_images([torch.from_numpy(x) for x in xs])
    want = np.asarray(jax_packing.pack_images([jnp.asarray(x) for x in xs]))
    np.testing.assert_array_equal(got.numpy(), want)
    un = port_packing.unpack_images(got, 3)
    np.testing.assert_array_equal(un.numpy(), np.asarray(jax_packing.unpack_images(want, 3)))
    for g in range(3):
        np.testing.assert_array_equal(un[g].numpy(), xs[g])


def _jax_packed_forward(params, stats, xs, pack, t_mult, norm="instance"):
    from vts_tpu.networks.unet_custom import CustomUNet as JaxUNet
    net = JaxUNet(ngf=NGF, num_downs=NDOWNS, num_layer_separate=4, norm_type=norm,
                  train=True, pack=pack, t_mult=t_mult)
    variables = {"params": jax_packing.pack_tree(_stack(params))}
    out = jax.jit(net.apply)(variables, jax_packing.pack_images([jnp.asarray(x) for x in xs]))
    return out


@pytest.mark.parametrize("pack,t_mult", [(2, 1), (3, 1), (2, 2)])
def test_packed_unet_matches_jax(pack, t_mult):
    """The port's pack=G forward against JAX's on the same packed weights, and
    against the port's own per-garment forwards."""
    nets = _garments(pack, t_mult=t_mult)
    sds = [n.state_dict() for n in nets]
    netp = CustomUNet(IN_NC, ngf=NGF, num_downs=NDOWNS, num_layer_separate=4, t_mult=t_mult,
                      pack=pack)
    netp.load_state_dict(port_packing.pack_tree(port_fleet.stack_states(sds)))
    xs = _inputs(pack, seed=pack)
    with torch.no_grad():
        got = netp(port_packing.pack_images([torch.from_numpy(x) for x in xs]))
        singles = [n(torch.from_numpy(x)) for n, x in zip(nets, xs)]
    want = _jax_packed_forward([_flax(sd)[0] for sd in sds], None, xs, pack, t_mult)
    if t_mult == 1:
        assert got.shape == (1, SIZE, SIZE, 5 * pack)
        got, want = (got,), (want,)
        singles = [(torch.cat(s, -1),) for s in singles]
    for head, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
        per = port_packing.unpack_images(a, pack)
        for g in range(pack):
            np.testing.assert_allclose(per[g].numpy(), singles[g][head].numpy(),
                                       rtol=RTOL, atol=ATOL)
    if t_mult == 2:
        assert got[1].shape == (1, 2 * SIZE, 2 * SIZE, 2 * pack)


def test_packed_gradients_stay_per_garment():
    """A loss on garment 0's slice of the packed output: exactly zero gradient
    on every leaf of garment 1, a nonzero one on garment 0's."""
    nets = _garments(2)
    netp = CustomUNet(IN_NC, ngf=NGF, num_downs=NDOWNS, num_layer_separate=4, pack=2)
    netp.load_state_dict(port_packing.pack_tree(port_fleet.stack_states(
        [n.state_dict() for n in nets])))
    x = port_packing.pack_images([torch.from_numpy(x) for x in _inputs(2, seed=5)])
    loss = port_packing.unpack_images(netp(x), 2)[0].abs().sum()
    grads = dict(zip([k for k, _ in netp.named_parameters()],
                     torch.autograd.grad(loss, list(netp.parameters()))))
    per = port_packing.unpack_tree(grads, 2)
    assert max(v[0].abs().max().item() for v in per.values()) > 0
    assert max(v[1].abs().max().item() for v in per.values()) == 0.0


def test_style_code_with_pack_raises_as_the_reference():
    from vts_tpu.networks.unet_custom import CustomUNet as JaxUNet
    with pytest.raises(NotImplementedError) as want:
        JaxUNet(ngf=NGF, num_downs=NDOWNS, use_style_code=True, pack=2).init(
            jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 2 * IN_NC)), jnp.zeros((1, 512)))
    with pytest.raises(NotImplementedError) as got:
        CustomUNet(IN_NC, ngf=NGF, num_downs=NDOWNS, use_style_code=True, pack=2)
    assert str(got.value) == str(want.value)


def test_stack_states_and_batches_match_jax():
    """stack_states / unstack_state on state dicts are JAX's on the same
    garments' trees; stack_batches keeps the keys every batch has."""
    from vts_tpu.parallel.fleet import stack_batches, stack_states, unstack_state
    sds = [n.state_dict() for n in _garments(2, "batch")]
    stacked = port_fleet.stack_states(sds)
    want = stack_states([_flax(sd)[0] for sd in sds])
    got = _stack([torch_to_unet_params(port_fleet.unstack_state(stacked, g)) for g in range(2)])
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                           got, want)
    for g in range(2):
        _assert_sd_equal(port_fleet.unstack_state(stacked, g), sds[g])
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                               torch_to_unet_params(port_fleet.unstack_state(stacked, g)),
                               unstack_state(want, g))
    rng = np.random.default_rng(3)
    batches = [{"S": rng.normal(size=(1, 8, 8, 1)).astype(np.float32),
                "T_valid": rng.normal(size=(1, 4)).astype(np.float32),
                "only_0": np.ones(2, np.float32)},
               {"T_valid": rng.normal(size=(1, 4)).astype(np.float32),
                "S": rng.normal(size=(1, 8, 8, 1)).astype(np.float32)}]
    got, want = port_fleet.stack_batches(batches), stack_batches(batches)
    assert list(got) == ["S", "T_valid"] and set(want) == set(got)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert port_fleet.common_keys(batches) == ["S", "T_valid"]
    with pytest.raises(ValueError, match="different keys"):
        port_fleet.stack_states([sds[0], {"x": torch.zeros(1)}])


# ------------------------------------------------------------------- fleet ---

def _opt(tmp, extra=()):
    from vts_torch.config import TrainOptions
    return TrainOptions().parse(step_argv(tmp, 1, d3=True, extra=(
        "--vision_aided_warmup_epoch", "2", "--lambda_G1_lpips", "0", "--device", "cpu",
        "--no_html", *extra)),
        quiet=True)


def _batches(tmp):
    from vts_torch.data import create_dataset
    it = iter(create_dataset(_opt(tmp)))
    return [next(it), next(it)]


def _state(model):
    """Every tensor a garment's step moves: the nets' state dicts (params and
    running stats) and the Adam moments."""
    out = {}
    for name, net in model.nets().items():
        out.update({f"{name}.{k}": v.clone() for k, v in net.state_dict().items()})
        a = model.adam[name]
        out.update({f"{name}.mu.{k}": v.clone() for k, v in a.mu.items()})
        out.update({f"{name}.nu.{k}": v.clone() for k, v in a.nu.items()})
    return out


@pytest.fixture(scope="module")
def fleet_run(env):  # noqa: F811
    """Two garments through a fleet, epoch 1 (before D3) then epoch 2 (D3 on),
    each step's garments' states and losses kept; the same two as single
    port runs with ``--seed g``, which draw from their own generators."""
    from vts_torch.models import create_model
    batches = _batches(env)
    model = create_model(_opt(env))
    trainer = port_fleet.FleetTrainer(model, 2)
    trainer.init_states()
    res = {"init": [], "fleet": [], "single": [], "fleet_losses": [], "single_losses": []}
    for g in range(2):
        trainer.select(g)
        res["init"].append(_state(model))
    seen = []
    real = model.lpips_net.forward

    def spy(*a, **kw):
        seen.append(next(iter(model.lpips_net.state_dict().values())).data_ptr())
        return real(*a, **kw)
    model.lpips_net.forward = spy
    for epoch in (1, 2):
        res["fleet_losses"].append(trainer.step(batches, epoch))
        per = []
        for g in range(2):
            trainer.select(g)
            per.append(_state(model))
        res["fleet"].append(per)
    model.lpips_net.forward = real
    res["lpips_ptrs"], res["clip"] = seen, model.clip
    singles = []
    for g in range(2):
        m = create_model(_opt(env, ("--seed", str(g))))
        m.setup()
        singles.append(m)
    res["single_init"] = [_state(m) for m in singles]
    for epoch in (1, 2):
        losses, per = [], []
        for m, b in zip(singles, batches):
            m.set_input(b)
            m.optimize_parameters(epoch)
            losses.append(dict(m._losses))
            per.append(_state(m))
        res["single"].append(per)
        res["single_losses"].append(losses)
    res.update(batches=batches, trainer=trainer, env=env)
    return res


def test_fleet_garments_initialize_as_single_runs_with_their_seed(fleet_run):
    for g in range(2):
        a, b = fleet_run["init"][g], fleet_run["single_init"][g]
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), g
    assert not torch.equal(fleet_run["init"][0]["G.down.down0.conv.weight"],
                           fleet_run["init"][1]["G.down.down0.conv.weight"])


@pytest.mark.parametrize("epoch", [1, 2], ids=["before_d3", "d3_active"])
def test_fleet_step_equals_single_steps_bit_for_bit(fleet_run, epoch):
    """Every loss, parameter, running statistic and Adam moment of each
    garment after the fleet's step equals the single run's, exactly."""
    i = epoch - 1
    for g in range(2):
        lf, ls = fleet_run["fleet_losses"][i][g], fleet_run["single_losses"][i][g]
        assert lf.keys() == ls.keys() and (("G_D3" in lf) == (epoch == 2))
        for k in lf:
            assert torch.equal(torch.as_tensor(lf[k]), torch.as_tensor(ls[k])), (g, k)
        a, b = fleet_run["fleet"][i][g], fleet_run["single"][i][g]
        assert a.keys() == b.keys()
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        assert not bad, (g, bad[:5])


def test_skitg_fleet_step_equals_single_steps_bit_for_bit(env):  # noqa: F811
    """skitG through the fleet: two garments of the skit dataset (the style
    code from each batch's style image) step as the two single skitG runs
    with ``--seed g`` do, every loss, parameter, running statistic and Adam
    moment exactly."""
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model
    skit = ("--model", "skit")
    it = iter(create_dataset(_opt(env, skit)))
    batches = [next(it), next(it)]
    assert all("style_image" in b for b in batches)
    trainer = port_fleet.FleetTrainer(create_model(_opt(env, skit)), 2)
    trainer.init_states()
    fleet_losses = trainer.step(batches, 1)
    for g, b in enumerate(batches):
        trainer.select(g)
        got = _state(trainer.model)
        single = create_model(_opt(env, skit + ("--seed", str(g))))
        single.setup()
        single.set_input(b)
        single.optimize_parameters(1)
        want = _state(single)
        assert fleet_losses[g].keys() == single._losses.keys()
        assert all(torch.equal(torch.as_tensor(fleet_losses[g][k]),
                               torch.as_tensor(single._losses[k])) for k in fleet_losses[g])
        assert got.keys() == want.keys() and single.opt.use_style_code
        bad = [k for k in got if not torch.equal(got[k], want[k])]
        assert not bad, (g, bad[:5])


def test_fleet_towers_are_one_copy(fleet_run):
    """Both garments' steps ran the one LPIPS tower (its weights at one
    address), and the model holds one CLIP tower for D3."""
    ptrs = fleet_run["lpips_ptrs"]
    assert len(ptrs) >= 4 and len(set(ptrs)) == 1
    trainer = fleet_run["trainer"]
    for g in range(2):
        trainer.select(g)
        assert trainer.model.clip is fleet_run["clip"]
    assert trainer.slots[0].nets["G"] is not trainer.slots[1].nets["G"]


def test_fleet_garment_zero_does_not_depend_on_garment_one(fleet_run):
    """Garment 1's batch changed (its sketch and image shifted), the draws
    injected (each garment's, drawn from its own generator): garment 0's
    update is bit for bit the fleet's above."""
    from vts_torch.models import create_model
    b0, b1 = fleet_run["batches"]
    b1x = {k: v + 0.25 if k in ("S", "I") else v for k, v in b1.items()}
    trainer = port_fleet.FleetTrainer(create_model(_opt(fleet_run["env"])), 2)
    trainer.init_states()
    draws = []
    for g in range(2):
        trainer.select(g)
        draws.append(trainer.model.draw(1, (256, 256)))
    losses = trainer.step([b0, b1x], 1, draws=draws)
    trainer.select(0)
    got, want = _state(trainer.model), fleet_run["fleet"][0][0]
    assert all(torch.equal(got[k], want[k]) for k in want)
    lw = fleet_run["fleet_losses"][0]
    assert all(torch.equal(torch.as_tensor(losses[0][k]), torch.as_tensor(v))
               for k, v in lw[0].items())
    assert float(losses[1]["G_L1"]) != float(lw[1]["G_L1"])


# ---------------------------------------------------------------- launcher ---

FLEET_LINE = re.compile(
    r"^\[fleet\] epoch (\d+)/(\d+) \((\d+)s\)((?: [A-Za-z0-9_]+:-?\d+\.\d{3})+)$")
MATERIALS = ("synthA", "synthB")
TEMPLATE = "synthetic://{material}?size=320&center_w=192&center_h=128&patches=6&val_patches=3"
SMALL = ["--device", "cpu", "--crop_size", "256", "--center_w", "192", "--center_h", "128",
         "--ngf", "4", "--ndf", "4", "--batch_size_G2", "4", "--batch_size_G2_val", "3",
         "--add_fake_T_sample_size", "3", "--use_vision_aided_loss", "false",
         "--lambda_G1_lpips", "0"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``vts_torch.launch ours launch`` with its default mode, on the CPU, two
    garments, 2 epochs of 1 step."""
    import vts_torch.launch as port_launch
    tmp = tmp_path_factory.mktemp("fleet")
    dirs = ["--checkpoints_dir", str(tmp / "c"), "--results_dir", str(tmp / "r")]
    out = io.StringIO()
    with redirect_stdout(out):
        rc = port_launch.main(["ours", "launch", "--materials", ",".join(MATERIALS),
                               "--dataroot-template", TEMPLATE, *dirs, "--", *SMALL,
                               "--data_len", "1", "--n_epochs", "2", "--n_epochs_decay", "0"])
    return tmp, dirs, rc, out.getvalue()


def test_fleet_launch_prints_the_reference_lines(launched):
    _, _, rc, text = launched
    assert rc == 0
    lines = [ln for ln in text.splitlines() if ln.startswith("[fleet]")]
    assert lines[0] == "[fleet] 2 garments over 1 devices"
    assert re.fullmatch(r"\[fleet\] trained 2 garments in \d+s", lines[-1])
    epochs = [FLEET_LINE.match(ln) for ln in lines[1:-1]]
    assert [m.group(1, 2) for m in epochs] == [("1", "2"), ("2", "2")]
    names = [kv.split(":")[0] for kv in epochs[0].group(4).split()]
    # every loss, sorted; the reference prints the first six of the same list
    assert names == sorted(names) and {"G_total", "D_fake_I", "G2_L1"} <= set(names)
    assert "[device] fleet trains on cpu" in text


def test_fleet_checkpoints_have_a_single_runs_trees(launched, env):  # noqa: F811
    """Each garment's latest G, D and D2 files (params, stats, Adam) hold the
    trees and shapes that a single-garment port run writes."""
    from vts_torch.models import create_model
    from vts_torch.utils.msgpack import msgpack_restore
    tmp, dirs, _, _ = launched
    single = create_model(_opt(env, ("--ngf", "4", "--ndf", "4")))
    single.setup()
    single.save_networks("latest", ckpt_dir=str(tmp / "single"))

    def shapes(path):
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        return jax.tree_util.tree_map(np.shape, tree)
    for m in MATERIALS:
        ck = tmp / "c" / f"{m}_sinskitG_baseline_ours"
        for kind in ("net", "opt"):
            for net in ("G", "D", "D2"):
                f = f"latest_{kind}_{net}.msgpack"
                assert shapes(ck / f) == shapes(tmp / "single" / f), (m, f)


def test_fleet_latest_goes_through_the_test_driver(launched):
    """``vts_torch.test --epoch latest`` loads a fleet garment's G (no "not
    found") and scores it: 8 finite metrics."""
    from vts_torch.test import test as port_test
    tmp, dirs, _, _ = launched
    out = io.StringIO()
    with redirect_stdout(out):
        metrics = port_test(["--model", "sinskit", "--name", "synthB_sinskitG_baseline_ours",
                             "--epoch", "latest", "--dataroot", TEMPLATE.format(material="synthB"),
                             "--device", "cpu", "--ngf", "4", "--crop_size", "256",
                             "--center_w", "192", "--center_h", "128", "--batch_size_G2", "1",
                             *dirs])[0]
    assert "not found" not in out.getvalue()
    assert len(metrics) == 8 and all(np.isfinite(v) for v in metrics.values())


def test_epoch_best_after_a_fleet_keeps_the_initialized_weights_in_both(launched, capsys):
    """A fleet writes no ``best``: the test phase's default ``--epoch best``
    then keeps the initialized G in both packages, with the same message."""
    from vts_torch.config import TestOptions
    from vts_torch.models import create_model
    from vts_tpu.models.base import NetState, load_net
    tmp, dirs, _, _ = launched
    name = "synthA_sinskitG_baseline_ours"
    model = create_model(TestOptions().parse(
        ["--model", "sinskit", "--name", name, "--dataroot", TEMPLATE.format(material="synthA"),
         "--device", "cpu", "--ngf", "4", *dirs], quiet=True))
    model.setup()
    before = {k: v.clone() for k, v in model.netG.state_dict().items()}
    capsys.readouterr()
    model.load_networks("best")
    port_msg = capsys.readouterr().out.strip()
    assert all(torch.equal(v, model.netG.state_dict()[k]) for k, v in before.items())
    state = NetState(params={"w": jnp.zeros(2)}, stats={})
    assert load_net(str(tmp / "c" / name), "best", "G", state) is state
    jax_msg = capsys.readouterr().out.strip()
    assert port_msg == jax_msg and jax_msg.endswith("not found — keeping initialized weights")


@pytest.mark.parametrize("method", ["pix2pix", "pix2pixhd", "spade"])
def test_baselines_are_refused_by_the_fleet(method, tmp_path, monkeypatch):
    """The reference's fleet wraps ``_train_step(..., use_d3=...)`` and calls it
    with ``frozen`` (``vts_tpu/parallel/fleet.py:62``, ``:71``), which these
    models' steps do not take; the port refuses their presets by name, before
    any data is built."""
    import vts_torch.data
    import vts_torch.launch as port_launch
    from vts_tpu.models import pix2pix, pix2pixhd, spade
    from vts_tpu.models.sinskit import SinSKITModel
    cls = {"pix2pix": pix2pix.Pix2PixModel, "pix2pixhd": pix2pixhd.Pix2PixHDModel,
           "spade": spade.SPADEModel}[method]
    params = set(inspect.signature(cls._train_step).parameters)
    assert {"frozen", "use_d3"} <= set(inspect.signature(SinSKITModel._train_step).parameters)
    assert not params & {"frozen", "use_d3"}
    monkeypatch.setattr(vts_torch.data, "create_dataset", lambda opt: pytest.fail("data built"))
    with pytest.raises(ValueError, match=rf"--mode fleet cannot train '{method}'"):
        port_launch.main([method, "launch", "--materials", "a,b",
                          "--checkpoints_dir", str(tmp_path), "--", "--device", "cpu"])


def test_ours_edit_launch_fails_at_the_first_loader_in_both(tmp_path):
    """``ours_edit`` on edited-sketch roots (testS and testM only): both
    packages' fleets fail building the first garment's training loader (no
    training sketch), before any model."""
    import vts_torch.launch as port_launch
    import vts_tpu.launch as jax_launch
    from PIL import Image
    for m in MATERIALS:
        for sub, mode in (("testS", "L"), ("testM", "L")):
            d = tmp_path / f"singleskit_{m}_edit_padded_320_x1" / sub
            d.mkdir(parents=True)
            Image.new(mode, (320, 320), 255).save(d / f"{m}_sketch.png")
    argv = ["ours_edit", "launch", "--materials", ",".join(MATERIALS), "--dataroot-template",
            str(tmp_path / "singleskit_{material}_edit_padded_320_x1") + "/",
            "--checkpoints_dir", str(tmp_path / "c"), "--results_dir", str(tmp_path / "r")]
    with pytest.raises(AssertionError, match="exactly one sketch, got \\[\\]"):
        jax_launch.main(argv)
    with pytest.raises(ValueError, match="exactly one sketch, got \\[\\]"):
        port_launch.main(argv + ["--", "--device", "cpu"])


# -------------------------------------------------------------------- slow ---

def _fleet_against_jax_fleet_trainer(env, extra=(), batch_fn=None, near_tie=False):  # noqa: F811
    """One D3-off fleet step of two garments in both packages (``extra``: the
    flags of both; ``batch_fn`` maps each garment's batch) from the same
    states and draws, held as :func:`test_fleet_step_matches_jax_fleet_trainer`
    states; with ``near_tie``, each garment's G in the 2-norm alone, to 1e-4
    plus twice how far the port's own fleet step moves that gradient
    (relative, in the 2-norm) under a 1e-6 relative change of the garments'
    G weights."""
    from tests.test_torch_port_train import _grad_tol
    from tests.torch_port_step import flat, jax_batch, jax_draws, np_tree, rel_norm
    from vts_torch.models import create_model
    from vts_torch.utils.convert_jax import (fleet_states_to_torch, torch_to_d_params)
    from vts_tpu.models import create_model as jax_create_model
    from vts_tpu.models.base import NetState
    from vts_tpu.parallel.fleet import FleetTrainer, stack_batches, stack_states
    from vts_tpu.parallel.mesh import build_mesh

    jopt, batch0 = jax_batch(env, 1, extra=extra)
    batches = [batch0, {k: np.ascontiguousarray(v[:, ::-1]) if k == "S" else v
                        for k, v in batch0.items()}]
    if batch_fn is not None:
        batches = [batch_fn(b) for b in batches]
    from vts_torch.config import TrainOptions
    model = create_model(TrainOptions().parse(step_argv(env, 1, extra=extra)
                                              + ["--device", "cpu", "--no_html"], quiet=True))
    trainer = port_fleet.FleetTrainer(model, 2)
    trainer.init_states()
    jm = jax_create_model(jopt)
    txs = {"G": jm.tx_g, "D": jm.tx_d, "D2": jm.tx_d2}
    stacked = {}
    for name in ("G", "D", "D2"):
        per = []
        for g in range(2):
            sd = trainer.slots[g].nets[name].state_dict()
            params, stats = ((torch_to_unet_params(sd), torch_to_unet_stats(sd)) if name == "G"
                             else torch_to_d_params(sd))
            params = jax.tree_util.tree_map(jnp.asarray, params)
            per.append(NetState(params=params, stats=jax.tree_util.tree_map(jnp.asarray, stats),
                                opt_state=txs[name].init(params)))
        stacked[name] = stack_states(per)
    # the JAX states come back to the port unchanged
    trainer.load_states(fleet_states_to_torch(jax.tree_util.tree_map(np.asarray, stacked), 2))
    jt = FleetTrainer(jm, build_mesh("garment:2"), num_garments=2)
    per_in = []
    for b in batches:
        jm.set_input(b)
        per_in.append({k: np.asarray(v) for k, v in jm._input.items()})
    rngs = jax.random.split(jax.random.key(42), 2)
    gS, dS, d2S, losses, _ = jt.step(stacked["G"], stacked["D"], stacked["D2"],
                                     stack_batches(per_in), rngs, jopt.lr, jopt.lr_G2, 1)
    port_losses = trainer.step(batches, 1, draws=[jax_draws(rngs[g], 1) for g in range(2)])
    new = {"G": gS, "D": dS, "D2": d2S}
    jump = [0.0, 0.0]
    if near_tie:
        noise = np.random.default_rng(0)
        shaken = dict(stacked, G=stacked["G"].replace(params=jax.tree_util.tree_map(
            lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape).astype(np.float32)),
            stacked["G"].params)))
        other = port_fleet.FleetTrainer(create_model(model.opt), 2)
        other.init_states()
        other.load_states(fleet_states_to_torch(jax.tree_util.tree_map(np.asarray, shaken), 2))
        other.step(batches, 1, draws=[jax_draws(rngs[g], 1) for g in range(2)])
        jump = [rel_norm(flat(torch_to_unet_params(other.slots[g].adam["G"].mu)),
                         flat(torch_to_unet_params(trainer.slots[g].adam["G"].mu)))
                for g in range(2)]
    for g in range(2):
        assert set(port_losses[g]) == set(losses)
        for k, v in port_losses[g].items():
            np.testing.assert_allclose(float(v), float(np.asarray(losses[k])[g]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"garment {g} loss {k}")
        for name in ("G", "D", "D2"):
            mu = trainer.slots[g].adam[name].mu
            got = flat(torch_to_unet_params(mu) if name == "G" else torch_to_d_params(mu)[0])
            want = flat(jax.tree_util.tree_map(lambda x: np.asarray(x)[g],
                                               np_tree(new[name].opt_state.mu)))
            assert got.keys() == want.keys()
            net_max = max(np.abs(v).max() for v in want.values())
            ratio = {k: np.abs(got[k] - want[k]).max() / _grad_tol(k, want[k], net_max)
                     for k in want}
            d2 = sum(float(((got[k] - want[k]).astype(np.float64) ** 2).sum()) for k in want)
            r2 = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in want)
            worst = max(ratio, key=ratio.get)
            print(f"garment {g} {name}: worst per-leaf |d|/_grad_tol {ratio[worst]:.2f} at "
                  f"{worst}, |d|/|g| over the network {np.sqrt(d2 / r2):.2e}"
                  + (f", the port's near-tie jump {jump[g]:.2e}" if name == "G" and near_tie
                     else ""))
            if name == "G" and near_tie:
                assert np.sqrt(d2 / r2) <= 1e-4 + 2 * jump[g], (g, name, jump[g])
            else:
                assert ratio[worst] <= 4 and np.sqrt(d2 / r2) <= 1e-4, (g, name, worst)


@pytest.mark.slow
def test_fleet_step_matches_jax_fleet_trainer(env):  # noqa: F811
    """One D3-off fleet step of two garments in both packages from the same
    states (the port's seeded weights through the converters into JAX's
    garment-stacked ``NetState``s, and back through ``fleet_states_to_torch``)
    and the same draws (each garment's split from its key as JAX's step
    splits it): losses within rtol 1e-4, each garment's G, D and D2
    gradients (Adam's first moment, β1 = 0) per leaf within 4×
    ``tests/test_torch_port_train.py``'s ``_grad_tol`` and 1e-4 in the
    2-norm over each network (the x2 and skitG rule): JAX's vmapped convs
    sum in another order than its single step (``tests/test_parallel.py``
    holds its own fleet to the single step at rtol 1e-2): garment 1's G
    read 1.2× the single step's per-leaf rule at one leaf when it took
    garment 0's batch, 0.67× with the flipped sketch here."""
    _fleet_against_jax_fleet_trainer(env)


@pytest.mark.slow
def test_skitg_fleet_step_matches_jax_fleet_trainer(env):  # noqa: F811
    """skitG through the fleet, two garments (the second with its sketch
    flipped), against ``vts_tpu``'s ``FleetTrainer`` on the skit model, the
    style code entering both as ``batch["style_code"]`` (the port's CLIP
    encoding of each batch's style image) so that JAX compiles no CLIP:
    held as the sinskit fleet step above, but each garment's G in the
    2-norm alone, by the near-tie rule of ``ROADMAP.md`` §C: 1e-4 plus twice
    what a 1e-6 relative change of G's weights does to the port's own G
    gradient.  The touch LPIPS's fp32 max-pool near-ties
    (``tests/test_torch_port_skit.py``) sit in this step's way: garment 0's
    G read 7.1e-4 from JAX's fleet in the 2-norm (53× ``_grad_tol`` at one
    leaf of ``up3_T``), the port's own jump 7.4e-4.  ``slow``, as its
    sinskit sibling: the JAX fleet's compile takes ~70 s in one process."""
    from vts_torch.networks.clip_vit import CLIPViT, clip_style_code, init_clip_params
    clip = CLIPViT(init_clip_params(0))

    def with_code(batch):
        with torch.no_grad():
            code = clip_style_code(clip, torch.from_numpy(batch["style_image"])).numpy()
        return {**batch, "style_code": code}
    _fleet_against_jax_fleet_trainer(env, ("--model", "skit"), with_code, near_tie=True)
