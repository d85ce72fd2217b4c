"""Several devices in the port against ``vts_tpu`` on the CPU: the layouts
(``vts_torch/parallel/mesh.py``), the sample-mixing ops over two ranks (the
batch norm, the D2 masked means, the StyleGAN2 minibatch stddev) against the
reference's on the whole batch, the garment fleet over two ranks against the
one-process fleet, ``--multihost`` against spawned ranks, and the baselines'
single-device step under ``--mesh data:2``.  Ranks are spawned gloo
processes on the CPU (``vts_torch.platform.spawn_ranks``: a file store in
the test's temporary directory, one intra-op thread each); the dp step
against JAX's batch step is ``tests/test_torch_port_train.py``'s ``dp2``
case."""

import inspect
import io
import os
import re
import socket
import subprocess
import sys
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_port_ranks as ranks
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import flat
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU2 = [torch.device("cpu")] * 2
SMALL = ["--device", "cpu", "--crop_size", "256", "--center_w", "192", "--center_h", "128",
         "--ngf", "4", "--ndf", "4", "--batch_size_G2", "4", "--batch_size_G2_val", "3",
         "--add_fake_T_sample_size", "3", "--use_vision_aided_loss", "false", "--no_html"]
TEMPLATE = "synthetic://{material}?size=320&center_w=192&center_h=128&patches=6&val_patches=3"


def _spawn(fn, *args, tmp):
    from vts_torch.platform import spawn_ranks
    return spawn_ranks(fn, args, CPU2, threads=1, tmp_dir=str(tmp))


# ------------------------------------------------------------- layouts ---

SPECS = ["", "data:2", "garment:4,data:2", "garment:2,spatial:2", "spatial:8", "data:16",
         "garment:3,data:3", "pipe:2"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_matches_jax(spec):
    """``parse_mesh_spec`` and ``build_mesh`` over 8 devices against the
    reference's on XLA's 8 host devices: the same axes and sizes, the same
    failures with the same text."""
    from vts_torch.parallel import mesh as port
    from vts_tpu.parallel import mesh as ref

    def outcome(mod, devices):
        try:
            m = mod.build_mesh(spec, devices)
        except (AssertionError, ValueError) as err:
            return type(err).__name__, str(err)
        if hasattr(m, "sizes"):
            return tuple(m.sizes), tuple(m.sizes.values())
        return tuple(m.axis_names), tuple(m.devices.shape)

    want = outcome(ref, jax.devices())
    got = outcome(port, [torch.device("cpu")] * 8)
    assert got == want
    if spec == "pipe:2":
        with pytest.raises(ValueError) as err:
            ref.parse_mesh_spec(spec)
        with pytest.raises(ValueError, match=re.escape(str(err.value))):
            port.parse_mesh_spec(spec)
    else:
        assert port.parse_mesh_spec(spec) == ref.parse_mesh_spec(spec)


def test_mesh_lays_devices_out_row_major_and_factors_as_jax():
    """The layout's devices in ``np.reshape``'s order, as the reference's
    ``Mesh`` holds them; each rank's data group; ``factor_devices``."""
    from vts_torch.parallel.mesh import build_mesh, factor_devices
    from vts_tpu.parallel import mesh as ref
    devs = [torch.device("cpu", i) for i in range(8)]
    m = build_mesh("garment:2,data:2", devs)
    jm = ref.build_mesh("garment:2,data:2", jax.devices())
    assert [[d.index for d in row] for row in m.devices] == \
        [[d.id for d in row] for row in jm.devices]
    assert m.data_groups() == [[0, 1], [2, 3]]
    assert build_mesh("data:2,garment:2", devs).data_groups() == [[0, 2], [1, 3]]
    assert build_mesh("garment:2,data:2,spatial:2", devs).data_groups() == \
        [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert [factor_devices(n) for n in range(1, 10)] == \
        [ref.factor_devices(n) for n in range(1, 10)]


@pytest.mark.parametrize("garments,axis", [(4, 2), (8, 4), (6, 3), (3, 2), (20, 8)])
def test_garment_blocks_match_the_references_sharding(garments, axis):
    """The garments each device holds: ``P("garment")``'s shards of the
    reference, or its ``device_put`` failure where the axis does not divide
    the garment count (20 garments on 8 cards)."""
    from vts_torch.parallel.mesh import garment_block
    from vts_tpu.parallel.mesh import build_mesh
    mesh = build_mesh(f"garment:{axis}", jax.devices())
    try:
        arr = jax.device_put(np.arange(garments), NamedSharding(mesh, P("garment")))
    except ValueError:
        with pytest.raises(ValueError, match=rf"--mesh garment:{axis} cannot shard {garments}"):
            garment_block(garments, axis, 0)
        return
    want = {s.device.id: list(np.asarray(s.data)) for s in arr.addressable_shards}
    got = {i: list(garment_block(garments, axis, i)) for i in range(axis)}
    assert got == want


# ------------------------------------------------- ops that mix samples ---

def _sg2_pair():
    from vts_torch.networks.stylegan2 import StyleGAN2Discriminator
    from vts_tpu.networks.stylegan2 import StyleGAN2Discriminator as J
    kw = {"ndf": 4, "crop_size": 64, "input_size": (32, 32)}
    net = StyleGAN2Discriminator(7, **kw)
    net.reset_parameters(torch.Generator().manual_seed(11))
    return net, J(ndf=4, crop_size=64), kw


def _skit_serial(tmp):
    """skitG's serial batch-2 step: (its options under ``--mesh data:2``, the
    batch, the whole batch's draws, the model after the step)."""
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model
    argv = ["--model", "skit", "--name", "sk", "--dataroot", TEMPLATE.format(material="smoke"),
            "--data_len", "2", "--batch_size", "2", "--checkpoints_dir", str(tmp), *SMALL]
    opt = TrainOptions().parse(argv, quiet=True)
    serial = create_model(opt)
    serial.setup()
    batch = next(iter(create_dataset(opt)))
    draws = serial.draw(2)
    serial.set_input(batch)
    serial.optimize_parameters(1, draws=draws)
    return TrainOptions().parse(argv + ["--mesh", "data:2"], quiet=True), batch, draws, serial


@pytest.fixture(scope="module")
def ops(env, tmp_path_factory):  # noqa: F811
    """The ops over 2 ranks, one half of each batch each, a skitG step and a
    fleet garment a rank (one spawn for all); the inputs."""
    tmp = tmp_path_factory.mktemp("ops")
    *skit, serial = _skit_serial(tmp)
    rng = np.random.default_rng(0)
    bn = (rng.normal(0.3, 1.5, (4, 8, 8, 6)).astype(np.float32),
          rng.normal(size=(4, 8, 8, 6)).astype(np.float32),
          rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(size=6).astype(np.float32))
    valid = (rng.uniform(size=24) > 0.4).astype(np.float32)
    valid[12:] = 0.0
    valid[12] = 1.0                 # the second rank holds one valid patch of 12
    masked = (rng.uniform(0.5, 2.0, 24).astype(np.float32), valid, 2)
    net, _, kw = _sg2_pair()
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    x = rng.uniform(-1, 1, (8, 32, 32, 7)).astype(np.float32)
    ct = rng.normal(size=(8, 1)).astype(np.float32)
    res = _spawn(ranks.ops_rank, bn, masked, (sd, x, ct, kw), skit,
                 (*_fleet_inputs(env), 1), tmp=tmp)
    return {"bn": bn, "masked": masked, "sg2": (sd, x, ct), "skit": serial}, res


def test_batch_norm_over_ranks_matches_flax_on_the_whole_batch(ops):
    """Two ranks, two samples each, against ``flax.linen.BatchNorm`` on all
    four: the output, the input gradient, the scale and bias gradients
    (summed over the ranks) and the running mean and variance (the same on
    both ranks), each within rtol 1e-5 (atol 1e-6 of the tensor's max)."""
    import flax.linen as fnn
    inputs, res = ops
    x, ct, scale, bias = inputs["bn"]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}

    def f(p, xx):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return y, mut["batch_stats"]
    y, vjp, new = jax.vjp(f, params, jnp.asarray(x), has_aux=True)
    gp, gx = vjp(jnp.asarray(ct))
    want = {"y": np.asarray(y), "dx": np.asarray(gx), "dscale": np.asarray(gp["scale"]),
            "dbias": np.asarray(gp["bias"]), "mean": np.asarray(new["mean"]),
            "var": np.asarray(new["var"])}
    for key, w in want.items():
        if key in ("y", "dx"):
            got = np.concatenate([r["bn"][key].numpy() for r in res])
        else:
            got = res[0]["bn"][key].numpy()
            np.testing.assert_array_equal(got, res[1]["bn"][key].numpy(), err_msg=key)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(), err_msg=key)


def test_masked_means_over_ranks_match_jax_on_the_whole_batch(ops):
    """D2's validity-masked mean over the global valid count and G2's
    per-image patch sum over the global batch size: the ranks' shares sum
    to the reference's value on all the patches, and each rank's gradient is
    its rows of the reference's (rtol 1e-6)."""
    from vts_tpu.losses.gan_masked import masked_mean, masked_patch_sum
    inputs, res = ops
    vec, valid, n = inputs["masked"]

    def f(v):
        return masked_mean(v, jnp.asarray(valid)) + masked_patch_sum(v, jnp.asarray(valid)) / n
    value, grad = jax.value_and_grad(f)(jnp.asarray(vec))
    for r in res:
        np.testing.assert_allclose(float(r["masked"]["value"]), float(value), rtol=1e-6)
    got = np.concatenate([r["masked"]["grad"].numpy() for r in res])
    np.testing.assert_allclose(got, np.asarray(grad), rtol=1e-6, atol=1e-9)


def test_stylegan2_stddev_over_ranks_matches_jax_on_the_whole_batch(ops):
    """The StyleGAN2 D on 8 patches, four a rank: its minibatch stddev groups
    min(8, 4) samples across the ranks in the reference's group-major order.
    The logits, the input gradient and every parameter gradient (summed
    over the ranks) against the reference's D on all 8, within 1e-4 of each
    tensor's max (a D's logit is ill-conditioned in fp32: the zoo's rule)."""
    from vts_torch.utils.convert_jax import torch_to_stylegan2_params
    inputs, res = ops
    sd, x, ct = inputs["sg2"]
    _, jnet, _ = _sg2_pair()
    params = torch_to_stylegan2_params({k: torch.from_numpy(v) for k, v in sd.items()})
    params = jax.tree_util.tree_map(jnp.asarray, params)
    @jax.jit
    def run(p, xx, c):
        y, vjp = jax.vjp(lambda p, xx: jnet.apply({"params": p}, xx), p, xx)
        return (y,) + vjp(c)
    y, gp, gx = run(params, jnp.asarray(x), jnp.asarray(ct))
    got_y = np.concatenate([r["sg2"]["y"].numpy() for r in res])
    got_dx = np.concatenate([r["sg2"]["dx"].numpy() for r in res])
    for got, want in ((got_y, np.asarray(y)), (got_dx, np.asarray(gx))):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    got_p = flat(torch_to_stylegan2_params(res[0]["sg2"]["dparams"]))
    want_p = flat(gp)
    assert got_p.keys() == want_p.keys()
    for k in want_p:
        assert np.abs(got_p[k] - want_p[k]).max() <= 1e-4 * np.abs(want_p[k]).max() + 1e-9, k
    # alone, each rank's stddev would differ: the groups do span the ranks
    from vts_torch.networks.stylegan2 import _minibatch_stddev
    h = torch.from_numpy(x).reshape(8, -1)[:, :16].reshape(8, 4, 4, 1)
    assert not torch.equal(_minibatch_stddev(h)[:4], _minibatch_stddev(h[:4]))


# ------------------------------------------------------------ the fleet ---

def _fleet_argv(env, m):  # noqa: F811
    return ["--model", "sinskit", "--name", f"{m}_fleet", "--dataroot",
            TEMPLATE.format(material=m), "--data_len", "1",
            "--checkpoints_dir", str(env / "fleet_ckpt"), *SMALL]


def _fleet_inputs(env):  # noqa: F811
    """Two 256² garments' argvs and first batches."""
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    argvs = [_fleet_argv(env, m) for m in ("synthA", "synthB")]
    return argvs, [next(iter(create_dataset(TrainOptions().parse(a, quiet=True))))
                   for a in argvs]


def test_fleet_over_two_ranks_is_the_one_process_fleet_bit_for_bit(ops, env):  # noqa: F811
    """Two 256² garments, one a rank, against the one-process fleet of both:
    every loss and every parameter, statistic and Adam tensor the same bits;
    the loss means gathered over the ranks those of the one-process fleet."""
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_torch.parallel.fleet import FleetTrainer
    argvs, batches = _fleet_inputs(env)
    trainer = FleetTrainer(create_model(TrainOptions().parse(argvs[0], quiet=True)), 2)
    trainer.init_states()
    trainer.step(batches, 1)
    res = [r["fleet"] for r in ops[1]]
    for g, got in enumerate(res):
        trainer.select(g)
        want = ranks._state(trainer.model)
        assert got["state"].keys() == want.keys()
        assert all(torch.equal(got["state"][k], want[k]) for k in want), g
        assert got["losses"].keys() == trainer.losses[g].keys()
        assert all(torch.equal(got["losses"][k], torch.as_tensor(v))
                   for k, v in trainer.losses[g].items()), g
    assert res[0]["means"] == res[1]["means"] == trainer.mean_losses()


def test_fleet_refuses_a_garment_axis_that_does_not_divide_the_garments(tmp_path):
    """Three garments over two devices: the reference's ``device_put`` onto
    ``P("garment")`` fails; so does the port's fleet, before any data."""
    import vts_torch.launch as port_launch
    from vts_tpu.parallel.mesh import build_mesh
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(np.zeros(3), NamedSharding(build_mesh("garment:2", jax.devices()[:2]),
                                                  P("garment")))
    args = types.SimpleNamespace(dataroot_template=TEMPLATE, checkpoints_dir=str(tmp_path),
                                 results_dir=str(tmp_path), extra=["--device", "cpu"])
    with pytest.raises(ValueError, match="--mesh garment:2 cannot shard 3 garments"):
        port_launch.run_fleet_mode("ours", ["a", "b", "c"], args, devices=CPU2)


@pytest.mark.parametrize("garments,flags,ranks_up", [
    (2, [], 1), (20, [], 1), (3, ["--mesh", "data:2"], 1), (2, ["--mesh", "garment:2"], 2)])
def test_cpu_fleet_is_one_device_unless_a_garment_axis_asks_for_more(
        monkeypatch, tmp_path, garments, flags, ranks_up):
    """On the CPU the fleet lays its garments over one device, as the
    reference's CPU (one JAX device) does, whatever the garment count and
    the cores; only a ``--mesh`` garment axis lays them over that many CPU
    ranks.  The ranks and the training are stubbed: this is the layout."""
    import vts_torch.launch as port_launch
    import vts_torch.platform as port_platform
    calls = []
    monkeypatch.setattr(port_launch, "_fleet_rank", lambda *a: calls.append(("here", a[-1])) or 0)
    monkeypatch.setattr(port_platform, "spawn_ranks",
                        lambda fn, a, devices, **kw: calls.append(("spawn", list(devices))))
    args = types.SimpleNamespace(dataroot_template=TEMPLATE, checkpoints_dir=str(tmp_path),
                                 results_dir=str(tmp_path),
                                 extra=["--device", "cpu", "--batch_size", "2", *flags])
    out = io.StringIO()
    with redirect_stdout(out):
        assert port_launch.run_fleet_mode("ours", [f"m{i}" for i in range(garments)], args) == 0
    assert out.getvalue().splitlines()[0] == f"[fleet] {garments} garments over {ranks_up} devices"
    assert calls == ([("here", 1)] if ranks_up == 1
                     else [("spawn", [torch.device("cpu")] * ranks_up)])


# ------------------------------------------------------------ the CLI ---

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cli_runs(env, tmp_path_factory):  # noqa: F811
    """``python -m vts_torch.train --device cpu --mesh data:2 --batch_size 2``
    (two spawned ranks) and the same run as two ``--multihost`` processes
    over TCP on 127.0.0.1, side by side, one intra-op thread each."""
    tmp = tmp_path_factory.mktemp("cli")
    common = ["--name", "dp", "--dataroot", TEMPLATE.format(material="smoke"), "--data_len", "2",
              "--n_epochs", "1", "--n_epochs_decay", "0", "--batch_size", "2", "--mesh", "data:2",
              "--val_for_each_epoch", "false",
              "--results_dir", str(tmp / "res"), *SMALL]
    run_env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    port = _free_port()
    procs = {"spawned": [subprocess.Popen(
        [sys.executable, "-m", "vts_torch.train", *common, "--checkpoints_dir",
         str(tmp / "spawned")], cwd=ROOT, env=run_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]}
    procs["multihost"] = [subprocess.Popen(
        [sys.executable, "-m", "vts_torch.train", *common, "--checkpoints_dir",
         str(tmp / "multihost"), "--multihost", "--coordinator_address", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(r)], cwd=ROOT, env=run_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    out = {}
    for key, ps in procs.items():
        texts = []
        for p in ps:
            text, _ = p.communicate(timeout=600)
            assert p.returncode == 0, text[-4000:]
            texts.append(text)
        out[key] = texts
    return tmp, out


def test_train_cli_with_a_data_axis_starts_two_ranks_and_writes_once(cli_runs):
    """Two ``[dist]`` lines (gloo, on the CPU), the data-parallel line on
    each rank, one loss log and one set of checkpoints (rank 0's)."""
    tmp, out = cli_runs
    text = out["spawned"][0]
    dist = re.findall(r"\[dist\] rank (\d)/2 on cpu \(backend gloo\)", text)
    assert sorted(dist) == ["0", "1"]
    assert text.count("data-parallel ranks active: batch 2 → 1 per rank × 2 ranks") == 2
    assert text.count("(epoch: 1, iters: 2") == 1
    ck = tmp / "spawned" / "dp"
    assert sorted(os.listdir(ck)) == sorted(
        ["loss_log.txt", "train_opt.txt"] + [f"latest_{kind}_{net}.msgpack"
                                             for kind in ("net", "opt")
                                             for net in ("G", "D", "D2")])


def test_multihost_processes_train_the_spawned_ranks_step(cli_runs):
    """``--multihost --coordinator_address 127.0.0.1:<port> --num_processes
    2 --process_id {0,1}``: each process a rank (its ``[dist]`` line), and
    rank 0's checkpoints the spawned ranks' bit for bit."""
    tmp, out = cli_runs
    for r, text in enumerate(out["multihost"]):
        assert f"[dist] rank {r}/2 on cpu (backend gloo)" in text
    a, b = tmp / "spawned" / "dp", tmp / "multihost" / "dp"
    files = sorted(f for f in os.listdir(a) if f.endswith(".msgpack"))
    assert files == sorted(f for f in os.listdir(b) if f.endswith(".msgpack"))
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_baselines_run_their_single_device_step_under_a_data_axis(env, tmp_path):  # noqa: F811
    """The reference's pix2pix never builds a data mesh (its setup skips
    ``_setup_dp_mesh``): under ``--mesh data:2`` the port's pix2pix trains
    in this one process, on its whole batch, as without the flag."""
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model
    from vts_torch.train import rank_devices
    from vts_tpu.models.pix2pix import Pix2PixModel
    from vts_tpu.models.pix2pixhd import Pix2PixHDModel
    from vts_tpu.models.sinskit import SinSKITModel
    from vts_tpu.models.spade import SPADEModel
    common = ["--model", "pix2pix", "--dataset_mode", "patchskit", "--name", "p2p",
              "--dataroot", TEMPLATE.format(material="smoke"), "--batch_size", "4",
              "--checkpoints_dir", str(tmp_path), "--crop_size", "256", "--center_w", "192",
              "--center_h", "128", "--ngf", "4", "--ndf", "4", "--batch_size_G2", "8"]
    for cls in (Pix2PixModel, Pix2PixHDModel, SPADEModel):
        assert "_setup_dp_mesh" not in inspect.getsource(cls.setup), cls
    assert "_setup_dp_mesh" in inspect.getsource(SinSKITModel.setup)
    argv = common + ["--device", "cpu", "--no_html"]
    models = {}
    for key, extra in (("mesh", ["--mesh", "data:2"]), ("plain", [])):
        opt = TrainOptions().parse(argv + extra, quiet=True)
        assert rank_devices(opt) is None
        models[key] = create_model(opt)
        models[key].setup()
        batch = next(iter(create_dataset(opt)))
        models[key].set_input(batch)
        models[key].optimize_parameters(1)
    assert models["mesh"].dp is None
    a, b = (m.get_current_losses() for m in (models["mesh"], models["plain"]))
    assert a == b



def test_skitg_inherits_the_data_parallel_step(ops):
    """skitG (``--model skit``) under ``--mesh data:2``: each rank encodes
    its own samples' style codes and takes sinskit's data-parallel step;
    against the port's serial batch-2 step from the same weights, batch and
    draws: losses within rtol 1e-5, G's gradient within 2e-4 in the 2-norm
    (skitG's near-ties on the CPU), the style codes the serial step's rows
    within rtol 1e-5 (CLIP at batch 1 against 2)."""
    inputs, res = ops
    serial = inputs["skit"]
    want = serial.get_current_losses()
    for k, v in want.items():
        assert abs(res[0]["skit"][0][k] - v) <= 1e-5 * abs(v) + 1e-7, k
    g = serial.adam["G"].mu
    num = sum(float(((res[0]["skit"][1][k] - v) ** 2).sum()) for k, v in g.items())
    assert (num / sum(float((v ** 2).sum()) for v in g.values())) ** 0.5 <= 2e-4
    torch.testing.assert_close(torch.cat([r["skit"][2] for r in res]),
                               serial._input["style_code"], rtol=1e-5, atol=1e-6)
