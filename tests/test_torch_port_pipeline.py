"""The run-time pipeline of the port against ``vts_tpu`` and against the
port's own plain path, on the CPU at 256² with ngf/ndf 4:

  * the loader: batches at 0 and 2 threads bit for bit the same and in
    ``vts_tpu``'s order (its ``DataLoader`` on its dataset), at batch 1 and
    at batch 2, shuffled over two epochs;
  * the on-disk sample cache: a file ``vts_tpu`` wrote is read by the port
    equal to the port's own build bit for bit, and one the port wrote is
    read by ``vts_tpu`` equal to its build, under the same key; an unreadable
    file is rebuilt;
  * the device caches: the loader's (``--cache_data_device``) returns the
    same tensors in the second epoch, stays bounded by the dataset under
    shuffled batches of 2 with the uncached loader's values, and serves a
    batch of another size with no new sample read; the model's
    (``--device_sample_cache``) returns the same tensors, misses on another
    sample, skips a validation batch, and stops at its cap with one
    warning; ``set_input`` takes the loader's tensors without a copy; the
    skit dataset's garments keep one entry each;
  * ``--lpips_tap_cache`` with ``--device_sample_cache``, and ``--remat_g
    on`` with ``--lpips_remat on`` (also over a batch-norm G, whose running
    statistics are folded in once), leave two training steps bit for bit
    the same as without them; the recomputation runs;
  * a chunk of 3 D3-active steps (``optimize_parameters_chunk``) with the
    tap and the D3 logit cache on equals 3 plain sequential steps bit for
    bit, its last losses left on the device; the baselines step
    one at a time; ``vts_torch.train --steps_per_dispatch 2`` on 3 shuffled
    samples (a chunk over two samples, then the epoch's partial chunk) ends
    where ``--steps_per_dispatch 1`` does, bit for bit, and logs at the
    chunks' ends only;
  * the factored LPIPS head's values and input gradients against
    ``vts_tpu``'s factored head, and ``y_taps`` against the y forward in both
    packages, with the "y_taps shapes" refusal;
  * the tap cache's refusal at ``data_len`` > 1 and its 8-miss thrash guard
    as ``vts_tpu``'s: the same lines on stdout, on the same lookups;
  * ``slow``: a chunk of 3 D3-active steps with both caches on against
    ``vts_tpu``'s ``optimize_parameters_chunk`` (one shared JAX run: its
    set-up and compile with CLIP take ~90 s here): the last losses within
    rtol 1e-3, each network within twice what a 1e-6 move of the weights
    does to JAX's own chunk plus 1e-3 of JAX's move, in the 2-norm.  Its tier-1 companions:
    the chunk against the port's sequential steps above, the single step
    against ``vts_tpu``'s (``tests/test_torch_port_train.py``), and the taps
    and the tap cache's guards against ``vts_tpu``'s.
"""

import io
import os
import time
import warnings
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_step import argv as step_argv
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import flat, jax_batch, jax_draws, load_jax_states, port_model
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)
from tests.torch_port_step import seeded_towers_drawn_once  # noqa: F401  (autouse fixture)

SIZE, CW, CH = 320, 192, 128
ONE = ("--data_len", "1")


def _tensors(model):
    """Every parameter, buffer and Adam moment of the model's networks."""
    out = {}
    for name, net in model.nets().items():
        out.update({f"{name}.{k}": v for k, v in net.state_dict().items()})
        if name in model.adam:
            a = model.adam[name]
            out.update({f"{name}.mu.{k}": v for k, v in a.mu.items()})
            out.update({f"{name}.nu.{k}": v for k, v in a.nu.items()})
    return out


def _assert_same(a, b):
    """Two models' networks, Adam moments and last losses, bit for bit."""
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    diff = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not diff, diff[:5]
    la, lb = a.get_current_losses(), b.get_current_losses()
    assert la == lb


def _batch(model):
    from vts_torch.data import create_dataset
    loader = create_dataset(model.opt)
    loader.set_epoch(1)
    return next(iter(loader))


def _garment(tmp):
    from vts_tpu.data.synthetic import generate_garment
    return generate_garment(str(tmp / "disk"), "synthA", padded_size=SIZE, center_w=CW,
                            center_h=CH, n_train_patches=6, n_val_patches=3, seed=0)


# ------------------------------------------------------------------ loader ---
@pytest.mark.parametrize("batch", [1, 2])
def test_loader_threads_give_the_same_batches_in_jax_order(env, batch):  # noqa: F811
    from vts_torch.config import TrainOptions
    from vts_torch.data import DataLoader, create_dataset
    from vts_tpu.data import DataLoader as JaxLoader
    from vts_tpu.data.singleskit import SingleSkitDataset as JaxSingleSkit
    argv = step_argv(env, batch, extra=("--data_len", "4"))
    jopt, _ = jax_batch(env, batch, extra=("--data_len", "4"))
    jax_loader = JaxLoader(JaxSingleSkit(jopt), batch_size=batch, shuffle=True,
                           drop_last=True, seed=0)
    port = {}
    for threads in (0, 2):
        opt = TrainOptions().parse(argv + ["--device", "cpu", "--num_threads", str(threads)],
                                   quiet=True)
        loader = create_dataset(opt)
        assert isinstance(loader, DataLoader) and loader.num_workers == threads
        port[threads] = loader
    for epoch in (1, 2):
        for ld in (jax_loader, *port.values()):
            ld.set_epoch(epoch)
        want = list(jax_loader)
        got0, got2 = list(port[0]), list(port[2])
        assert len(want) == len(got0) == len(got2) == 4 // batch
        for w, a, b in zip(want, got0, got2):
            assert set(w) == set(a) == set(b)
            for k in w:
                np.testing.assert_array_equal(a[k], w[k], err_msg=k)
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                assert a[k].dtype == b[k].dtype == w[k].dtype, k


def test_loader_window_is_bounded():
    """At most max(2, 2·threads) batches are built ahead of the consumer."""
    from vts_torch.data import DataLoader

    class Counting:
        def __init__(self):
            self.built = 0

        def __len__(self):
            return 20

        def __getitem__(self, i):
            self.built += 1
            return {"x": np.full((1,), i, np.float32)}

    for threads in (1, 3):
        ds = Counting()
        it = iter(DataLoader(ds, batch_size=1, num_workers=threads))
        first = next(it)
        time.sleep(0.2)
        assert int(first["x"][0, 0]) == 0
        assert ds.built <= max(2, 2 * threads) + 1, (threads, ds.built)
        assert [int(b["x"][0, 0]) for b in it] == list(range(1, 20))


# --------------------------------------------------------------- disk cache ---
def test_disk_cache_crosses_both_ways(env):  # noqa: F811
    from vts_torch.config import TrainOptions
    from vts_torch.data.singleskit import SingleSkitDataset
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.data.singleskit import SingleSkitDataset as JaxSingleSkit
    root = _garment(env)

    def opts(cache):
        argv = step_argv(env, 1, extra=("--data_len", "2", "--dataroot", root,
                                        "--cache_dir", str(env / cache)))
        return (JaxTrainOptions().parse(argv, quiet=True),
                TrainOptions().parse(argv + ["--device", "cpu"], quiet=True))
    key = "train_len2_crop256_m1_seed0"

    # vts_tpu writes sample 0; the port reads it as its own build
    jopt, opt = opts("jax_wrote")
    JaxSingleSkit(jopt)[0]
    path = env / "jax_wrote" / key / "sample_00000.npz"
    assert path.exists()
    ds = SingleSkitDataset(opt)
    assert ds.cache_dir == str(env / "jax_wrote" / key)
    mtime = path.stat().st_mtime_ns
    got, own = ds[0], ds.build_sample(0)
    assert path.stat().st_mtime_ns == mtime                 # read, not rewritten
    assert set(got) == set(own) | {"sample_idx"}
    for k in own:
        assert got[k].dtype == own[k].dtype, k
        np.testing.assert_array_equal(got[k], own[k], err_msg=k)

    # the port writes sample 1; vts_tpu reads it as its own build
    jopt, opt = opts("port_wrote")
    mine = SingleSkitDataset(opt)[1]
    assert (env / "port_wrote" / key / "sample_00001.npz").exists()
    jds = JaxSingleSkit(jopt)
    theirs, build = jds[1], jds.build_sample(1)
    for k in build:
        np.testing.assert_array_equal(theirs[k], build[k], err_msg=k)
        np.testing.assert_array_equal(mine[k], build[k], err_msg=k)

    # an unreadable file is deleted and rebuilt
    bad = env / "port_wrote" / key / "sample_00001.npz"
    bad.write_bytes(b"not an npz")
    again = SingleSkitDataset(opt)[1]
    for k in build:
        np.testing.assert_array_equal(again[k], build[k], err_msg=k)
    with np.load(bad) as z:
        assert set(z.files) == set(build)


def test_disk_cache_default_directory(env):  # noqa: F811
    """``<dataroot>/.vts_cache`` by default; a synthetic:// root (no directory
    here) only under ``--cache_dir``."""
    from vts_torch.config import TrainOptions
    from vts_torch.data.singleskit import SingleSkitDataset
    root = _garment(env)
    opt = TrainOptions().parse(step_argv(env, 1, extra=("--dataroot", root))
                               + ["--device", "cpu"], quiet=True)
    ds = SingleSkitDataset(opt)
    assert ds.cache_dir == os.path.join(root, ".vts_cache", "train_len2_crop256_m1_seed0")
    opt = TrainOptions().parse(step_argv(env, 1) + ["--device", "cpu"], quiet=True)
    assert SingleSkitDataset(opt).cache_dir is None


# ------------------------------------------------------------ device caches ---
def test_loader_device_cache_is_per_sample_and_bounded(env):  # noqa: F811
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    argv = step_argv(env, 2, extra=("--data_len", "4")) + ["--device", "cpu"]
    plain = create_dataset(TrainOptions().parse(argv, quiet=True))
    cached = create_dataset(TrainOptions().parse(argv + ["--cache_data_device"], quiet=True))
    reads = []

    class Reads:
        """The dataset, recording which samples are read."""

        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            reads.append(i)
            return self.ds[i]
    cached.dataset = Reads(cached.dataset)
    for epoch in (1, 2, 3):
        plain.set_epoch(epoch)
        cached.set_epoch(epoch)
        for bp, bc in zip(plain, cached):
            assert torch.is_tensor(bc["S"]) and isinstance(bc["sample_idx"], np.ndarray)
            for k in bp:
                np.testing.assert_array_equal(np.asarray(bc[k]), bp[k], err_msg=k)
        assert len(cached.dev_cache) <= 4
    assert len(cached.dev_cache) == 4 and sorted(reads) == [0, 1, 2, 3]
    # a batch of one (the anneal's batch_size change) comes from the cache
    cached.batch_size = 1
    for b in cached:
        assert b["S"] is cached.dev_cache[int(b["sample_idx"][0])]["S"]
    assert sorted(reads) == [0, 1, 2, 3]


def test_model_device_sample_cache(env):  # noqa: F811
    model = port_model(env, 1, extra=("--device_sample_cache", "true", *ONE))
    b0 = _batch(model)
    b1 = dict(b0, sample_idx=np.array([1]), S=b0["S"] + 0.5)
    model.set_input(b0)
    first = model._input["S"]
    model.set_input(b1)
    assert model._input["S"] is not first
    model.set_input(b0)
    assert model._input["S"] is first
    np.testing.assert_array_equal(first.numpy(), b0["S"] * b0["M"])
    model.set_input(b0, phase="val")
    assert model._input["S"] is not first
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for i in range(2, 40):
            model.set_input(dict(b0, sample_idx=np.array([i])))
    capped = [w for w in seen if "--device_sample_cache hit its 32-entry cap" in str(w.message)]
    assert len(model._sample_dev_cache) == 32 and len(capped) == 1


def test_set_input_takes_the_loaders_tensors_without_a_copy(env):  # noqa: F811
    model = port_model(env, 1, extra=ONE)
    b = _batch(model)
    tb = {k: torch.from_numpy(v) if k != "sample_idx" else v for k, v in b.items()}
    model.set_input(tb)
    assert model._input["T_coords"] is tb["T_coords"]
    plain = port_model(env, 1, extra=ONE)
    plain.set_input(b)
    for k, v in plain._input.items():
        assert torch.equal(model._input[k], v), k
    assert model._sample_key == plain._sample_key == (0,)


def test_skit_garments_keep_their_own_cache_entries(env):  # noqa: F811
    """Each garment of the skit dataset numbers its samples from 0; the
    items' ``sample_idx`` is their own index, so the model's per-sample
    cache holds one entry a garment and serves each its own sample."""
    from vts_torch.data import collate, create_dataset
    model = port_model(env, 1, extra=("--model", "skit", *ONE, "--device_sample_cache", "true"))
    ds = create_dataset(model.opt).dataset
    items = [collate([ds[i]]) for i in range(len(ds))]
    assert [int(b["material_index"][0]) for b in items] == [0, 1]
    assert [int(b["sample_idx"][0]) for b in items] == [0, 1]
    for b in items + items[:1]:
        model.set_input(b)
        np.testing.assert_array_equal(model._input["S"].numpy(), b["S"] * b["M"])
    assert set(model._sample_dev_cache) == {((0,), "train"), ((1,), "train")}


# ------------------------------------------------- caches and remat: bit for bit ---
class _Calls:
    """Counts the forward calls of a module."""

    def __init__(self, module):
        self.n = 0
        module.register_forward_hook(lambda *a: setattr(self, "n", self.n + 1))


_REFS = {}


def _two_steps(env, flags, ref_flags=()):  # noqa: F811
    """Two training steps on one sample (``data_len`` 1, D3 off) with
    ``flags``, and the same without them (one reference a ``ref_flags``,
    shared by the module) → (reference model, model, G's forward calls)."""
    def run(extra):
        m = port_model(env, 1, extra=ONE + tuple(extra))
        calls = _Calls(m.netG)
        batch = _batch(m)
        for _ in range(2):
            m.set_input(batch)
            m.optimize_parameters(epoch=1)
        return m, calls.n
    if ref_flags not in _REFS:
        _REFS[ref_flags] = run(ref_flags)[0]
    return (_REFS[ref_flags],) + run(tuple(ref_flags) + tuple(flags))


@pytest.mark.parametrize("flags,ref_flags", [
    (("--lpips_tap_cache", "true", "--device_sample_cache", "true"), ()),
    (("--remat_g", "on", "--lpips_remat", "on"), ()),
    (("--remat_g", "on"), ("--normG", "batch")),
], ids=["tap_and_sample_caches", "remat", "remat_batch_norm_g"])
def test_caches_and_remat_leave_two_steps_bit_for_bit(env, flags, ref_flags):  # noqa: F811
    ref, got, g_calls = _two_steps(env, flags, ref_flags)
    _assert_same(ref, got)
    if "--lpips_tap_cache" in flags:
        assert got._tap_cache_kv[0] == (0,) and got._tap_cache_stats == (1, 1)
    if "--device_sample_cache" in flags:
        assert list(got._sample_dev_cache) == [((0,), "train")]
    # each step's G forward, and under --remat_g its recomputation
    assert g_calls == (4 if "--remat_g" in flags else 2)
    if ref_flags:
        assert any(k.endswith(".mean") for k in _tensors(got))


@pytest.fixture(scope="module")
def d3_runs(env):  # noqa: F811
    """Three D3-active steps on one sample without caches, and as one chunk
    of 3 with the tap and the D3 logit cache on."""
    caches = ONE + ("--lpips_tap_cache", "true", "--d3_logit_cache", "true")
    plain = port_model(env, 1, True, ONE)
    batch = _batch(plain)
    for _ in range(3):
        plain.set_input(batch)
        plain.optimize_parameters(epoch=1)
    chunk = port_model(env, 1, True, caches)
    chunk.set_input(batch)
    stacked = {k: torch.stack([v] * 3) for k, v in chunk._input.items()}
    assert chunk.optimize_parameters_chunk(stacked, 1, sample_keys=[(0,)] * 3) == 3
    return plain, chunk


def test_cached_chunk_equals_plain_sequential_steps_bit_for_bit(d3_runs):
    plain, chunk = d3_runs
    _assert_same(plain, chunk)
    assert torch.equal(plain.generator.get_state(), chunk.generator.get_state())
    # one tap lookup for the chunk, one D3 logit entry for the sample
    assert chunk._tap_cache_stats == (0, 1) and list(chunk._d3_real_cache) == [(0,)]
    assert {"G_D3", "D3_loss"} <= set(chunk.get_current_losses())


def test_chunk_keeps_its_last_losses_on_the_device(d3_runs):
    _, chunk = d3_runs
    losses = [v for v in chunk._losses.values() if torch.is_tensor(v)]
    assert losses and all(v.dim() == 0 and v.device == chunk.device for v in losses)


def test_baselines_step_one_at_a_time():
    """A model without ``supports_chunk`` (pix2pix, pix2pixHD, SPADE) takes a
    chunk as one ``optimize_parameters`` a slice, with each slice's input."""
    from vts_torch.models.pix2pix import Pix2PixModel
    from vts_torch.models.pix2pixhd import Pix2PixHDModel
    from vts_torch.models.sinskit import SinSKITModel
    from vts_torch.models.spade import SPADEModel
    assert SinSKITModel.supports_chunk
    assert not any(m.supports_chunk for m in (Pix2PixModel, Pix2PixHDModel, SPADEModel))

    class Fake:
        supports_chunk = False
        seen = []

        def optimize_parameters(self, epoch, draws=None):
            self.seen.append((epoch, float(self._input["S"][0]), self._sample_key, draws))

    fake = Fake()
    stacked = {"S": torch.arange(3.0).reshape(3, 1)}
    n = SinSKITModel.optimize_parameters_chunk(fake, stacked, 4, sample_keys=[(0,), (1,), (2,)],
                                               draws=["a", "b", "c"])
    assert n == 3 and fake.seen == [(4, 0.0, (0,), "a"), (4, 1.0, (1,), "b"),
                                    (4, 2.0, (2,), "c")]


def test_train_with_steps_per_dispatch(env, capsys):  # noqa: F811
    """3 batches at ``--steps_per_dispatch 2``: a chunk of 2, then the epoch's
    partial chunk of 1, end bit for bit where 3 single steps do; the loss
    lines come at the chunks' ends (iterations 2 and 3), not at 1."""
    from vts_torch.train import train
    models = {}
    for spd in (1, 2):
        argv = step_argv(env, 1, extra=("--data_len", "3", "--n_epochs", "1",
                                        "--n_epochs_decay", "0", "--print_freq", "1",
                                        "--val_for_each_epoch", "false",
                                        "--steps_per_dispatch", str(spd),
                                        "--name", f"spd{spd}"))
        models[spd] = train(argv + ["--device", "cpu", "--no_html"])
        out = capsys.readouterr().out
        iters = [int(line.split("iters: ")[1].split(",")[0]) for line in out.splitlines()
                 if line.startswith("(epoch: ")]
        assert iters == ([1, 2, 3] if spd == 1 else [2, 3]), out
    _assert_same(models[1], models[2])


# ------------------------------------------------------------------ LPIPS ---
def test_factored_head_matches_jax():
    """Values within rtol 1e-5 of ``vts_tpu``'s factored head (3- and
    1-channel); input gradients within 1e-3 of the gradient's 2-norm (the
    two packages' fp32 VGG backward, measured 4.3e-4 at 1 channel and below
    1e-4 at 3) and, against the port's composed head on the same VGG, within
    1e-6 of it."""
    from vts_torch.losses.lpips import LPIPS, init_lpips_params
    from vts_tpu.losses.lpips import init_lpips_params as jax_init
    from vts_tpu.losses.lpips import lpips as jax_lpips
    params, net = jax_init(0), LPIPS(init_lpips_params(0))
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)

    @jax.jit
    def jax_head(a, b):
        val, vjp = jax.vjp(lambda t: jax_lpips(params, t, b, y_no_grad=True,
                                               head_mode="factored"), a)
        return val, vjp(jnp.ones_like(val))[0]
    for c in (3, 1):
        xc, yc = x[..., :c], y[..., :c]
        want, g_want = jax_head(jnp.asarray(xc), jnp.asarray(yc))
        want, g_want = np.asarray(want), np.asarray(g_want)
        grads = {}
        for head in ("factored", "composed"):
            xt = torch.tensor(xc, requires_grad=True)
            got = net(xt, torch.tensor(yc), y_no_grad=True, head_mode=head)
            got.sum().backward()
            grads[head] = xt.grad.numpy()
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, err_msg=head)
        g = grads["factored"]
        assert np.linalg.norm(g - g_want) <= 1e-3 * np.linalg.norm(g_want)
        assert np.linalg.norm(g - grads["composed"]) <= 1e-6 * np.linalg.norm(g_want)
    with pytest.raises(ValueError, match="head_mode"):
        net(torch.tensor(x), torch.tensor(y), head_mode="fused")


def test_y_taps_equal_the_y_forward_in_both_packages():
    from vts_torch.losses.lpips import LPIPS, init_lpips_params, lpips_y_taps
    from vts_tpu.losses.lpips import init_lpips_params as jax_init
    from vts_tpu.losses.lpips import lpips as jax_lpips
    from vts_tpu.losses.lpips import lpips_y_taps as jax_taps
    params, net = jax_init(0), LPIPS(init_lpips_params(0))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jt = jax.jit(lambda t: jax_taps(params, t))(jnp.asarray(y))
    taps = lpips_y_taps(net, torch.tensor(y))
    for a, b in zip(taps, jt):               # fp32 round-off of two VGGs
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())
    for head in ("composed", "factored"):
        xt, xu = torch.tensor(x, requires_grad=True), torch.tensor(x, requires_grad=True)
        with_taps = net(xt, None, y_no_grad=True, y_taps=taps, head_mode=head)
        inline = net(xu, torch.tensor(y), y_no_grad=True, head_mode=head)
        with_taps.sum().backward()
        inline.sum().backward()
        assert torch.equal(with_taps, inline) and torch.equal(xt.grad, xu.grad)
        np.testing.assert_allclose(
            with_taps.detach().numpy(),
            np.asarray(jax.jit(lambda a, t: jax_lpips(params, a, a, y_no_grad=True, y_taps=t,
                                                      head_mode=head))(jnp.asarray(x), jt)),
            rtol=1e-5)
    small = lpips_y_taps(net, torch.zeros(1, 32, 32, 3))
    with pytest.raises(ValueError, match="y_taps shapes"):
        net(torch.tensor(x), None, y_no_grad=True, y_taps=small)
    with pytest.raises(ValueError, match="y_taps shapes"):
        jax_lpips(params, jnp.asarray(x), jnp.asarray(x), y_no_grad=True,
                  y_taps=jax_taps(params, jnp.zeros((1, 32, 32, 3))))
    with pytest.raises(ValueError, match="y_no_grad"):
        net(torch.tensor(x), None, y_taps=taps)


# ------------------------------------------------------- tap cache's guards ---
def _jax_model(env, extra):  # noqa: F811
    from vts_tpu.models.sinskit import SinSKITModel as JaxModel
    jopt, batch = jax_batch(env, 1, extra=extra)
    return JaxModel(jopt), batch


def test_tap_cache_refusal_at_data_len_above_one_is_the_references(env):  # noqa: F811
    extra = ("--lpips_tap_cache", "true", "--data_len", "2")
    jm, _ = _jax_model(env, extra)
    model = port_model(env, 1, extra=extra)
    model.set_input(_batch(model))
    lines = []
    for call in (lambda: jm._lpips_taps_cached({"lpips": None}), model._lpips_taps_cached):
        buf = io.StringIO()
        with redirect_stdout(buf), pytest.warns(UserWarning, match="data_len=2 cycles"):
            assert call() is None
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] and lines[0].startswith("[sinskit] --lpips_tap_cache: data_len=2")
    assert model._tap_cache_disabled and jm._tap_cache_disabled


def test_tap_cache_thrash_guard_is_the_references(env, monkeypatch):  # noqa: F811
    """Lookups for samples 0, 0, 1, 2, ... : both packages hit once, then
    turn the cache off at the lookup whose miss is the 8th and outnumbers the
    hits, with the same counts and the same first sentence on stdout."""
    import vts_torch.models.sinskit as port_sinskit
    extra = ("--lpips_tap_cache", "true", *ONE)
    jm, batch = _jax_model(env, extra)
    jm.lpips_params = None
    jm._lpips_tap_jit = lambda p, y: ("taps", y)
    jm._lpips_tap_cache_kv = (None, None)
    jm._input = {"I": batch["I"]}
    model = port_model(env, 1, extra=extra)
    model.set_input(_batch(model))
    monkeypatch.setattr(port_sinskit, "lpips_y_taps", lambda net, y, dtype=None: ("taps", y))
    keys = [(0,), (0,)] + [(i,) for i in range(1, 12)]
    seen = {}
    for name, m, call in (("jax", jm, lambda: jm._lpips_taps_cached({"lpips": None})),
                          ("port", model, model._lpips_taps_cached)):
        got = []
        buf = io.StringIO()
        with redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for k in keys:
                m._sample_key = k
                got.append(call() is not None)
        seen[name] = (got, m._tap_cache_stats, buf.getvalue().split(" — ")[0])
    assert seen["jax"] == seen["port"]
    got, stats, line = seen["port"]
    assert got == [True] * 8 + [False] * 5 and stats == (1, 8)
    assert line == "[sinskit] --lpips_tap_cache: 8 misses vs 1 hits"


# ------------------------------------------------------- the chunk vs JAX ---
@pytest.fixture(scope="module")
def jax_chunk(env):  # noqa: F811
    """``vts_tpu``'s ``optimize_parameters_chunk`` of 3 D3-active steps on one
    sample with the tap and the D3 logit cache on, and the port's from the
    same weights and draws (each step's draws replayed from its key in JAX's
    chain) → (JAX losses of the last step, port losses, JAX's flat params
    before, JAX's states after, the port model, JAX's states after the same
    chunk from weights moved by 1e-6 of themselves: how far round-off
    carries JAX's own chunk)."""
    from vts_tpu.models import create_model as jax_create_model
    extra = (*ONE, "--lpips_tap_cache", "true", "--d3_logit_cache", "true")
    jopt, batch = jax_batch(env, 1, True, extra)
    jm = jax_create_model(jopt)
    jm.setup(batch)
    jm.set_input(batch)
    model = port_model(env, 1, True, extra)
    load_jax_states(model, jm.states)
    before = {k: flat(v.params) for k, v in jm.states.items()}
    noise = np.random.default_rng(1)
    # fresh buffers throughout: the chunk donates its input states
    moved = {k: jax.tree_util.tree_map(jnp.copy, v.replace(params=jax.tree_util.tree_map(
        lambda x: x * (1 + 1e-6 * noise.standard_normal(x.shape).astype(np.float32)), v.params)))
        for k, v in jm.states.items()}
    keys, rng = [], jm.rng
    for _ in range(3):
        keys.append(rng)
        rng = jax.random.split(rng, 6)[0]
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x] * 3), jm._input)
    jm.optimize_parameters_chunk(stacked, epoch=1, sample_keys=[jm._sample_key] * 3)
    want, after = jm.get_current_losses(), dict(jm.states)
    jm.states, jm._rng_dev = moved, jm.rng
    jm.optimize_parameters_chunk(stacked, epoch=1, sample_keys=[jm._sample_key] * 3)
    model.set_input(batch)
    model.optimize_parameters_chunk({k: torch.stack([v] * 3) for k, v in model._input.items()},
                                    1, sample_keys=[model._sample_key] * 3,
                                    draws=[jax_draws(k, 1) for k in keys])
    return want, model.get_current_losses(), before, after, model, jm.states


@pytest.mark.slow
def test_chunk_losses_match_jax(jax_chunk):
    """The last step's losses within rtol 1e-3 (two Adam steps' sign-like
    moves on round-off leaves ride into them); both caches filled once."""
    want, got, _, _, model, _ = jax_chunk
    assert set(got) == set(want) and {"G_D3", "D3_loss"} <= set(got)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-7, (k, got[k], want[k])
    assert list(model._d3_real_cache) == [(0,)] and model._tap_cache_stats == (0, 1)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["G", "D", "D2"])
def test_chunk_moves_match_jax(jax_chunk, name):
    """Each network after the chunk within twice the distance that moving
    JAX's weights by 1e-6 of themselves puts between JAX's own results, plus
    1e-3 of JAX's move over the chunk, in the 2-norm (the ROADMAP's rule:
    after the first step Adam turns round-off in near-zero gradients into
    moves of ±lr), over the leaves whose exact gradient is not zero
    (``ZERO_GRAD``'s biases hold round-off of either sign in both)."""
    from tests.test_torch_port_train import ZERO_GRAD
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_unet_params
    _, _, before, after, model, jitter = jax_chunk
    sd = getattr(model, f"net{name}").state_dict()
    p = flat(torch_to_unet_params(sd) if name == "G" else torch_to_d_params(sd)[0])
    p0, p1, pj = before[name], flat(after[name].params), flat(jitter[name].params)
    keys = [k for k in p1 if not ZERO_GRAD.search(k)]

    def norm(a, b):
        return np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2) for k in keys))
    move, dd, dj = norm(p1, p0), norm(p, p1), norm(pj, p1)
    print(f"[chunk vs jax] {name}: |port - jax| {dd:.3e}, |jax moved 1e-6 - jax| {dj:.3e}, "
          f"jax's move {move:.3e}")
    assert dd <= 2 * dj + 1e-3 * move, (dd, dj, move)
