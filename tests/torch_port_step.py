"""One sinskit training step of ``vts_tpu`` and of ``vts_torch`` from the same
weights, batch and random draws, at 256² with ngf/ndf 4 (8 downs reach a
1×1 latent, as at 1536²).  Shared by ``tests/test_torch_port_train.py`` and
``tests/test_torch_port_visuals.py``.

The JAX side runs ``SinSKITModel._train_step`` jitted, with ``--canvas_fold
1 --lpips_fold 1`` (exact re-expressions of its default folds) and, for a
D3-active step, ``use_d3=True`` with the frozen LPIPS, CLIP and D3-head
weights passed as arguments.  The port replays JAX's draws: the DiffAugment
uniforms, the "more fake T" uniforms and the ``--lpips_crop`` window are
drawn from the step's key exactly as the JAX step splits it.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

DATAROOT = "synthetic://porttrain?size=320&center_w=192&center_h=128&patches=6&val_patches=3"
K, K_VAL, MORE = 6, 4, 4


def argv(tmp, batch=1, d3=False, extra=()):
    """Both packages' training flags; ``d3``: D3 on from epoch 1; ``extra``
    appended."""
    return ["--model", "sinskit", "--dataroot", DATAROOT, "--name", "train",
            "--crop_size", "256", "--center_w", "192", "--center_h", "128",
            "--ngf", "4", "--ndf", "4", "--batch_size", str(batch),
            "--batch_size_G2", str(K), "--batch_size_G2_val", str(K_VAL),
            "--add_fake_T_sample_size", str(MORE), "--data_len", "2",
            "--use_vision_aided_loss", "true" if d3 else "false",
            "--vision_aided_warmup_epoch", "1", "--init_gain", "0.5",
            "--canvas_fold", "1", "--lpips_fold", "1",
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res"),
            *extra]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A temporary directory, with the synthetic data written under it."""
    tmp = tmp_path_factory.mktemp("train")
    old = os.environ.get("VTS_SYNTH_DIR")
    os.environ["VTS_SYNTH_DIR"] = str(tmp / "synth")
    try:
        yield tmp
    finally:
        if old is None:
            os.environ.pop("VTS_SYNTH_DIR", None)
        else:
            os.environ["VTS_SYNTH_DIR"] = old


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op torch thread while a module runs.  Its nets are small, so
    threads buy little in one process, and under the suite's parallel workers
    (6 on 8 cores) each worker's 8 threads oversubscribe the cores.  Autouse
    in every ``tests/test_torch_*.py`` that imports it.  Not imported by
    ``test_torch_port_skit.py`` and ``test_torch_port_visuals.py``: on one
    thread torch's CPU sums run in another order, and the skitG step's G
    gradient (per leaf, 4× ``_grad_tol``) and the visuals after ``test()``
    on a trained G (rtol 1e-4) go past their tolerances there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def seeded_towers_drawn_once():
    """The seeded LPIPS, Inception and CLIP towers' numpy draws (deterministic,
    ~3 s a model with CLIP, most of a small model's set-up) made once for a
    module's many models; each model still builds its towers from them and
    runs its own ``setup``.  Autouse in the modules that import it."""
    import vts_torch.models.sinskit as sinskit
    with pytest.MonkeyPatch.context() as mp:
        for name in ("init_clip_params", "init_lpips_params", "init_inception_params"):
            mp.setattr(sinskit, name, functools.lru_cache(getattr(sinskit, name)))
        yield


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_batch(tmp, batch, d3=False, extra=()):
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.data import create_dataset as jax_create_dataset
    jopt = JaxTrainOptions().parse(argv(tmp, batch, d3, extra), quiet=True)
    jopt.num_threads = 0
    return jopt, next(iter(jax_create_dataset(jopt)))


def jax_aug_draws(key, policy, shape, dt=jnp.float32):
    """DiffAugment's draws for ``policy`` on an image of ``shape``, split from
    ``key`` as ``vts_tpu/ops/diffaug.py`` splits it (one key per policy
    position), in the port's layout (:func:`vts_torch.ops.diffaug.draw`)."""
    n, h, w = shape[:3]

    def uniform(k):
        return torch.tensor(np.asarray(
            jax.random.uniform(k, (n, 1, 1, 1), dt).astype(jnp.float32))).reshape(n)

    def ints(k, lo, hi):
        return torch.tensor(np.asarray(jax.random.randint(k, (n, 1), lo, hi))).reshape(n)

    out = []
    for k, letter in zip(jax.random.split(key, len(policy)), policy):
        if letter in "bsc":
            out.append(uniform(k))
        elif letter == "t":
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            kh, kw = jax.random.split(k)
            out.append(torch.stack([ints(kh, -sh, sh + 1), ints(kw, -sw, sw + 1)], 1))
        elif letter == "o":
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            ky, kx = jax.random.split(k)
            out.append(torch.stack([ints(ky, 0, h + (1 - ch % 2)),
                                    ints(kx, 0, w + (1 - cw % 2))], 1))
        elif letter == "n":
            k1, k2, k3 = jax.random.split(k, 3)
            out.append({"sigma": uniform(k1), "gate": uniform(k2), "normal": torch.tensor(
                np.asarray(jax.random.normal(k3, tuple(shape), dt).astype(jnp.float32)))})
    return out


def jax_draws(rng, n, dtype=None, crop=None, policy="bs", shape=None, gp_k=None, more=MORE):
    """The draws of one JAX ``_train_step``, split from its key as the step
    and its callees split it (sinskit.py:608, diffaug.py, patch.py:178-183).
    ``dtype``: the step's compute dtype, which DiffAugment draws its
    uniforms in; ``policy``/``shape``: the DiffAugment policy and the
    (N, H, W, C) image it augments (only b and s need no shape); ``crop`` =
    (c, h, w): the ``--lpips_crop`` window, drawn as at sinskit.py:850-854
    (``split(fold_in(k_more, 113))``, then ``randint``); ``gp_k``: the D2
    patch count of a WGAN-GP step, whose interpolation weights are drawn
    from ``k_gp1`` (one per sample) and ``k_gp2`` (one per patch) as
    ``gradient_penalty`` draws them."""
    _, k_aug_r, k_aug_f, k_more, k_gp1, k_gp2 = jax.random.split(rng, 6)
    dt = dtype or jnp.float32
    shape = shape or (n, 1, 1, 3)
    keys = [k_more] if n == 1 else list(jax.random.split(k_more, n))
    draws_more = []
    for key in keys:
        k_row, k_col = jax.random.split(key)
        draws_more.append(np.stack([np.asarray(jax.random.uniform(k_row, (more,))),
                                    np.asarray(jax.random.uniform(k_col, (more,)))]))
    draws = {"aug_real": jax_aug_draws(k_aug_r, policy, shape, dt),
             "aug_fake": jax_aug_draws(k_aug_f, policy, shape, dt),
             "more": torch.from_numpy(np.stack(draws_more))}
    if crop is not None:
        c, h, w = crop
        kcy, kcx = jax.random.split(jax.random.fold_in(k_more, 113))
        draws["lpips_crop"] = (int(jax.random.randint(kcy, (), 0, max(h - c, 0) + 1)),
                               int(jax.random.randint(kcx, (), 0, max(w - c, 0) + 1)))
    if gp_k is not None:
        for name, key, m in (("gp1", k_gp1, n), ("gp2", k_gp2, gp_k)):
            draws[name] = torch.tensor(np.asarray(jax.random.uniform(key, (m, 1, 1, 1)))
                                       ).reshape(m)
    return draws


def port_model(tmp, batch, d3=False, extra=()):
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    opt = TrainOptions().parse(argv(tmp, batch, d3, extra) + ["--device", "cpu", "--no_html"],
                               quiet=True)
    model = create_model(opt)
    model.setup()
    return model


def load_jax_states(model, states):
    from vts_torch.utils.convert_jax import (d_params_to_torch, d_stats_to_torch,
                                             unet_params_to_torch, unet_stats_to_torch)
    sd = dict(unet_params_to_torch(np_tree(states["G"].params)))
    sd.update(unet_stats_to_torch(np_tree(states["G"].stats)))
    model.netG.load_state_dict(sd)
    for name in ("D", "D2"):
        sd = dict(d_params_to_torch(np_tree(states[name].params)))
        sd.update(d_stats_to_torch(np_tree(states[name].stats)))
        getattr(model, f"net{name}").load_state_dict(sd)


def run_step(tmp, n, d3=False, extra=(), draw_kw=None, batch_fn=None):
    """One JAX step and one port step at epoch 1 from the same weights, batch
    and draws → (JAX model with its updated states and outputs, JAX losses,
    port model after its step).  ``extra``: flags for both packages;
    ``draw_kw``: keyword arguments of :func:`jax_draws` beyond the key and n;
    ``batch_fn``: maps the batch before both models take it."""
    from vts_tpu.models import create_model as jax_create_model
    jopt, batch = jax_batch(tmp, n, d3, extra)
    if batch_fn is not None:
        batch = batch_fn(batch)
    jmodel = jax_create_model(jopt)
    jmodel.setup(batch)
    jmodel.set_input(batch)
    states0 = jmodel.states
    frozen = {"lpips": jmodel.lpips_params}
    if d3:
        frozen.update(clip=jmodel.clip_params, d3=jmodel.d3_heads)
    fn = jax.jit(functools.partial(jmodel._train_step, use_d3=d3))
    gS, dS, d2S, losses, outputs = fn(states0["G"], states0["D"], states0["D2"], jmodel._input,
                                      jmodel.rng, jnp.float32(jopt.lr),
                                      jnp.float32(jopt.lr_G2), jnp.int32(1), frozen)
    jmodel.states = {"G": gS, "D": dS, "D2": d2S}
    outputs.pop("next_rng")
    jmodel._outputs = outputs

    model = port_model(tmp, n, d3, extra)
    load_jax_states(model, states0)
    model.set_input(batch)
    model.optimize_parameters(epoch=1, draws=jax_draws(jmodel.rng, n, **(draw_kw or {})))
    return jmodel, {k: float(v) for k, v in losses.items()}, model


def assert_bf16_losses(ref, want, got, what=""):
    """The bf16 lane's rule for the losses of one step (``ref``: JAX fp32,
    ``want``: JAX bf16, ``got``: the port's bf16; dicts of floats):
    |port16 − jax16| ≤ 2·|jax16 − jax32| + 1e-3·|jax32| per loss."""
    assert set(got) == set(want) == set(ref)
    for k in ref:
        gap, diff = abs(want[k] - ref[k]), abs(got[k] - want[k])
        print(f"[bf16 loss{what}] {k}: |port16 - jax16| {diff:.3e}, |jax16 - jax32| "
              f"{gap:.3e}, |jax32| {abs(ref[k]):.3e}")
        assert diff <= 2 * gap + 1e-3 * abs(ref[k]), (what, k, diff, gap, ref[k])


def _norm(tree, keys):
    return float(np.sqrt(sum(np.sum(np.square(tree[k].astype(np.float64))) for k in keys)))


def rel_norm(got, want):
    """‖got − want‖ / ‖want‖ over two flat dicts of arrays with want's keys."""
    keys = sorted(want)
    return _norm({k: got[k] - want[k] for k in keys}, keys) / _norm(want, keys)


def assert_bf16_tree(ref, want, got, what="", near_tie=0.0):
    """The bf16 lane's rule for one network's gradient (or running stats),
    flat dicts of arrays: ‖port16 − jax16‖ / ‖jax32‖ ≤ 2·‖jax16 − jax32‖ /
    ‖jax32‖ + 1e-3 over the whole tree, plus ``near_tie``: where LPIPS
    near-ties make the gradient jump, how far JAX's own fp32 gradient moves
    (relative, in the 2-norm) under a 1e-6 relative change of the weights."""
    keys = sorted(ref)
    assert set(keys) == set(want) == set(got), what
    if not keys:
        return
    scale = _norm(ref, keys)
    d_port = _norm({k: got[k] - want[k] for k in keys}, keys) / scale
    d_jax = _norm({k: want[k] - ref[k] for k in keys}, keys) / scale
    print(f"[bf16 {what}] |port16 - jax16|/|jax32| {d_port:.3e}, |jax16 - jax32|/|jax32| "
          f"{d_jax:.3e}, near-tie jump {near_tie:.3e}")
    assert d_port <= 2 * d_jax + 1e-3 + near_tie, (what, d_port, d_jax, near_tie)

