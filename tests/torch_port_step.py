"""One sinskit training step of ``vts_tpu`` and of ``vts_torch`` from the same
weights, batch and random draws, at 256² with ngf/ndf 4 (8 downs reach a
1×1 latent, as at 1536²).  Shared by ``tests/test_torch_port_train.py`` and
``tests/test_torch_port_visuals.py``.

The JAX side runs ``SinSKITModel._train_step`` jitted, with ``--canvas_fold
1 --lpips_fold 1`` (exact re-expressions of its default folds) and, for a
D3-active step, ``use_d3=True`` with the frozen LPIPS, CLIP and D3-head
weights passed as arguments.  The port replays JAX's draws: the DiffAugment
uniforms and the "more fake T" uniforms are drawn from the step's key
exactly as the JAX step splits it.
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


def argv(tmp, batch=1, d3=False):
    """Both packages' training flags; ``d3``: D3 on from epoch 1."""
    return ["--model", "sinskit", "--dataroot", DATAROOT, "--name", "train",
            "--crop_size", "256", "--center_w", "192", "--center_h", "128",
            "--ngf", "4", "--ndf", "4", "--batch_size", str(batch),
            "--batch_size_G2", str(K), "--batch_size_G2_val", str(K_VAL),
            "--add_fake_T_sample_size", str(MORE), "--data_len", "2",
            "--use_vision_aided_loss", "true" if d3 else "false",
            "--vision_aided_warmup_epoch", "1", "--init_gain", "0.5",
            "--canvas_fold", "1", "--lpips_fold", "1",
            "--checkpoints_dir", str(tmp / "ckpt"), "--results_dir", str(tmp / "res")]


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


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_batch(tmp, batch, d3=False):
    from vts_tpu.config import TrainOptions as JaxTrainOptions
    from vts_tpu.data import create_dataset as jax_create_dataset
    jopt = JaxTrainOptions().parse(argv(tmp, batch, d3), quiet=True)
    jopt.num_threads = 0
    return jopt, next(iter(jax_create_dataset(jopt)))


def jax_draws(rng, n):
    """The uniforms of one JAX ``_train_step``, split from its key as the step
    and its callees split it (sinskit.py:608, diffaug.py, patch.py:178-183)."""
    _, k_aug_r, k_aug_f, k_more, _, _ = jax.random.split(rng, 6)

    def aug(key):
        kb, ks = jax.random.split(key, 2)
        return {"b": torch.tensor(np.asarray(jax.random.uniform(kb, (n, 1, 1, 1)))).reshape(n),
                "s": torch.tensor(np.asarray(jax.random.uniform(ks, (n, 1, 1, 1)))).reshape(n)}

    keys = [k_more] if n == 1 else list(jax.random.split(k_more, n))
    more = []
    for key in keys:
        k_row, k_col = jax.random.split(key)
        more.append(np.stack([np.asarray(jax.random.uniform(k_row, (MORE,))),
                              np.asarray(jax.random.uniform(k_col, (MORE,)))]))
    return {"aug_real": aug(k_aug_r), "aug_fake": aug(k_aug_f),
            "more": torch.from_numpy(np.stack(more))}


def port_model(tmp, batch, d3=False):
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    opt = TrainOptions().parse(argv(tmp, batch, d3) + ["--device", "cpu", "--no_html"],
                               quiet=True)
    model = create_model(opt)
    model.setup()
    return model


def load_jax_states(model, states):
    from vts_torch.utils.convert_jax import (d_params_to_torch, d_stats_to_torch,
                                             unet_params_to_torch)
    model.netG.load_state_dict(unet_params_to_torch(np_tree(states["G"].params)))
    for name in ("D", "D2"):
        sd = dict(d_params_to_torch(np_tree(states[name].params)))
        sd.update(d_stats_to_torch(np_tree(states[name].stats)))
        getattr(model, f"net{name}").load_state_dict(sd)


def run_step(tmp, n, d3=False):
    """One JAX step and one port step at epoch 1 from the same weights, batch
    and draws → (JAX model with its updated states and outputs, JAX losses,
    port model after its step)."""
    from vts_tpu.models import create_model as jax_create_model
    jopt, batch = jax_batch(tmp, n, d3)
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

    model = port_model(tmp, n, d3)
    load_jax_states(model, states0)
    model.set_input(batch)
    model.optimize_parameters(epoch=1, draws=jax_draws(jmodel.rng, n))
    return jmodel, {k: float(v) for k, v in losses.items()}, model
