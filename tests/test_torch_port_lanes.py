"""The round-5 production lane of the port against ``vts_tpu`` on the CPU:
one training step at batch 2 with ``--lpips_crop 128`` (the canvas LPIPS on
one 128² window of the 256² canvas), at 256² with ngf/ndf 4, from the same
weights, batch and draws (the crop window replayed from JAX's key,
``tests/torch_port_step.py``):

  (a) in fp32, held as the other steps are (``test_torch_port_train.py``):
      losses rtol 1e-4, the gradients (Adam μ, β1 = 0) per leaf by
      ``_grad_tol``, params and running stats as there;
  (b) under ``--dtype bfloat16``, held to a bound relative to JAX's own bf16
      error, with the JAX fp32 step of (a) as the reference:
        per loss      |port16 − jax16| ≤ 2·|jax16 − jax32| + 1e-3·|jax32|;
        per network   ‖port16 − jax16‖ / ‖jax32‖ ≤ 2·‖jax16 − jax32‖ / ‖jax32‖
                      + 1e-3, over the whole gradient (Adam μ).
      The two bf16 steps round at nearly the same places (the port follows
      the reference's casts one for one); where they differ — a conv's bias
      added after its rounding, K1's fp32 bias, the order of a sum before
      its rounding — each difference is one more bf16 rounding of the kind
      that separates JAX's bf16 step from its fp32 one.

Also the LPIPS module alone under bf16 against ``vts_tpu.losses.lpips.lpips(
dtype=bf16)`` (the same relative bound), and D3's logits of a bf16 fake
image against JAX's (both widen it to fp32 first: rtol 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import _grad_tol
from tests.torch_port_step import env  # noqa: F401  (module-scoped fixture)
from tests.torch_port_step import assert_bf16_losses, assert_bf16_tree
from tests.torch_port_step import flat, jax_batch, jax_draws, load_jax_states, port_model
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

LANE = ["--lpips_crop", "128"]
BF16 = ["--dtype", "bfloat16"]


def _port_tree(model):
    from vts_torch.utils.convert_jax import torch_to_d_params, torch_to_unet_params
    to_flax = {"G": lambda sd: (torch_to_unet_params(sd), {}), "D": torch_to_d_params,
               "D2": torch_to_d_params}
    out = {"losses": model.get_current_losses()}
    for name in ("G", "D", "D2"):
        params, stats = to_flax[name](getattr(model, f"net{name}").state_dict())
        out[name] = {"params": flat(params), "stats": flat(stats),
                     "mu": flat(to_flax[name](dict(model.adam[name].mu))[0])}
    return out


@pytest.fixture(scope="module")
def lane(env):  # noqa: F811
    """{"jax32", "jax16", "port32", "port16"}: each {"losses", net: {"params",
    "stats", "mu"}} after one step at batch 2 with --lpips_crop 128."""
    from vts_tpu.models import create_model as jax_create_model
    jopt, batch = jax_batch(env, 2, extra=LANE)
    jopt16, _ = jax_batch(env, 2, extra=LANE + BF16)
    jm = jax_create_model(jopt)
    jm.setup(batch)
    jm.set_input(batch)
    states0 = jm.states
    h, w = batch["S"].shape[1:3]
    out = {}
    for key, model in (("jax32", jm), ("jax16", jax_create_model(jopt16))):
        fn = jax.jit(functools.partial(model._train_step, use_d3=False))
        gS, dS, d2S, losses, _ = fn(states0["G"], states0["D"], states0["D2"], jm._input, jm.rng,
                                    jnp.float32(jopt.lr), jnp.float32(jopt.lr_G2),
                                    jnp.int32(1), {"lpips": jm.lpips_params})
        out[key] = {"losses": {k: float(v) for k, v in losses.items()}}
        for name, st in (("G", gS), ("D", dS), ("D2", d2S)):
            out[key][name] = {"params": flat(st.params), "stats": flat(st.stats),
                              "mu": flat(st.opt_state.mu)}
    for key, extra, dtype in (("port32", LANE, None), ("port16", LANE + BF16, jnp.bfloat16)):
        model = port_model(env, 2, extra=extra)
        load_jax_states(model, states0)
        model.set_input(batch)
        draws = jax_draws(jm.rng, 2, dtype, crop=(128, h, w))
        assert model._crop_active(h, w) and draws["lpips_crop"] != (0, 0)
        model.optimize_parameters(epoch=1, draws=draws)
        out[key] = _port_tree(model)
    return out


def test_fp32_crop_step_losses(lane):
    want, got = lane["jax32"]["losses"], lane["port32"]["losses"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_fp32_crop_step_grads_params_and_stats(lane, net):
    """Gradients per leaf within ``_grad_tol``; params and running stats as
    ``test_torch_port_train.py::test_train_step_params_and_stats`` holds them."""
    want, got = lane["jax32"][net], lane["port32"][net]
    g = want["mu"]
    assert g.keys() == got["mu"].keys() and want["params"].keys() == got["params"].keys()
    net_max = max(np.abs(v).max() for v in g.values())
    lr = 1e-3 if net in ("G", "D") else 5e-4
    for k in g:
        tol = _grad_tol(k, g[k], net_max)
        assert np.abs(g[k] - got["mu"][k]).max() <= tol, (net, k)
        tiny = np.abs(g[k]) <= tol
        bound = np.where(tiny, 2 * lr + 1e-6, 1e-6 + 1e-5 * np.abs(want["params"][k]))
        assert (np.abs(want["params"][k] - got["params"][k]) <= bound).all(), (net, k)
    for k in want["stats"]:
        np.testing.assert_allclose(got["stats"][k], want["stats"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_bf16_crop_step_losses(lane):
    """|port16 − jax16| ≤ 2·|jax16 − jax32| + 1e-3·|jax32| per loss."""
    assert_bf16_losses(*(lane[k]["losses"] for k in ("jax32", "jax16", "port16")))


@pytest.mark.parametrize("net", ["G", "D", "D2"])
def test_bf16_crop_step_grads(lane, net):
    """‖port16 − jax16‖ / ‖jax32‖ ≤ 2·‖jax16 − jax32‖ / ‖jax32‖ + 1e-3 over
    the network's whole gradient (Adam μ), and the running stats likewise."""
    ref, want, got = (lane[k][net] for k in ("jax32", "jax16", "port16"))
    for part in ("mu", "stats"):
        assert_bf16_tree(ref[part], want[part], got[part], f"{part} {net}")


@pytest.mark.parametrize("kind", ["canvas", "gray_patches"])
def test_lpips_bf16_matches_jax(kind):
    """The port's LPIPS at dtype bf16 against ``lpips(dtype=bf16)``, both
    with the y branch apart (y_no_grad), and its x-gradient: per sample
    |port16 − jax16| ≤ 2·|jax16 − jax32| + 1e-3·|jax32|, and the gradient
    within the same bound relative to its norm."""
    from vts_tpu.losses.lpips import init_lpips_params as jax_init
    from vts_tpu.losses.lpips import lpips as jax_lpips
    from vts_torch.losses.lpips import LPIPS, init_lpips_params
    rng = np.random.default_rng(21)
    shape = (2, 64, 48, 3) if kind == "canvas" else (6, 32, 32, 1)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    params = jax_init(0)

    def jax_fn(dtype):
        f = lambda a: jax_lpips(params, a, jnp.asarray(y), dtype=dtype, y_no_grad=True)
        d, vjp = jax.vjp(f, jnp.asarray(x))
        return d, vjp(jnp.ones_like(d))[0]
    (d32, g32), (d16, g16) = jax_fn(None), jax_fn(jnp.bfloat16)
    net = LPIPS(init_lpips_params(0))
    xt = torch.from_numpy(x).requires_grad_(True)
    dp = net(xt, torch.from_numpy(y), y_no_grad=True, dtype=torch.bfloat16)
    (gp,) = torch.autograd.grad(dp.sum(), xt)
    assert dp.dtype == torch.float32
    d32, d16, dp = (np.asarray(t, np.float64) for t in (d32, d16, dp.detach()))
    assert (np.abs(dp - d16) <= 2 * np.abs(d16 - d32) + 1e-3 * np.abs(d32)).all(), (dp, d16, d32)
    g32, g16, gp = (np.asarray(t, np.float64) for t in (g32, g16, gp))
    scale = np.linalg.norm(g32)
    d_port, d_jax = np.linalg.norm(gp - g16) / scale, np.linalg.norm(g16 - g32) / scale
    print(f"[bf16 lpips {kind}] x-grad |port16 - jax16|/|jax32| {d_port:.3e}, "
          f"|jax16 - jax32|/|jax32| {d_jax:.3e}")
    assert d_port <= 2 * d_jax + 1e-3


def test_d3_logits_of_a_bf16_fake_match_jax():
    """A bf16 fake image meets D3's fp32 CLIP tower: both packages widen it
    to fp32 first (jnp's promotion), so the logits agree as in fp32 (rtol
    1e-4, atol 1e-5 of the largest), and the gradient comes back bf16."""
    from vts_tpu.losses.vision_aided import d3_logits as jax_d3_logits
    from vts_tpu.losses.vision_aided import init_d3_head_params as jax_heads
    from vts_tpu.networks.clip_vit import init_clip_params as jax_clip
    from vts_torch.losses import vision_aided as tv
    from vts_torch.networks import clip_vit as tc
    fake = np.random.default_rng(3).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    f16 = jnp.asarray(fake).astype(jnp.bfloat16)
    want = jax_d3_logits(jax_clip(0), jax_heads(0), f16)
    ft = torch.tensor(np.asarray(f16.astype(jnp.float32))).to(torch.bfloat16)
    ft.requires_grad_(True)
    got = tv.d3_logits(tc.CLIPViT(tc.init_clip_params(0)),
                       tv.D3Heads(tv.init_d3_head_params(0)), ft)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())
    (g,) = torch.autograd.grad(sum(torch.mean(tv.softplus(-lg)) for lg in got), ft)
    assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
