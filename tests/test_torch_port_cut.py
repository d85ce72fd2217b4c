"""The CUT heads and losses (``vts_torch/networks/cut_heads.py``) and the
normal-loss training modes (``vts_torch/losses/normal.py``) against
``vts_tpu`` on the CPU, at small shapes from seeded numpy:

  * each head (``PoolingF``, ``ReshapeF``, ``StridedConvF``, ``PatchSampleF``
    with and without its MLP) on flax's init carried into the port by
    ``cut_head_params_to_torch``: the forward within 1e-5 of its max, the
    input's and every parameter's gradient (a random cotangent) within 1e-5
    of each one's max; the port's own init carried back into flax gives the
    same forward; the converters' round trip is exact; ``PatchSampleF``'s
    locations are JAX's, injected;
  * ``patch_nce_loss`` (batch 2; the key takes no gradient), ``gram_matrix``
    and ``texture_loss`` (the real side takes no gradient): values within
    1e-5 of their max, gradients within 1e-5 of theirs;
  * ``surface_normal_angle_error`` in its four modes on random normals, on
    normals whose cosines sit near ±1, on normals with cos ≤ 0 and on a
    case where the mask of AL and TAL selects nothing: values within
    1e-6 + 1e-5·|ref| (the per-pixel angle also within what 2^-22 of its
    cosine moves it by, acos being ill-conditioned near ±1); the three
    training modes' gradients w.r.t. both normal maps within 1e-5 of each
    one's max plus 1e-7 plus, per pixel, what a cosine a few ulps apart
    (2^-22) moves acos' slope by; TAL's NaN gradient where a cosine rounds
    to −1 or below (the reference's) at the same pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vts_torch.losses import normal as port_normal
from vts_torch.networks import cut_heads as port_cut
from vts_torch.utils.convert_jax import cut_head_params_to_torch, torch_to_cut_head_params
from vts_tpu.losses import normal as jax_normal
from vts_tpu.networks import cut_heads as jax_cut
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

FWD, GRAD = 1e-5, 1e-5


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(np.abs(want).max(), 1e-30) + 1e-7
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(), tol)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check_head(jmod, pmod, params, xs, rng, **call):
    """Forward, input and parameter gradients of ``pmod`` (on ``params``
    converted) against ``jmod`` under a random cotangent on each output."""
    pmod.load_state_dict(cut_head_params_to_torch(params))

    def jax_out(p, *x):
        out = jmod.apply({"params": p}, list(x) if call.get("listed") else x[0],
                         **call.get("jax_kw", {}))
        return out[0] if call.get("listed") else [out]

    jouts = jax_out(params, *[jnp.asarray(x) for x in xs])
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in jouts]
    jgrad = jax.grad(lambda p, *x: sum(jnp.sum(o * c) for o, c in zip(jax_out(p, *x), cots)),
                     argnums=tuple(range(len(xs) + 1)))(params, *[jnp.asarray(x) for x in xs])
    txs = [_t(x, grad=True) for x in xs]
    pouts = pmod(txs, **call.get("port_kw", {}))[0] if call.get("listed") else [pmod(txs[0])]
    for i, (po, jo) in enumerate(zip(pouts, jouts)):
        _close(po.detach().numpy(), jo, FWD, f"out{i}")
    sum(torch.sum(o * _t(c)) for o, c in zip(pouts, cots)).backward()
    for i, (tx, jg) in enumerate(zip(txs, jgrad[1:])):
        _close(tx.grad.numpy(), jg, GRAD, f"dx{i}")
    if params:
        want = cut_head_params_to_torch(jgrad[0])
        for k, p in pmod.named_parameters():
            _close(p.grad.numpy(), want[k].numpy(), GRAD, k)


@pytest.mark.parametrize("head,shape", [("pooling", (2, 6, 5, 8)), ("reshape", (2, 16, 12, 8)),
                                        ("reshape", (2, 3, 5, 4)),
                                        ("strided", (2, 160, 144, 8)),
                                        ("strided", (1, 64, 64, 8))],
                         ids=["pooling", "reshape", "reshape_small", "strided_2conv",
                              "strided_none"])
def test_single_map_heads_match_jax(head, shape):
    rng = np.random.default_rng(len(head) + shape[1])
    x = rng.uniform(-1, 1, size=shape).astype(np.float32)
    if head == "pooling":
        jmod, pmod = jax_cut.PoolingF(), port_cut.PoolingF()
    elif head == "reshape":
        jmod, pmod = jax_cut.ReshapeF(), port_cut.ReshapeF()
    else:
        jmod, pmod = jax_cut.StridedConvF(), port_cut.StridedConvF(shape[-1], shape[1])
    params = jmod.init(jax.random.key(3), jnp.asarray(x)).get("params", {})
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    assert sorted(k.split(".")[0] for k in pmod.state_dict()) == \
        sorted(k.split("/")[0] for k in _flat(params))
    _check_head(jmod, pmod, params, [x], rng)


def _patch_sample_setup(use_mlp):
    rng = np.random.default_rng(11)
    feats = [rng.uniform(-1, 1, size=(2, 8, 8, 16)).astype(np.float32),
             rng.uniform(-1, 1, size=(2, 4, 4, 32)).astype(np.float32)]
    jmod = jax_cut.PatchSampleF(use_mlp=use_mlp, nc=24, num_patches=20)
    params = jmod.init(jax.random.key(4), [jnp.asarray(f) for f in feats],
                       jax.random.key(5)).get("params", {})
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    _, ids = jmod.apply({"params": params}, [jnp.asarray(f) for f in feats], jax.random.key(5))
    pmod = port_cut.PatchSampleF(use_mlp=use_mlp, nc=24, num_patches=20,
                                 in_channels=[f.shape[-1] for f in feats])
    return rng, feats, jmod, params, [np.asarray(i) for i in ids], pmod


@pytest.mark.parametrize("use_mlp", [False, True], ids=["plain", "mlp"])
def test_patch_sample_matches_jax_with_its_ids(use_mlp):
    rng, feats, jmod, params, ids, pmod = _patch_sample_setup(use_mlp)
    assert [len(i) for i in ids] == [20, 16]                 # min(num_patches, H·W)
    _check_head(jmod, pmod, params, feats, rng, listed=True,
                jax_kw={"rng": jax.random.key(5)},
                port_kw={"patch_ids": [torch.from_numpy(i) for i in ids]})
    # the port's own draw: a prefix of a permutation, the same for the batch
    got, pids = pmod([_t(f) for f in feats], generator=torch.Generator().manual_seed(0))
    for f, g, i in zip(feats, got, pids):
        assert g.shape == (2 * len(i), 24 if use_mlp else f.shape[-1])
        assert len(set(i.tolist())) == len(i) and int(i.max()) < f.shape[1] * f.shape[2]


def test_cut_head_weights_convert_both_ways():
    """The port's own init carried into flax gives the port's forward; the
    round trip of the converters is exact; the MLP's names are flax's."""
    rng, feats, jmod, params, ids, _ = _patch_sample_setup(True)
    pmod = port_cut.PatchSampleF(use_mlp=True, nc=24, num_patches=20, in_channels=[16, 32],
                                 generator=torch.Generator().manual_seed(1))
    tree = torch_to_cut_head_params(pmod.state_dict())
    assert sorted(_flat(tree)) == sorted(_flat(params))
    for k, v in _flat(tree).items():
        assert v.shape == _flat(params)[k].shape, k
    back = cut_head_params_to_torch(tree)
    for k, v in pmod.state_dict().items():
        assert torch.equal(back[k], v), k
    want, _ = jmod.apply({"params": tree}, [jnp.asarray(f) for f in feats], jax.random.key(5),
                         patch_ids=[jnp.asarray(i) for i in ids])
    got, _ = pmod([_t(f) for f in feats], patch_ids=[torch.from_numpy(i) for i in ids])
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w, FWD)
    x = rng.uniform(-1, 1, size=(1, 130, 130, 8)).astype(np.float32)
    conv = port_cut.StridedConvF(8, 130, generator=torch.Generator().manual_seed(2))
    assert [k for k in conv.state_dict()] == ["Conv_0.weight", "Conv_0.bias",
                                              "Conv_1.weight", "Conv_1.bias"]
    want = jax_cut.StridedConvF().apply({"params": torch_to_cut_head_params(conv.state_dict())},
                                        jnp.asarray(x))
    _close(conv(_t(x)).detach().numpy(), want, FWD)
    with pytest.raises(ValueError, match="height 130"):
        conv(_t(x[:, :100]))


def test_patch_nce_loss_matches_jax():
    rng = np.random.default_rng(21)
    q = np.asarray(jax_cut.l2_normalize(jnp.asarray(rng.standard_normal((2 * 12, 16)),
                                                    jnp.float32)))
    k = np.asarray(jax_cut.l2_normalize(jnp.asarray(rng.standard_normal((2 * 12, 16)),
                                                    jnp.float32)))
    cot = rng.standard_normal(24).astype(np.float32)
    want = jax_cut.patch_nce_loss(jnp.asarray(q), jnp.asarray(k), batch_size=2)
    dq, dk = jax.grad(lambda a, b: jnp.sum(jax_cut.patch_nce_loss(a, b, batch_size=2) * cot),
                      argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    assert np.abs(np.asarray(dk)).max() == 0.0                # the key stops the gradient
    tq, tk = _t(q, grad=True), _t(k, grad=True)
    got = port_cut.patch_nce_loss(tq, tk, batch_size=2)
    _close(got.detach().numpy(), want, FWD)
    torch.sum(got * _t(cot)).backward()
    _close(tq.grad.numpy(), dq, GRAD)
    assert tk.grad is None
    _close(port_cut.l2_normalize(_t(q * 3)).numpy(), jax_cut.l2_normalize(jnp.asarray(q * 3)),
           FWD)


def test_gram_and_texture_loss_match_jax():
    rng = np.random.default_rng(22)
    fakes = [rng.uniform(-1, 1, size=s).astype(np.float32) for s in ((2, 9, 7, 6), (2, 4, 4, 10))]
    reals = [rng.uniform(-1, 1, size=f.shape).astype(np.float32) for f in fakes]
    _close(port_cut.gram_matrix(_t(fakes[0])).numpy(),
           jax_cut.gram_matrix(jnp.asarray(fakes[0])), FWD)
    jf = [jnp.asarray(f) for f in fakes]
    jr = [jnp.asarray(r) for r in reals]
    want = jax_cut.texture_loss(jf, jr)
    dfake, dreal = jax.grad(lambda a, b: jax_cut.texture_loss(a, b), argnums=(0, 1))(jf, jr)
    assert all(np.abs(np.asarray(d)).max() == 0.0 for d in dreal)
    tf = [_t(f, grad=True) for f in fakes]
    tr = [_t(r, grad=True) for r in reals]
    got = port_cut.texture_loss(tf, tr)
    _close(got.detach().numpy(), want, FWD)
    got.backward()
    for t, d in zip(tf, dfake):
        _close(t.grad.numpy(), d, GRAD)
    assert all(t.grad is None for t in tr)


def _normals(case, rng, shape=(2, 6, 7, 3)):
    """(real, pred) normal maps for each case: random; pred ≈ ±real with
    perturbations from 1e-4 to 3e-1 (cosines near ±1, on both sides of the
    masks' 0.999 and 0.9999 bounds); pred with cos ≤ 0 everywhere; pred =
    real (cos = 1: AL's and TAL's masks select nothing)."""
    real = rng.standard_normal(shape).astype(np.float32)
    real[..., 2] = np.abs(real[..., 2]) + 0.5
    if case == "random":
        return real, rng.standard_normal(shape).astype(np.float32)
    if case == "near_pm1":
        sign = np.where(rng.uniform(size=shape[:3] + (1,)) < 0.5, -1.0, 1.0)
        scale = 10.0 ** rng.uniform(-4, -0.5, size=shape[:3] + (1,))
        return real, (sign * real + scale * rng.standard_normal(shape)).astype(np.float32)
    if case == "nonpositive":
        pred = rng.standard_normal(shape).astype(np.float32)
        dot = np.sum(pred * real, -1, keepdims=True)
        pred = np.where(dot > 0, -pred, pred).astype(np.float32)
        return real, pred
    return real, real.copy()


@pytest.mark.parametrize("case", ["random", "near_pm1", "nonpositive", "empty_mask"])
@pytest.mark.parametrize("mode", ["evaluate", "train_L2_loss", "train_AL_loss", "train_TAL_loss"])
def test_normal_modes_match_jax(mode, case):
    rng = np.random.default_rng(["random", "near_pm1", "nonpositive", "empty_mask"].index(case))
    real, pred = _normals(case, rng)
    want = np.asarray(jax_normal.surface_normal_angle_error(jnp.asarray(real), jnp.asarray(pred),
                                                            mode))
    tr, tp = _t(real, grad=True), _t(pred, grad=True)
    got = port_normal.surface_normal_angle_error(tr, tp, mode)
    atol = 1e-6
    if mode == "evaluate":
        # acos is ill-conditioned near ±1: a cosine a few float32 ulps apart
        # (2^-22) moves the angle by 2^-22/sin(angle) radians
        atol = atol + np.degrees(2.0 ** -22 / np.maximum(np.sin(np.radians(want)), 1e-12))
    assert np.all(np.abs(got.detach().numpy() - want) <= atol + 1e-5 * np.abs(want))
    if case == "empty_mask" and mode in ("train_AL_loss", "train_TAL_loss"):
        assert float(got) == 0.0
    if mode == "evaluate":
        return
    dr, dp = jax.grad(lambda r, p: jax_normal.surface_normal_angle_error(r, p, mode),
                      argnums=(0, 1))(jnp.asarray(real), jnp.asarray(pred))
    got.backward()
    cos = np.asarray(jax_normal.cosine_similarity(jnp.asarray(pred), jnp.asarray(real)))
    for g, w in ((tr.grad, dr), (tp.grad, dp)):
        g, w = g.numpy(), np.asarray(w)
        # a cosine that rounds to -1 or below gives TAL a NaN gradient in the
        # reference (acos' infinite slope times the zero its where passes):
        # the same pixels in the port
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert (mode, case) == ("train_TAL_loss", "near_pm1") or np.isfinite(w).all()
        ok = np.isfinite(w)
        # acos' slope 1/√(1 − cos²) moves by a relative cos·2^-22/(1 − cos²)
        # when the cosine is a few ulps apart: each pixel's gradient may too
        amp = np.abs(cos) * 2.0 ** -22 / np.maximum(1.0 - cos * cos, 1e-30)
        tol = 1e-5 * np.abs(w[ok]).max() + 1e-7 + (np.abs(w) * amp[..., None])[ok]
        assert np.all(np.abs(g[ok] - w[ok]) <= tol), np.abs(g[ok] - w[ok]).max()
