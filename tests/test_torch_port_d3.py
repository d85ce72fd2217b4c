"""The vision-aided D3 of the port against ``vts_tpu`` on the CPU, on seeded
numpy inputs:

  * the 1-D resize matrices against ``vts_tpu.ops.resize_mm._resize_matrix``
    (max |Δ| ≤ 1e-6), and ``resize_mm`` with its VJP (rtol 1e-5, atol 1e-6);
  * the seeded CLIP tower and D3 heads, bit for bit, through ``convert_jax``;
  * ``clip_image_features`` (embedding and the three taps) at 224² and 256²
    (rtol 1e-4, and atol 1e-5 of the tensor's largest magnitude: after 12
    residual blocks the taps reach ~10-30, and an element near zero carries
    the round-off of that scale);
  * ``clip_style_code``, the skitG style code, at 224² and from a 256²
    image (resized inside), under the embedding's limit above;
  * ``d3_logits``, ``d3_d_loss`` and ``d3_g_loss`` (rtol 1e-4, atol 1e-6), and
    the gradient of ``d3_g_loss`` in the fake image (within 1e-4 of its max);
  * the OpenAI-format loader on a ``visual.*`` state dict written here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vts_torch.losses import vision_aided as tv
from vts_torch.networks import clip_vit as tc
from vts_torch.ops.resize_mm import _resize_matrix, resize_mm
from vts_torch.utils.convert_jax import clip_params_to_torch, d3_head_params_to_torch
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, size, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _assert_close(got, want, what):
    """|Δ| ≤ 1e-4·|want| + 1e-5·max|want|, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.fixture(scope="module")
def towers():
    """(JAX CLIP params, JAX D3 heads, port CLIPViT, port D3Heads), seed 0."""
    from vts_tpu.losses.vision_aided import init_d3_head_params
    from vts_tpu.networks.clip_vit import init_clip_params
    jclip, jheads = init_clip_params(0), init_d3_head_params(0)
    clip = tc.CLIPViT(tc.init_clip_params(0))
    heads = tv.D3Heads(tv.init_d3_head_params(0))
    return jclip, jheads, clip, heads


@pytest.mark.parametrize("sizes", [(1536, 224), (256, 224), (64, 224)],
                         ids=["1536to224", "256to224", "64to224_upsample"])
def test_resize_matrix_matches_jax(sizes):
    from vts_tpu.ops.resize_mm import _resize_matrix as jax_resize_matrix
    want = jax_resize_matrix(*sizes, "linear", True)
    got = _resize_matrix(*sizes)
    assert got.shape == want.shape == sizes[::-1] and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


def test_resize_mm_and_vjp_match_jax():
    from vts_tpu.ops.resize_mm import resize_mm as jax_resize_mm
    x = _images(1, 256)
    ct = np.random.default_rng(2).normal(size=(2, 224, 224, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_resize_mm(a, (224, 224)), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = resize_mm(xt, (224, 224))
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["clip", "heads"])
def test_seeded_init_matches_jax_bit_for_bit(towers, which):
    jclip, jheads, clip, heads = towers
    want = (clip_params_to_torch(_np_tree(jclip)) if which == "clip"
            else d3_head_params_to_torch(_np_tree(jheads)))
    got = (clip if which == "clip" else heads).state_dict()
    assert set(got) == set(want) and len(want) == (152 if which == "clip" else 24)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not any(p.requires_grad for p in (clip if which == "clip" else heads).parameters())


@pytest.mark.parametrize("size", [224, 256])
def test_clip_features_match_jax(towers, size):
    from vts_tpu.networks.clip_vit import clip_image_features
    jclip, _, clip, _ = towers
    x = _images(size, size)
    want_emb, want_taps = clip_image_features(jclip, jnp.asarray(x), tv.TAP_LAYERS)
    with torch.no_grad():
        emb, taps = tc.clip_image_features(clip, torch.from_numpy(x), tv.TAP_LAYERS)
    assert emb.shape == (2, 512) and len(taps) == 3
    _assert_close(emb, want_emb, "embedding")
    for i, (a, b) in enumerate(zip(taps, want_taps)):
        assert a.shape == (2, 50, 768)
        _assert_close(a, b, f"tap {i}")


@pytest.mark.parametrize("size", [224, 256])
def test_clip_style_code_matches_jax(towers, size):
    from vts_tpu.networks.clip_vit import clip_style_code
    jclip, _, clip, _ = towers
    x = _images(size + 1, size)
    want = clip_style_code(jclip, jnp.asarray(x))
    with torch.no_grad():
        got = tc.clip_style_code(clip, torch.from_numpy(x))
    assert got.shape == (2, 512)
    _assert_close(got, want, "style code")


def test_d3_logits_and_losses_match_jax(towers):
    from vts_tpu.losses import vision_aided as jv
    jclip, jheads, clip, heads = towers
    real, fake = _images(3, 256), _images(4, 256)
    want = jv.d3_logits(jclip, jheads, jnp.asarray(fake))
    with torch.no_grad():
        got = tv.d3_logits(clip, heads, torch.from_numpy(fake))
        d_loss = tv.d3_d_loss(clip, heads, torch.from_numpy(real), torch.from_numpy(fake))
        g_loss = tv.d3_g_loss(clip, heads, torch.from_numpy(fake))
    assert [tuple(t.shape) for t in got] == [(2, 50)] * 3 + [(2, 1)]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6,
                                   err_msg=f"level {i}")
    np.testing.assert_allclose(
        float(d_loss), float(jv.d3_d_loss(jclip, jheads, jnp.asarray(real), jnp.asarray(fake))),
        rtol=1e-4)
    np.testing.assert_allclose(float(g_loss),
                               float(jv.d3_g_loss(jclip, jheads, jnp.asarray(fake))), rtol=1e-4)


def test_d3_g_loss_input_grad_matches_jax(towers):
    """The gradient that reaches G: through the heads, the 12 blocks and the
    1536² → 224² resize, here from a 256² fake."""
    from vts_tpu.losses import vision_aided as jv
    jclip, jheads, clip, heads = towers
    fake = _images(5, 256)
    want = np.asarray(jax.grad(lambda f: jv.d3_g_loss(jclip, jheads, f))(jnp.asarray(fake)))
    ft = torch.from_numpy(fake).requires_grad_(True)
    (got,) = torch.autograd.grad(tv.d3_g_loss(clip, heads, ft), ft)
    assert np.abs(want).max() > 0
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_openai_loader_matches_jax(tmp_path):
    """A ``visual.*`` state dict (OpenAI layout: (out, in) weights, OIHW conv)
    written with ``torch.save``: both packages load the same tree and give
    the same features."""
    from vts_tpu.networks.clip_vit import clip_image_features, load_clip_weights
    src = tc.init_clip_params(7)
    rng = np.random.default_rng(8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731

    def ln(prefix, p):
        p["scale"] = (1 + 0.1 * rng.normal(size=p["scale"].shape)).astype(np.float32)
        p["bias"] = (0.1 * rng.normal(size=p["bias"].shape)).astype(np.float32)
        return {f"{prefix}.weight": t(p["scale"]), f"{prefix}.bias": t(p["bias"])}

    sd = {"visual.conv1.weight": t(src["conv"].transpose(3, 2, 0, 1)),
          "visual.class_embedding": t(src["class_embedding"]),
          "visual.positional_embedding": t(src["positional_embedding"]),
          "visual.proj": t(src["proj"]), "logit_scale": torch.tensor(4.6)}
    sd.update(ln("visual.ln_pre", src["ln_pre"]))
    sd.update(ln("visual.ln_post", src["ln_post"]))
    for i, blk in enumerate(src["blocks"]):
        p = f"visual.transformer.resblocks.{i}"
        sd.update(ln(f"{p}.ln_1", blk["ln_1"]))
        sd.update(ln(f"{p}.ln_2", blk["ln_2"]))
        blk["attn"]["qkv_b"] = rng.normal(size=3 * 768).astype(np.float32) * 0.1
        sd.update({f"{p}.attn.in_proj_weight": t(blk["attn"]["qkv_w"].T),
                   f"{p}.attn.in_proj_bias": t(blk["attn"]["qkv_b"]),
                   f"{p}.attn.out_proj.weight": t(blk["attn"]["out_w"].T),
                   f"{p}.attn.out_proj.bias": t(blk["attn"]["out_b"]),
                   f"{p}.mlp.c_fc.weight": t(blk["mlp"]["fc_w"].T),
                   f"{p}.mlp.c_fc.bias": t(blk["mlp"]["fc_b"]),
                   f"{p}.mlp.c_proj.weight": t(blk["mlp"]["proj_w"].T),
                   f"{p}.mlp.c_proj.bias": t(blk["mlp"]["proj_b"])})
    path = tmp_path / "clip_visual.pt"
    torch.save(sd, path)
    jtree, tree = load_clip_weights(str(path)), tc.load_clip_weights(str(path))
    want_sd, got_sd = clip_params_to_torch(_np_tree(jtree)), clip_params_to_torch(tree)
    src_sd = clip_params_to_torch(src)
    assert set(got_sd) == set(want_sd) == set(src_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]) and torch.equal(got_sd[k], src_sd[k]), k
    x = _images(9, 224)
    want_emb, want_taps = clip_image_features(jtree, jnp.asarray(x), (11,))
    with torch.no_grad():
        emb, taps = tc.clip_image_features(tc.CLIPViT(tree), torch.from_numpy(x), (11,))
    _assert_close(emb, want_emb, "embedding")
    _assert_close(taps[0], want_taps[0], "tap after block 11")
    torch.save({"conv1.weight": sd["visual.conv1.weight"]}, tmp_path / "bad.pt")
    with pytest.raises(KeyError):
        tc.load_clip_weights(str(tmp_path / "bad.pt"))
