"""Port parity for the generator: positional encoding, InstanceNorm and the
dual-head CustomUNet (256², ngf 4) on weights bridged from JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vts_tpu.networks.blocks import InstanceNorm as JaxInstanceNorm
from vts_tpu.networks.positional import positional_encoding as jax_pe
from vts_tpu.networks.unet_custom import CustomUNet as JaxCustomUNet
from vts_torch.networks.blocks import InstanceNorm
from vts_torch.networks.positional import positional_encoding
from vts_torch.networks.unet_custom import CustomUNet
from vts_torch.utils.convert_jax import torch_to_unet_params, unet_params_to_torch
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("h,w,dim", [(256, 256, 4), (96, 160, 4), (33, 17, 6)])
def test_positional_encoding_exact(h, w, dim):
    """(c) SPE grid, channel order [x_emb, y_emb], row 0 zero: exact."""
    got = positional_encoding(h, w, "spe", dim, batch=2).numpy()
    want = np.asarray(jax_pe(h, w, "spe", dim, batch=2))
    np.testing.assert_array_equal(got, want)


def test_instance_norm_one_pass_matches():
    """(c) one-pass fp32 statistics, eps 1e-5: atol 1e-5."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 24, 20, 7)) * 3 + 1.5).astype(np.float32)
    want = np.asarray(JaxInstanceNorm().apply({}, jnp.asarray(x)))
    got = InstanceNorm()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def unet_pair():
    jnet = JaxCustomUNet(ngf=4, num_downs=8, num_layer_separate=4, train=False,
                         init_gain=0.5)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 256, 256, 9)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jnet.init(jax.random.key(0), jnp.asarray(x))["params"])
    return jnet, params, x


def test_unet_state_dict_round_trip_is_bit_exact(unet_pair):
    _, params, _ = unet_pair
    net = CustomUNet(9, ngf=4)
    net.load_state_dict(unet_params_to_torch(params))
    back = torch_to_unet_params(net.state_dict())
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_custom_unet_matches_jax(unet_pair):
    """(d) the 5-channel output at 256²/ngf 4 from bridged weights: ≤ 1e-4."""
    jnet, params, x = unet_pair
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = CustomUNet(9, ngf=4).eval()
    net.load_state_dict(unet_params_to_torch(params))
    with torch.no_grad():
        got = torch.cat(net(torch.from_numpy(x)), dim=-1).numpy()
    assert got.shape == want.shape == (1, 256, 256, 5)
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(want).max() > 1e-2      # a non-trivial output was compared


def test_custom_unet_seeded_init_is_deterministic():
    nets = []
    for _ in range(2):
        net = CustomUNet(9, ngf=4)
        net.reset_parameters(torch.Generator().manual_seed(3))
        nets.append(net.state_dict())
    for k in nets[0]:
        torch.testing.assert_close(nets[0][k], nets[1][k], rtol=0, atol=0)
    w = nets[0]["down.down1.conv.weight"]      # xavier, gain 0.02, flax fans
    assert abs(w.std().item() - 0.02 * np.sqrt(2.0 / (4 * 16 + 8 * 16))) < 2e-4
