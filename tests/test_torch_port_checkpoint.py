"""(g) Checkpoints cross the two packages bit-exactly: a file written by the
JAX ``save_net`` is read by the port's msgpack codec, and a file written by
the port is read by ``flax.serialization.msgpack_restore``."""

import jax
import numpy as np
import torch
from flax.serialization import msgpack_restore as flax_restore
from flax.serialization import msgpack_serialize as flax_serialize

from vts_tpu.models.base import NetState
from vts_tpu.models.base import save_net as jax_save_net
from vts_torch.models.base import load_net, save_net
from vts_torch.networks.unet_custom import CustomUNet
from vts_torch.utils import msgpack
from vts_torch.utils.convert_jax import torch_to_unet_params, unet_params_to_torch
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)


def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _unet_params(seed):
    net = CustomUNet(9, ngf=4)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return torch_to_unet_params(net.state_dict())


def test_jax_checkpoint_read_by_port(tmp_path):
    params = _unet_params(0)
    jax_save_net(str(tmp_path), "best", "G", NetState(params=params, stats={}))
    with open(tmp_path / "best_net_G.msgpack", "rb") as f:
        payload = msgpack.msgpack_restore(f.read())
    a, b = _flat(params), _flat(payload["params"])
    assert a.keys() == b.keys() and payload["stats"] == {}
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    net = CustomUNet(9, ngf=4)
    assert load_net(str(tmp_path), "best", "G", net, unet_params_to_torch)
    for k, v in unet_params_to_torch(params).items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=0, atol=0)


def test_port_checkpoint_read_by_flax(tmp_path):
    params = _unet_params(1)
    path = save_net(str(tmp_path), "latest", "G", params)
    with open(path, "rb") as f:
        payload = flax_restore(f.read())
    a, b = _flat(params), _flat(payload["params"])
    assert a.keys() == b.keys() and payload["stats"] == {}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_codec_scalars_and_containers_match_flax():
    tree = {"a": np.arange(7, dtype=np.int32).reshape(7, 1), "b": np.float32(2.5),
            "c": {"d": np.zeros((0, 3), np.float64), "e": [1, -3, 300, -70000, 2 ** 40],
                  "f": "x" * 40, "g": 1.25, "h": None, "i": True, "j": np.float64(-1.0)},
            "k": np.ones((3,), np.uint8)}
    ours = msgpack.msgpack_serialize(tree)
    assert ours == flax_serialize(tree)
    back = msgpack.msgpack_restore(ours)
    assert _flat(back).keys() == _flat(tree).keys()
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(np.asarray(_flat(back)[k]), np.asarray(v))
