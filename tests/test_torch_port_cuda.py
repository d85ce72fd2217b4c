"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels are built at first use); every
test here is marked ``cuda`` and skips without a card.  Run on the GPU
machine with ``python -m pytest tests/test_torch_port_cuda.py -q``.  This
file imports no JAX, so it also runs where JAX is not installed."""

import pytest
import torch

from vts_torch.ops import conv3x3 as k1
from vts_torch.ops import patch as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("shape", [(2, 16, 24, 64, 128), (1, 13, 7, 3, 5),
                                   (3, 37, 29, 128, 128), (2, 9, 40, 64, 64)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_kernel_matches_plain(cuda, shape, relu):
    n, h, w, c, co = shape
    g = torch.Generator(device="cpu").manual_seed(sum(shape))
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(3, 3, c, co, generator=g) * 0.1).to(cuda)
    b = torch.randn(co, generator=g).to(cuda)
    before = k1.conv3x3_bias_relu.launches
    got = k1.conv3x3_bias_relu(x, wt, b, relu=relu)
    torch.cuda.synchronize()
    assert k1.conv3x3_bias_relu.launches == before + 1
    want = k1.conv3x3_bias_relu_plain(x, wt, b, relu=relu)
    tol = 1e-4 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol


def test_conv3x3_kernel_bf16(cuda):
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2, 20, 24, 64, generator=g).to(cuda, torch.bfloat16)
    wt = (torch.randn(3, 3, 64, 128, generator=g) * 0.1).to(cuda, torch.bfloat16)
    b = torch.randn(128, generator=g).to(cuda)
    got = k1.conv3x3_bias_relu(x, wt, b).float()
    want = k1.conv3x3_bias_relu_plain(x.float(), wt.float(), b)
    # bf16 output rounding: 2^-8 relative
    assert ((got - want).abs() <= 2 ** -8 * want.abs() + 1e-3).all()


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_gather_kernel_matches_plain(cuda, mode, dtype):
    g = torch.Generator(device="cpu").manual_seed(1)
    img = (torch.rand(3, 70, 90, 2, generator=g) * 100).to(dtype).to(cuda)
    ox = torch.randint(-20, 90, (3, 11), generator=g).to(cuda)
    oy = torch.randint(-20, 70, (3, 11), generator=g).to(cuda)
    before = k2.gather_patches.launches
    got = k2.gather_patches(img, ox, oy, 32, mode=mode)
    torch.cuda.synchronize()
    assert k2.gather_patches.launches == before + 1
    assert torch.equal(got, k2.gather_patches_plain(img, ox, oy, 32, mode=mode))


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        k1.conv3x3_bias_relu(x, torch.randn(3, 3, 4, 4, device=cuda, dtype=torch.float64),
                             torch.randn(4, device=cuda))
    with pytest.raises(ValueError):
        k2.gather_patches(torch.randn(8, 8, 2, device=cuda), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), 4)
