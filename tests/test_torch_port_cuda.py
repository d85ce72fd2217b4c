"""The port's CUDA kernels — forward and backward — against their plain
versions, on the card.

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
                                   (3, 37, 29, 128, 128), (2, 9, 40, 64, 64),
                                   (33000, 2, 2, 3, 128), (70000, 1, 2, 3, 8),
                                   (128, 32, 32, 64, 64), (128, 16, 16, 128, 128)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_kernel_matches_plain(cuda, shape, relu):
    """(70000, 1, 2) has N past the grid's z limit (launched in chunks); the
    last two are the training path's patch shapes."""
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


@pytest.mark.parametrize("shape", [(2, 16, 24, 64, 128), (1, 13, 7, 3, 5),
                                   (3, 37, 29, 128, 128), (128, 16, 16, 128, 64),
                                   (33000, 2, 2, 128, 8), (70000, 1, 2, 8, 3),
                                   (128, 32, 32, 64, 64), (128, 16, 16, 128, 128)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_dx_kernel_matches_plain(cuda, shape, relu):
    """K1 dx against its plain version (and the autograd path launches it):
    |Δ| ≤ 1e-4·max|ref| + 1e-5.  (70000, 1, 2) has N past the grid's z
    limit (launched in chunks); the last two are the training path's patch
    shapes."""
    n, h, w, c, co = shape
    g = torch.Generator(device="cpu").manual_seed(sum(shape) + 1)
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(3, 3, c, co, generator=g) * 0.1).to(cuda)
    b = torch.randn(co, generator=g).to(cuda)
    gy = torch.randn(n, h, w, co, generator=g).to(cuda)
    y = k1.conv3x3_bias_relu(x, wt, b, relu=relu)
    before = k1.conv3x3_dx.launches
    got = k1.conv3x3_dx(gy, y, wt, relu=relu)
    torch.cuda.synchronize()
    assert k1.conv3x3_dx.launches == before + 1
    want = k1.conv3x3_dx_plain(gy, y, wt, relu=relu)
    tol = 1e-4 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    xg = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(k1.conv3x3_bias_relu(xg, wt, b, relu=relu), xg, gy)
    assert k1.conv3x3_dx.launches == before + 2
    assert (gx - want).abs().max().item() <= tol


@pytest.mark.parametrize("shape", [(2, 16, 24, 64, 128), (128, 32, 32, 64, 64),
                                   (4, 24, 40, 128, 128), (1, 13, 7, 3, 5)])
def test_conv3x3_dx_kernel_bf16(cuda, shape):
    """K1 dx on bf16 gy, y and w (the --dtype bfloat16 LPIPS) against its
    plain version in bf16: both sum in fp32 and round once, so they differ
    by the fp32 limit plus one bf16 rounding of each, |Δ| ≤ 2^-7·|ref| +
    1e-4·max|ref| + 1e-5; the autograd path launches it and returns bf16."""
    n, h, w, c, co = shape
    x, wt, b, gy = (t.to(cuda, torch.bfloat16) for t in _lpips_like(shape, sum(shape) + 7))
    y = k1.conv3x3_bias_relu(x, wt, b)
    before = k1.conv3x3_dx.launches
    got = k1.conv3x3_dx(gy, y, wt)
    torch.cuda.synchronize()
    assert k1.conv3x3_dx.launches == before + 1 and got.dtype == torch.bfloat16
    want = k1.conv3x3_dx_plain(gy, y, wt).float()
    tol = 2 ** -7 * want.abs() + 1e-4 * want.abs().max() + 1e-5
    assert ((got.float() - want).abs() <= tol).all()
    xg = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(k1.conv3x3_bias_relu(xg, wt, b), xg, gy)
    assert k1.conv3x3_dx.launches == before + 2 and gx.dtype == torch.bfloat16
    assert torch.equal(gx, got)


def _lpips_like(shape, seed, spread=False):
    """ReLU'd activations, He-scaled weights, a cotangent, as the LPIPS
    convs see them; ``spread`` scales the activations by 1e-3…1e3."""
    n, h, w, c, co = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.relu(torch.randn(n, h, w, c, generator=g))
    if spread:
        x = x * 10.0 ** (6 * torch.rand(n, h, w, c, generator=g) - 3)
    wt = torch.randn(3, 3, c, co, generator=g) * (2.0 / (9 * c)) ** 0.5
    b = torch.randn(co, generator=g) * 0.1
    gy = torch.randn(n, h, w, co, generator=g)
    return x, wt, b, gy


def test_conv3x3_kernels_at_wide_magnitudes(cuda):
    """K1 and K1 dx (3xTF32 on the tensor cores) with activations spread over
    six decades, against their plain fp32 versions: |Δ| ≤ 1e-4·max|ref| +
    1e-5, the limit of chip_smoke.py."""
    x, wt, b, gy = (t.to(cuda) for t in _lpips_like((2, 40, 24, 64, 128), 3, spread=True))
    y = k1.conv3x3_bias_relu(x, wt, b)
    want = k1.conv3x3_bias_relu_plain(x, wt, b)
    assert (y - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
    got = k1.conv3x3_dx(gy, y, wt)
    want = k1.conv3x3_dx_plain(gy, y, wt)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5


def test_conv3x3_kernels_repeat_bit_for_bit(cuda):
    """No split-K and no atomics: two launches on the same inputs give the
    same bits, forward and dx."""
    x, wt, b, gy = (t.to(cuda) for t in _lpips_like((4, 48, 40, 64, 128), 5))
    ys = [k1.conv3x3_bias_relu(x, wt, b) for _ in range(2)]
    dxs = [k1.conv3x3_dx(gy, ys[0], wt) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(dxs[0], dxs[1])


def serial_scatter(grad, ox, oy, shape, mode, **windows):
    """scatter_patches on CPU copies of the inputs, with deterministic
    algorithms on: index_put_(accumulate=True) then adds serially, in the
    order (window, row, column) that the kernel sums in."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cpu = {k: v.cpu() for k, v in windows.items()}
        return k2.scatter_patches(grad.cpu(), None if ox is None else ox.cpu(),
                                  None if oy is None else oy.cpu(), shape, mode, **cpu)
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("n", [1, 2])
def test_scatter_kernel_matches_plain(cuda, mode, n):
    """K2 backward against the CPU index_put_(accumulate=True) run serially,
    with overlapping and out-of-bounds windows: bit-exact (each canvas
    element is summed by one thread, window, row, column ascending), and the
    same bits in 3 runs; the autograd path of gather_patches launches it."""
    g = torch.Generator(device="cpu").manual_seed(n)
    ox = torch.randint(-20, 90, (n, 17), generator=g)
    oy = torch.randint(-20, 70, (n, 17), generator=g)
    ox[:, :5], oy[:, :5] = 30, 20
    grad = (torch.randn(n * 17, 32, 32, 2, generator=g)
            * torch.exp(3 * torch.randn(n * 17, 32, 32, 2, generator=g))).to(cuda)
    ox, oy = ox.to(cuda, torch.int32), oy.to(cuda, torch.int32)
    before = k2.scatter_patches.launches
    runs = [k2.scatter_patches(grad, ox, oy, (n, 70, 90, 2), mode=mode) for _ in range(3)]
    torch.cuda.synchronize()
    assert k2.scatter_patches.launches == before + 3
    want = serial_scatter(grad, ox, oy, (n, 70, 90, 2), mode)
    assert all(torch.equal(r.cpu(), want) for r in runs)
    img = torch.zeros(n, 70, 90, 2, device=cuda, requires_grad=True)
    (gi,) = torch.autograd.grad(k2.gather_patches(img, ox, oy, 32, mode=mode), img, grad)
    assert k2.scatter_patches.launches == before + 4
    assert torch.equal(gi.cpu(), want)


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("n", [1, 2])
def test_scatter_kernel_bf16(cuda, mode, n):
    """K2 backward on a bf16 cotangent (the --dtype bfloat16 step): summed in
    fp32 and rounded once to bf16, bit-exact against the serial CPU scatter
    rounded the same way; a bf16 gather's gradient launches it."""
    g = torch.Generator(device="cpu").manual_seed(n + 10)
    ox = torch.randint(-20, 90, (n, 17), generator=g)
    oy = torch.randint(-20, 70, (n, 17), generator=g)
    ox[:, :5], oy[:, :5] = 30, 20
    grad = torch.randn(n * 17, 32, 32, 2, generator=g).to(cuda, torch.bfloat16)
    ox, oy = ox.to(cuda, torch.int32), oy.to(cuda, torch.int32)
    before = k2.scatter_patches.launches
    got = k2.scatter_patches(grad, ox, oy, (n, 70, 90, 2), mode=mode)
    torch.cuda.synchronize()
    assert k2.scatter_patches.launches == before + 1 and got.dtype == torch.bfloat16
    want = serial_scatter(grad, ox, oy, (n, 70, 90, 2), mode)
    assert want.dtype == torch.bfloat16 and torch.equal(got.cpu(), want)
    img = torch.zeros(n, 70, 90, 2, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    (gi,) = torch.autograd.grad(k2.gather_patches(img, ox, oy, 32, mode=mode), img, grad)
    assert k2.scatter_patches.launches == before + 2 and torch.equal(gi, got)


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("c", [1, 3])
def test_scatter_kernel_from_coords(cuda, mode, c):
    """K2 backward at packed coords (origins decoded in the kernel, .5 ties
    and the all-zero coords of padded patches included) equals the serial CPU scatter at patch_offsets' offsets, bit
    for bit, and so does the gradient of a group at those coords."""
    g = torch.Generator(device="cpu").manual_seed(c)
    coords = torch.zeros(2, 9, 8)
    coords[..., 0] = torch.randint(-20, 90, (2, 9), generator=g).float()
    coords[..., 1] = torch.randint(-20, 70, (2, 9), generator=g).float()
    coords[..., 4], coords[..., 5] = 32, 1.0
    coords[..., 6] = torch.tensor([0.5, 1.5, 2.5, -0.5, 3.0, 0.5, -1.5, 1.0, 2.5])
    coords[..., 7] = torch.tensor([2.5, 0.5, -0.5, 1.5, 0.0, 3.5, 0.5, -2.5, 1.0])
    coords[1, 4:6] = 0.0                                       # padded patches: NaN offsets
    coords = coords.to(cuda)
    grad = torch.randn(18, 32, 32, c, generator=g).to(cuda)
    got = k2.scatter_patches(grad, None, None, (2, 70, 90, c), mode, coords=coords)
    ox, oy, _ = k2.patch_offsets(coords.cpu())
    want = serial_scatter(grad, ox, oy, (2, 70, 90, c), mode)
    assert torch.equal(got.cpu(), want)
    imgs = (torch.zeros(2, 70, 90, c, device=cuda, requires_grad=True),
            torch.zeros(2, 70, 90, 2, device=cuda))
    out, _ = k2.gather_patches_group(imgs, coords=coords, cutout=32, mode=mode)
    (gi,) = torch.autograd.grad(out, imgs[0], grad)
    assert torch.equal(gi.cpu(), want)


@pytest.mark.parametrize("mode", ["gather", "slice"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("windows", ["offsets", "coords"])
@pytest.mark.parametrize("n", [1, 3])
def test_gather_group_kernel_matches_plain(cuda, mode, dtype, windows, n):
    """One launch for a group of 1-, 2- and 3-channel images (and a fourth,
    2-channel, non-contiguous), at int offsets or at packed coords with .5
    ties and padded (all-zero) patches: each output equals
    gather_patches_plain of its image, bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(n + 7)
    imgs = [(torch.rand(n, 70, 90, c, generator=g) * 100).to(dtype).to(cuda) for c in (1, 2, 3)]
    imgs.append(imgs[2][..., :2])
    ox = torch.randint(-20, 90, (n, 11), generator=g)
    oy = torch.randint(-20, 70, (n, 11), generator=g)
    ox[:, :3], oy[:, :3] = 30, 20
    if windows == "coords":
        coords = torch.zeros(n, 11, 8)
        coords[..., 0], coords[..., 1] = ox.float(), oy.float()     # + 0.5, − 1.5: ties
        coords[..., 4], coords[..., 5], coords[..., 6], coords[..., 7] = 32, 1.0, 0.5, -1.5
        coords[:, -2:] = 0.0                                   # padded patches: NaN offsets
        kw = dict(coords=coords.to(cuda))
        ox, oy, _ = k2.patch_offsets(coords)
    else:
        kw = dict(offset_x=ox.to(cuda), offset_y=oy.to(cuda))
    before = k2.gather_patches.launches
    outs = k2.gather_patches_group(imgs, cutout=32, mode=mode, **kw)
    torch.cuda.synchronize()
    assert k2.gather_patches.launches == before + 1
    for im, out in zip(imgs, outs):
        want = k2.gather_patches_plain(im, ox.to(cuda), oy.to(cuda), 32, mode=mode)
        assert torch.equal(out, want)


def test_discriminator_input_grad_matches_cpu(cuda):
    """The G-loss pass differentiates D w.r.t. its input through the pyramid's
    average pool (F.avg_pool2d's CUDA backward is wrong for the NHWC view,
    hence the port's own pool): CUDA vs CPU within 1e-5 of the max |g|."""
    from vts_torch.networks.blocks import make_initializer
    from vts_torch.networks.discriminators import MultiscaleDiscriminator, reset_parameters
    d = MultiscaleDiscriminator(4, ndf=4, n_layers=3, num_D=3)
    reset_parameters(d, make_initializer("xavier", 0.5), torch.Generator().manual_seed(0))
    x = torch.randn(1, 128, 128, 4, generator=torch.Generator().manual_seed(1))
    x[:, :40] = 0.0
    grads = []
    for dev in ("cpu", cuda):
        xi = x.to(dev).requires_grad_()
        out = d.to(dev)(xi, update_stats=False)
        (g,) = torch.autograd.grad(sum(o[-1].mean() for o in out), xi)
        grads.append(g.cpu())
    assert (grads[0] - grads[1]).abs().max() <= 1e-5 * grads[0].abs().max()


def test_d3_on_cuda_matches_cpu(cuda):
    """D3 on the card with TF32 off (the ``cuda`` fixture): CLIP ViT-B/32 of a
    512² image (the resize to 224² included), the four logit levels and
    d3_g_loss's gradient in the image, CUDA vs CPU: logits within 1e-4 of
    their max + 1e-5, the gradient within 1e-4 of its max."""
    from vts_torch.losses import vision_aided as tv
    from vts_torch.networks.clip_vit import CLIPViT, init_clip_params
    clip, heads = CLIPViT(init_clip_params(0)), tv.D3Heads(tv.init_d3_head_params(0))
    x = torch.rand(1, 512, 512, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    got = []
    for dev in ("cpu", cuda):
        xi = x.to(dev).requires_grad_()
        logits = tv.d3_logits(clip.to(dev), heads.to(dev), xi)
        loss = sum(torch.mean(tv.softplus(-lg)) for lg in logits)
        (g,) = torch.autograd.grad(loss, xi)
        got.append(([lg.detach().cpu() for lg in logits], g.cpu()))
    (want_l, want_g), (l_cuda, g_cuda) = got
    for a, b in zip(l_cuda, want_l):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-5
    assert (g_cuda - want_g).abs().max() <= 1e-4 * want_g.abs().max()


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        k1.conv3x3_bias_relu(x, torch.randn(3, 3, 4, 4, device=cuda, dtype=torch.float64),
                             torch.randn(4, device=cuda))
    with pytest.raises(ValueError):
        k2.gather_patches(torch.randn(8, 8, 2, device=cuda), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        k1.conv3x3_dx(torch.randn(1, 8, 8, 4, device=cuda, dtype=torch.float16),
                      torch.randn(1, 8, 8, 4, device=cuda, dtype=torch.float16),
                      torch.randn(3, 3, 4, 4, device=cuda, dtype=torch.float16))
    ox = torch.zeros(1, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k2.gather_patches_group((torch.randn(1, 8, 8, 2, device=cuda), torch.randn(1, 8, 8, 2)),
                                offset_x=ox, offset_y=ox, cutout=4)
    with pytest.raises(TypeError):
        k2.gather_patches_group((torch.randn(1, 8, 8, 2, device=cuda),
                                 torch.zeros(1, 8, 8, 2, device=cuda, dtype=torch.uint8)),
                                offset_x=ox, offset_y=ox, cutout=4)
    with pytest.raises(TypeError):
        k2.scatter_patches(torch.randn(2, 4, 4, 2, device=cuda, dtype=torch.float64),
                           torch.zeros(2, dtype=torch.int32, device=cuda),
                           torch.zeros(2, dtype=torch.int32, device=cuda), (1, 8, 8, 2))
