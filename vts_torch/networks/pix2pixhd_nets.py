"""The pix2pixHD generators (``vts_tpu/networks/pix2pixhd_nets.py``), NHWC in
and out.

  ``_GlobalCore``:     reflect pad 3, 7×7 conv ngf, norm, ReLU; n_downsampling
                       stride-2 3×3 convs (zero pad 1) doubling the channels,
                       each with norm and ReLU; ``n_blocks`` residual blocks;
                       n_downsampling stride-2 3×3 transposed convs halving
                       them, each with norm and ReLU (no head);
  ``GlobalGenerator``: the core (``core``), reflect pad 3, a 7×7 conv to
                       ``out_nc`` and tanh;
  ``LocalEnhancer``:   the input average-pooled ``n_local_enhancers`` times
                       (3×3, stride 2, pad 1, the pad left out of the count);
                       a core at ngf·2^L on the coarsest (``global``); then per
                       level, finest last: reflect pad 3, 7×7 conv, norm,
                       ReLU, stride-2 3×3 conv to twice the channels, norm,
                       ReLU, plus the coarser level's output,
                       ``n_blocks_local`` residual blocks, a stride-2
                       transposed conv back, norm, ReLU; then the 7×7 tanh
                       head;
  ``Encoder``:         a core without blocks and the 7×7 tanh head, with
                       :func:`instance_average` for the per-instance mean.

Every conv has a bias, whatever the norm, as in the reference.  The
transposed conv is :class:`~vts_torch.networks.resnet_gen.ConvT3x3` (torch
padding 1, output padding 1: the reference's flax padding (1, 2) on the
stride-dilated input).  Submodules carry the reference's flax names:
``Conv_i``, ``ConvTranspose_i`` and ``ResnetBlock_b`` counted in call order
in each scope, one counter per kind (so the levels of a ``LocalEnhancer``
share them), ``BatchNorm_i`` under ``--normG batch`` (an instance norm holds
nothing), and the scopes ``core`` and ``global``; a state-dict key is the
flax tree path (:mod:`vts_torch.utils.convert_jax`).  The convs run in the
net's ``dtype`` (params fp32) unless ``forward`` is given another.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import Conv, avg_pool_3x3_s2_nopad_count
from .resnet_gen import ConvT3x3, ResnetBlock, ResnetGenerator, _Named, _pad


class _GlobalCore(_Named):
    def __init__(self, in_nc: int, ngf: int, n_downsampling: int, n_blocks: int,
                 norm_type: str):
        super().__init__(norm_type)
        self.stem = (self._add("Conv", Conv(in_nc, ngf, 7)), self._norm(ngf))
        self.downs, self.ups = [], []
        c = ngf
        for _ in range(n_downsampling):
            self.downs.append((self._add("Conv", Conv(c, 2 * c, 3, stride=2, padding=1)),
                               self._norm(2 * c)))
            c *= 2
        self.blocks = [self._add("ResnetBlock", ResnetBlock(c, norm_type, use_bias=True))
                       for _ in range(n_blocks)]
        for _ in range(n_downsampling):
            self.ups.append((self._add("ConvTranspose", ConvT3x3(c, c // 2)),
                             self._norm(c // 2)))
            c //= 2

    def forward(self, x, dtype: torch.dtype = torch.float32):
        h = self._conv_norm_relu(*self.stem, _pad(x, 3, "reflect"), dtype)
        for conv, norm in self.downs:
            h = self._conv_norm_relu(conv, norm, h, dtype)
        for name in self.blocks:
            h = getattr(self, name)(h, dtype)
        for conv, norm in self.ups:
            h = self._conv_norm_relu(conv, norm, h, dtype)
        return h


class _Generator(_Named):
    """The init and compute-dtype settings of a generator; its seeded
    ``reset_parameters`` is the ResNet generator's."""

    def __init__(self, norm_type: str, init_type: str, init_gain: float, dtype: torch.dtype):
        super().__init__(norm_type)
        self.init_type, self.init_gain, self.dtype = init_type, init_gain, dtype

    reset_parameters = ResnetGenerator.reset_parameters

    def _head(self, h, dtype):
        return torch.tanh(getattr(self, self.head)(_pad(h, 3, "reflect"), dtype))


class GlobalGenerator(_Generator):
    def __init__(self, in_nc: int, ngf: int = 64, out_nc: int = 3, n_downsampling: int = 3,
                 n_blocks: int = 9, norm_type: str = "instance", init_type: str = "xavier",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32):
        super().__init__(norm_type, init_type, init_gain, dtype)
        self.core = _GlobalCore(in_nc, ngf, n_downsampling, n_blocks, norm_type)
        self.head = self._add("Conv", Conv(ngf, out_nc, 7))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = None,
                deterministic: bool = True) -> torch.Tensor:
        """x (N, H, W, in_nc) → (N, H, W, out_nc) in [-1, 1]; H and W
        multiples of 2^n_downsampling."""
        dt = dtype or self.dtype
        return self._head(self.core(x, dt), dt)


class LocalEnhancer(_Generator):
    def __init__(self, in_nc: int, ngf: int = 32, out_nc: int = 3, n_downsample_global: int = 3,
                 n_blocks_global: int = 9, n_local_enhancers: int = 1, n_blocks_local: int = 3,
                 norm_type: str = "instance", init_type: str = "xavier",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32):
        super().__init__(norm_type, init_type, init_gain, dtype)
        self.n_local = n_local_enhancers
        self.add_module("global", _GlobalCore(in_nc, ngf * 2 ** n_local_enhancers,
                                              n_downsample_global, n_blocks_global, norm_type))
        self.levels = []
        for n in range(1, n_local_enhancers + 1):
            g = ngf * 2 ** (n_local_enhancers - n)
            stem = (self._add("Conv", Conv(in_nc, g, 7)), self._norm(g))
            down = (self._add("Conv", Conv(g, 2 * g, 3, stride=2, padding=1)), self._norm(2 * g))
            blocks = [self._add("ResnetBlock", ResnetBlock(2 * g, norm_type, use_bias=True))
                      for _ in range(n_blocks_local)]
            up = (self._add("ConvTranspose", ConvT3x3(2 * g, g)), self._norm(g))
            self.levels.append((stem, down, blocks, up))
        self.head = self._add("Conv", Conv(ngf, out_nc, 7))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = None,
                deterministic: bool = True) -> torch.Tensor:
        dt = dtype or self.dtype
        pyramid = [x]
        for _ in range(self.n_local):
            pyramid.append(avg_pool_3x3_s2_nopad_count(pyramid[-1]))
        out = getattr(self, "global")(pyramid[-1], dt)
        for n, (stem, down, blocks, up) in enumerate(self.levels, 1):
            h = self._conv_norm_relu(*stem, _pad(pyramid[self.n_local - n], 3, "reflect"), dt)
            h = self._conv_norm_relu(*down, h, dt) + out
            for name in blocks:
                h = getattr(self, name)(h, dt)
            out = self._conv_norm_relu(*up, h, dt)
        return self._head(out, dt)


class Encoder(_GlobalCore):
    """The core without blocks, in the generator's own scope, and the head."""

    def __init__(self, in_nc: int, ngf: int = 32, out_nc: int = 3, n_downsampling: int = 4,
                 norm_type: str = "instance", init_type: str = "xavier",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32):
        super().__init__(in_nc, ngf, n_downsampling, 0, norm_type)
        self.init_type, self.init_gain, self.dtype = init_type, init_gain, dtype
        self.head = self._add("Conv", Conv(ngf, out_nc, 7))

    reset_parameters = ResnetGenerator.reset_parameters
    _head = _Generator._head

    def forward(self, x: torch.Tensor, dtype: torch.dtype = None,
                deterministic: bool = True) -> torch.Tensor:
        dt = dtype or self.dtype
        return self._head(super().forward(x, dt), dt)


def instance_average(features: torch.Tensor, inst: torch.Tensor,
                     num_instances: int) -> torch.Tensor:
    """Each pixel's features replaced by the mean over its instance: an
    integer map ``inst`` (N, H, W[, 1]) with labels in [0, num_instances),
    the segment mean as one-hot products (as the reference computes it)."""
    n, h, w, c = features.shape
    onehot = F.one_hot(inst.reshape(n, h * w).long(), num_instances).to(features.dtype)
    sums = torch.einsum("npk,npc->nkc", onehot, features.reshape(n, h * w, c))
    means = sums / torch.clamp_min(onehot.sum(1)[..., None], 1.0)
    return torch.einsum("npk,nkc->npc", onehot, means).reshape(n, h, w, c)
