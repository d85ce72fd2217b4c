"""The SPADE generator family (``vts_tpu/networks/spade_nets.py``), NHWC in
and out.

  :class:`SpectralConv`:      a conv whose kernel is divided by σ, its
                              largest singular value as one power
                              iteration from the stored ``u`` estimates it;
  :func:`parse_spade_config`: ``spectralspadesyncbatch3x3`` → (spectral,
                              param-free norm, kernel size);
  :class:`SPADENorm`:         the param-free instance or batch norm (a
                              sync batch norm is a batch norm on one
                              device), then the segmap, brought to x's size
                              by nearest resizing, through ``mlp_shared`` →
                              ReLU → ``mlp_gamma`` and ``mlp_beta``:
                              normalized·(1 + γ) + β;
  :class:`SPADEResnetBlock`:  norm_0 → LeakyReLU(0.2) → conv_0 → norm_1 →
                              LeakyReLU → conv_1, plus the input, or when
                              fin ≠ fout plus ``conv_s`` (no bias) on
                              ``norm_s`` of it;
  :class:`SPADEGenerator`:    the ``fc`` stem (a 3×3 conv on the segmap
                              brought down to (sh, sw), sw = W / 2^n_up; or
                              with ``use_vae`` a Dense on ``z``, reshaped
                              to (sh, sw, 16·ngf)), ``head_0``, 2× up,
                              ``G_middle_0``, (2× up when n_up > 5),
                              ``G_middle_1``, 2× up, ``up_0``, then
                              ``up_1``..``up_3`` (n_up > 2, 3, 4) and
                              ``up_4`` (n_up > 6) each after a 2× up,
                              LeakyReLU, ``conv_img`` and tanh; 2× up is a
                              plain nearest repeat;
  :class:`ConvEncoder`, :func:`kld_loss`, :func:`reparameterize`: the VAE
                              option's image encoder and loss.

The spectral norm is written out, not ``torch.nn.utils.spectral_norm``,
which differs in four ways: it differentiates through σ, skips the power
iteration in eval, stores ``v`` and normalizes by ``max(‖·‖, eps)``.  Here,
as in the reference: the kernel as a matrix W (out × in·kh·kw; σ and ``u``
do not depend on how the other axes are flattened, so the torch OIHW
layout gives the flax HWIO one's), v = Wᵀu / (‖Wᵀu‖ + 1e-12), u' = Wv /
(‖Wv‖ + 1e-12), σ = v·(Wᵀu'), the conv with kernel / σ with σ outside the
gradient; ``u'`` is written back only by a training-mode pass given
``update_stats`` (the reference's ``train`` module attribute and its
mutable ``batch_stats``): an eval pass, and a pass with
``update_stats=False``, iterate once from the stored ``u`` and write
nothing.  ``u`` starts as a normal draw / √out from the seeded generator
(the reference's law; JAX's draw itself is not reproduced).

Submodules carry the reference's flax names (``fc``, ``head_0``,
``G_middle_{0,1}``, ``up_{0..4}``, ``conv_{0,1,s}``, ``norm_{0,1,s}``,
``mlp_{shared,gamma,beta}``, ``BatchNorm_0``, ``conv_img``, ``layer{i}``,
``fc_mu``, ``fc_var``), so a state-dict key is the flax tree path: ``u``
and the running ``mean``/``var`` are the flax ``batch_stats``
(:mod:`vts_torch.utils.convert_jax`).  The convs run in the net's ``dtype``
(params fp32); without autograd (the eval forward) the modulation,
activations and additions run in place, so a 1536² forward holds a few
512-channel tensors at a time.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_nearest
from ..ops.resize_mm import resize_mm
from .blocks import BatchNorm, Conv, leaky_relu, make_initializer


def _leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) of a tensor the caller owns: in place when no gradient
    is taken (the same values as :func:`leaky_relu`)."""
    return leaky_relu(x, 0.2) if torch.is_grad_enabled() else F.leaky_relu_(x, 0.2)


class SpectralConv(Conv):
    """k×k conv over NHWC with the spectral norm of the module docstring;
    ``u`` (out,) is a buffer."""

    def __init__(self, in_c: int, out_c: int, k: int, use_bias: bool = True, stride: int = 1,
                 padding: int = 0):
        super().__init__(in_c, out_c, k, use_bias, stride, padding)
        self.register_buffer("u", torch.full((out_c,), 1.0 / math.sqrt(out_c)))

    def reset_parameters(self, init, gen):
        super().reset_parameters(init, gen)
        out_c = self.u.shape[0]
        with torch.no_grad():
            self.u.copy_(torch.randn((out_c,), generator=gen) / math.sqrt(out_c))

    @torch.no_grad()
    def power_iteration(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(u', σ): one power iteration from the stored ``u``, in fp32."""
        w = self.weight.float().reshape(self.weight.shape[0], -1)
        v = torch.mv(w.t(), self.u)
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = torch.mv(w, v)
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        return u, torch.dot(v, torch.mv(w.t(), u))

    def forward(self, x, dtype: torch.dtype = torch.float32, update_stats: bool = True):
        u, sigma = self.power_iteration()
        if self.training and update_stats:
            self.u.copy_(u)
        return self._conv(x, self.weight / sigma, dtype)


def parse_spade_config(config_text: str) -> Tuple[bool, str, int]:
    """``spectralspadesyncbatch3x3`` → (True, "syncbatch", 3), as the
    reference parses it; an unparsable string is a ``ValueError``."""
    spectral = config_text.startswith("spectral")
    rest = config_text[len("spectral"):] if spectral else config_text
    m = re.search(r"spade(\D+)(\d)x\d", rest)
    if not m:
        raise ValueError(f"unparsable SPADE config {config_text!r}")
    return spectral, m.group(1), int(m.group(2))


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """SPADE's param-free instance norm over (H, W): the two-pass variance
    ``jnp.var`` takes, eps 1e-5, in x's dtype."""
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class Dense(nn.Module):
    """A flax ``Dense``: ``weight`` (out, in), the flax kernel transposed."""

    def __init__(self, in_f: int, out_f: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f))

    def reset_parameters(self, init, gen):
        o, i = self.weight.shape
        init(self.weight, i, o, gen, 0)
        nn.init.zeros_(self.bias)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class SPADENorm(nn.Module):
    def __init__(self, norm_nc: int, label_nc: int, param_free: str = "syncbatch", ks: int = 3,
                 nhidden: int = 128):
        super().__init__()
        self.param_free = param_free
        if param_free != "instance":           # batch, syncbatch and any other name
            self.BatchNorm_0 = BatchNorm(norm_nc, affine=False)
        pw = ks // 2
        self.mlp_shared = Conv(label_nc, nhidden, ks, padding=pw)
        self.mlp_gamma = Conv(nhidden, norm_nc, ks, padding=pw)
        self.mlp_beta = Conv(nhidden, norm_nc, ks, padding=pw)

    def forward(self, x, segmap, dtype: torch.dtype = torch.float32):
        if self.param_free == "instance":
            normalized = _instance_norm(x)
        else:
            normalized = self.BatchNorm_0(x)
        seg = resize_nearest(segmap, tuple(x.shape[1:3]))
        actv = self.mlp_shared(seg, dtype)
        actv = torch.relu(actv) if torch.is_grad_enabled() else actv.relu_()
        gamma = self.mlp_gamma(actv, dtype)
        if torch.is_grad_enabled():
            return normalized * (1 + gamma) + self.mlp_beta(actv, dtype)
        normalized.mul_(gamma.add_(1))
        del gamma
        return normalized.add_(self.mlp_beta(actv, dtype))


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, norm_g: str = "spectralspadesyncbatch3x3",
                 semantic_nc: int = 1):
        super().__init__()
        spectral, pf, ks = parse_spade_config(norm_g)
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        conv = SpectralConv if spectral else Conv
        self.conv_0 = conv(fin, fmiddle, 3, padding=1)
        self.conv_1 = conv(fmiddle, fout, 3, padding=1)
        if self.learned_shortcut:
            self.conv_s = conv(fin, fout, 1, use_bias=False)
        self.norm_0 = SPADENorm(fin, semantic_nc, pf, ks)
        self.norm_1 = SPADENorm(fmiddle, semantic_nc, pf, ks)
        if self.learned_shortcut:
            self.norm_s = SPADENorm(fin, semantic_nc, pf, ks)

    def forward(self, x, seg, dtype: torch.dtype = torch.float32):
        x_s = self.conv_s(self.norm_s(x, seg, dtype), dtype) if self.learned_shortcut else x
        dx = self.conv_0(_leaky(self.norm_0(x, seg, dtype)), dtype)
        dx = self.conv_1(_leaky(self.norm_1(dx, seg, dtype)), dtype)
        return x_s + dx if torch.is_grad_enabled() else dx.add_(x_s)


def _up2(h: torch.Tensor) -> torch.Tensor:
    """2× nearest upsampling of NHWC: each pixel repeated 2×2."""
    n, hh, ww, c = h.shape
    return h[:, :, None, :, None, :].expand(n, hh, 2, ww, 2, c).reshape(n, 2 * hh, 2 * ww, c)


class SPADEGenerator(nn.Module):
    def __init__(self, semantic_nc: int = 1, ngf: int = 64, out_nc: int = 5,
                 num_upsampling_layers: int = 3, aspect_ratio: float = 1.0,
                 norm_g: str = "spectralspadesyncbatch3x3", use_vae: bool = False,
                 z_dim: int = 256, crop_size: int = 32, init_type: str = "xavier",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = ngf
        self.n_up, self.aspect_ratio, self.use_vae = num_upsampling_layers, aspect_ratio, use_vae
        self.ngf, self.init_type, self.init_gain, self.dtype = ngf, init_type, init_gain, dtype
        if use_vae:                            # sized for a crop_size-wide input
            sw = crop_size // 2 ** num_upsampling_layers
            self.fc = Dense(z_dim, 16 * nf * sw * round(sw / aspect_ratio))
        else:
            self.fc = Conv(semantic_nc, 16 * nf, 3, padding=1)

        def block(name, fin, fout):
            self.add_module(name, SPADEResnetBlock(fin, fout, norm_g, semantic_nc))

        block("head_0", 16 * nf, 16 * nf)
        block("G_middle_0", 16 * nf, 16 * nf)
        block("G_middle_1", 16 * nf, 16 * nf)
        block("up_0", 16 * nf, 8 * nf)
        final_nc = 8 * nf
        for name, on, fin, fout in (("up_1", 2, 8 * nf, 4 * nf), ("up_2", 3, 4 * nf, 2 * nf),
                                    ("up_3", 4, 2 * nf, nf), ("up_4", 6, nf, nf // 2)):
            if num_upsampling_layers > on:
                block(name, fin, fout)
                final_nc = fout
        self.conv_img = Conv(final_nc, out_nc, 3, padding=1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init (xavier-normal with the reference's gain by default):
        every conv and Dense kernel, zero biases, each ``u`` a normal draw /
        √out, running statistics at 0 and 1."""
        init = make_initializer(self.init_type, self.init_gain)
        for m in self.modules():
            if isinstance(m, (Conv, Dense, BatchNorm)):
                m.reset_parameters(init, generator)

    def forward(self, seg: torch.Tensor, z: Optional[torch.Tensor] = None,
                dtype: torch.dtype = None, deterministic: bool = True) -> torch.Tensor:
        """seg (N, H, W, semantic_nc) → (N, H, W, out_nc) in [-1, 1] for W a
        multiple of 2^num_upsampling_layers; ``z`` (N, z_dim) with
        ``use_vae``."""
        dt = dtype or self.dtype
        n_up = self.n_up
        sw = seg.shape[2] // 2 ** n_up
        sh = round(sw / self.aspect_ratio)
        if self.use_vae:
            if z is None:
                raise ValueError("the VAE SPADE generator needs a z sample")
            x = self.fc(z, dt).reshape(-1, sh, sw, 16 * self.ngf)
        else:
            x = self.fc(resize_nearest(seg, (sh, sw)), dt)
        x = _up2(self.head_0(x, seg, dt))
        x = self.G_middle_0(x, seg, dt)
        if n_up > 5:
            x = _up2(x)
        x = _up2(self.G_middle_1(x, seg, dt))
        x = self.up_0(x, seg, dt)
        for name, on in (("up_1", 2), ("up_2", 3), ("up_3", 4), ("up_4", 6)):
            if n_up > on:
                x = getattr(self, name)(_up2(x), seg, dt)
        x = self.conv_img(_leaky(x), dt)
        return torch.tanh(x) if torch.is_grad_enabled() else x.tanh_()


class ConvEncoder(nn.Module):
    """The VAE's image encoder → (mu, logvar): the image resized to 256²
    (antialiased bilinear) when it is not, six stride-2 3×3 spectral convs
    (``layer0..5``, ndf·(1, 2, 4, 8, 8, 8)) each followed by the two-pass
    instance norm and, after the first, LeakyReLU(0.2); LeakyReLU, the NHWC
    flatten, and the Dense heads ``fc_mu`` and ``fc_var``."""

    def __init__(self, in_nc: int = 3, ndf: int = 64, z_dim: int = 256,
                 init_type: str = "xavier", init_gain: float = 0.02):
        super().__init__()
        self.init_type, self.init_gain = init_type, init_gain
        c = in_nc
        for i, mult in enumerate((1, 2, 4, 8, 8, 8)):
            self.add_module(f"layer{i}", SpectralConv(c, ndf * mult, 3, stride=2, padding=1))
            c = ndf * mult
        self.fc_mu = Dense(c * 4 * 4, z_dim)
        self.fc_var = Dense(c * 4 * 4, z_dim)

    reset_parameters = SPADEGenerator.reset_parameters

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.shape[1] != 256 or x.shape[2] != 256:
            x = resize_mm(x, (256, 256), kernel="linear")
        h = x
        for i in range(6):
            h = _instance_norm(getattr(self, f"layer{i}")(h))
            if i > 0:
                h = leaky_relu(h, 0.2)
        h = leaky_relu(h, 0.2).reshape(h.shape[0], -1)
        return self.fc_mu(h), self.fc_var(h)


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """−½·Σ(1 + logvar − mu² − e^logvar)."""
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mu + e^(logvar/2)·ε, ε a standard normal draw from ``generator``."""
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype).to(mu.device)
    return mu + torch.exp(0.5 * logvar) * eps
