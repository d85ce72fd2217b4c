"""Pix2pixHD — the paper's second baseline (``vts_tpu/models/pix2pixhd.py``,
reference models/pix2pixHD_model.py): the ``global`` generator (or
``local``, ``encoder``) from the sketch to the 5-channel (image, touch)
output, two ``multiscale`` Ds with intermediate features — D on (S, I), D2
on (S, T), 2 scales each — trained with lsgan, GAN-feat·``lambda_feat`` and
VGG19·``lambda_vgg`` on 32² patches (the patchskit dataset, batch 32), and
tested on the full canvas.

One training step is the reference's ``_train_step``, in its order:
  1. G forward once on S, fake_I and fake_T masked by M, the graph kept;
  2. D update on 0.5·(fake + real), the fake pass on cat(S, fake_I) taken
     through the image pool when ``--pool_size`` > 0 (:func:`pool_query`,
     its draws from :meth:`draw`); the real pass's features are kept;
  3. D2 update the same way on (S, T), at ``--lr_G2``, never through the pool;
  4. G update against the updated Ds: G_GAN, the I term plus the T term;
     G_GAN_Feat·λ_feat, which is the reference's 0·G_GAN (it compares the
     fake features with themselves) unless ``--correct_gan_feat true``,
     which matches the updated Ds' fake features against the real-side
     features of step 2 and 3 (the Ds before their Adam step); G_VGG·λ_vgg,
     the VGG19 loss of fake_I against I plus that of gx and gy each tiled
     to 3 channels, the three in one VGG pass.  G_GAN_Feat drops out under
     ``--no_ganFeat_loss`` or ``--getIntermFeat_D false``, G_VGG under
     ``--no_vgg_loss``;
  5. Adam with the linear lr decay; while a G leaf is frozen (below) its
     gradient is zero, and Adam steps it all the same.

The two-stage schedule: :meth:`update_fixed_params`, which the training
driver calls after each epoch, freezes every G leaf under a ``global`` or
``core`` scope while the epoch is below ``--niter_fix_global`` (under
``--netG global`` that is everything but the head, as in the reference)
and lifts that with the reference's printed line.  The pool lives on the
device across steps and is not saved.  Everything else — ``test()``, the
metrics, the checkpoints, the gallery without ``pred_fake_T_full`` — is
:class:`~vts_torch.models.pix2pix.Pix2PixModel`'s.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..losses.gan import feature_matching_loss, gan_loss
from ..losses.vgg import VGG19, init_vgg19_params, load_vgg19_weights, vgg_loss
from ..utils.image_pool import pool_query
from .base import lr_factor
from .pix2pix import Pix2PixModel
from .sinskit import _detached


def _tile3(t: torch.Tensor, c: int) -> torch.Tensor:
    return t[..., c:c + 1].repeat(1, 1, 1, 3)


class Pix2PixHDModel(Pix2PixModel):
    d_kind = "multiscale"
    supports_image_pool = True          # D's fake pass queries the pool (--pool_size > 0)
    always_matches_real = False         # G_GAN_Feat against the real side only when asked

    def __init__(self, opt):
        super().__init__(opt)
        self.generator = torch.Generator().manual_seed(int(opt.seed))
        self.pool_size = int(getattr(opt, "pool_size", 0)) if self.isTrain else 0
        self._pool = None                      # (buffer on the device, count)
        self.frozen = ()                       # G's frozen leaves, by state-dict name
        self.vgg = None
        if self.isTrain and not opt.no_vgg_loss:
            vw = opt.vgg_weights
            self.vgg = VGG19(load_vgg19_weights(vw) if vw else init_vgg19_params(0)).to(
                self.device)

    def draw(self, n: int, size=None) -> Dict:
        """The step's random numbers for a batch of n, from the model's
        generator: with a pool, ``{"pool_u": (n,) uniforms, "pool_rid": (n,)
        slots in [0, pool_size)}``, else nothing."""
        if not self.pool_size:
            return {}
        return {"pool_u": torch.rand((n,), generator=self.generator),
                "pool_rid": torch.randint(0, self.pool_size, (n,), generator=self.generator)}

    def optimize_parameters(self, epoch: int = 1, draws: Optional[Dict] = None) -> None:
        f = lr_factor(self.opt.lr_policy, epoch - 1, self.opt) * self.lr_override
        if draws is None:
            draws = self.draw(self._input["S"].shape[0])
        self._losses, self._outputs = self._train_step(self._input, self.opt.lr * f,
                                                       self.opt.lr_G2 * f, draws)

    def _rates(self, lr: float, lr_d2: float):
        """The step's learning rates of G, D and D2."""
        return lr, lr, lr_d2

    def vgg_term(self, fake_I, fake_T, I, real_T) -> torch.Tensor:
        """VGG(fake_I, I) + VGG(gx³) + VGG(gy³), the three in one pass."""
        x = torch.cat([fake_I, _tile3(fake_T, 0), _tile3(fake_T, 1)])
        y = torch.cat([I, _tile3(real_T, 0), _tile3(real_T, 1)])
        return vgg_loss(self.vgg, x, y, groups=3)

    def _train_step(self, batch: Dict[str, torch.Tensor], lr: float, lr_d2: float,
                    draws: Dict):
        opt = self.opt
        mode = opt.gan_mode
        S, I = batch["S"], batch["I"]
        M = batch.get("M", torch.ones_like(S))
        real_T = batch["T_images"]                    # (N, 32, 32, 2), pre-masked

        lr_g, lr_d, lr_d2 = self._rates(lr, lr_d2)

        # ---- 1. G forward, graph kept ----
        fake_I, fake_T = self._split(self.netG(S), M)
        fake_I_d, fake_T_d = fake_I.detach(), fake_T.detach()

        # ---- 2, 3. D (fake pass through the pool) and D2 updates ----
        fake_SI = torch.cat([S, fake_I_d], -1)
        if self.pool_size:
            if self._pool is None:
                self._pool = (torch.zeros((self.pool_size,) + tuple(fake_SI.shape[1:]),
                                          device=fake_SI.device), 0)
            buf, n, fake_SI = pool_query(*self._pool, fake_SI, draws["pool_u"],
                                         draws["pool_rid"])
            self._pool = (buf, n)
        losses: Dict[str, torch.Tensor] = {}
        pred_real = {}
        for name, fake, real, rate in (("D", fake_SI, I, lr_d),
                                       ("D2", torch.cat([S, fake_T_d], -1), real_T, lr_d2)):
            net = getattr(self, f"net{name}")
            l_fake = torch.mean(gan_loss(net(fake), False, mode))
            p_real = net(torch.cat([S, real], -1))
            l_real = torch.mean(gan_loss(p_real, True, mode))
            self._update(name, (l_fake + l_real) * 0.5, rate)
            losses[f"{name}_fake"], losses[f"{name}_real"] = l_fake.detach(), l_real.detach()
            pred_real[name] = _detached(p_real)

        # ---- 4. G update against the updated Ds ----
        p_I = self.netD(torch.cat([S, fake_I], -1), update_stats=False)
        p_T = self.netD2(torch.cat([S, fake_T], -1), update_stats=False)
        aux = {"G_GAN": torch.mean(gan_loss(p_I, True, mode))
               + torch.mean(gan_loss(p_T, True, mode))}
        total = aux["G_GAN"]
        if not opt.no_ganFeat_loss and opt.getIntermFeat_D:
            if self.always_matches_real or opt.correct_gan_feat:
                fm = feature_matching_loss(p_I, pred_real["D"], opt.n_layers_D, opt.num_D_D1) \
                    + feature_matching_loss(p_T, pred_real["D2"], opt.n_layers_D, opt.num_D_D2)
            else:                              # the reference's term: identically 0
                fm = 0.0 * aux["G_GAN"]
            aux["G_GAN_Feat"] = fm * opt.lambda_feat
            total = total + aux["G_GAN_Feat"]
        if self.vgg is not None:
            aux["G_VGG"] = self.vgg_term(fake_I, fake_T, I, real_T) * opt.lambda_vgg
            total = total + aux["G_VGG"]
        self._update("G", total, lr_g, self.frozen)
        losses.update({k: v.detach() for k, v in aux.items()})
        losses["G_total"] = total.detach()
        return losses, {"fake_I": fake_I_d, "fake_T": fake_T_d}

    # ------------------------------------------------------------------
    def update_fixed_params(self, epoch: int) -> None:
        """While ``epoch`` < ``--niter_fix_global`` only the leaves outside the
        global generator train (the others get zero gradients); from there on
        every leaf (reference pix2pixHD_model.py:942-963)."""
        nf = int(getattr(self.opt, "niter_fix_global", 0))
        if nf <= 0 or not self.isTrain:
            return
        if epoch < nf and not self.frozen:
            self.frozen = frozenset(
                k for k, _ in self.netG.named_parameters()
                if any("global" in part or "core" in part for part in k.split(".")))
        elif epoch >= nf and self.frozen:
            print("------------ Now also finetuning global generator -----------")
            self.frozen = ()
