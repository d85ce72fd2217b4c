"""Pix2pix — the paper's baseline (``vts_tpu/models/pix2pix.py``, reference
models/pix2pix_model.py): one ResNet G from the sketch to the 5-channel
(image, touch) output, two ``basic`` PatchGAN Ds — D on (S, I), D2 on (S, T)
— trained with a GAN loss (vanilla by default) and L1·``lambda_L1`` on 32²
patches (the patchskit dataset, batch 32), and tested on the full canvas.

One training step is the reference's ``_train_step``, in its order:
  1. G forward once on S (train-mode batch norm: its running statistics
     update once), fake_I and fake_T masked by M, the graph kept;
  2. D update on 0.5·(fake + real), the fake pass then the real one, so D's
     running statistics chain fake → real;
  3. D2 update the same way, at ``--lr_G2``;
  4. G update against the updated Ds (their batch statistics, the new ones
     discarded): GAN_I + GAN_T + (L1_I + L1_T)·lambda_L1;
  5. Adam (β1 ``--beta1``, β2 ``--beta2``) with the linear lr decay.
The step draws nothing at random.

Everything else — ``test()``, the 8 metrics, the checkpoints, the gallery —
is :class:`~vts_torch.models.sinskit.SinSKITModel`'s, with G's own eval
forward (running statistics) and its own checkpoint layout.  The gallery
has no ``pred_fake_T_full`` panel: the reference's sinskit visuals read
``lambda_G2_GAN``, which pix2pix's parser does not declare (its training
run fails there), and pix2pix's D2 takes no canvas-wide (S, I, M)
conditioning to run on.

``--T_resolution_multiplier`` > 1 is refused: the reference's G keeps the
touch output at the canvas size (``generate_T_imgs`` is no option) while
it multiplies it by the m× mask, which fails in its step and its eval
forward alike.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import resolve_device
from ..losses.gan import gan_loss
from ..networks import define_D, define_G
from ..networks.blocks import make_initializer
from ..networks.discriminators import reset_parameters as reset_d
from .base import Adam, lr_factor
from .sinskit import SinSKITModel


class Pix2PixModel(SinSKITModel):
    """Lifecycle as :class:`SinSKITModel`'s; the networks and the step are
    pix2pix's."""

    pred_fake_T_full_visual = False
    # the reference's baselines never split their step (vts_tpu/models/pix2pix.py:111-125)
    data_parallel = False
    # nor chunk it: a chunk of steps is one optimize_parameters a step
    # (vts_tpu/models/sinskit.py:969-977)
    supports_chunk = False
    masked_stacks = ("",)               # the reference masks T_images, not val_T_images
    d_kind = "basic"                    # the kind of D and D2

    def __init__(self, opt):
        if int(opt.T_resolution_multiplier) != 1:
            raise ValueError(f"--T_resolution_multiplier > 1 with --model {opt.model}: G's "
                             f"touch output stays at the canvas size while the touch mask is "
                             f"resized (the reference's step fails on it too)")
        self.opt = opt
        self.isTrain = bool(opt.isTrain)
        self.device = resolve_device(opt.device)
        self.dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
        self.mult = 1
        self.lr_override = 1.0
        self.netG = define_G(opt, opt.sketch_nc, opt.image_nc + opt.touch_nc, dtype=self.dtype)
        self.model_names = ["G"]
        if self.isTrain:
            self.netD = define_D(opt, opt.sketch_nc + opt.image_nc, netD=self.d_kind,
                                 num_D=opt.num_D_D1, dtype=self.dtype)
            self.netD2 = define_D(opt, opt.sketch_nc + opt.touch_nc, netD=self.d_kind,
                                  num_D=opt.num_D_D2, dtype=self.dtype)
            self.model_names += ["D", "D2"]
        self.use_d3 = False
        self.clip = None
        self._init_metrics_and_state()

    def setup(self, example_batch=None) -> None:
        """Seeded init (``--seed``) of G, and of D and D2 in training, then onto
        the device with Adam moments for each network."""
        seed = int(self.opt.seed)
        self.netG.reset_parameters(torch.Generator().manual_seed(seed))
        self.netG.to(self.device)
        print(f"[{self.opt.model.lower()}] netG params: "
              f"{sum(p.numel() for p in self.netG.parameters()) / 1e6:.3f} M")
        if not self.isTrain:
            self.netG.eval()
            return
        init = make_initializer(self.opt.init_type, self.opt.init_gain)
        for i, net in enumerate((self.netD, self.netD2)):
            reset_d(net, init, torch.Generator().manual_seed(seed + 1 + i))
            net.to(self.device).train()
        self.netG.train()
        for name, net in self.nets().items():
            self.adam[name] = Adam(net.named_parameters(), self.opt.beta1, self.opt.beta2)

    # ------------------------------------------------------------------
    def optimize_parameters(self, epoch: int = 1, draws: Optional[Dict] = None) -> None:
        """One training step at the lr of ``epoch`` (``draws`` is accepted for
        the drivers' sake: the step draws nothing)."""
        f = lr_factor(self.opt.lr_policy, epoch - 1, self.opt) * self.lr_override
        self._losses, self._outputs = self._train_step(self._input, self.opt.lr * f,
                                                       self.opt.lr_G2 * f)

    def _split(self, out: torch.Tensor, M: torch.Tensor):
        out = out.float()
        nc = self.opt.image_nc
        return out[..., :nc] * M, out[..., nc:] * M

    def _train_step(self, batch: Dict[str, torch.Tensor], lr: float, lr_d2: float):
        opt = self.opt
        mode = opt.gan_mode
        S, I = batch["S"], batch["I"]
        M = batch.get("M", torch.ones_like(S))
        real_T = batch["T_images"]                    # (N, 32, 32, 2), pre-masked

        # ---- 1. G forward, graph kept ----
        fake_I, fake_T = self._split(self.netG(S), M)
        fake_I_d, fake_T_d = fake_I.detach(), fake_T.detach()

        # ---- 2, 3. D and D2 updates, running stats fake → real ----
        losses: Dict[str, torch.Tensor] = {}
        for name, fake, real, rate in (("D", fake_I_d, I, lr), ("D2", fake_T_d, real_T, lr_d2)):
            net = getattr(self, f"net{name}")
            l_fake = torch.mean(gan_loss(net(torch.cat([S, fake], -1)), False, mode))
            l_real = torch.mean(gan_loss(net(torch.cat([S, real], -1)), True, mode))
            self._update(name, (l_fake + l_real) * 0.5, rate)
            losses[f"{name}_fake"], losses[f"{name}_real"] = l_fake.detach(), l_real.detach()

        # ---- 4. G update against the updated Ds ----
        p_I = self.netD(torch.cat([S, fake_I], -1), update_stats=False)
        p_T = self.netD2(torch.cat([S, fake_T], -1), update_stats=False)
        l1 = torch.mean(torch.abs(fake_I - I)) + torch.mean(torch.abs(fake_T - real_T))
        aux = {"G_GAN_I": torch.mean(gan_loss(p_I, True, mode)),
               "G_GAN_T": torch.mean(gan_loss(p_T, True, mode)), "G_L1": l1 * opt.lambda_L1}
        total = aux["G_GAN_I"] + aux["G_GAN_T"] + aux["G_L1"]
        self._update("G", total, lr)
        losses.update({k: v.detach() for k, v in aux.items()})
        losses["G_total"] = total.detach()
        return losses, {"fake_I": fake_I_d, "fake_T": fake_T_d}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward_eval(self, S: torch.Tensor, M: torch.Tensor, style_code=None):
        """The fp32 eval forward on G's running statistics."""
        was_training = self.netG.training
        self.netG.eval()
        try:
            return self._split(self.netG(S, dtype=torch.float32), M)
        finally:
            self.netG.train(was_training)
