"""SinSKIT — the flagship sketch→(image, touch) model
(``vts_tpu/models/sinskit.py``): ``setup`` (seeded init of G, and of D and
D2 in training), ``set_input``, ``optimize_parameters`` (one training step),
``test`` (the fp32 eval forward), ``compute_metrics`` (batched 8-metric
evaluation), ``get_current_losses``, ``get_current_visuals`` (the gallery's
arrays), ``update_learning_rate``, ``save_networks`` / ``load_networks``.

One training step is the reference's ``_train_step``, in its order:
  1. G forward once, its graph kept;
  2. D1 update on (S, fake_I) and (S, I), batch-norm stats threaded fake → real;
  3. the patch stacks, and the "more fake T" stack sampled ∝ the dilated mask;
  4. D2 update, stats threaded fake → more → real;
  5. from ``--vision_aided_warmup_epoch`` on, the vision-aided D3's logits
     of the real image (frozen CLIP ViT-B/32 and heads, no gradient);
  6. G update against the updated D1 and D2 (batch statistics, new ones
     discarded): G1 = GAN + L1·100 + LPIPS (+ D3's softplus loss on one CLIP
     pass of fake_I once D3 is active), G2 = per-patch L1·10 + LPIPS·10,
     the gradient through the G forward of step 1.  ``D3_loss`` is logged
     only: the reference never steps the D3 heads.
The reference's quirks are kept: the G2 GAN terms see detached tactile
patches (logged, no G gradient, unless ``--g2_gan_backprop``), DiffAugment
feeds only D2's visual conditioning, and D2's conditioning is detached.

Every random draw of a step — DiffAugment's brightness and saturation for
real and fake, the uniforms that place the "more fake T" windows, and the
``--lpips_crop`` window — comes from a ``torch.Generator`` seeded by
``--seed``, or is injected with ``optimize_parameters(draws=...)`` (see
:meth:`SinSKITModel.draw`).

``--lpips_crop`` c > 0 computes the canvas LPIPS on one c² window of fake_I
and I a step (shared by the batch), when c is below the canvas side, as the
reference does; its backward puts the window's cotangent into a zero canvas.

``--dtype bfloat16`` follows the reference's casts one for one: G, D1 and D2
convolve in bf16 with fp32 params; G's output, the masks it is multiplied
by, the canvas copies of S and I, DiffAugment and every patch gathered from
them stay bf16; a concatenation takes the wider type; G_L1 takes its mean in
fp32, G2's L1 widens the fake patches, the GAN losses widen the logits, and
LPIPS runs its backbone in bf16 with fp32 head sums.  The eval forward
(:meth:`test`) is fp32.

The LPIPS and Inception towers are ``--lpips_weights`` and
``--inception_weights`` when given, else the reference's seeded ones.

The settings not ported yet (WGAN-GP, style codes, ``T_resolution_multiplier
> 1``, the legacy per-metric evaluation, ...) are refused by the options
(:mod:`vts_torch.config.options`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.coords import patch_offsets
from ..device import resolve_device
from ..losses.gan import feature_matching_loss, gan_loss
from ..losses.gan_masked import masked_mean, masked_patch_sum, per_sample_gan_loss
from ..losses.lpips import LPIPS, init_lpips_params, load_lpips_weights
from ..losses.vision_aided import D3Heads, d3_logits, init_d3_head_params, softplus
from ..metrics.evaluate import DEFAULT_EVAL_METRICS
from ..metrics.evaluate_batch import compute_evaluation_metrics_batched
from ..metrics.inception import InceptionBlock0, init_inception_params, load_inception_weights
from ..networks import define_D, define_G
from ..networks.blocks import make_initializer
from ..networks.clip_vit import CLIPViT, init_clip_params, load_clip_weights
from ..networks.discriminators import reset_parameters as reset_d
from ..networks.positional import positional_encoding
from ..ops import diffaug
from ..ops.normal import compute_normal
from ..ops.patch import gather_patches_from_coords, gather_patches_group, sample_offsets_in_mask
from ..utils.collage import bbox_overlay, patch_collage
from ..utils.convert_jax import (adam_state_to_flax, adam_state_to_torch, d_params_to_torch,
                                 d_stats_to_torch, torch_to_d_params, torch_to_unet_params,
                                 unet_params_to_torch)
from .base import Adam, load_net, load_opt_state, lr_factor, save_net

_PATCH_STACKS = ("T_images", "I_masks", "T_valid",
                 "val_T_images", "val_I_masks", "val_T_valid")


class SinSKITModel:
    """Lifecycle as in the reference: setup → set_input → optimize_parameters
    / test → get_current_losses / compute_metrics → save/load_networks."""

    def __init__(self, opt):
        lpc = int(opt.lpips_crop)
        if lpc < 0 or (lpc and (lpc % 16 or lpc < 64)):
            raise ValueError(f"--lpips_crop must be 0 (full canvas) or a multiple of 16 "
                             f">= 64, got {lpc}")
        if lpc and opt.step_mode == "split":
            raise ValueError("--lpips_crop is implemented for the fused step only; "
                             "--step_mode split would silently ignore it")
        self.opt = opt
        self.isTrain = bool(opt.isTrain)
        self.device = resolve_device(opt.device)
        self.dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
        self.mult = 1
        pe_nc = 2 * opt.positional_encoding_dim if opt.use_positional_encoding else 0
        self.input_nc = opt.sketch_nc + pe_nc
        self.netG = define_G(opt, self.input_nc, opt.image_nc + opt.touch_nc, dtype=self.dtype)
        self.model_names = ["G"]
        if self.isTrain:
            d1_in = opt.image_nc + (opt.sketch_nc if opt.use_cGAN else 0)
            self.netD = define_D(opt, d1_in, netD=opt.netD, num_D=opt.num_D_D1, dtype=self.dtype)
            d2_in = opt.touch_nc
            if opt.use_cGAN_G2:
                d2_in += (opt.sketch_nc if opt.use_cGAN_G2_S else 0) \
                    + (opt.image_nc + 1 if opt.use_cGAN_G2_I else 0)
            self.netD2 = define_D(opt, d2_in, netD=opt.netD2, n_layers=opt.n_layers_D2,
                                  num_D=opt.num_D_D2, dtype=self.dtype)
            if opt.lambda_G1_GAN > 0:
                self.model_names.append("D")
            if opt.lambda_G2_GAN > 0:
                self.model_names.append("D2")
            self.use_d3 = bool(opt.use_vision_aided_loss)
            self.clip: Optional[CLIPViT] = None
            self.d3_heads: Optional[D3Heads] = None
            self.generator = torch.Generator().manual_seed(int(opt.seed))
        lw, iw = opt.lpips_weights, opt.inception_weights
        self.lpips_net = LPIPS(load_lpips_weights(lw) if lw else init_lpips_params(0)).to(
            self.device)
        self.inception = InceptionBlock0(
            load_inception_weights(iw) if iw else init_inception_params(0)).to(self.device)
        self.eval_metrics = list(DEFAULT_EVAL_METRICS)
        self.adam: Dict[str, Adam] = {}
        self._input: Dict[str, torch.Tensor] = {}
        self._outputs: Dict[str, torch.Tensor] = {}
        self._losses: Dict[str, torch.Tensor] = {}
        self._pe_cache: Dict = {}
        self.metrics: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def nets(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self, f"net{name}") for name in self.model_names}

    def setup(self, example_batch=None) -> None:
        """Seeded init (``--seed``) of G, and of D and D2 in training, then onto
        the device with Adam moments for each network that trains; with
        ``--use_vision_aided_loss``, D3's frozen CLIP tower (``--clip_weights``
        or the seeded one) and heads."""
        seed = int(self.opt.seed)
        self.netG.reset_parameters(torch.Generator().manual_seed(seed))
        self.netG.to(self.device)
        n_params = sum(p.numel() for p in self.netG.parameters())
        print(f"[sinskit] netG params: {n_params / 1e6:.3f} M")
        if not self.isTrain:
            self.netG.eval()
            return
        init = make_initializer(self.opt.init_type, self.opt.init_gain)
        for i, net in enumerate((self.netD, self.netD2)):
            reset_d(net, init, torch.Generator().manual_seed(seed + 1 + i))
            net.to(self.device).train()
        self.netG.train()
        print(f"[sinskit] netD params: "
              f"{sum(p.numel() for p in self.netD.parameters()) / 1e6:.3f} M, netD2: "
              f"{sum(p.numel() for p in self.netD2.parameters()) / 1e6:.3f} M")
        for name, net in self.nets().items():
            self.adam[name] = Adam(net.named_parameters(), self.opt.beta1, self.opt.beta2)
        if self.use_d3:
            # frozen, on the device once (the tower is ~350 MB in fp32); not
            # among the networks that are saved or stepped
            cw = self.opt.clip_weights
            self.clip = CLIPViT(load_clip_weights(cw) if cw else init_clip_params(0)).to(
                self.device)
            self.d3_heads = D3Heads(init_d3_head_params(0)).to(self.device)
            print(f"[sinskit] D3: CLIP ViT-B/32 ({cw or 'seeded tower'}) from epoch "
                  f"{self.opt.vision_aided_warmup_epoch}")

    def _pe(self, n: int, h: int, w: int):
        """The positional encoding, built on the host once per (n, h, w) and
        kept on the device (a 1536² one is 75 MB: rebuilding and copying it
        every step idled the card ~10 ms per step)."""
        opt = self.opt
        if not opt.use_positional_encoding:
            return None
        if (n, h, w) not in self._pe_cache:
            self._pe_cache[(n, h, w)] = positional_encoding(
                h, w, mode=opt.positional_encoding_mode, dim=opt.positional_encoding_dim,
                batch=n, device=self.device)
        return self._pe_cache[(n, h, w)]

    # ------------------------------------------------------------------
    def set_input(self, batch: Dict[str, np.ndarray], phase: str = "train") -> None:
        """Batch of numpy arrays → device tensors; S and I are masked by M, the
        patch stacks fold (N, K, …) → (N·K, …) (coords keep (N, K, 8)) and the
        tactile patches are masked by their object masks."""
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in batch.items()
               if k not in ("name", "sample_idx") and isinstance(v, np.ndarray)
               and v.dtype.kind in "fiub"}
        if "M" in dev:
            dev["S"] = dev["S"] * dev["M"]
            if "I" in dev:
                dev["I"] = dev["I"] * dev["M"]
        for key in _PATCH_STACKS:
            if key in dev and dev[key].dim() >= 2:
                dev[key] = dev[key].reshape((-1,) + tuple(dev[key].shape[2:]))
        for pre in ("", "val_"):
            if f"{pre}T_images" in dev:
                dev[f"{pre}T_images"] = dev[f"{pre}T_images"] * dev[f"{pre}I_masks"]
        self._input = dev
        self.data_phase = phase

    # ------------------------------------------------------------------
    def _crop_active(self, h: int, w: int) -> bool:
        return 0 < int(self.opt.lpips_crop) < max(h, w)

    def draw(self, n: int, size=None) -> Dict:
        """The random numbers of one step for a batch of n (canvas ``size`` =
        (h, w)), from the model's generator: ``{"aug_real": {letter: (n,)},
        "aug_fake": {letter: (n,)}, "more": (n, 2, add_fake_T_sample_size)}``
        — uniforms in [0, 1) — and, when ``--lpips_crop`` crops that canvas,
        ``"lpips_crop": (oy, ox)``, integers in [0, h − c] and [0, w − c].
        The same structure, filled from elsewhere, is what
        :meth:`optimize_parameters` takes as ``draws``."""
        opt = self.opt
        policy = opt.diffaugment if opt.use_diffaug else ""
        out = {"aug_real": diffaug.draw(policy, n, self.generator),
               "aug_fake": diffaug.draw(policy, n, self.generator),
               "more": torch.rand((n, 2, opt.add_fake_T_sample_size), generator=self.generator)}
        if size is not None and self._crop_active(*size):
            c = int(opt.lpips_crop)
            out["lpips_crop"] = tuple(
                int(torch.randint(0, max(side - c, 0) + 1, (), generator=self.generator))
                for side in size)
        return out

    def optimize_parameters(self, epoch: int = 1, draws: Optional[Dict] = None) -> None:
        """One training step at the lr of ``epoch``, with D3 from
        ``--vision_aided_warmup_epoch`` on."""
        opt = self.opt
        f = lr_factor(opt.lr_policy, epoch - 1, opt)
        if draws is None:
            draws = self.draw(self._input["S"].shape[0], tuple(self._input["S"].shape[1:3]))
        use_d3 = self.use_d3 and epoch >= opt.vision_aided_warmup_epoch
        self._losses, self._outputs = self._train_step(self._input, opt.lr * f,
                                                       opt.lr_G2 * f, draws, use_d3)

    def _update(self, name: str, loss: torch.Tensor, lr: float) -> None:
        """Gradient of ``loss`` w.r.t. network ``name``'s parameters, then Adam."""
        params = dict(getattr(self, f"net{name}").named_parameters())
        if not (torch.is_tensor(loss) and loss.requires_grad):   # every term detached
            grads = [None] * len(params)
        else:
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        self.adam[name].step(params, grads, lr)

    def _train_step(self, batch: Dict[str, torch.Tensor], lr: float, lr_d2: float,
                    draws: Dict, use_d3: bool = False):
        opt = self.opt
        mode = opt.gan_mode
        real_lbl = 0.8 if opt.smooth_GAN_label else 1.0
        S, I = batch["S"], batch["I"]
        M = batch.get("M", torch.ones_like(S))
        n, h, w, _ = S.shape
        nc = opt.image_nc
        losses: Dict[str, torch.Tensor] = {}
        # the canvas constants in the compute dtype, as the reference pre-casts them
        cd = self.dtype
        S_d, I_d, M_d = S.to(cd), I.to(cd), M.to(cd)

        # ---- 1. G forward, graph kept; its output stays in the compute dtype ----
        pe = self._pe(n, h, w)
        x_in = torch.cat([S, pe], dim=-1) if pe is not None else S
        out = self.netG(x_in)
        fake_I, fake_T = out[..., :nc] * M_d, out[..., nc:] * M_d
        fake_I_d, fake_T_d = fake_I.detach(), fake_T.detach()
        if opt.use_diffaug:
            aug_real_I = diffaug.diff_augment(I_d, opt.diffaugment, draws=draws["aug_real"]) * M_d
            aug_fake_I = diffaug.diff_augment(fake_I_d, opt.diffaugment,
                                              draws=draws["aug_fake"]) * M_d
        else:
            aug_real_I, aug_fake_I = I_d, fake_I_d

        # ---- 2. D1 update ----
        if "D" in self.model_names:
            fake_in = torch.cat([S_d, fake_I_d], -1) if opt.use_cGAN else fake_I_d
            real_in = torch.cat([S_d, I_d], -1) if opt.use_cGAN else I_d
            pred_fake = self.netD(fake_in)
            pred_fake_I = pred_fake[-1][-1].detach()      # D1's last logit map, a visual
            l_fake = torch.mean(gan_loss(pred_fake, False, mode, real_lbl)) * opt.lambda_G1_GAN
            l_real = torch.mean(gan_loss(self.netD(real_in), True, mode, real_lbl)) \
                * opt.lambda_G1_GAN
            self._update("D", (l_fake + l_real + 0.0) * 0.5, lr)
            losses.update(D_fake_I=l_fake.detach(), D_real_I=l_real.detach(),
                          D_I_grad_penalty=0.0)

        # ---- 3. patch stacks ----
        real_T = batch["T_images"]                    # (N·K, pc, pc, 2), pre-masked
        coords = batch["T_coords"]                    # (N, K, 8)
        valid = batch["T_valid"]
        k, pc = real_T.shape[0], real_T.shape[1]
        # one K2 launch for the four stacks at the batch's coords
        fake_T_patch_d, S_patch, real_I_patch, fake_I_patch = gather_patches_group(
            (fake_T_d, S_d, aug_real_I, aug_fake_I), coords=coords, cutout=32)
        realI_cond = torch.cat([real_I_patch, batch["I_masks"]], -1)
        fakeI_cond = torch.cat([fake_I_patch, batch["I_masks"]], -1)

        def d2_cond(t_patch, s_p, i_p):
            parts = [t_patch]
            if opt.use_cGAN_G2:
                if opt.use_cGAN_G2_S:
                    parts.append(s_p)
                if opt.use_cGAN_G2_I:
                    parts.append(i_p)
            return torch.cat(parts, -1)

        if opt.use_more_fakeT:
            mk = opt.add_fake_T_sample_size
            offs = [sample_offsets_in_mask(M[i, ..., 0], mk, pc, uniforms=draws["more"][i])
                    for i in range(n)]
            ox = torch.stack([o[0] for o in offs])
            oy = torch.stack([o[1] for o in offs])
            # one K2 launch for the three stacks at the "more fake T" offsets
            # (pc == 32: T_resolution_multiplier is 1)
            more_I, more_T, more_S = gather_patches_group(
                (fake_I_d, fake_T_d, S_d), offset_x=ox, offset_y=oy, cutout=32)
            more_I = torch.cat([more_I, torch.ones_like(more_I[..., :1])], -1)
            more_cond = d2_cond(more_T, more_S, more_I)

        # ---- 4. D2 update ----
        if "D2" in self.model_names:
            pf = self.netD2(d2_cond(fake_T_patch_d, S_patch, fakeI_cond))
            l_fake = masked_mean(per_sample_gan_loss(pf, False, mode, real_lbl), valid) \
                * opt.lambda_G2_GAN
            l_more = 0.0
            if opt.use_more_fakeT:
                l_more = torch.mean(per_sample_gan_loss(self.netD2(more_cond), False, mode,
                                                        real_lbl)) * opt.lambda_G2_GAN
            pred_real_T = self.netD2(d2_cond(real_T, S_patch, realI_cond))
            l_real = masked_mean(per_sample_gan_loss(pred_real_T, True, mode, real_lbl),
                                 valid) * opt.lambda_G2_GAN
            self._update("D2", (l_fake + l_more + l_real + 0.0) * 0.5, lr_d2)
            pred_real_T = [[t.detach() for t in scale] for scale in pred_real_T]
            losses.update(D_fake_T_concat=l_fake.detach(), D_more_fake_T=(
                l_more.detach() if torch.is_tensor(l_more) else l_more),
                D_real_T_concat=l_real.detach(), D_T_grad_penalty=0.0)
        else:
            pred_real_T = None

        # ---- 5. D3's real logits (frozen heads); the fake ones come from the
        # one CLIP pass of the G loss ----
        if use_d3:
            with torch.no_grad():
                d3_real_logits = d3_logits(self.clip, self.d3_heads, I)

        # ---- 6. G update against the updated discriminators ----
        aux: Dict[str, torch.Tensor] = {}
        if opt.lambda_G1_GAN > 0:
            g_in = torch.cat([S_d, fake_I], -1) if opt.use_cGAN else fake_I
            aux["G_GAN"] = torch.mean(gan_loss(self.netD(g_in, update_stats=False), True,
                                               mode, real_lbl)) * opt.lambda_G1_GAN
        if opt.lambda_G1_L1 > 0:
            aux["G_L1"] = torch.mean(torch.abs(fake_I - I_d), dtype=torch.float32) \
                * opt.lambda_G1_L1
        if opt.lambda_G1_lpips > 0:
            lp_x, lp_y = fake_I, I_d
            if self._crop_active(h, w):
                # one c² window of both (the reference's dynamic_slice); the
                # slice's backward puts its cotangent into a zero canvas
                c = int(opt.lpips_crop)
                oy, ox = (int(v) for v in draws["lpips_crop"])
                lp_x = lp_x[:, oy:oy + min(c, h), ox:ox + min(c, w)]
                lp_y = lp_y[:, oy:oy + min(c, h), ox:ox + min(c, w)]
            aux["G_lpips"] = torch.mean(self.lpips_net(lp_x, lp_y, y_no_grad=True, dtype=cd)) \
                * opt.lambda_G1_lpips
        f_T_patch = gather_patches_from_coords(fake_T, coords, 32)
        if opt.lambda_G2_L1 > 0:
            l1map = torch.abs(f_T_patch.float() - real_T) * valid[:, None, None, None]
            # per-image patch SUM, batch MEAN (reference .sum(1).mean())
            aux["G2_L1"] = torch.sum(torch.mean(l1map, dim=(1, 2, 3))) * opt.lambda_G2_L1 / n
        if opt.lambda_G2_lpips > 0:
            lp = self.lpips_net(torch.cat([f_T_patch[..., 0:1], f_T_patch[..., 1:2]], 0),
                                torch.cat([real_T[..., 0:1], real_T[..., 1:2]], 0),
                                y_no_grad=True, dtype=cd)
            aux["G2_lpips"] = (masked_patch_sum(lp[:k], valid) / max(n, 1)
                               + masked_patch_sum(lp[k:], valid) / max(n, 1)) \
                * opt.lambda_G2_lpips
        if opt.lambda_G2_GAN > 0 and "D2" in self.model_names:
            t_for_gan = f_T_patch if opt.g2_gan_backprop else f_T_patch.detach()
            with torch.set_grad_enabled(bool(opt.g2_gan_backprop)):
                pf = self.netD2(d2_cond(t_for_gan, S_patch, fakeI_cond), update_stats=False)
                vec = per_sample_gan_loss(pf, True, mode, real_lbl) * opt.lambda_G2_GAN
                aux["G2_GAN"] = masked_patch_sum(vec, valid) / n
                if opt.lambda_G2_GAN_feat > 0 and opt.netD2 == "multiscale" \
                        and pred_real_T is not None and len(pf[0]) > 1:
                    aux["G2_GAN_feat"] = feature_matching_loss(
                        pf, pred_real_T, opt.n_layers_D, opt.num_D_D2) * opt.lambda_G2_GAN_feat
        if use_d3:
            lf = d3_logits(self.clip, self.d3_heads, fake_I)
            aux["G_D3"] = sum(torch.mean(softplus(-l)) for l in lf) * opt.lambda_G1_GAN
            # D3's D objective, logged only, from the same fake pass
            d3_d = 0.0
            for a, b in zip(d3_real_logits, lf):
                d3_d = d3_d + torch.mean(softplus(-a)) + torch.mean(softplus(b.detach()))
            losses["D3_loss"] = d3_d * 0.5 * opt.lambda_G1_GAN
        total = 0.0
        for v in aux.values():
            total = total + v
        self._update("G", total, lr)
        losses.update({key: v.detach() for key, v in aux.items()})
        losses["G_total"] = total.detach()
        outputs = {"fake_I": fake_I_d, "fake_T": fake_T_d, "aug_real_I": aug_real_I,
                   "aug_fake_I": aug_fake_I}
        if "D" in self.model_names:
            outputs["pred_fake_I"] = pred_fake_I
        return losses, outputs

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward_eval(self, S: torch.Tensor, M: torch.Tensor):
        n, h, w, _ = S.shape
        pe = self._pe(n, h, w)
        x = torch.cat([S, pe], dim=-1) if pe is not None else S
        out = self.netG(x, dtype=torch.float32)
        nc = self.opt.image_nc
        return out[..., :nc] * M, out[..., nc:] * M

    def test(self) -> None:
        S = self._input["S"]
        M = self._input.get("M", torch.ones_like(S))
        fake_I, fake_T = self._forward_eval(S, M)
        self._outputs = {"fake_I": fake_I, "fake_T": fake_T}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _pred_fake_T_full(self) -> torch.Tensor:
        """D2 on the whole canvas, [fake_T, S, (aug_fake_I, M)] as in its
        patch conditioning, each in fake_T's dtype: the last scale's logit
        map, as the reference takes it.  After :meth:`test`, which leaves no
        augmented image, fake_I stands in for it, as there.  Batch
        statistics, running ones kept; run only when visuals are asked for,
        outside the training step."""
        opt, out, inp = self.opt, self._outputs, self._input
        S = inp["S"]
        fake_T = out["fake_T"]
        parts = [fake_T]
        if opt.use_cGAN_G2:
            if opt.use_cGAN_G2_S:
                parts.append(S.to(fake_T.dtype))
            if opt.use_cGAN_G2_I:
                aug_I = out.get("aug_fake_I", out["fake_I"])
                M = inp.get("M", torch.ones_like(S))
                parts.append(torch.cat([aug_I, M.to(aug_I.dtype)], -1).to(fake_T.dtype))
        return self.netD2(torch.cat(parts, -1), update_stats=False)[-1][-1]

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        """The gallery's arrays (NHWC, float, or uint8 for the panels), as the
        reference's ``get_current_visuals``: the inputs, the generated image,
        gx, gy and normals, the augmented images, D1's and the full-canvas D2's
        logit maps after a training step, and per coord set (train in red,
        val in green) the box overlays and the real/fake gx patch panels of
        sample 0.  The panels' gather is a K2 launch on the card."""
        def host(t):
            return t.detach().float().cpu().numpy()

        vis: Dict[str, np.ndarray] = {}
        inp = self._input
        vis["real_S"] = host(inp["S"])
        for k, name in (("I", "real_I"), ("M", "M")):
            if k in inp:
                vis[name] = host(inp[k])
        out = self._outputs
        if not out:
            return vis
        fake_T = out["fake_T"]
        vis["fake_I"] = host(out["fake_I"])
        vis["fake_gx"] = host(fake_T[..., 0:1])
        vis["fake_gy"] = host(fake_T[..., 1:2])
        vis["fake_N"] = host(compute_normal(fake_T, scale_nz=self.opt.scale_nz))
        for k in ("aug_real_I", "aug_fake_I", "pred_fake_I"):
            if k in out:
                vis[k] = host(out[k])
        if self.isTrain and "D2" in self.model_names:
            vis["pred_fake_T_full"] = host(self._pred_fake_T_full())
        n_log = int(self.opt.num_touch_patch_for_logging)
        n_b = fake_T.shape[0]
        for prefix, ckey, tkey, vkey, color in (
                ("train", "T_coords", "T_images", "T_valid", (255, 0, 0)),
                ("val", "val_T_coords", "val_T_images", "val_T_valid", (0, 255, 0))):
            if ckey not in inp:
                continue
            valid = inp[vkey].reshape(n_b, -1)[0] > 0
            if not bool(valid.any()):
                continue
            coords = inp[ckey].reshape(n_b, -1, 8)[0][valid][:n_log]
            ox, oy, cut = patch_offsets(host(coords), self.mult)
            vis[f"{prefix}_I_bb"] = bbox_overlay(vis["fake_I"], ox // self.mult,
                                                 oy // self.mult, cut // self.mult, color)[None]
            vis[f"{prefix}_gx_bb"] = bbox_overlay(vis["fake_gx"], ox, oy, cut, color)[None]
            real_T = inp[tkey].reshape((n_b, -1) + tuple(inp[tkey].shape[-3:]))[0][valid][:n_log]
            fake_T_patch = gather_patches_from_coords(fake_T[0:1], coords, 32, self.mult)
            vis[f"{prefix}_real_gx_patches"] = patch_collage(host(real_T[..., 0:1]))[None]
            vis[f"{prefix}_fake_gx_patches"] = patch_collage(host(fake_T_patch[..., 0:1]))[None]
        return vis

    # ------------------------------------------------------------------
    def get_current_losses(self) -> Dict[str, float]:
        """The last step's losses as floats (one device→host copy), in sorted
        key order as the reference logs them."""
        names = sorted(self._losses)
        vals = torch.stack([torch.as_tensor(self._losses[k], dtype=torch.float32,
                                            device=self.device) for k in names]).cpu()
        return {k: float(v) for k, v in zip(names, vals)}

    def compute_metrics(self, phase: str = "val") -> Dict[str, float]:
        """The 8 metrics on the batched path, per sample, averaged over the
        batch.  The test phase scores the test coord set (keys
        ``metric_<name>``); in training the train coord set (``metric_train_
        <name>``) and the val set (``metric_<name>``)."""
        fake_I = self._outputs["fake_I"]
        inp = self._input
        if phase == "test" or not self.isTrain or getattr(self, "data_phase", "") == "test":
            sources = (("", "T_coords", "T_images", "T_valid"),)
        else:
            sources = (("train_", "T_coords", "T_images", "T_valid"),
                       ("", "val_T_coords", "val_T_images", "val_T_valid"))
        res: Dict[str, float] = {}
        n = fake_I.shape[0]
        for prefix, ckey, tkey, vkey in sources:
            if ckey not in inp or "I" not in inp:
                continue
            coords = inp[ckey].reshape(n, -1, 8)
            valid = inp[vkey].reshape(n, -1) > 0
            if not bool(valid.any()):
                continue
            real_T = inp[tkey].reshape((n, -1) + tuple(inp[tkey].shape[-3:]))
            per_sample = []
            for i in range(n):
                per_sample.extend(d for d in compute_evaluation_metrics_batched(
                    inp["I"][i:i + 1], fake_I[i:i + 1], self._outputs["fake_T"][i:i + 1],
                    coords[i:i + 1], real_T[i:i + 1], valid[i:i + 1],
                    eval_metrics=self.eval_metrics, lpips_net=self.lpips_net,
                    inception=self.inception, mult=self.mult, prefix=prefix) if d)
            if per_sample:
                keys = set().union(*per_sample)
                res.update({k: float(np.mean([m[k] for m in per_sample if k in m]))
                            for k in keys})
        self.metrics = res
        return res

    def update_learning_rate(self, epoch: int) -> float:
        f = lr_factor(self.opt.lr_policy, epoch, self.opt)
        print(f"learning rate = {self.opt.lr * f:.7f}")
        return f

    # ------------------------------------------------------------------
    def _ckpt_dir(self, for_load: bool) -> str:
        exp = getattr(self.opt, "pretrained_name", None) if for_load else None
        return f"{self.opt.checkpoints_dir}/{exp or self.opt.name}"

    @staticmethod
    def _converters(name: str):
        """(state dict → (flax params, flax stats), flax params → state dict,
        flax stats → state dict) for network ``name``."""
        if name == "G":
            return (lambda sd: (torch_to_unet_params(sd), {})), unet_params_to_torch, None
        return torch_to_d_params, d_params_to_torch, d_stats_to_torch

    def save_networks(self, tag: str) -> None:
        """``<tag>_net_<Name>.msgpack`` per network, and ``<tag>_opt_<Name>
        .msgpack`` with its Adam state in training."""
        for name, net in self.nets().items():
            to_flax = self._converters(name)[0]
            params, stats = to_flax(net.state_dict())
            opt_state = None
            if name in self.adam:
                a = self.adam[name]
                opt_state = adam_state_to_flax(a.count, a.mu, a.nu,
                                               lambda sd: to_flax(sd)[0])
            save_net(self._ckpt_dir(False), tag, name, params, stats, opt_state)

    def load_networks(self, tag: str) -> None:
        for name, net in self.nets().items():
            _, params_to_torch, stats_to_torch = self._converters(name)
            load_net(self._ckpt_dir(True), tag, name, net, params_to_torch, stats_to_torch)
            state = load_opt_state(self._ckpt_dir(True), tag, name) \
                if name in self.adam else None
            if state is not None:
                a = self.adam[name]
                a.count, mu, nu = adam_state_to_torch(state, params_to_torch)
                a.mu = {k: v.to(self.device) for k, v in mu.items()}
                a.nu = {k: v.to(self.device) for k, v in nu.items()}
