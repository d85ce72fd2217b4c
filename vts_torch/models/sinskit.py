"""SinSKIT — the flagship sketch→(image, touch) model
(``vts_tpu/models/sinskit.py``): ``setup`` (seeded init of G, and of D and
D2 in training), ``set_input``, ``optimize_parameters`` (one training step),
``test`` (the fp32 eval forward), ``compute_metrics`` (batched 8-metric
evaluation), ``get_current_losses``, ``update_learning_rate``,
``save_networks`` / ``load_networks``.

One training step is the reference's ``_train_step``, in its order:
  1. G forward once, its graph kept;
  2. D1 update on (S, fake_I) and (S, I), batch-norm stats threaded fake → real;
  3. the patch stacks, and the "more fake T" stack sampled ∝ the dilated mask;
  4. D2 update, stats threaded fake → more → real;
  5. G update against the updated D1 and D2 (batch statistics, new ones
     discarded): G1 = GAN + L1·100 + LPIPS, G2 = per-patch L1·10 + LPIPS·10,
     the gradient through the G forward of step 1.
The reference's quirks are kept: the G2 GAN terms see detached tactile
patches (logged, no G gradient, unless ``--g2_gan_backprop``), DiffAugment
feeds only D2's visual conditioning, and D2's conditioning is detached.

Every random draw of a step — DiffAugment's brightness and saturation for
real and fake, and the uniforms that place the "more fake T" windows — comes
from a ``torch.Generator`` seeded by ``--seed``, or is injected with
``optimize_parameters(draws=...)`` (see :meth:`SinSKITModel.draw`).

Not ported yet, and raising: the vision-aided D3 (a step at an epoch where
it would be active raises), WGAN-GP, style codes, ``T_resolution_multiplier
> 1``, the legacy per-metric evaluation and the visuals.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..losses.gan import feature_matching_loss, gan_loss
from ..losses.gan_masked import GAN_MODES, masked_mean, masked_patch_sum, per_sample_gan_loss
from ..losses.lpips import LPIPS, init_lpips_params
from ..metrics.evaluate import DEFAULT_EVAL_METRICS
from ..metrics.evaluate_batch import compute_evaluation_metrics_batched
from ..metrics.inception import InceptionBlock0, init_inception_params
from ..networks import define_D, define_G
from ..networks.blocks import make_initializer
from ..networks.discriminators import reset_parameters as reset_d
from ..networks.positional import positional_encoding
from ..ops import diffaug
from ..ops.patch import gather_patches_from_coords, gather_patches_group, sample_offsets_in_mask
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
        if int(opt.T_resolution_multiplier) != 1:
            raise NotImplementedError("T_resolution_multiplier > 1 is not ported yet")
        if opt.eval_mode != "batched":
            raise NotImplementedError("--eval_mode legacy is not ported yet")
        self.opt = opt
        self.isTrain = bool(opt.isTrain)
        self.device = resolve_device(opt.device)
        self.mult = 1
        pe_nc = 2 * opt.positional_encoding_dim if opt.use_positional_encoding else 0
        self.input_nc = opt.sketch_nc + pe_nc
        self.netG = define_G(opt, self.input_nc, opt.image_nc + opt.touch_nc)
        self.model_names = ["G"]
        if self.isTrain:
            if opt.gan_mode not in GAN_MODES:
                raise NotImplementedError(f"--gan_mode {opt.gan_mode} is not ported yet")
            if opt.use_diffaug and set(opt.diffaugment) - set("bs"):
                raise NotImplementedError(f"--diffaugment {opt.diffaugment!r}: only the "
                                          f"letters 'b' and 's' are ported yet")
            d1_in = opt.image_nc + (opt.sketch_nc if opt.use_cGAN else 0)
            self.netD = define_D(opt, d1_in, netD=opt.netD, num_D=opt.num_D_D1)
            d2_in = opt.touch_nc
            if opt.use_cGAN_G2:
                d2_in += (opt.sketch_nc if opt.use_cGAN_G2_S else 0) \
                    + (opt.image_nc + 1 if opt.use_cGAN_G2_I else 0)
            self.netD2 = define_D(opt, d2_in, netD=opt.netD2, n_layers=opt.n_layers_D2,
                                  num_D=opt.num_D_D2)
            if opt.lambda_G1_GAN > 0:
                self.model_names.append("D")
            if opt.lambda_G2_GAN > 0:
                self.model_names.append("D2")
            self.use_d3 = bool(opt.use_vision_aided_loss)
            self.generator = torch.Generator().manual_seed(int(opt.seed))
        self.lpips_net = LPIPS(init_lpips_params(0)).to(self.device)
        self.inception = InceptionBlock0(init_inception_params(0)).to(self.device)
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
        the device with Adam moments for each network that trains."""
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
    def draw(self, n: int) -> Dict:
        """The random numbers of one step for a batch of n, from the model's
        generator: ``{"aug_real": {letter: (n,)}, "aug_fake": {letter: (n,)},
        "more": (n, 2, add_fake_T_sample_size)}`` — uniforms in [0, 1).  The
        same structure, filled from elsewhere, is what
        :meth:`optimize_parameters` takes as ``draws``."""
        opt = self.opt
        policy = opt.diffaugment if opt.use_diffaug else ""
        return {"aug_real": diffaug.draw(policy, n, self.generator),
                "aug_fake": diffaug.draw(policy, n, self.generator),
                "more": torch.rand((n, 2, opt.add_fake_T_sample_size),
                                   generator=self.generator)}

    def optimize_parameters(self, epoch: int = 1, draws: Optional[Dict] = None) -> None:
        """One training step at the lr of ``epoch``."""
        opt = self.opt
        if self.use_d3 and epoch >= opt.vision_aided_warmup_epoch:
            raise NotImplementedError(
                f"epoch {epoch} >= --vision_aided_warmup_epoch "
                f"{opt.vision_aided_warmup_epoch}: the vision-aided D3 (CLIP) is not "
                f"ported yet; pass --use_vision_aided_loss false to train without it")
        f = lr_factor(opt.lr_policy, epoch - 1, opt)
        if draws is None:
            draws = self.draw(self._input["S"].shape[0])
        self._losses, self._outputs = self._train_step(self._input, opt.lr * f,
                                                       opt.lr_G2 * f, draws)

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
                    draws: Dict):
        opt = self.opt
        mode = opt.gan_mode
        real_lbl = 0.8 if opt.smooth_GAN_label else 1.0
        S, I = batch["S"], batch["I"]
        M = batch.get("M", torch.ones_like(S))
        n, h, w, _ = S.shape
        nc = opt.image_nc
        losses: Dict[str, torch.Tensor] = {}

        # ---- 1. G forward, graph kept ----
        pe = self._pe(n, h, w)
        x_in = torch.cat([S, pe], dim=-1) if pe is not None else S
        out = self.netG(x_in).float()
        fake_I, fake_T = out[..., :nc] * M, out[..., nc:] * M
        fake_I_d, fake_T_d = fake_I.detach(), fake_T.detach()
        if opt.use_diffaug:
            aug_real_I = diffaug.diff_augment(I, opt.diffaugment, draws=draws["aug_real"]) * M
            aug_fake_I = diffaug.diff_augment(fake_I_d, opt.diffaugment,
                                              draws=draws["aug_fake"]) * M
        else:
            aug_real_I, aug_fake_I = I, fake_I_d

        # ---- 2. D1 update ----
        if "D" in self.model_names:
            fake_in = torch.cat([S, fake_I_d], -1) if opt.use_cGAN else fake_I_d
            real_in = torch.cat([S, I], -1) if opt.use_cGAN else I
            l_fake = torch.mean(gan_loss(self.netD(fake_in), False, mode, real_lbl)) \
                * opt.lambda_G1_GAN
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
            (fake_T_d, S, aug_real_I, aug_fake_I), coords=coords, cutout=32)
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
                (fake_I_d, fake_T_d, S), offset_x=ox, offset_y=oy, cutout=32)
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

        # ---- 5. G update against the updated discriminators ----
        aux: Dict[str, torch.Tensor] = {}
        if opt.lambda_G1_GAN > 0:
            g_in = torch.cat([S, fake_I], -1) if opt.use_cGAN else fake_I
            aux["G_GAN"] = torch.mean(gan_loss(self.netD(g_in, update_stats=False), True,
                                               mode, real_lbl)) * opt.lambda_G1_GAN
        if opt.lambda_G1_L1 > 0:
            aux["G_L1"] = torch.mean(torch.abs(fake_I - I)) * opt.lambda_G1_L1
        if opt.lambda_G1_lpips > 0:
            aux["G_lpips"] = torch.mean(self.lpips_net(fake_I, I, y_no_grad=True)) \
                * opt.lambda_G1_lpips
        f_T_patch = gather_patches_from_coords(fake_T, coords, 32)
        if opt.lambda_G2_L1 > 0:
            l1map = torch.abs(f_T_patch - real_T) * valid[:, None, None, None]
            # per-image patch SUM, batch MEAN (reference .sum(1).mean())
            aux["G2_L1"] = torch.sum(torch.mean(l1map, dim=(1, 2, 3))) * opt.lambda_G2_L1 / n
        if opt.lambda_G2_lpips > 0:
            lp = self.lpips_net(torch.cat([f_T_patch[..., 0:1], f_T_patch[..., 1:2]], 0),
                                torch.cat([real_T[..., 0:1], real_T[..., 1:2]], 0),
                                y_no_grad=True)
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
        total = 0.0
        for v in aux.values():
            total = total + v
        self._update("G", total, lr)
        losses.update({key: v.detach() for key, v in aux.items()})
        losses["G_total"] = total.detach()
        outputs = {"fake_I": fake_I_d, "fake_T": fake_T_d, "aug_real_I": aug_real_I,
                   "aug_fake_I": aug_fake_I}
        return losses, outputs

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward_eval(self, S: torch.Tensor, M: torch.Tensor):
        n, h, w, _ = S.shape
        pe = self._pe(n, h, w)
        x = torch.cat([S, pe], dim=-1) if pe is not None else S
        out = self.netG(x).float()
        nc = self.opt.image_nc
        return out[..., :nc] * M, out[..., nc:] * M

    def test(self) -> None:
        S = self._input["S"]
        M = self._input.get("M", torch.ones_like(S))
        fake_I, fake_T = self._forward_eval(S, M)
        self._outputs = {"fake_I": fake_I, "fake_T": fake_T}

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
