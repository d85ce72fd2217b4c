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

Every random draw of a step — DiffAugment's for real and fake, the
uniforms that place the "more fake T" windows, the ``--lpips_crop`` window
and WGAN-GP's interpolation weights — comes from a ``torch.Generator``
seeded by ``--seed``, or is injected with ``optimize_parameters(draws=...)``
(see :meth:`SinSKITModel.draw`).

``--T_resolution_multiplier`` m > 1 (2 or 4): G's tactile head comes out at
m× the canvas, masked by M_T, the nearest m× resize of M; the tactile
patches are cut at 32·m from it (the coords scaled by m), their S and I
conditioning at 32 from the canvas (the "more fake T" ones at the offsets
// m) and resized bicubically to 32·m; the "more fake T" sampler runs on
M_T; D2 and the touch losses take 32·m patches.  The gathers at the two
sizes are separate K2 launches: 5 a step (3 at m = 1).

``--gan_mode wgangp`` adds the gradient penalty to D1's and D2's losses;
its D pass uses batch statistics and leaves the running ones alone.
``--lr_policy plateau`` scales the lr by ``lr_override``, which the
training driver sets from its :class:`~vts_torch.models.base.PlateauTracker`.

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

``--use_style_code`` (the skitG generator, :mod:`vts_torch.models.skit`):
G takes the batch's ``style_code`` (N, style_code_dim) in the training step,
its eval forward and :meth:`test`, with no gradient into it; the CLIP tower
that encodes it is built at setup, in both phases, and is the same tower
D3 uses.  ``--eval_mode legacy`` scores each sample with the reference's
per-metric loop (:func:`vts_torch.metrics.evaluate.compute_evaluation_metrics`)
in place of the batched pass.

``--mesh data:N`` (N > 1) splits the training batch over N ranks
(:mod:`vts_torch.platform`), as the reference's GSPMD step shards it, and
keeps the step's meaning: every rank holds the same networks and loads the
same global batch, keeps its block of the samples (:meth:`set_input`) and
of the step's draws (drawn for the global batch on every rank), and takes
its *share* of each loss: a mean over the samples divided by N, a validity
-masked mean over the global valid count, a per-image sum over the global
batch size.  The batch norms and the StyleGAN2 D's minibatch stddev use the
global batch (:mod:`vts_torch.parallel.dist`).  So the ranks' gradients sum
to the global batch's: each network's are summed over the ranks in one
collective before Adam, and the logged losses are the global ones.  The
baselines (pix2pix, pix2pixHD, SPADE) never split, as in the reference.

The settings not ported yet are refused by the options
(:mod:`vts_torch.config.options`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.coords import patch_offsets
from ..device import resolve_device
from ..losses.gan import feature_matching_loss, gan_loss, gradient_penalty
from ..losses.gan_masked import masked_mean, masked_patch_sum, per_sample_gan_loss
from ..losses.lpips import LPIPS, init_lpips_params, load_lpips_weights
from ..losses.vision_aided import D3Heads, d3_logits, init_d3_head_params, softplus
from ..metrics.evaluate import DEFAULT_EVAL_METRICS, compute_evaluation_metrics
from ..metrics.evaluate_batch import compute_evaluation_metrics_batched
from ..metrics.inception import InceptionBlock0, init_inception_params, load_inception_weights
from ..networks import (CustomUNet, StyleGAN2Discriminator, StyleGAN2Generator, define_D,
                        define_G)
from ..networks.blocks import BatchNorm, make_initializer
from ..networks.clip_vit import CLIPViT, init_clip_params, load_clip_weights
from ..networks.discriminators import reset_parameters as reset_d
from ..networks.positional import positional_encoding
from ..ops import diffaug
from ..ops.normal import compute_normal
from ..ops.patch import gather_patches_from_coords, gather_patches_group, sample_offsets_in_mask
from ..ops.resize import resize_bicubic, resize_nearest
from ..parallel.dist import DataGroup
from ..parallel.mesh import mesh_for_flag, parse_mesh_spec, visible_devices
from ..platform import world
from ..utils.collage import bbox_overlay, patch_collage
from ..utils.convert_jax import (adam_state_to_flax, adam_state_to_torch, d_params_to_torch,
                                 d_stats_to_torch, resnet_params_to_torch, resnet_stats_to_torch,
                                 stylegan2_params_to_torch, torch_to_d_params,
                                 torch_to_resnet_params, torch_to_stylegan2_params,
                                 torch_to_unet_params, torch_to_unet_stats, unet_params_to_torch,
                                 unet_stats_to_torch)
from .base import Adam, load_net, load_opt_state, lr_factor, save_net

_PATCH_STACKS = ("T_images", "I_masks", "T_valid",
                 "val_T_images", "val_I_masks", "val_T_valid")


def _detached(t):
    """A loss value, a logit map or a (nested) list of logit maps, detached."""
    if isinstance(t, (list, tuple)):
        return [_detached(v) for v in t]
    return t.detach() if torch.is_tensor(t) else t


def _gather_by_size(images, **kw):
    """:func:`gather_patches_group` over images that may differ in element
    size, one launch for each size: a zoo G whose convs run in fp32
    whatever the compute dtype (VisGel) gives fp32 maps beside the bf16
    canvas under ``--dtype bfloat16``, as the reference's does."""
    images = tuple(images)
    sizes = {}
    for i, im in enumerate(images):
        sizes.setdefault(im.element_size(), []).append(i)
    if len(sizes) == 1:
        return gather_patches_group(images, **kw)
    out = [None] * len(images)
    for idx in sizes.values():
        for i, t in zip(idx, gather_patches_group([images[i] for i in idx], **kw)):
            out[i] = t
    return tuple(out)


def data_axis(opt) -> int:
    """``--mesh``'s ``data`` axis N (1 without one), after the reference's
    two refusals when N > 1: a batch that N does not divide, and
    ``--steps_per_dispatch`` > 1."""
    ndp = parse_mesh_spec(opt.mesh).get("data", 1)
    if ndp > 1:
        n = int(opt.batch_size)
        if n % ndp:
            raise ValueError(f"--mesh data:{ndp} needs batch_size divisible by {ndp} "
                             f"(got {n}); the batch axis is what shards")
        if int(opt.steps_per_dispatch) > 1:
            raise ValueError("--mesh data parallelism and --steps_per_dispatch > 1 are mutually "
                             "exclusive (chunk stacking would gather the sharded batch)")
    return ndp


def _rows(group: DataGroup, draws):
    """This rank's rows of a (nested list or dict of) whole-batch draw(s)."""
    if isinstance(draws, (list, tuple)):
        return [_rows(group, d) for d in draws]
    if isinstance(draws, dict):
        return {k: _rows(group, d) for k, d in draws.items()}
    return group.rows(draws)


class SinSKITModel:
    """Lifecycle as in the reference: setup → set_input → optimize_parameters
    / test → get_current_losses / compute_metrics → save/load_networks."""

    # whether --mesh data:N splits this model's training step over ranks
    data_parallel = True
    # the gallery's full-canvas D2 logit map after a training step
    pred_fake_T_full_visual = True
    # the touch-patch stacks (by prefix) that set_input masks by their object masks
    masked_stacks = ("", "val_")

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
        self.mult = int(opt.T_resolution_multiplier)
        self.lr_override = 1.0               # --lr_policy plateau: set by the training driver
        pe_nc = 0
        if opt.use_positional_encoding:
            pe_nc = 2 * opt.positional_encoding_dim \
                if opt.positional_encoding_mode == "spe" else 2
        self.input_nc = opt.sketch_nc + pe_nc
        self.netG = define_G(opt, self.input_nc, opt.image_nc + opt.touch_nc, dtype=self.dtype)
        self.model_names = ["G"]
        if self.isTrain:
            if opt.netD2 == "patch" and opt.lambda_G2_GAN > 0:
                # the reference's D2 update, which runs when lambda_G2_GAN > 0,
                # broadcasts D2's (K·tiles,) losses against the (K,) validity
                # mask and fails there
                raise ValueError("--netD2 patch cuts each 32·m² patch into 16² tiles, so D2's "
                                 "per-tile losses do not match the patches' validity mask "
                                 "(the reference's step fails on it too)")
            d1_in = opt.image_nc + (opt.sketch_nc if opt.use_cGAN else 0)
            crop = int(opt.crop_size)
            self.netD = define_D(opt, d1_in, netD=opt.netD, num_D=opt.num_D_D1, dtype=self.dtype,
                                 input_size=(crop, crop))
            d2_in = opt.touch_nc
            if opt.use_cGAN_G2:
                d2_in += (opt.sketch_nc if opt.use_cGAN_G2_S else 0) \
                    + (opt.image_nc + 1 if opt.use_cGAN_G2_I else 0)
            self.netD2 = define_D(opt, d2_in, netD=opt.netD2, n_layers=opt.n_layers_D2,
                                  num_D=opt.num_D_D2, dtype=self.dtype,
                                  input_size=(32 * self.mult,) * 2)
            if "stylegan2" in opt.netD2:
                # its flattened head is sized for the patches: the full-canvas
                # pass fails in the reference (a matmul of mismatched widths)
                self.pred_fake_T_full_visual = False
            if opt.lambda_G1_GAN > 0:
                self.model_names.append("D")
            if opt.lambda_G2_GAN > 0:
                self.model_names.append("D2")
            self.use_d3 = bool(opt.use_vision_aided_loss)
            self.d3_heads: Optional[D3Heads] = None
            self.generator = torch.Generator().manual_seed(int(opt.seed))
        self.clip: Optional[CLIPViT] = None
        self._pe_cache: Dict = {}
        self._init_metrics_and_state()

    def _init_metrics_and_state(self) -> None:
        """The LPIPS and Inception towers of the metrics (``--lpips_weights``
        and ``--inception_weights`` when given, else the seeded ones) on the
        device, and the empty per-step state."""
        lw, iw = self.opt.lpips_weights, self.opt.inception_weights
        self.lpips_net = LPIPS(load_lpips_weights(lw) if lw else init_lpips_params(0)).to(
            self.device)
        self.inception = InceptionBlock0(
            load_inception_weights(iw) if iw else init_inception_params(0)).to(self.device)
        self.eval_metrics = list(DEFAULT_EVAL_METRICS)
        self.adam: Dict[str, Adam] = {}
        self._input: Dict[str, torch.Tensor] = {}
        self._outputs: Dict[str, torch.Tensor] = {}
        self._losses: Dict[str, torch.Tensor] = {}
        self.metrics: Dict[str, float] = {}
        self.dp: Optional[DataGroup] = None   # --mesh data:N: this rank's data group

    # ------------------------------------------------------------------
    def nets(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self, f"net{name}") for name in self.model_names}

    def setup(self, example_batch=None) -> None:
        """Seeded init (``--seed``) of G, and of D and D2 in training, then onto
        the device with Adam moments for each network that trains; the
        frozen CLIP tower (``--clip_weights`` or the seeded one) for the style
        code and for D3, with D3's heads, when either is on."""
        self.init_nets(int(self.opt.seed))
        n_params = sum(p.numel() for p in self.netG.parameters())
        print(f"[sinskit] netG params: {n_params / 1e6:.3f} M")
        if self.opt.use_style_code or (self.isTrain and self.use_d3):
            # frozen, on the device once (the tower is ~350 MB in fp32); not
            # among the networks that are saved or stepped
            cw = self.opt.clip_weights
            self.clip = CLIPViT(load_clip_weights(cw) if cw else init_clip_params(0)).to(
                self.device)
            print(f"[sinskit] CLIP ViT-B/32 ({cw or 'seeded tower'}) for "
                  + " and ".join(w for w, on in (
                      ("the style code", self.opt.use_style_code),
                      (f"D3 from epoch {self.opt.vision_aided_warmup_epoch}",
                       self.isTrain and self.use_d3)) if on))
        if not self.isTrain:
            return
        print(f"[sinskit] netD params: "
              f"{sum(p.numel() for p in self.netD.parameters()) / 1e6:.3f} M, netD2: "
              f"{sum(p.numel() for p in self.netD2.parameters()) / 1e6:.3f} M")
        if self.use_d3:
            self.d3_heads = D3Heads(init_d3_head_params(0)).to(self.device)
        self._setup_dp()

    def _setup_dp(self) -> None:
        """``--mesh`` (the reference's ``_setup_dp_mesh``): outside ranks the
        spec is checked against this machine's devices, as ``build_mesh``
        checks it; a ``data`` axis of N > 1 then needs a batch divisible by
        N and ``--steps_per_dispatch`` 1 (:func:`data_axis`), and this
        process to be one of N ranks; the networks' batch norms and StyleGAN2
        Ds join the ranks' :class:`DataGroup`.  Other axes change nothing, as
        in the reference's train path; a model whose ``data_parallel`` is
        False (the baselines) ignores ``--mesh``, as the reference's do."""
        spec = self.opt.mesh
        if not spec or not self.data_parallel:
            return
        ranks = world()
        if ranks is None:
            mesh_for_flag(spec, visible_devices(self.device.type))
        ndp = data_axis(self.opt)
        if ndp <= 1:
            return
        n = int(self.opt.batch_size)
        if ranks is None or ranks.size != ndp:
            raise RuntimeError(
                f"--mesh {spec} trains on {ndp} data ranks, and this process is "
                + ("not one of several" if ranks is None else f"one of {ranks.size}")
                + ": vts_torch.train starts them (with --multihost, start one process a rank)")
        self.dp = DataGroup(ranks.rank, ndp, ranks.group)
        for net in (self.netG, self.netD, self.netD2):
            for m in net.modules():
                if isinstance(m, (BatchNorm, StyleGAN2Discriminator)):
                    m.group = self.dp
        print(f"[sinskit] data-parallel ranks active: batch {n} → {n // ndp} per rank × "
              f"{ndp} ranks")

    def init_nets(self, seed: int) -> None:
        """Seeded init of the networks in place, on the device: G from ``seed``
        (in eval mode outside training), D and D2 from ``seed`` + 1 and + 2,
        with fresh Adam moments for each network that trains.  What
        :meth:`setup` does with ``--seed`` and the fleet with each garment's
        seed (:class:`vts_torch.parallel.fleet.FleetTrainer`).  The draws run
        on the CPU, wherever the networks are, so every device gets the same
        weights."""
        self.netG.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        self.netG.to(self.device)
        if not self.isTrain:
            self.netG.eval()
            return
        init = make_initializer(self.opt.init_type, self.opt.init_gain)
        for i, net in enumerate((self.netD, self.netD2)):
            reset_d(net.cpu(), init, torch.Generator().manual_seed(seed + 1 + i))
            net.to(self.device).train()
        self.netG.train()
        self.adam = {name: Adam(net.named_parameters(), self.opt.beta1, self.opt.beta2)
                     for name, net in self.nets().items()}

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
        tactile patches of :attr:`masked_stacks` are masked by their object
        masks.  On data-parallel ranks a training batch whose N the ranks
        divide is cut to this rank's block of samples (the reference shards
        it; anything else, the validation sample among it, stays whole)."""
        arrays = {k: v for k, v in batch.items()
                  if k not in ("name", "sample_idx") and isinstance(v, np.ndarray)
                  and v.dtype.kind in "fiub"}
        n = len(arrays["S"]) if "S" in arrays else 0
        self._dp_split = self.dp is not None and phase == "train" and n and n % self.dp.size == 0
        if self._dp_split:
            arrays = {k: self.dp.rows(v) if v.ndim and len(v) == n else v
                      for k, v in arrays.items()}
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in arrays.items()}
        if "M" in dev:
            dev["S"] = dev["S"] * dev["M"]
            if "I" in dev:
                dev["I"] = dev["I"] * dev["M"]
        for key in _PATCH_STACKS:
            if key in dev and dev[key].dim() >= 2:
                dev[key] = dev[key].reshape((-1,) + tuple(dev[key].shape[2:]))
        for pre in self.masked_stacks:
            if f"{pre}T_images" in dev:
                dev[f"{pre}T_images"] = dev[f"{pre}T_images"] * dev[f"{pre}I_masks"]
        self._input = dev
        self.data_phase = phase

    # ------------------------------------------------------------------
    def _crop_active(self, h: int, w: int) -> bool:
        return 0 < int(self.opt.lpips_crop) < max(h, w)

    def draw(self, n: int, size=None) -> Dict:
        """The random numbers of one step for a batch of n (canvas ``size`` =
        (h, w), by default ``--crop_size``²), from the model's generator:
        ``{"aug_real": …, "aug_fake": …}``, DiffAugment's draws for each
        policy position (:func:`vts_torch.ops.diffaug.draw`), ``"more": (n, 2,
        add_fake_T_sample_size)`` uniforms in [0, 1); when ``--lpips_crop``
        crops that canvas, ``"lpips_crop": (oy, ox)``, integers in [0, h − c]
        and [0, w − c]; under ``--gan_mode wgangp``, ``"gp1": (n,)`` and
        ``"gp2": (n·batch_size_G2,)`` uniforms, the penalty's interpolation
        weights.  The same structure, filled from elsewhere, is what
        :meth:`optimize_parameters` takes as ``draws``."""
        opt = self.opt
        policy = opt.diffaugment if opt.use_diffaug else ""
        if size is None:
            size = (int(opt.crop_size),) * 2
        shape = (n, *size, opt.image_nc)
        out = {"aug_real": diffaug.draw(policy, shape, self.generator),
               "aug_fake": diffaug.draw(policy, shape, self.generator),
               "more": torch.rand((n, 2, opt.add_fake_T_sample_size), generator=self.generator)}
        if opt.gan_mode == "wgangp":
            out["gp1"] = torch.rand((n,), generator=self.generator)
            out["gp2"] = torch.rand((n * int(opt.batch_size_G2),), generator=self.generator)
        if self._crop_active(*size):
            c = int(opt.lpips_crop)
            out["lpips_crop"] = tuple(
                int(torch.randint(0, max(side - c, 0) + 1, (), generator=self.generator))
                for side in size)
        return out

    def optimize_parameters(self, epoch: int = 1, draws: Optional[Dict] = None) -> None:
        """One training step at the lr of ``epoch``, with D3 from
        ``--vision_aided_warmup_epoch`` on."""
        opt = self.opt
        f = lr_factor(opt.lr_policy, epoch - 1, opt) * self.lr_override
        if draws is None:
            draws = self.draw(self._input["S"].shape[0] * self._ranks(),
                              tuple(self._input["S"].shape[1:3]))
        if self.dp is not None:
            # the global batch's draws (drawn here or given), this rank's rows
            draws = {k: v if k == "lpips_crop" else _rows(self.dp, v) for k, v in draws.items()}
        use_d3 = self.use_d3 and epoch >= opt.vision_aided_warmup_epoch
        self._losses, self._outputs = self._train_step(self._input, opt.lr * f,
                                                       opt.lr_G2 * f, draws, use_d3)

    def _ranks(self) -> int:
        """How many ranks share the training step: N under ``--mesh data:N``,
        else 1.  Refuses a step on a batch that was not split."""
        if self.dp is None:
            return 1
        if not self._dp_split:
            raise ValueError(f"--mesh data:{self.dp.size}: the training batch of "
                             f"{len(self._input['S'])} was not split over the ranks")
        return self.dp.size

    def _update(self, name: str, loss: torch.Tensor, lr: float, frozen=()) -> None:
        """Gradient of ``loss`` w.r.t. network ``name``'s parameters, summed
        over the data-parallel ranks, then Adam; the parameters named in
        ``frozen`` get a zero gradient (not computed)."""
        params = dict(getattr(self, f"net{name}").named_parameters())
        live = [k for k in params if k not in frozen]
        if not (torch.is_tensor(loss) and loss.requires_grad) or not live:   # every term detached
            grads = [None] * len(live)
        else:
            grads = torch.autograd.grad(loss, [params[k] for k in live], allow_unused=True)
        got = dict(zip(live, grads))
        grads = {k: torch.zeros_like(p) if got.get(k) is None else got[k]
                 for k, p in params.items()}
        if self.dp is not None:
            self.dp.sum_flat_(list(grads.values()))
        self.adam[name].step(params, grads, lr)

    def _train_step(self, batch: Dict[str, torch.Tensor], lr: float, lr_d2: float,
                    draws: Dict, use_d3: bool = False):
        opt = self.opt
        mode = opt.gan_mode
        real_lbl = 0.8 if opt.smooth_GAN_label else 1.0
        S, I = batch["S"], batch["I"]
        M = batch.get("M", torch.ones_like(S))
        n, h, w, _ = S.shape
        mult = self.mult
        M_T = M if mult == 1 else resize_nearest(M, (h * mult, w * mult))
        losses: Dict[str, torch.Tensor] = {}
        # on data-parallel ranks: the global batch size, and this rank's share
        # of a mean over the global batch (its own samples' mean / ranks)
        ranks = self._ranks()
        n_all = n * ranks

        def share(t):
            return t if ranks == 1 else t / ranks
        # the canvas constants in the compute dtype, as the reference pre-casts them
        cd = self.dtype
        S_d, I_d, M_d = S.to(cd), I.to(cd), M.to(cd)

        # ---- 1. G forward, graph kept; its output stays in the compute dtype ----
        pe = self._pe(n, h, w)
        x_in = torch.cat([S, pe], dim=-1) if pe is not None else S
        style = self._style_code(batch)
        fake_I, fake_T = self._split_g_out(self.netG(x_in, style), M_d, M_T.to(cd))
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
            # D1's last logit map, a visual
            pred_fake_I = (pred_fake[-1][-1] if isinstance(pred_fake, (list, tuple))
                           else pred_fake).detach()
            l_fake = share(torch.mean(gan_loss(pred_fake, False, mode, real_lbl))) \
                * opt.lambda_G1_GAN
            l_real = share(torch.mean(gan_loss(self.netD(real_in), True, mode, real_lbl))) \
                * opt.lambda_G1_GAN
            gp = share(self._penalty(self.netD, real_in, fake_in, draws, "gp1"))
            self._update("D", (l_fake + l_real + gp) * 0.5, lr)
            losses.update(D_fake_I=l_fake.detach(), D_real_I=l_real.detach(),
                          D_I_grad_penalty=_detached(gp))

        # ---- 3. patch stacks ----
        real_T = batch["T_images"]                    # (N·K, pc, pc, 2), pre-masked
        coords = batch["T_coords"]                    # (N, K, 8)
        valid = batch["T_valid"]
        k, pc = real_T.shape[0], real_T.shape[1]      # pc = 32·mult
        if mult == 1:
            # one K2 launch for the four stacks at the batch's coords
            fake_T_patch_d, S_patch, real_I_patch, fake_I_patch = _gather_by_size(
                (fake_T_d, S_d, aug_real_I, aug_fake_I), coords=coords, cutout=32)
        else:
            # fake_T at 32·mult from the touch canvas, the conditioning at 32
            # from the canvas, resized to 32·mult: a K2 launch each
            fake_T_patch_d, = gather_patches_group((fake_T_d,), coords=coords, cutout=pc,
                                                   scale_multiplier=mult)
            S_patch, real_I_patch, fake_I_patch = (resize_bicubic(t, (pc, pc)) for t in
                                                   _gather_by_size(
                                                       (S_d, aug_real_I, aug_fake_I),
                                                       coords=coords, cutout=32))
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
            offs = [sample_offsets_in_mask(M_T[i, ..., 0], mk, pc, uniforms=draws["more"][i])
                    for i in range(n)]
            ox = torch.stack([o[0] for o in offs])
            oy = torch.stack([o[1] for o in offs])
            if mult == 1:
                # one K2 launch for the three stacks at the "more fake T" offsets
                more_I, more_T, more_S = _gather_by_size(
                    (fake_I_d, fake_T_d, S_d), offset_x=ox, offset_y=oy, cutout=32)
            else:
                more_T, = gather_patches_group((fake_T_d,), offset_x=ox, offset_y=oy, cutout=pc)
                more_I, more_S = (resize_bicubic(t, (pc, pc)) for t in _gather_by_size(
                    (fake_I_d, S_d), offset_x=ox // mult, offset_y=oy // mult, cutout=32))
            more_I = torch.cat([more_I, torch.ones_like(more_I[..., :1])], -1)
            more_cond = d2_cond(more_T, more_S, more_I)

        # ---- 4. D2 update ----
        if "D2" in self.model_names:
            # the global batch's valid patch count
            n_valid = None if ranks == 1 else self.dp.sum_(torch.sum(valid).reshape(1))[0]
            fake_cond = d2_cond(fake_T_patch_d, S_patch, fakeI_cond)
            real_cond = d2_cond(real_T, S_patch, realI_cond)
            pf = self.netD2(fake_cond)
            l_fake = masked_mean(per_sample_gan_loss(pf, False, mode, real_lbl), valid,
                                 n_valid) * opt.lambda_G2_GAN
            l_more = 0.0
            if opt.use_more_fakeT:
                l_more = share(torch.mean(per_sample_gan_loss(self.netD2(more_cond), False,
                                                              mode, real_lbl))) * opt.lambda_G2_GAN
            pred_real_T = self.netD2(real_cond)
            l_real = masked_mean(per_sample_gan_loss(pred_real_T, True, mode, real_lbl),
                                 valid, n_valid) * opt.lambda_G2_GAN
            gp = share(self._penalty(self.netD2, real_cond, fake_cond, draws, "gp2"))
            self._update("D2", (l_fake + l_more + l_real + gp) * 0.5, lr_d2)
            pred_real_T = _detached(pred_real_T)
            losses.update(D_fake_T_concat=l_fake.detach(), D_more_fake_T=_detached(l_more),
                          D_real_T_concat=l_real.detach(), D_T_grad_penalty=_detached(gp))
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
            aux["G_GAN"] = share(torch.mean(gan_loss(self.netD(g_in, update_stats=False), True,
                                                     mode, real_lbl))) * opt.lambda_G1_GAN
        if opt.lambda_G1_L1 > 0:
            # I in G's output dtype (fp32 for a G whose convs stay fp32 under
            # bf16, VisGel), as the reference casts it
            aux["G_L1"] = share(torch.mean(torch.abs(fake_I - I.to(fake_I.dtype)),
                                           dtype=torch.float32)) * opt.lambda_G1_L1
        if opt.lambda_G1_lpips > 0:
            lp_x, lp_y = fake_I, I_d
            if self._crop_active(h, w):
                # one c² window of both (the reference's dynamic_slice); the
                # slice's backward puts its cotangent into a zero canvas
                c = int(opt.lpips_crop)
                oy, ox = (int(v) for v in draws["lpips_crop"])
                lp_x = lp_x[:, oy:oy + min(c, h), ox:ox + min(c, w)]
                lp_y = lp_y[:, oy:oy + min(c, h), ox:ox + min(c, w)]
            aux["G_lpips"] = share(torch.mean(self.lpips_net(lp_x, lp_y, y_no_grad=True,
                                                             dtype=cd))) * opt.lambda_G1_lpips
        f_T_patch = gather_patches_from_coords(fake_T, coords, 32, mult)
        if opt.lambda_G2_L1 > 0:
            l1map = torch.abs(f_T_patch.float() - real_T) * valid[:, None, None, None]
            # per-image patch SUM, batch MEAN (reference .sum(1).mean())
            aux["G2_L1"] = torch.sum(torch.mean(l1map, dim=(1, 2, 3))) * opt.lambda_G2_L1 \
                / n_all
        if opt.lambda_G2_lpips > 0:
            lp = self.lpips_net(torch.cat([f_T_patch[..., 0:1], f_T_patch[..., 1:2]], 0),
                                torch.cat([real_T[..., 0:1], real_T[..., 1:2]], 0),
                                y_no_grad=True, dtype=cd)
            aux["G2_lpips"] = (masked_patch_sum(lp[:k], valid) / max(n_all, 1)
                               + masked_patch_sum(lp[k:], valid) / max(n_all, 1)) \
                * opt.lambda_G2_lpips
        if opt.lambda_G2_GAN > 0 and "D2" in self.model_names:
            t_for_gan = f_T_patch if opt.g2_gan_backprop else f_T_patch.detach()
            with torch.set_grad_enabled(bool(opt.g2_gan_backprop)):
                pf = self.netD2(d2_cond(t_for_gan, S_patch, fakeI_cond), update_stats=False)
                vec = per_sample_gan_loss(pf, True, mode, real_lbl) * opt.lambda_G2_GAN
                aux["G2_GAN"] = masked_patch_sum(vec, valid) / n_all
                if opt.lambda_G2_GAN_feat > 0 and opt.netD2 == "multiscale" \
                        and pred_real_T is not None and isinstance(pf, (list, tuple)) \
                        and len(pf[0]) > 1:
                    aux["G2_GAN_feat"] = share(feature_matching_loss(
                        pf, pred_real_T, opt.n_layers_D, opt.num_D_D2)) * opt.lambda_G2_GAN_feat
        if use_d3:
            lf = d3_logits(self.clip, self.d3_heads, fake_I)
            aux["G_D3"] = share(sum(torch.mean(softplus(-l)) for l in lf)) * opt.lambda_G1_GAN
            # D3's D objective, logged only, from the same fake pass
            d3_d = 0.0
            for a, b in zip(d3_real_logits, lf):
                d3_d = d3_d + torch.mean(softplus(-a)) + torch.mean(softplus(b.detach()))
            losses["D3_loss"] = share(d3_d) * 0.5 * opt.lambda_G1_GAN
        total = 0.0
        for v in aux.values():
            total = total + v
        self._update("G", total, lr)
        losses.update({key: v.detach() for key, v in aux.items()})
        losses["G_total"] = total.detach()
        if ranks > 1:
            # the ranks' shares summed: the global batch's losses, one collective
            names = sorted(losses)
            vals = self.dp.sum_(torch.stack([torch.as_tensor(losses[key], dtype=torch.float32,
                                                             device=self.device)
                                             for key in names]))
            losses = dict(zip(names, vals.unbind()))
        outputs = {"fake_I": fake_I_d, "fake_T": fake_T_d, "aug_real_I": aug_real_I,
                   "aug_fake_I": aug_fake_I}
        if "D" in self.model_names:
            outputs["pred_fake_I"] = pred_fake_I
        return losses, outputs

    def _penalty(self, net, real, fake, draws: Dict, key: str):
        """WGAN-GP's penalty on ``net`` (0 unless ``--gan_mode wgangp``), its
        D pass with batch statistics and the running ones kept."""
        if self.opt.gan_mode != "wgangp":
            return 0.0
        return gradient_penalty(lambda z: net(z, update_stats=False), real, fake,
                                alpha=draws[key])

    def _style_code(self, batch: Dict[str, torch.Tensor]):
        """The batch's style code for G (no gradient into it), or None."""
        code = batch.get("style_code") if self.opt.use_style_code else None
        return None if code is None else code.detach()

    def _split_g_out(self, out, M, M_T):
        """G's (visual, tactile) pair, or the one map of a zoo generator (its
        first ``image_nc`` channels visual) → (fake_I, fake_T) masked by M and
        M_T."""
        if torch.is_tensor(out):
            out = (out[..., :self.opt.image_nc], out[..., self.opt.image_nc:])
        vis, tac = out
        return vis * M.to(vis.dtype), tac * M_T.to(tac.dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward_eval(self, S: torch.Tensor, M: torch.Tensor, style_code=None):
        """The fp32 eval forward; a ``--normG batch`` G normalizes with its
        running statistics (the reference's ``netG_eval``).  fake_T comes out
        at the touch canvas, masked by M_T."""
        n, h, w, _ = S.shape
        pe = self._pe(n, h, w)
        x = torch.cat([S, pe], dim=-1) if pe is not None else S
        was_training = self.netG.training
        self.netG.eval()
        try:
            out = self.netG(x, style_code, dtype=torch.float32)
        finally:
            self.netG.train(was_training)
        M_T = M if self.mult == 1 else resize_nearest(M, (h * self.mult, w * self.mult))
        return self._split_g_out(out, M, M_T)

    def test(self) -> None:
        S = self._input["S"]
        M = self._input.get("M", torch.ones_like(S))
        fake_I, fake_T = self._forward_eval(S, M, self._style_code(self._input))
        self._outputs = {"fake_I": fake_I, "fake_T": fake_T}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _pred_fake_T_full(self) -> torch.Tensor:
        """D2 on the whole canvas, [fake_T, S, (aug_fake_I, M)] as in its
        patch conditioning, each in fake_T's dtype, S and (aug_I, M) resized
        bicubically to the touch canvas at ``T_resolution_multiplier`` > 1:
        the last scale's logit map, as the reference takes it (the map itself
        from a single-scale D2).  After :meth:`test`, which leaves no
        augmented image, fake_I stands in for it, as there.  Batch
        statistics, running ones kept; run only when visuals are asked for,
        outside the training step."""
        opt, out, inp = self.opt, self._outputs, self._input
        S = inp["S"]
        fake_T = out["fake_T"]
        size = tuple(fake_T.shape[1:3])
        parts = [fake_T]
        if opt.use_cGAN_G2:
            if opt.use_cGAN_G2_S:
                parts.append((S if self.mult == 1 else resize_bicubic(S, size)).to(fake_T.dtype))
            if opt.use_cGAN_G2_I:
                aug_I = out.get("aug_fake_I", out["fake_I"])
                M = inp.get("M", torch.ones_like(S))
                i4 = torch.cat([aug_I, M.to(aug_I.dtype)], -1)
                if self.mult != 1:
                    i4 = resize_bicubic(i4, size)
                parts.append(i4.to(fake_T.dtype))
        pred = self.netD2(torch.cat(parts, -1), update_stats=False)
        return pred[-1][-1] if isinstance(pred, (list, tuple)) else pred

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
        if self.isTrain and "D2" in self.model_names and self.pred_fake_T_full_visual:
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
        """The 8 metrics per sample, averaged over the batch: on the batched
        path, or with ``--eval_mode legacy`` the reference's per-metric loop
        on each sample's valid patches (cut by K2).  The test phase scores the
        test coord set (keys ``metric_<name>``); in training the train coord
        set (``metric_train_<name>``) and the val set (``metric_<name>``)."""
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
            fake_T = self._outputs["fake_T"]
            per_sample = []
            for i in range(n):
                if self.opt.eval_mode == "legacy":
                    v = valid[i]
                    if not bool(v.any()):
                        continue
                    fake_T_patch = gather_patches_from_coords(fake_T[i:i + 1],
                                                              coords[i:i + 1], 32, self.mult)
                    per_sample.append(compute_evaluation_metrics(
                        inp["I"][i:i + 1], fake_I[i:i + 1], real_T[i][v], fake_T_patch[v],
                        eval_metrics=self.eval_metrics, lpips_net=self.lpips_net,
                        inception=self.inception, prefix=prefix))
                    continue
                per_sample.extend(d for d in compute_evaluation_metrics_batched(
                    inp["I"][i:i + 1], fake_I[i:i + 1], fake_T[i:i + 1],
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

    def _converters(self, name: str):
        """(state dict → (flax params, flax stats), flax params → state dict,
        flax stats → state dict) for network ``name``, by its family."""
        net = getattr(self, f"net{name}")
        if isinstance(net, CustomUNet):
            return (lambda sd: (torch_to_unet_params(sd), torch_to_unet_stats(sd)),
                    unet_params_to_torch, unet_stats_to_torch)
        if isinstance(net, (StyleGAN2Generator, StyleGAN2Discriminator)):
            return (lambda sd: (torch_to_stylegan2_params(sd), {}), stylegan2_params_to_torch,
                    None)
        if name == "G":
            return torch_to_resnet_params, resnet_params_to_torch, resnet_stats_to_torch
        return torch_to_d_params, d_params_to_torch, d_stats_to_torch

    def save_networks(self, tag: str, ckpt_dir: Optional[str] = None) -> None:
        """``<tag>_net_<Name>.msgpack`` per network, and ``<tag>_opt_<Name>
        .msgpack`` with its Adam state in training, under ``ckpt_dir``
        (default ``<checkpoints_dir>/<name>``)."""
        for name, net in self.nets().items():
            to_flax = self._converters(name)[0]
            params, stats = to_flax(net.state_dict())
            opt_state = None
            if name in self.adam:
                a = self.adam[name]
                opt_state = adam_state_to_flax(a.count, a.mu, a.nu,
                                               lambda sd: to_flax(sd)[0])
            save_net(ckpt_dir or self._ckpt_dir(False), tag, name, params, stats, opt_state)

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
