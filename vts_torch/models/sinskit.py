"""SinSKIT — the flagship sketch→(image, touch) model, eval surface
(``vts_tpu/models/sinskit.py``): ``setup`` (seeded init), ``set_input``,
``test`` (the fp32 eval forward), ``compute_metrics`` (batched 8-metric
evaluation), ``save_networks`` / ``load_networks``.

The training step, the legacy per-metric evaluation, visuals, style codes
and ``T_resolution_multiplier > 1`` are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..losses.lpips import LPIPS, init_lpips_params
from ..metrics.evaluate import DEFAULT_EVAL_METRICS
from ..metrics.evaluate_batch import compute_evaluation_metrics_batched
from ..metrics.inception import InceptionBlock0, init_inception_params
from ..networks import define_G
from ..networks.positional import positional_encoding
from ..utils.convert_jax import torch_to_unet_params, unet_params_to_torch
from .base import load_net, save_net

_PATCH_STACKS = ("T_images", "I_masks", "T_valid")


class SinSKITModel:
    """Lifecycle as in the reference: setup → set_input → test →
    compute_metrics; save/load_networks."""

    def __init__(self, opt):
        if opt.isTrain:
            raise NotImplementedError("sinskit training is not ported yet (eval only)")
        if int(opt.T_resolution_multiplier) != 1:
            raise NotImplementedError("T_resolution_multiplier > 1 is not ported yet")
        if opt.eval_mode != "batched":
            raise NotImplementedError("--eval_mode legacy is not ported yet")
        self.opt = opt
        self.device = resolve_device(opt.device)
        self.mult = 1
        pe_nc = 2 * opt.positional_encoding_dim if opt.use_positional_encoding else 0
        self.input_nc = opt.sketch_nc + pe_nc
        self.netG = define_G(opt, self.input_nc, opt.image_nc + opt.touch_nc)
        self.lpips_net = LPIPS(init_lpips_params(0)).to(self.device)
        self.inception = InceptionBlock0(init_inception_params(0)).to(self.device)
        self.eval_metrics = list(DEFAULT_EVAL_METRICS)
        self._input: Dict[str, torch.Tensor] = {}
        self._outputs: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def setup(self, example_batch=None) -> None:
        """Seeded init of G (``--seed``), then onto the device in eval mode."""
        gen = torch.Generator().manual_seed(int(self.opt.seed))
        self.netG.reset_parameters(gen)
        self.netG.to(self.device).eval()
        n_params = sum(p.numel() for p in self.netG.parameters())
        print(f"[sinskit] netG params: {n_params / 1e6:.3f} M")

    def _pe(self, n: int, h: int, w: int):
        opt = self.opt
        if not opt.use_positional_encoding:
            return None
        return positional_encoding(h, w, mode=opt.positional_encoding_mode,
                                   dim=opt.positional_encoding_dim, batch=n,
                                   device=self.device)

    # ------------------------------------------------------------------
    def set_input(self, batch: Dict[str, np.ndarray]) -> None:
        """Batch of numpy arrays → device tensors; S and I are masked by M, the
        patch stacks fold (N, K, …) → (N·K, …) and T is masked by I_masks."""
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
        if "T_images" in dev:
            dev["T_images"] = dev["T_images"] * dev["I_masks"]
        self._input = dev

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
    def compute_metrics(self, phase: str = "test") -> Dict[str, float]:
        """The 8 metrics on the batched path over the test coord set,
        averaged over the batch (keys ``metric_<name>``)."""
        if phase != "test":
            raise NotImplementedError("only the test-phase metrics are ported yet")
        fake_I = self._outputs["fake_I"]
        inp = self._input
        res: Dict[str, float] = {}
        n = fake_I.shape[0]
        if "T_coords" in inp and "I" in inp:
            coords = inp["T_coords"].reshape(n, -1, 8)
            valid = inp["T_valid"].reshape(n, -1) > 0
            real_T = inp["T_images"].reshape((n, -1) + tuple(inp["T_images"].shape[-3:]))
            per_sample = []
            for i in range(n):
                per_sample.extend(d for d in compute_evaluation_metrics_batched(
                    inp["I"][i:i + 1], fake_I[i:i + 1], self._outputs["fake_T"][i:i + 1],
                    coords[i:i + 1], real_T[i:i + 1], valid[i:i + 1],
                    eval_metrics=self.eval_metrics, lpips_net=self.lpips_net,
                    inception=self.inception, mult=self.mult) if d)
            if per_sample:
                keys = set().union(*per_sample)
                res = {k: float(np.mean([m[k] for m in per_sample if k in m]))
                       for k in keys}
        return res

    # ------------------------------------------------------------------
    def _ckpt_dir(self, for_load: bool) -> str:
        exp = getattr(self.opt, "pretrained_name", None) if for_load else None
        return f"{self.opt.checkpoints_dir}/{exp or self.opt.name}"

    def save_networks(self, tag: str) -> None:
        save_net(self._ckpt_dir(False), tag, "G",
                 torch_to_unet_params(self.netG.state_dict()))

    def load_networks(self, tag: str) -> None:
        load_net(self._ckpt_dir(True), tag, "G", self.netG, unet_params_to_torch)
