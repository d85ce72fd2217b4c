"""The evaluation metrics' names and the legacy per-metric evaluation
(``vts_tpu/metrics/evaluate.py``, ``--eval_mode legacy``); the default
batched evaluation is :mod:`vts_torch.metrics.evaluate_batch`.

The legacy evaluation keeps the reference's quirks (model_utils.py:431-561):

  * the visual images are rescaled to [0, 1] with the real image's min/max
    and the fake is clamped;
  * the fake tactile stack is clamped to [0, 1] before the T metrics, though
    touch lies in [-1, 1];
  * T_LPIPS resizes the patches to 224² by nearest neighbour and runs LPIPS
    on gx and on gy apart (one channel each), summing the two means;
  * T_SIFID tiles each channel to RGB at 299² and averages gx's and gy's
    SIFIDs, the tactile values entering Inception untransformed; SIFID
    fits its Gaussians on the host (float64 covariances) to block-0
    features at the input's own resolution;
  * T_MSE is one mean over all valid patches;
  * LPIPS runs in chunks of 16 pairs, so the K1 launches of T_LPIPS are at
    (≤ 16·2, 224², ·).

``T_FID`` (:mod:`vts_torch.metrics.tactile_fid`) is computed when asked
for; it is not among :data:`DEFAULT_EVAL_METRICS`.  Keys are
``metric_{prefix}{name}``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..losses.normal import surface_normal_angle_error
from ..ops.normal import compute_normal
from ..ops.resize import resize_nearest
from .frechet import frechet_distance, gaussian_stats
from .psnr_ssim import psnr, ssim
from .tactile_fid import tactile_patch_fid

DEFAULT_EVAL_METRICS = (
    "I_SIFID", "I_LPIPS", "I_PSNR", "I_SSIM",
    "T_SIFID", "T_LPIPS", "T_AE", "T_MSE",
)

LPIPS_CHUNK = 16


def lpips_chunked(lpips_net, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N,) LPIPS distances, 16 pairs at a time."""
    return torch.cat([lpips_net(x[i:i + LPIPS_CHUNK], y[i:i + LPIPS_CHUNK])
                      for i in range(0, x.shape[0], LPIPS_CHUNK)])


def sifid(inception, real: torch.Tensor, fake: torch.Tensor,
          normalize_input: bool = True) -> List[float]:
    """Single-image FID of each (real, fake) pair: a Gaussian fitted on the
    host to each image's block-0 features over its spatial positions."""
    feats = [inception(t, normalize_input).cpu().numpy() for t in (real, fake)]
    return [frechet_distance(*gaussian_stats(a.reshape(-1, a.shape[-1])),
                             *gaussian_stats(b.reshape(-1, b.shape[-1])))
            for a, b in zip(*feats)]


@torch.no_grad()
def compute_evaluation_metrics(real_I: torch.Tensor, fake_I: torch.Tensor,
                               real_T: torch.Tensor = None, fake_T: torch.Tensor = None,
                               eval_metrics: Sequence[str] = DEFAULT_EVAL_METRICS,
                               lpips_net=None, inception=None,
                               prefix: str = "") -> Dict[str, float]:
    """One sample's metrics: real_I, fake_I (1, H, W, 3); real_T, fake_T the
    valid patches (Kv, pc, pc, 2)."""
    out: Dict[str, float] = {}

    def key(name):
        return f"metric_{prefix}{name}"

    if "I_LPIPS" in eval_metrics:
        out[key("I_LPIPS")] = float(torch.mean(lpips_chunked(lpips_net, real_I, fake_I)))
    i_min, i_max = torch.min(real_I), torch.max(real_I)
    real_In = (real_I - i_min) / (i_max - i_min)
    fake_In = torch.clamp((fake_I - i_min) / (i_max - i_min), 0.0, 1.0)
    if "I_SIFID" in eval_metrics:
        out[key("I_SIFID")] = float(np.mean(sifid(inception, real_In, fake_In)))
    if "I_PSNR" in eval_metrics:
        out[key("I_PSNR")] = float(psnr(real_In, fake_In, data_range=1.0))
    if "I_SSIM" in eval_metrics:
        out[key("I_SSIM")] = float(ssim(real_In, fake_In, data_range=1.0))
    if real_T is None or fake_T is None:
        return out

    fake_Tc = torch.clamp(fake_T, 0.0, 1.0)       # reference quirk (model_utils.py:521)
    if "T_LPIPS" in eval_metrics:
        r224 = resize_nearest(real_T, (224, 224))
        f224 = resize_nearest(fake_Tc, (224, 224))
        gx = torch.mean(lpips_chunked(lpips_net, f224[..., 0:1], r224[..., 0:1]))
        gy = torch.mean(lpips_chunked(lpips_net, f224[..., 1:2], r224[..., 1:2]))
        out[key("T_LPIPS")] = float(gx + gy)
    if "T_AE" in eval_metrics:
        ae = surface_normal_angle_error(compute_normal(real_T, scale_nz=1.0),
                                        compute_normal(fake_Tc, scale_nz=1.0), mode="evaluate")
        out[key("T_AE")] = float(torch.mean(ae))
    if "T_FID" in eval_metrics:
        out[key("T_FID")] = tactile_patch_fid(real_T.cpu().numpy(), fake_Tc.cpu().numpy())
    if "T_SIFID" in eval_metrics:
        r299 = resize_nearest(real_T, (299, 299))
        f299 = resize_nearest(fake_Tc, (299, 299))
        gx, gy = (np.asarray(sifid(inception, r299[..., c:c + 1].expand(-1, -1, -1, 3),
                                   f299[..., c:c + 1].expand(-1, -1, -1, 3),
                                   normalize_input=False)) for c in (0, 1))
        out[key("T_SIFID")] = float(np.mean((gx + gy) / 2.0))
    if "T_MSE" in eval_metrics:
        out[key("T_MSE")] = float(torch.mean((real_T - fake_Tc) ** 2))
    return out
