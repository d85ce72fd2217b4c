"""Batched evaluation of the 8 metrics: one device pass, one host fetch.

Counterpart of ``vts_tpu/metrics/evaluate_batch.py``, quirks kept:
  * the visual images are rescaled with the *real* image's per-sample
    min/max and the fake is clamped to [0, 1];
  * the fake tactile patches are clipped to [0, 1] before the T metrics;
  * SIFID comes back from the device as fp32 Gaussian moments, and the
    Fréchet distance (``scipy.linalg.sqrtm``) runs on the host in float64.

The fake tactile patches are cut from the canvas at the data's coords by
kernel K2 (:func:`vts_torch.ops.patch.gather_patches_from_coords`), and the
LPIPS backbone runs kernel K1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..losses.lpips import LPIPS
from ..losses.normal import surface_normal_angle_error
from ..ops.normal import compute_normal
from ..ops.patch import gather_patches_from_coords
from ..ops.resize import resize_nearest
from .evaluate import DEFAULT_EVAL_METRICS
from .frechet import frechet_distance
from .inception import InceptionBlock0
from .psnr_ssim import psnr, ssim


def _moments(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, h, w, C) features → per-sample (mu (N, C), sigma (N, C, C)) over
    the spatial positions, fp32, with np.cov's n-1 normalization."""
    x = feats.float().reshape(feats.shape[0], -1, feats.shape[-1])
    n = x.shape[1]
    mu = torch.mean(x, dim=1)
    xc = x - mu[:, None, :]
    sigma = torch.matmul(xc.transpose(1, 2), xc) / max(n - 1, 1)
    return mu, sigma


@torch.no_grad()
def _device_pass(lpips_net: LPIPS, inception: InceptionBlock0, real_I, fake_I, fake_T,
                 coords, real_T, valid, mult: int,
                 eval_metrics: Tuple[str, ...]) -> Dict:
    """All device-side metric work for a batch.  Shapes: real_I/fake_I
    (N, H, W, 3); fake_T (N, Hm, Wm, 2); coords (N, K, 8); real_T
    (N, K, pc, pc, 2); valid (N, K) float."""
    out: Dict = {}
    n, k, pc = real_T.shape[0], real_T.shape[1], real_T.shape[2]
    cnt = torch.clamp_min(torch.sum(valid, dim=1), 1.0)

    if "I_LPIPS" in eval_metrics:
        out["I_LPIPS"] = lpips_net(real_I, fake_I)

    i_min = torch.amin(real_I, dim=(1, 2, 3), keepdim=True)
    i_max = torch.amax(real_I, dim=(1, 2, 3), keepdim=True)
    real_In = (real_I - i_min) / (i_max - i_min)
    fake_In = torch.clamp((fake_I - i_min) / (i_max - i_min), 0.0, 1.0)

    if "I_SIFID" in eval_metrics:
        out["I_SIFID_moments"] = (*_moments(inception(real_In, True)),
                                  *_moments(inception(fake_In, True)))
    if "I_PSNR" in eval_metrics:
        out["I_PSNR"] = torch.stack([psnr(real_In[i:i + 1], fake_In[i:i + 1])
                                     for i in range(n)])
    if "I_SSIM" in eval_metrics:
        out["I_SSIM"] = torch.stack([ssim(real_In[i:i + 1], fake_In[i:i + 1])
                                     for i in range(n)])

    # ---- tactile ----
    fake_T_patch = gather_patches_from_coords(fake_T, coords, 32, mult)   # (N·K, pc, pc, 2)
    fT = torch.clamp(fake_T_patch, 0.0, 1.0)   # reference quirk (model_utils.py:521)
    rT = real_T.reshape(n * k, pc, pc, 2)

    if "T_LPIPS" in eval_metrics:
        r224 = resize_nearest(rT, (224, 224))
        f224 = resize_nearest(fT, (224, 224))
        gx = lpips_net(f224[..., 0:1], r224[..., 0:1]).reshape(n, k)
        gy = lpips_net(f224[..., 1:2], r224[..., 1:2]).reshape(n, k)
        out["T_LPIPS"] = (torch.sum(gx * valid, dim=1) + torch.sum(gy * valid, dim=1)) / cnt

    if "T_AE" in eval_metrics:
        fn_ = compute_normal(fT, scale_nz=1.0)
        rn_ = compute_normal(rT, scale_nz=1.0)
        ae = surface_normal_angle_error(rn_, fn_, mode="evaluate")
        per_patch = torch.mean(ae.reshape(n, k, -1), dim=-1)
        out["T_AE"] = torch.sum(per_patch * valid, dim=1) / cnt

    if "T_SIFID" in eval_metrics:
        r299 = resize_nearest(rT, (299, 299))
        f299 = resize_nearest(fT, (299, 299))
        moms = []
        for ch in (0, 1):
            tile3 = lambda x: x[..., ch:ch + 1].expand(-1, -1, -1, 3)
            moms.append((_moments(inception(tile3(r299), False)),
                         _moments(inception(tile3(f299), False))))
        out["T_SIFID_moments"] = moms

    if "T_MSE" in eval_metrics:
        per_patch = torch.mean((real_T - fT.reshape(real_T.shape)) ** 2, dim=(2, 3, 4))
        out["T_MSE"] = torch.sum(per_patch * valid, dim=1) / cnt
    return out


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return type(tree)(_to_host(v) for v in tree)


def compute_evaluation_metrics_batched(
    real_I, fake_I, fake_T, coords, real_T, valid,
    eval_metrics: Sequence[str] = DEFAULT_EVAL_METRICS,
    lpips_net: LPIPS = None,
    inception: InceptionBlock0 = None,
    mult: int = 1,
    prefix: str = "",
) -> List[Dict[str, float]]:
    """Per-sample metric dicts (keys ``metric_{prefix}{name}``) for a batch of
    device tensors (see :func:`_device_pass`); a sample with no valid patch
    gives {}."""
    valid_f = valid.float()
    host = _to_host(_device_pass(lpips_net, inception, real_I, fake_I, fake_T, coords,
                                 real_T, valid_f, int(mult), tuple(eval_metrics)))
    n, k = valid.shape
    valid_np = valid_f.cpu().numpy() > 0
    f64 = lambda a: a.astype(np.float64)
    results: List[Dict[str, float]] = []
    for i in range(n):
        if valid_np[i].sum() == 0:
            results.append({})
            continue
        res: Dict[str, float] = {}
        keyf = lambda name: f"metric_{prefix}{name}"
        for name in ("I_LPIPS", "I_PSNR", "I_SSIM", "T_LPIPS", "T_AE", "T_MSE"):
            if name in host:
                res[keyf(name)] = float(host[name][i])
        if "I_SIFID_moments" in host:
            mr, sr, mf, sf = host["I_SIFID_moments"]
            res[keyf("I_SIFID")] = frechet_distance(f64(mr[i]), f64(sr[i]),
                                                    f64(mf[i]), f64(sf[i]))
        if "T_SIFID_moments" in host:
            vals = []
            for (mrs, srs), (mfs, sfs) in host["T_SIFID_moments"]:
                vals.append(np.asarray([
                    frechet_distance(f64(mrs[i * k + j]), f64(srs[i * k + j]),
                                     f64(mfs[i * k + j]), f64(sfs[i * k + j]))
                    for j in range(k) if valid_np[i, j]]))
            res[keyf("T_SIFID")] = float(np.mean((vals[0] + vals[1]) / 2.0))
        results.append(res)
    return results
