"""Inference / evaluation entry point (``vts_tpu/test.py``).

Deterministic single-sample evaluation, as in the reference: whatever was
passed, the driver runs at batch 1, in order (``serial_batches``), with no
flip, no loader threads, no device cache of the samples (each is visited
once) and no dashboard.  It loads the tagged generator
checkpoint, runs the fp32 eval forward per sample (``--dtype bfloat16``
does not change it: the reference's eval forward is fp32 too), computes
the 8 metrics and pickles them to
``<results_dir>/<name>/<phase>_<epoch>/eval_metrics[_i].pkl``, and writes the
HTML gallery there: per sample its visuals as PNGs, the raw tactile field
(``*_fake_gxgy_raw.npz``) and the patch coords (``*_patch_coords.json``),
and ``index.html``.  When the samples carry a ``material_index`` (the skit
dataset), the mean of each metric over each material's samples goes to
``eval_metrics_per_material.pkl`` there, keyed by material name, with one
printed line per material.  An edited sketch (no visual image, no touch
records) has no metrics: its gallery and raw tactile field are written and
``eval_metrics.pkl`` holds ``{}``, as in the reference.  On CUDA the run
turns TF32 off (cuDNN convs and matmuls in full fp32).  With
``--multihost`` the process joins its ranks first (as the reference's test
driver runs ``apply_platform``): every process tests the whole set, and
only rank 0 writes.

Run:  python -m vts_torch.test --model sinskit|skit --epoch best \\
          --dataroot synthetic://smoke?size=1800 [--device cuda|cpu]
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np
import torch

from .config import TestOptions
from .data import create_dataset
from .device import describe, resolve_device
from .models import create_model
from .platform import init_multihost, is_lead, leave
from .utils.html import HTML
from .utils.visualizer import save_images


def save_metrics(web_dir: str, metrics: Dict[str, float], index=None) -> str:
    os.makedirs(web_dir, exist_ok=True)
    path = os.path.join(web_dir, "eval_metrics.pkl" if index is None
                        else f"eval_metrics_{index}.pkl")
    with open(path, "wb") as f:
        pickle.dump(metrics, f)
    return path


def mean_metrics(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """The mean of each metric over the rows that have it."""
    keys = set().union(*rows)
    return {k: float(np.mean([m[k] for m in rows if k in m])) for k in keys}


def save_per_material(web_dir: str, all_metrics: List[Dict[str, float]],
                      sample_material: List[int], names) -> Dict[str, Dict[str, float]]:
    """``eval_metrics_per_material.pkl``: {material name: the mean of each
    metric over its samples}, one line printed per material."""
    per_mat: Dict[str, Dict[str, float]] = {}
    for mat in sorted({m for m in sample_material if m >= 0}):
        rows = [met for met, mi in zip(all_metrics, sample_material) if mi == mat]
        label = names[mat] if mat < len(names) else str(mat)
        per_mat[label] = mean_metrics(rows)
        print(f"material [{label}] ({len(rows)} samples): " +
              " ".join(f"{k}={v:.4f}" for k, v in sorted(per_mat[label].items())))
    with open(os.path.join(web_dir, "eval_metrics_per_material.pkl"), "wb") as f:
        pickle.dump(per_mat, f)
    return per_mat


def test(argv=None, opt=None) -> List[Dict[str, float]]:
    if opt is None:
        opt = TestOptions().parse(argv)
    opt.num_threads = 0
    opt.cache_data_device = False       # each sample is visited once
    opt.batch_size = 1
    opt.serial_batches = True
    opt.no_flip = True
    opt.display_id = 0
    joined = init_multihost(opt)
    lead = is_lead()
    device = resolve_device(opt.device)
    print(f"[device] {opt.name} tests on {describe(device)}", flush=True)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dataset = create_dataset(opt)
        model = create_model(opt)
        web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.epoch}")
        webpage = HTML(web_dir, f"Experiment = {opt.name}, Phase = {opt.phase}, "
                                f"Epoch = {opt.epoch}") if lead else None
        all_metrics: List[Dict[str, float]] = []
        sample_material: List[int] = []
        for i, data in enumerate(dataset):
            if i >= opt.num_test:
                break
            if i == 0:
                model.setup(data)
                model.load_networks(opt.epoch)
            model.set_input(data)
            model.test()
            metrics = model.compute_metrics(phase="test")
            if lead:
                save_metrics(web_dir, metrics, index=i)
            all_metrics.append(metrics)
            mat = data.get("material_index")
            sample_material.append(-1 if mat is None else int(np.asarray(mat).reshape(-1)[0]))
            visuals = model.get_current_visuals()
            name = getattr(dataset.dataset, "name", f"sample_{i}")
            if lead:
                save_images(webpage, visuals, f"{name}_{i}.png", width=opt.display_winsize,
                            patch_coords=np.asarray(data.get("full_T_coords",
                                                             np.zeros((1, 0, 4))))[0],
                            image_height=visuals["real_S"].shape[1],
                            save_raw_arr_vis=opt.save_raw_arr_vis)
            print(f"processed sample {i}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if all_metrics:
            means = mean_metrics(all_metrics)
            if lead:
                save_metrics(web_dir, means)
            print("mean metrics: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
        if lead and any(m >= 0 for m in sample_material):
            save_per_material(web_dir, all_metrics, sample_material,
                              getattr(dataset.dataset, "materials", []))
        if lead:
            webpage.save()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        if joined:
            leave()
    return all_metrics


if __name__ == "__main__":
    test()
