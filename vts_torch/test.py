"""Inference / evaluation entry point (``vts_tpu/test.py``).

Loads the tagged generator checkpoint, runs the fp32 eval forward per
sample, computes the 8 metrics and pickles them to
``<results_dir>/<name>/<phase>_<epoch>/eval_metrics[_i].pkl``, and writes the
HTML gallery there: per sample its visuals as PNGs, the raw tactile field
(``*_fake_gxgy_raw.npz``) and the patch coords (``*_patch_coords.json``),
and ``index.html``.  On CUDA the run turns TF32 off (cuDNN convs and
matmuls in full fp32).

Run:  python -m vts_torch.test --model sinskit --epoch best \\
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
from .device import resolve_device
from .models import create_model
from .utils.html import HTML
from .utils.visualizer import save_images


def save_metrics(web_dir: str, metrics: Dict[str, float], index=None) -> str:
    os.makedirs(web_dir, exist_ok=True)
    path = os.path.join(web_dir, "eval_metrics.pkl" if index is None
                        else f"eval_metrics_{index}.pkl")
    with open(path, "wb") as f:
        pickle.dump(metrics, f)
    return path


def test(argv=None, opt=None) -> List[Dict[str, float]]:
    if opt is None:
        opt = TestOptions().parse(argv)
    device = resolve_device(opt.device)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dataset = create_dataset(opt)
        model = create_model(opt)
        web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.epoch}")
        webpage = HTML(web_dir, f"Experiment = {opt.name}, Phase = {opt.phase}, "
                                f"Epoch = {opt.epoch}")
        all_metrics: List[Dict[str, float]] = []
        for i, data in enumerate(dataset):
            if i >= opt.num_test:
                break
            if i == 0:
                model.setup(data)
                model.load_networks(opt.epoch)
            model.set_input(data)
            model.test()
            metrics = model.compute_metrics(phase="test")
            save_metrics(web_dir, metrics, index=i)
            all_metrics.append(metrics)
            visuals = model.get_current_visuals()
            name = getattr(dataset.dataset, "name", f"sample_{i}")
            save_images(webpage, visuals, f"{name}_{i}.png", width=opt.display_winsize,
                        patch_coords=np.asarray(data.get("full_T_coords",
                                                         np.zeros((1, 0, 4))))[0],
                        image_height=visuals["real_S"].shape[1],
                        save_raw_arr_vis=opt.save_raw_arr_vis)
            print(f"processed sample {i}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if all_metrics:
            keys = set().union(*all_metrics)
            mean_metrics = {k: float(np.mean([m[k] for m in all_metrics if k in m]))
                            for k in keys}
            save_metrics(web_dir, mean_metrics)
            print("mean metrics: " + " ".join(f"{k}={v:.4f}"
                                              for k, v in sorted(mean_metrics.items())))
        webpage.save()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return all_metrics


if __name__ == "__main__":
    test()
