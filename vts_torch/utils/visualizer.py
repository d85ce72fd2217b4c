"""Loss and metric logging and the HTML galleries (``vts_tpu/utils/visualizer.py``):
the console lines and ``checkpoints/<name>/loss_log.txt`` of
``print_current_losses`` and ``print_current_metrics``, the per-epoch
``results/<name>/<phase>_<epoch>/eval_metrics.pkl`` of
``save_current_metrics``, the training gallery under
``checkpoints/<name>/web/`` (``display_current_results``) and the test
gallery's per-sample files (:func:`save_images`), in the reference's
formats.  The live dashboard and wandb are not ported."""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Dict

import numpy as np

from .html import HTML
from .image import save_image, tensor2im


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        os.makedirs(os.path.dirname(self.log_name), exist_ok=True)
        with open(self.log_name, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    def _log(self, msg: str) -> str:
        print(msg)
        with open(self.log_name, "a") as f:
            f.write(msg + "\n")
        return msg

    def display_current_results(self, visuals: Dict[str, np.ndarray], epoch: int) -> None:
        """``web/images/epoch<e>_<label>.png`` for each visual, and
        ``web/index.html`` with the last 8 epochs' rows."""
        for label, image in visuals.items():
            save_image(tensor2im(image), os.path.join(self.img_dir,
                                                      f"epoch{epoch:03d}_{label}.png"))
        page = HTML(self.web_dir, f"Experiment name = {self.name}")
        for e in range(epoch, max(0, epoch - 8), -1):
            page.add_header(f"epoch [{e}]")
            ims = [f"images/epoch{e:03d}_{label}.png" for label in visuals]
            page.add_images(ims, list(visuals), ims, width=self.opt.display_winsize)
        page.save()

    def print_current_losses(self, epoch: int, iters: int, losses: Dict[str, float],
                             t_comp: float, t_data: float) -> str:
        msg = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
        return self._log(msg + " ".join(f"{k}: {v:.3f}" for k, v in losses.items()))

    def print_current_metrics(self, epoch: int, metrics: Dict[str, float]) -> str:
        return self._log(f"(epoch: {epoch}) " + " ".join(f"{k}: {v:.4f}"
                                                         for k, v in metrics.items()))

    def save_current_metrics(self, epoch, metrics: Dict[str, float]) -> str:
        d = os.path.join(self.opt.results_dir, self.name, f"{self.opt.phase}_{epoch}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "eval_metrics.pkl")
        with open(path, "wb") as f:
            pickle.dump(metrics, f)
        return path


def save_images(webpage: HTML, visuals: Dict[str, np.ndarray], image_path: str, width: int,
                patch_coords: np.ndarray, image_height: int, save_raw_arr_vis: bool) -> None:
    """One sample's row of the test gallery: ``<name>_<label>.png`` per visual,
    the raw tactile field as ``<name>_fake_gxgy_raw.npz`` (and ``.npy`` under
    ``save_raw_arr_vis``), and ``<name>_patch_coords.json`` with the y-flipped
    coords the reference's website pipeline reads."""
    image_dir = webpage.get_image_dir()
    name = os.path.splitext(os.path.basename(image_path))[0]
    webpage.add_header(name)
    ims = []
    for label, im_data in visuals.items():
        image_name = f"{name}_{label}.png"
        save_image(tensor2im(im_data), os.path.join(image_dir, image_name))
        ims.append(image_name)
    if "fake_gx" in visuals and "fake_gy" in visuals:
        raw = {"gx": np.squeeze(visuals["fake_gx"]), "gy": np.squeeze(visuals["fake_gy"])}
        np.savez(os.path.join(image_dir, f"{name}_fake_gxgy_raw.npz"), **raw)
        if save_raw_arr_vis:
            np.save(os.path.join(image_dir, f"{name}_fake_gxgy_raw.npy"),
                    np.stack([raw["gx"], raw["gy"]]))
    coords = np.asarray(patch_coords).tolist()             # (K, 4) ROIs (x, y, h, w)
    flipped = [[c[0], image_height - c[1] - c[3], *c[2:]] for c in coords]
    with open(os.path.join(image_dir, f"{name}_patch_coords.json"), "w") as f:
        json.dump({"coords": coords, "coords_y_flipped": flipped}, f)
    webpage.add_images(ims, list(visuals), ims, width=width)
