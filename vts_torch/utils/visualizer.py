"""Loss and metric logging and the HTML galleries (``vts_tpu/utils/visualizer.py``):
the console lines and ``checkpoints/<name>/loss_log.txt`` of
``print_current_losses`` and ``print_current_metrics``, the per-epoch
``results/<name>/<phase>_<epoch>/eval_metrics.pkl`` of
``save_current_metrics``, the training gallery under
``checkpoints/<name>/web/`` (``display_current_results``) and the test
gallery's per-sample files (:func:`save_images`), in the reference's
formats.  Two optional sinks, as in the reference: the live dashboard
(:mod:`vts_torch.utils.live`, on with ``--display_id`` > 0) gets the losses,
metrics, epoch times and image names; wandb (``--use_wandb``, project
"SKIT", ``l_``/``m_`` prefixes) when it is installed, else a note."""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Dict

import numpy as np

from .html import HTML
from .image import save_image, tensor2im
from .live import maybe_start


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.wandb = None
        if opt.use_wandb:
            try:
                import wandb
                self.wandb = wandb.run or wandb.init(project="SKIT", name=opt.name,
                                                     config=vars(opt))
            except ImportError:
                print("[visualizer] wandb requested but not installed — skipping")
        self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        os.makedirs(os.path.dirname(self.log_name), exist_ok=True)
        with open(self.log_name, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")
        self.dashboard = maybe_start(opt, self.img_dir)

    def _log(self, msg: str) -> str:
        print(msg)
        with open(self.log_name, "a") as f:
            f.write(msg + "\n")
        return msg

    def close(self) -> None:
        """Stop the dashboard's server, when there is one."""
        if self.dashboard:
            self.dashboard.close()
            print(f"[visualizer] live dashboard at {self.dashboard.url} closed")
            self.dashboard = None

    def display_current_results(self, visuals: Dict[str, np.ndarray], epoch: int) -> None:
        """``web/images/epoch<e>_<label>.png`` for each visual, and
        ``web/index.html`` with the last 8 epochs' rows."""
        for label, image in visuals.items():
            save_image(tensor2im(image), os.path.join(self.img_dir,
                                                      f"epoch{epoch:03d}_{label}.png"))
        if self.dashboard:
            self.dashboard.push_images([f"epoch{epoch:03d}_{label}.png" for label in visuals])
        page = HTML(self.web_dir, f"Experiment name = {self.name}")
        for e in range(epoch, max(0, epoch - 8), -1):
            page.add_header(f"epoch [{e}]")
            ims = [f"images/epoch{e:03d}_{label}.png" for label in visuals]
            page.add_images(ims, list(visuals), ims, width=self.opt.display_winsize)
        page.save()

    def print_current_losses(self, epoch: int, iters: int, losses: Dict[str, float],
                             t_comp: float, t_data: float) -> str:
        msg = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
        msg = self._log(msg + " ".join(f"{k}: {v:.3f}" for k, v in losses.items()))
        if self.wandb:
            self.wandb.log({f"l_{k}": v for k, v in losses.items()})
        if self.dashboard:
            self.dashboard.push_losses(epoch, iters, losses)
        return msg

    def print_current_metrics(self, epoch: int, metrics: Dict[str, float]) -> str:
        msg = self._log(f"(epoch: {epoch}) " + " ".join(f"{k}: {v:.4f}"
                                                        for k, v in metrics.items()))
        if self.wandb:
            self.wandb.log({k.replace("metric_", "m_"): v for k, v in metrics.items()})
        if self.dashboard:
            self.dashboard.push_metrics(epoch, metrics)
        return msg

    def plot_epoch_time(self, epoch: int, seconds: float) -> None:
        """An epoch's wall time, to wandb and the dashboard."""
        if self.wandb:
            self.wandb.log({"epoch_time_s": seconds, "epoch": epoch})
        if self.dashboard:
            self.dashboard.push_epoch_time(epoch, seconds)

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
    the raw tactile field as ``<name>_fake_gxgy_raw.npz`` (and under
    ``save_raw_arr_vis`` the (2, H, W) ``.npy`` and the (H, W, 3) float32
    ``.exr`` of gx, gy, 0 for rendering tools), and ``<name>_patch_coords.json`` with the y-flipped
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
            _save_exr(os.path.join(image_dir, f"{name}_fake_gxgy_raw.exr"), raw["gx"], raw["gy"])
    coords = np.asarray(patch_coords).tolist()             # (K, 4) ROIs (x, y, h, w)
    flipped = [[c[0], image_height - c[1] - c[3], *c[2:]] for c in coords]
    with open(os.path.join(image_dir, f"{name}_patch_coords.json"), "w") as f:
        json.dump({"coords": coords, "coords_y_flipped": flipped}, f)
    webpage.add_images(ims, list(visuals), ims, width=width)


def _save_exr(path: str, gx: np.ndarray, gy: np.ndarray) -> None:
    """(gx, gy, 0) as a float32 OpenEXR image through OpenCV (reference
    visualizer.py:112-130); without OpenCV or its EXR codec, a note."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
    except ImportError as e:
        print(f"[save_images] exr export unavailable: {e}")
        return
    exr = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).astype(np.float32)
    try:
        cv2.imwrite(path, exr)
    except cv2.error as e:
        print(f"[save_images] exr export unavailable: {e}")
