"""Loss and metric logging (``vts_tpu/utils/visualizer.py``): the console
lines and ``checkpoints/<name>/loss_log.txt`` of ``print_current_losses``
and ``print_current_metrics``, in the reference's format, and the per-epoch
``results/<name>/<phase>_<epoch>/eval_metrics.pkl`` of
``save_current_metrics``.  The HTML gallery, the live dashboard and wandb
are not ported yet."""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        os.makedirs(os.path.dirname(self.log_name), exist_ok=True)
        with open(self.log_name, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    def _log(self, msg: str) -> str:
        print(msg)
        with open(self.log_name, "a") as f:
            f.write(msg + "\n")
        return msg

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
