"""Training entry point (``vts_tpu/train.py``).

The epoch loop: one training step per batch (with the vision-aided D3 from
``--vision_aided_warmup_epoch`` on), the loss line every ``--print_freq``
samples (and on each epoch's first batch), the visuals and the HTML gallery
under ``<checkpoints_dir>/<name>/web/`` every ``--display_freq`` samples
(none under ``--no_html``), the ``latest`` checkpoint every
``--save_latest_freq`` samples; at each epoch's end the
validation metrics of the epoch's first sample (for a model trained on
patches, ``--return_patch``, of the full view of a validation loader built
once with ``return_patch`` false, ``data_len`` 1 and batch 1) with the
reference's best vote — save ``best`` when at least half of the non-train
metrics improve (lower is better for LPIPS, AE, MSE, SIFID; higher for
PSNR, SSIM) — the
epoch checkpoints, and the lr schedule (under ``--lr_policy plateau`` the
sum of the lower-is-better validation metrics drives a
:class:`~vts_torch.models.base.PlateauTracker`).  With ``--anneal_epoch`` and
``--anneal_set``, the options named there change once, at the start of that
epoch (``[anneal]`` line): the step reads them anew every time, and the
loader takes the new batch size.  Each epoch's wall time goes to the
loggers (``plot_epoch_time``); with ``--display_id`` > 0 the live dashboard
serves the run on 127.0.0.1 until training ends.  On CUDA the run turns
TF32 off (cuDNN convs and matmuls in full fp32).

``--mesh`` with a ``data`` axis of N > 1 (sinskit and skit; the baselines
run their single-device step, as the reference's) starts N ranks on this
machine (:func:`vts_torch.platform.spawn_ranks`): on the first N cards of
the layout, or on the CPU N processes, after the whole spec is checked
against the visible devices (a core each on the CPU); with
``--multihost`` the processes are the ranks.  Each rank trains its block
of every batch (:class:`~vts_torch.models.sinskit.SinSKITModel`).  Only
rank 0 writes (``loss_log.txt``, the gallery, the dashboard,
checkpoints) and validates; what validation decides (the best vote, the
plateau's lr) it sends to the others.  Every rank computes the gallery's
visuals, which run the global batch norms.

Run:  python -m vts_torch.train --model sinskit --dataroot synthetic://demo \\
          --data_len 3 [--device cuda|cpu] ...
"""

from __future__ import annotations

import copy
import time
from typing import Dict

import torch

from .config import TrainOptions
from .data import create_dataset
from .device import describe, resolve_device
from .models import MODELS, create_model
from .models.base import PlateauTracker
from .models.sinskit import data_axis
from .parallel.mesh import mesh_for_flag, visible_devices
from .platform import agree, init_multihost, is_lead, leave, spawn_ranks, world
from .utils.visualizer import Visualizer

LOWER_BETTER = ("LPIPS", "AE", "MSE", "SIFID")
HIGHER_BETTER = ("PSNR", "SSIM")


def metric_improved(name: str, new: float, old: float) -> bool:
    if any(t in name for t in LOWER_BETTER):
        return new < old
    if any(t in name for t in HIGHER_BETTER):
        return new > old
    return False


def best_vote(metrics: Dict[str, float], best: Dict[str, float]) -> bool:
    """True when at least ``total // 2`` of the non-train metrics improved
    (floor division, as in the reference)."""
    names = [k for k in metrics if not k.startswith("metric_train_")]
    if not names:
        return False
    improved = sum(1 for k in names if k not in best or metric_improved(k, metrics[k], best[k]))
    return improved >= len(names) // 2


# --anneal_set keys (vts_tpu/train.py:52-59): the step's cost knobs and the
# batch size; anything that changes the training problem is refused
_ANNEAL_KEYS = {
    "lpips_crop": int,
    "batch_size": int,
    "remat_g": str,
    "lpips_remat": str,
    "lpips_fold_axis": str,
    "lpips_head": str,
}
_ANNEAL_CHOICES = {
    "remat_g": ("auto", "on", "off", "True", "False", "1", "0"),
    "lpips_remat": ("auto", "on", "off", "True", "False", "1", "0"),
    "lpips_fold_axis": ("hw", "w"),
    "lpips_head": ("composed", "factored"),
}


def apply_anneal(opt, spec: str) -> Dict[str, object]:
    """Parse ``--anneal_set`` ("k=v,k=v"), apply it to ``opt`` and return the
    changes; a bad entry raises ``ValueError`` before anything is applied.
    As the reference's, except that ``lpips_fold_axis`` and ``lpips_head``
    are checked against their choices too (the reference applies a typo)."""
    changed: Dict[str, object] = {}
    for item in (s.strip() for s in spec.split(",")):
        if not item:
            continue
        key, sep, val = item.partition("=")
        key = key.strip()
        if not sep or key not in _ANNEAL_KEYS:
            raise ValueError(f"--anneal_set: bad entry {item!r} (keys: {sorted(_ANNEAL_KEYS)})")
        changed[key] = _ANNEAL_KEYS[key](val.strip())
    if changed.get("lpips_crop", 0) % 16:
        raise ValueError("--anneal_set: lpips_crop must be 0 or a multiple of 16")
    if changed.get("batch_size", 1) < 1:
        raise ValueError("--anneal_set: batch_size must be >= 1")
    for k, choices in _ANNEAL_CHOICES.items():
        if k in changed and changed[k] not in choices:
            raise ValueError(f"--anneal_set: {k} must be one of {'|'.join(choices)}")
    for k, v in changed.items():
        setattr(opt, k, v)
    return changed


def rank_devices(opt):
    """The devices of the data ranks this run starts, or None: ``--mesh``
    with a ``data`` axis of N > 1 on a data-parallel model, outside ranks.
    The whole spec is checked first against the visible devices, or under
    ``--multihost`` against the ranks' (the reference's ``build_mesh``),
    then the data axis (:func:`data_axis`)."""
    if not opt.mesh or not MODELS[opt.model.lower()].data_parallel:
        return None
    ranks = world()
    layout = mesh_for_flag(opt.mesh, ranks.devices if ranks is not None
                           else visible_devices(resolve_device(opt.device).type))
    if ranks is not None or data_axis(opt) <= 1:
        return None
    flat = layout.devices.reshape(-1)
    return [flat[i] for i in layout.data_groups()[0]]


def _rank_train(opt):
    return _train_here(opt).get_current_losses()


def train(argv=None, opt=None):
    """Train; returns the model, or under ``--mesh data:N`` each rank's last
    losses (:meth:`get_current_losses`), in rank order."""
    if opt is None:
        opt = TrainOptions().parse(argv)
    joined = init_multihost(opt)
    try:
        devices = rank_devices(opt)
        if devices is None:
            return _train_here(opt)
        # the CPU's threads shared out among its ranks
        threads = max(1, torch.get_num_threads() // len(devices)) \
            if devices[0].type == "cpu" else None
        return spawn_ranks(_rank_train, (opt,), devices, threads=threads)
    finally:
        if joined:
            leave()


def _train_here(opt):
    device = resolve_device(opt.device)
    print(f"[device] {opt.name} trains on {describe(device)}", flush=True)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    visualizer = Visualizer(opt) if is_lead() else None
    try:
        return _train(opt, device, visualizer)
    finally:
        if visualizer is not None:
            visualizer.close()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _train(opt, device, visualizer):
    lead = visualizer is not None          # rank 0, or the only process: it writes
    anneal_pending = bool(opt.anneal_epoch) and bool(opt.anneal_set)
    if anneal_pending:
        if opt.step_mode == "split":
            raise NotImplementedError("--anneal_epoch is implemented for the fused step only "
                                      "(as in the reference)")
        annealed = copy.copy(opt)
        apply_anneal(annealed, opt.anneal_set)    # a bad spec fails before training,
        data_axis(annealed)                       # and a batch the data ranks do not divide
    dataset = create_dataset(opt)
    print(f"The number of training images = {len(dataset.dataset)}")
    model = create_model(opt)
    total_iters = 0
    best_metrics: Dict[str, float] = {}
    plateau = PlateauTracker() if opt.lr_policy == "plateau" else None
    eval_batch = None
    val_loader = None
    t_start = time.time()
    first = True
    for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + 1):
        epoch_start = time.time()
        if anneal_pending and epoch >= opt.anneal_epoch:
            anneal_pending = False
            changed = apply_anneal(opt, opt.anneal_set)
            if "batch_size" in changed:
                dataset.batch_size = int(opt.batch_size)
            print(f"[anneal] epoch {epoch}: applied {changed}")
        dataset.set_epoch(epoch)
        t_data_mark = time.time()
        for i, data in enumerate(dataset):
            t_data = time.time() - t_data_mark
            if eval_batch is None:
                eval_batch = {k: v[:1] for k, v in data.items()}
            if first:
                model.setup(data)
                if opt.continue_train or opt.pretrained_name:
                    model.load_networks(opt.epoch)
                first = False
            total_iters += opt.batch_size
            t_comp_mark = time.time()
            model.set_input(data)
            model.optimize_parameters(epoch)
            t_comp = (time.time() - t_comp_mark) / opt.batch_size
            if lead and (total_iters % opt.print_freq == 0 or i == 0):
                visualizer.print_current_losses(epoch, total_iters, model.get_current_losses(),
                                                t_comp, t_data)
            if total_iters % opt.display_freq == 0 and not opt.no_html:
                visuals = model.get_current_visuals()
                if lead:
                    visualizer.display_current_results(visuals, epoch)
            if lead and total_iters % opt.save_latest_freq == 0:
                print(f"saving the latest model (epoch {epoch}, total_iters {total_iters})")
                model.save_networks("latest")
            t_data_mark = time.time()

        if lead and opt.val_for_each_epoch and (eval_batch is not None
                                                or getattr(opt, "return_patch", False)):
            if getattr(opt, "return_patch", False):
                # a model trained on patches validates on the full view
                if val_loader is None:
                    val_opt = copy.copy(opt)
                    val_opt.return_patch, val_opt.data_len, val_opt.batch_size = False, 1, 1
                    val_loader = create_dataset(val_opt)
                model.set_input(next(iter(val_loader)), phase="val")
            else:
                model.set_input(eval_batch)
            model.test()
            t_eval = time.time()
            metrics = model.compute_metrics()
            print(f"[eval] epoch {epoch} metric suite ({opt.eval_mode}) took "
                  f"{time.time() - t_eval:.1f} s")
            visualizer.print_current_metrics(epoch, metrics)
            visualizer.save_current_metrics(epoch, metrics)
            if best_vote(metrics, best_metrics):
                print(f"saving the BEST model at epoch {epoch}")
                model.save_networks("best")
                for k, v in metrics.items():
                    if not k.startswith("metric_train_"):
                        best_metrics[k] = v
            if plateau is not None:
                lower = [v for k, v in metrics.items() if not k.startswith("metric_train_")
                         and any(t in k for t in LOWER_BETTER)]
                model.lr_override = plateau.update(float(sum(lower)))
        # the plateau's lr, as rank 0 decided it
        model.lr_override = agree([model.lr_override])[0]

        if lead:
            if epoch % opt.save_epoch_freq == 0:
                print(f"saving the model at the end of epoch {epoch}, iters {total_iters}")
                model.save_networks("latest")
                model.save_networks(str(epoch))
            model.save_networks("latest")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_time = time.time() - epoch_start
        if lead:
            visualizer.plot_epoch_time(epoch, epoch_time)
        print(f"End of epoch {epoch} / {opt.n_epochs + opt.n_epochs_decay} \t "
              f"Time Taken: {epoch_time:.0f} sec")
        model.update_learning_rate(epoch)
        if hasattr(model, "update_fixed_params"):
            model.update_fixed_params(epoch)
    print(f"Training finished in {time.time() - t_start:.0f} s")
    return model


if __name__ == "__main__":
    train()
