#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (vts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device: name, compute capability (must be 9.0), nvidia-smi name and
     power limit; builds every kernel from vts_torch/csrc (one nvcc per
     source, all started together);
  2. kernels against their plain PyTorch versions on the card, TF32 off:
     K1 forward at the eval and the training shapes and K1 dx at the
     training shapes (canvas and patch LPIPS, x branch), each within
     1e-4·max|ref| + 1e-5; K2 forward bit-exact at the eval shape and at
     every training shape (1, 2 and 3 channels, K = 64 and 32), and K2
     backward (the scatter-add) within 1e-6·max|ref| + 1e-7 against
     index_put_(accumulate=True) — both modes, the batched form,
     overlapping and out-of-bounds windows;
  3. the test slice end to end: a seeded ngf-10 generator written as
     best_net_G.msgpack, then ``vts_torch.test.test`` on a 1800² synthetic
     garment (1536² canvas, K = 100 test patches) with --device cuda; all 8
     metrics finite, and the forward kernels' launch counts > 0 in that run;
     then ``vts_torch.test`` at 256² on cuda and on cpu (plain versions)
     agree;
  4. the training slice end to end: ``vts_torch.train`` on the same garment
     at the full-width training defaults (1536² crop, ngf 10, ndf 8, K = 64
     patches + 32 "more fake T", batch_size_G2_val 128) for the 2 steps of
     one epoch and its validation pass; every loss finite, the launch
     counts of K1 fwd, K1 dx, K2 fwd and K2 bwd all > 0 in that run, the G,
     D and D2 checkpoints with their Adam files written, and the best G
     then loading into ``vts_torch.test``; then one 256² training step on
     cuda and on cpu from the same weights and draws: losses within rtol
     1e-4, Adam first moments (the gradients) within 1e-4 of each leaf's
     max |g| (see :func:`grad_tol` for the two named sets of leaves held to
     a round-off floor);
  5. times (CUDA events, warm-up, median of >= 10 runs): each kernel and its
     plain version and library call at each path shape, the bound from the
     shapes; the wall time of one test sample, and of one 1536² training
     step (median of >= 5 after warm-up) with its peak memory and launches.

The second-to-last line is ``{"kernels": [...]}``, one row per kernel and
path: an ``eval`` row covers one test sample (its launches are the test
run's, which holds one sample) and a ``train`` row one training step (its
launches are those of a timed step, counted from 0); ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` sum the per-shape times over those launches,
and ``max_abs_err`` is the worst of the checks at that path's shapes.  The
last line is ``{"ok": true, "device": {...}}``.  Nothing is printed as a result unless
every phase passed.  No JAX and nothing of vts_tpu is imported.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores
# and HBM3 bandwidth.  Stated against the card's power limit, printed below.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# K1 at the eval path: (N, H, W, C, Co, launches per test sample).  I_LPIPS runs
# VGG on [real, fake] at the canvas; T_LPIPS on [fake, real] 2·K 224² patches,
# once for gx and once for gy.
K1_SHAPES = [
    (2, 1536, 1536, 64, 64, 1),
    (2, 768, 768, 64, 128, 1),
    (2, 768, 768, 128, 128, 1),
    (200, 224, 224, 64, 64, 2),
    (200, 112, 112, 64, 128, 2),
    (200, 112, 112, 128, 128, 2),
]
# K1 on the training path: (N, H, W, C, Co, forward launches per step, dx
# launches per step).  The canvas LPIPS runs x (fake_I) and y (real I, no
# grad) separately; the patch LPIPS runs gx and gy of the K = 64 fake_T
# patches as one 2K batch, x and y separately; dx runs for x only.
K1_TRAIN = [
    (1, 1536, 1536, 64, 64, 2, 1),
    (1, 768, 768, 64, 128, 2, 1),
    (1, 768, 768, 128, 128, 2, 1),
    (128, 32, 32, 64, 64, 2, 1),
    (128, 16, 16, 64, 128, 2, 1),
    (128, 16, 16, 128, 128, 2, 1),
]
# K2 on the training path: (channels, K, launches per step).  K = 64 at the
# batch's coords: fake_T for D2 and again for G's losses, S, and the two
# augmented I; K = 32 at the "more fake T" offsets: fake_I, fake_T and S.
K2_TRAIN = [(2, 64, 2), (1, 64, 1), (3, 64, 2), (3, 32, 1), (2, 32, 1), (1, 32, 1)]
CANVAS, PADDED, NGF, K_PATCH, K_TRAIN = 1536, 1800, 10, 100, 64
KERNELS = ("conv3x3_bias_relu", "conv3x3_dx", "gather_patches", "scatter_patches")
# launches of one test sample and of one training step, as the tables above give them
PER_SAMPLE = {"conv3x3_bias_relu": sum(r[-1] for r in K1_SHAPES), "conv3x3_dx": 0,
              "gather_patches": 1, "scatter_patches": 0}
PER_STEP = {"conv3x3_bias_relu": sum(r[5] for r in K1_TRAIN),
            "conv3x3_dx": sum(r[6] for r in K1_TRAIN),
            "gather_patches": sum(r[2] for r in K2_TRAIN), "scatter_patches": 1}
SMALL_DATA = "synthetic://small?size=320&center_w=192&center_h=128&patches=6&val_patches=3"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=10, warmup=2):
    """Median device time of fn() in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def counters():
    from vts_torch.ops import conv3x3 as k1
    from vts_torch.ops import patch as k2
    return {"conv3x3_bias_relu": k1.conv3x3_bias_relu, "conv3x3_dx": k1.conv3x3_dx,
            "gather_patches": k2.gather_patches, "scatter_patches": k2.scatter_patches}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


# Gradient leaves held to a round-off floor rather than 1e-4 of their max:
# the bias of a conv that a norm follows has an exactly-zero gradient (the
# norm removes any per-channel constant), so only round-off is left there;
# the logit head's bias sums fake and real terms of opposite sign.
ZERO_GRAD = re.compile(r"(down[1-6]|up[1-7](_T)?|Conv4x4_[123])\W.*bias")
CANCELLING = re.compile(r"Conv4x4_4\W.*bias")


def grad_tol(name, g, net_max):
    """|Δg| bound of one gradient leaf: 1e-4 of the leaf's max |g|; 1e-5 of
    the network's max |g| for a :data:`ZERO_GRAD` leaf, and that floor on
    top for a :data:`CANCELLING` one."""
    if ZERO_GRAD.search(name):
        return 1e-5 * net_max
    return 1e-4 * g.abs().max().item() + (1e-5 * net_max if CANCELLING.search(name) else 0.0)


def gather_bytes(ox, oy, c, cut=32):
    """Bytes one gather must move: each canvas pixel the windows touch read
    once, the patches written once, the offsets read."""
    ar = torch.arange(cut, device=ox.device)
    iy = (oy.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, :, None].expand(-1, -1, cut)
    ix = (ox.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, None, :].expand(-1, cut, -1)
    touched = torch.zeros(CANVAS, CANVAS, dtype=torch.bool, device=ox.device)
    touched[iy, ix] = True
    return int(touched.sum().item()) * c * 4 + ox.numel() * cut * cut * c * 4 + 2 * ox.numel() * 4


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.kernels import build
    from vts_torch.models import create_model
    from vts_torch.ops import conv3x3 as k1
    from vts_torch.ops import patch as k2
    from vts_torch.test import test as run_test
    from vts_torch.train import train as run_train

    t_start = time.time()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---------------------------------------------------------------- 1 ---
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name} capability {cap} count {torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    check(cap == (9, 0), f"needs a Hopper card (sm_90), got capability {cap}")
    t0 = time.time()
    libs = build.build()
    print(f"[build] {len(libs)} kernels in {time.time() - t0:.1f} s")
    for kname, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[ptxas {kname}] {line.strip()}")

    # ---------------------------------------------------------------- 2 ---
    gen = torch.Generator(device="cpu").manual_seed(0)
    k1_rows = []
    for (n, h, w, c, co, mult) in K1_SHAPES:
        x = torch.relu(torch.randn(n, h, w, c, generator=gen)).to(dev)
        wt = (torch.randn(3, 3, c, co, generator=gen) * math.sqrt(2.0 / (9 * c))).to(dev)
        b = (torch.randn(co, generator=gen) * 0.1).to(dev)
        got = k1.conv3x3_bias_relu(x, wt, b)
        ref = k1.conv3x3_bias_relu_plain(x, wt, b)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        print(f"[K1 check] {(n, h, w, c)}->{co}: max|d| {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"K1 disagrees with its plain version at {(n, h, w, c, co)}")
        k1_rows.append(dict(shape=[n, h, w, c, co], per_sample=mult, err=err,
                            tensors=(x, wt, b)))
        del got, ref

    dx_rows = []
    for (n, h, w, c, co, fwd_per_step, dx_per_step) in K1_TRAIN:
        x = torch.relu(torch.randn(n, h, w, c, generator=gen)).to(dev)
        wt = (torch.randn(3, 3, c, co, generator=gen) * math.sqrt(2.0 / (9 * c))).to(dev)
        b = (torch.randn(co, generator=gen) * 0.1).to(dev)
        gy = torch.randn(n, h, w, co, generator=gen).to(dev)
        y = k1.conv3x3_bias_relu(x, wt, b)
        ref = k1.conv3x3_bias_relu_plain(x, wt, b)
        torch.cuda.synchronize()
        f_err = (y - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        print(f"[K1 check] {(n, h, w, c)}->{co}: max|d| {f_err:.3e} (tol {tol:.3e})")
        check(f_err <= tol, f"K1 disagrees with its plain version at {(n, h, w, c, co)}")
        got = k1.conv3x3_dx(gy, y, wt)
        ref = k1.conv3x3_dx_plain(gy, y, wt)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        print(f"[K1 dx check] gy {(n, h, w, co)} -> dx {c}: max|d| {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"K1 dx disagrees with its plain version at {(n, h, w, c, co)}")
        dx_rows.append(dict(shape=[n, h, w, c, co], fwd=fwd_per_step, dx=dx_per_step,
                            f_err=f_err, err=err, tensors=(x, wt, b, y, gy)))
        del got, ref

    img2 = torch.randn(2, CANVAS, CANVAS, 2, generator=gen).to(dev)
    ox = torch.randint(-40, CANVAS + 8, (2, K_PATCH), generator=gen)
    oy = torch.randint(-40, CANVAS + 8, (2, K_PATCH), generator=gen)
    ox[:, :10], oy[:, :10] = 500, 600            # overlapping windows
    ox, oy = ox.to(dev, torch.int32), oy.to(dev, torch.int32)   # as patch_offsets gives
    for mode in ("gather", "slice"):
        for im, a, bb in ((img2, ox, oy), (img2[0], ox[0], oy[0])):
            got = k2.gather_patches(im, a, bb, 32, mode=mode)
            ref = k2.gather_patches_plain(im, a, bb, 32, mode=mode)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"K2 differs from its plain version ({mode}, "
                                         f"image {tuple(im.shape)})")
    coords = torch.zeros(2, K_PATCH, 8)        # packed (ROI_x, ROI_y, …, crop_pos) records
    coords[..., 0], coords[..., 1] = ox.cpu() - 3.5, oy.cpu() - 2.5
    coords[..., 4], coords[..., 5], coords[..., 6], coords[..., 7] = 32, 1.0, 3.5, 2.5
    coords = coords.to(dev)
    got = k2.gather_patches_from_coords(img2, coords)
    ref = k2.gather_patches_plain(img2, *k2.patch_offsets(coords)[:2], 32)
    torch.cuda.synchronize()
    check(torch.equal(got, ref) and got.shape == (2 * K_PATCH, 32, 32, 2),
          "K2 from (N, K, 8) coords differs from its plain version")
    print("[K2 check] gather/slice, single and batched, from coords, OOB + overlapping: "
          "bit-exact")
    k2_train = []
    for (c, kk, per_step) in K2_TRAIN:
        im = torch.randn(1, CANVAS, CANVAS, c, generator=gen).to(dev)
        a, bb = ox[:1, :kk].contiguous(), oy[:1, :kk].contiguous()
        for mode in ("gather", "slice"):
            got = k2.gather_patches(im, a, bb, 32, mode=mode)
            ref = k2.gather_patches_plain(im, a, bb, 32, mode=mode)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"K2 differs from its plain version ({mode}, "
                                         f"{c} channels, K = {kk})")
        k2_train.append(dict(c=c, k=kk, per_step=per_step, tensors=(im[0], a[0], bb[0])))
    print("[K2 check] training shapes (1, 1536², 1|2|3) x K 64|32, gather/slice: bit-exact")

    oxt, oyt = ox[:, :K_TRAIN].contiguous(), oy[:, :K_TRAIN].contiguous()
    gpatch = torch.randn(2 * K_TRAIN, 32, 32, 2, generator=gen).to(dev)
    k2b_err = 0.0
    for mode in ("gather", "slice"):
        for n_img in (1, 2):
            g_in = gpatch[:n_img * K_TRAIN]
            shape = (n_img, CANVAS, CANVAS, 2)
            got = k2.scatter_patches(g_in, oxt[:n_img], oyt[:n_img], shape, mode=mode)
            ref = k2.scatter_patches_plain(g_in, oxt[:n_img], oyt[:n_img], shape, mode=mode)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-6 * ref.abs().max().item() + 1e-7
            k2b_err = max(k2b_err, err)
            print(f"[K2 bwd check] {mode} {shape} K={K_TRAIN}: max|d| {err:.3e} (tol {tol:.3e})")
            check(err <= tol, f"K2 backward disagrees with index_put_ ({mode}, {shape})")
    del got, ref

    # ---------------------------------------------------------------- 3 ---
    tmp_dir = tempfile.TemporaryDirectory(prefix="vts_torch_smoke_")
    tmp = tmp_dir.name
    dirs = ["--checkpoints_dir", os.path.join(tmp, "ckpt"),
            "--results_dir", os.path.join(tmp, "res")]
    argv = ["--model", "sinskit", "--epoch", "best", "--name", "smoke",
            "--dataroot", f"synthetic://smoke?size={PADDED}", "--device", "cuda",
            "--ngf", str(NGF), "--crop_size", str(CANVAS),
            "--batch_size_G2", str(K_PATCH)] + dirs
    opt = TestOptions().parse(argv, quiet=True)
    model = create_model(opt)
    model.setup()
    model.save_networks("best")
    del model
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    metrics = run_test(argv)[0]
    t_slice = time.time() - t0
    test_launches = read_counts()
    print(f"[slice] {len(metrics)} metrics in {t_slice:.2f} s (first run, incl. data "
          f"and model set-up): " + " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
    print(f"[slice] launches during the test run: {test_launches}")
    check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
          f"expected 8 finite metrics, got {metrics}")
    check(test_launches["conv3x3_bias_relu"] > 0 and test_launches["gather_patches"] > 0,
          f"a forward kernel was not launched: {test_launches}")

    small = ["--model", "sinskit", "--epoch", "best", "--name", "small",
             "--dataroot", SMALL_DATA, "--crop_size", "256", "--center_w", "192",
             "--center_h", "128", "--ngf", "4", "--batch_size_G2", "4",
             "--init_gain", "0.5"] + dirs
    sopt = TestOptions().parse(small + ["--device", "cpu"], quiet=True)
    smodel = create_model(sopt)
    smodel.setup()
    smodel.save_networks("best")
    on_gpu = run_test(small + ["--device", "cuda"])[0]
    on_cpu = run_test(small + ["--device", "cpu"])[0]
    for key in on_cpu:
        rel = abs(on_gpu[key] - on_cpu[key]) / max(abs(on_cpu[key]), 1e-12)
        print(f"[reference] {key}: cuda {on_gpu[key]:.7g} cpu {on_cpu[key]:.7g} rel {rel:.2e}")
        check(rel <= (1e-3 if "SIFID" in key else 1e-4),
              f"{key} on cuda disagrees with the cpu reference")

    # ---------------------------------------------------------------- 4 ---
    targv = ["--model", "sinskit", "--name", "train_smoke",
             "--dataroot", f"synthetic://smoke?size={PADDED}", "--device", "cuda",
             "--data_len", "2", "--n_epochs", "1", "--n_epochs_decay", "0",
             "--no_html"] + dirs
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    tmodel = run_train(targv)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    train_launches = read_counts()
    losses = tmodel.get_current_losses()
    print(f"[train] 2 steps + validation in {t_train:.2f} s (first run, incl. data and "
          f"model set-up); last losses: " + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[train] launches during the training run: {train_launches}")
    check(len(losses) >= 13 and all(math.isfinite(v) for v in losses.values()),
          f"a training loss is not finite: {losses}")
    check(all(train_launches[k] > 0 for k in KERNELS),
          f"a kernel was not launched by the training run: {train_launches}")
    ck = os.path.join(tmp, "ckpt", "train_smoke")
    missing = [f"best_{kind}_{net}.msgpack" for net in ("G", "D", "D2") for kind in ("net", "opt")
               if not os.path.exists(os.path.join(ck, f"best_{kind}_{net}.msgpack"))]
    check(not missing, f"checkpoints not written: {missing}")
    del tmodel
    tm = run_test(["--model", "sinskit", "--epoch", "best", "--name", "train_smoke",
                   "--dataroot", f"synthetic://smoke?size={PADDED}", "--device", "cuda",
                   "--batch_size_G2", str(K_PATCH)] + dirs)[0]
    check(len(tm) == 8 and all(math.isfinite(v) for v in tm.values()),
          f"the trained best G does not evaluate: {tm}")
    print("[train] best G loads into vts_torch.test: " +
          " ".join(f"{k}={v:.6g}" for k, v in sorted(tm.items())))

    strain = ["--model", "sinskit", "--name", "small_train", "--dataroot", SMALL_DATA,
              "--crop_size", "256", "--center_w", "192", "--center_h", "128", "--ngf", "4",
              "--ndf", "4", "--batch_size_G2", "6", "--batch_size_G2_val", "4",
              "--add_fake_T_sample_size", "4", "--data_len", "2", "--init_gain", "0.5",
              "--no_html"] + dirs
    pair = {}
    for d in ("cpu", "cuda"):
        o = TrainOptions().parse(strain + ["--device", d], quiet=True)
        pair[d] = create_model(o)
        pair[d].setup()
    sbatch = next(iter(create_dataset(o)))
    draws = pair["cpu"].draw(1)
    for m in pair.values():
        m.set_input(sbatch)
        m.optimize_parameters(1, draws=draws)
    lc, lg = pair["cpu"].get_current_losses(), pair["cuda"].get_current_losses()
    worst = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-7) for k in lc)
    print(f"[train ref] 256² step, cuda vs cpu: worst loss rel {worst:.2e}")
    for k in lc:
        check(abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) + 1e-7,
              f"training loss {k} on cuda {lg[k]} disagrees with cpu {lc[k]}")
    for net in ("G", "D", "D2"):
        mu_c, mu_g = pair["cpu"].adam[net].mu, pair["cuda"].adam[net].mu
        net_max = max(v.abs().max().item() for v in mu_c.values())
        at_roundoff = {k for k, v in mu_c.items() if v.abs().max().item() <= 1e-5 * net_max}
        check(at_roundoff == {k for k in mu_c if ZERO_GRAD.search(k)},
              f"{net}: the leaves at round-off are not the named ones: {sorted(at_roundoff)}")
        ratio = {k: (mu_g[k].cpu() - v).abs().max().item() / grad_tol(k, v, net_max)
                 for k, v in mu_c.items()}
        worst = max(ratio, key=ratio.get)
        print(f"[train ref] {net} grads cuda vs cpu: worst per-leaf |d|/tolerance "
              f"{ratio[worst]:.2e} at {worst} (network max |g| {net_max:.3e}, "
              f"{len(at_roundoff)} leaves at round-off)")
        check(ratio[worst] <= 1.0, f"{net} gradient {worst} on cuda disagrees with cpu")
    del pair

    # ---------------------------------------------------------------- 5 ---
    rows = {}                     # (kernel, path) -> per-sample or per-step sums
    shape_rows = []

    def add(kname, path, per, ms, plain, lib, flops, nbytes, err, shape):
        acc = rows.setdefault((kname, path), dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                                  flops=0.0, bytes=0.0, err=0.0, per=0))
        for k_, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                      ("flops", flops), ("bytes", nbytes)):
            acc[k_] += per * v
        acc["err"] = max(acc["err"], err)
        acc["per"] += per
        bound, by = bound_ms(flops, nbytes)
        shape_rows.append(dict(kernel=kname, path=path, shape=shape, launches=per, ms=ms,
                               plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                               tflops=flops / ms / 1e9, max_abs_err=err))
        return bound, by

    for row in k1_rows:
        n, h, w, c, co = row["shape"]
        x, wt, b = row["tensors"]
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)
        ms = cuda_ms(lambda: k1.conv3x3_bias_relu(x, wt, b))
        plain = cuda_ms(lambda: k1.conv3x3_bias_relu_plain(x, wt, b))
        lib = cuda_ms(lambda: F.relu(F.conv2d(x_nchw, w_oihw, b, padding=1)))
        flops = 2.0 * 9 * n * h * w * c * co
        nbytes = 4.0 * (n * h * w * c + 9 * c * co + co + n * h * w * co)
        bound, _ = add("conv3x3_bias_relu", "eval", row["per_sample"], ms, plain, lib, flops,
                       nbytes, row["err"], row["shape"])
        print(f"[time K1 eval] {(n, h, w, c)}->{co}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"F.conv2d+relu {lib:.4f} ms, bound {bound:.4f} ms (operations), "
              f"{flops / ms / 1e9:.2f} TFLOP/s")
        del row["tensors"]

    for row in dx_rows:
        n, h, w, c, co = row["shape"]
        x, wt, b, y, gy = row["tensors"]
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_nchw, y_nchw, gy_nchw = (t.permute(0, 3, 1, 2) for t in (x, y, gy))
        flops = 2.0 * 9 * n * h * w * c * co
        f_ms = cuda_ms(lambda: k1.conv3x3_bias_relu(x, wt, b))
        f_plain = cuda_ms(lambda: k1.conv3x3_bias_relu_plain(x, wt, b))
        f_lib = cuda_ms(lambda: F.relu(F.conv2d(x_nchw, w_oihw, b, padding=1)))
        f_bytes = 4.0 * (n * h * w * c + 9 * c * co + co + n * h * w * co)
        ms = cuda_ms(lambda: k1.conv3x3_dx(gy, y, wt))
        plain = cuda_ms(lambda: k1.conv3x3_dx_plain(gy, y, wt))
        lib = cuda_ms(lambda: torch.nn.grad.conv2d_input(
            (n, c, h, w), w_oihw, gy_nchw * (y_nchw > 0), padding=1))
        nbytes = 4.0 * (2 * n * h * w * co + 9 * c * co + n * h * w * c)
        fb, _ = add("conv3x3_bias_relu", "train", row["fwd"], f_ms, f_plain, f_lib, flops,
                    f_bytes, row["f_err"], row["shape"])
        bb, by = add("conv3x3_dx", "train", row["dx"], ms, plain, lib, flops, nbytes,
                     row["err"], row["shape"])
        print(f"[time K1 train] {(n, h, w, c)}->{co}: fwd {f_ms:.4f} ms (plain {f_plain:.4f}, "
              f"F.conv2d+relu {f_lib:.4f}, bound {fb:.4f}); dx {ms:.4f} ms (plain "
              f"{plain:.4f}, conv2d_input+mask {lib:.4f}, bound {bb:.4f} {by}), "
              f"dx {flops / ms / 1e9:.2f} TFLOP/s")
        del row["tensors"]

    def time_gather(path, per, img1, ox1, oy1, c, err):
        ms = cuda_ms(lambda: k2.gather_patches(img1, ox1, oy1, 32), reps=50)
        plain = cuda_ms(lambda: k2.gather_patches_plain(img1, ox1, oy1, 32), reps=50)
        ar = torch.arange(32, device=dev)
        iy = (oy1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, :, None]
        ix = (ox1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, None, :]
        lib = cuda_ms(lambda: img1[iy, ix], reps=50)
        kk = ox1.numel()
        bound, _ = add("gather_patches", path, per, ms, plain, lib, 0.0,
                       gather_bytes(ox1, oy1, c), err, [1, CANVAS, CANVAS, c, kk, 32])
        print(f"[time K2 {path}] (1,{CANVAS},{CANVAS},{c}) K={kk} cut 32: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, indexing {lib:.4f} ms, bound {bound:.5f} ms (bytes), "
              f"{per} per {'sample' if path == 'eval' else 'step'}")

    # eval: fake_T (1, 1536², 2) at the K = 100 test patches
    time_gather("eval", PER_SAMPLE["gather_patches"], img2[0], ox[0], oy[0], 2, 0.0)
    for row in k2_train:
        time_gather("train", row["per_step"], *row["tensors"], row["c"], 0.0)
        del row["tensors"]

    oxt1, oyt1 = oxt[0], oyt[0]
    gp1 = gpatch[:K_TRAIN].contiguous()
    shape1 = (1, CANVAS, CANVAS, 2)
    ms = cuda_ms(lambda: k2.scatter_patches(gp1, oxt1, oyt1, shape1), reps=50)
    plain = cuda_ms(lambda: k2.scatter_patches_plain(gp1, oxt1, oyt1, shape1), reps=50)
    ar = torch.arange(32, device=dev)
    iy = (oyt1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, :, None]
    ix = (oxt1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, None, :]
    flat = (iy * CANVAS + ix).reshape(-1)                       # (K·32·32,) pixel index
    gflat = gp1.reshape(-1, 2)

    def index_add():
        return torch.zeros(CANVAS * CANVAS, 2, device=dev).index_add_(0, flat, gflat)

    lib = cuda_ms(index_add, reps=50)
    nbytes = CANVAS * CANVAS * 2 * 4 + K_TRAIN * 32 * 32 * 2 * 4 + 2 * K_TRAIN * 4
    bound, _ = add("scatter_patches", "train", PER_STEP["scatter_patches"], ms, plain, lib,
                   0.0, nbytes, k2b_err, [1, CANVAS, CANVAS, 2, K_TRAIN, 32])
    print(f"[time K2 bwd] (1,{CANVAS},{CANVAS},2) K={K_TRAIN} cut 32: kernel {ms:.4f} ms, "
          f"plain (index_put_) {plain:.4f} ms, index_add_ {lib:.4f} ms, bound {bound:.5f} ms "
          f"(bytes: the canvas zero fill {CANVAS * CANVAS * 8 / 1e6:.1f} MB dominates)")
    del img2, gpatch

    # one test sample: G forward + the 8 metrics, after a warm-up
    topt = TestOptions().parse(argv, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.load_networks("best")
    model.set_input(batch)
    walls, g_ms = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.test()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.compute_metrics()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i:
            walls.append((t2 - t0) * 1e3)
            g_ms.append((t1 - t0) * 1e3)
    print(f"[time sample] one {CANVAS}² test sample: {statistics.median(walls):.1f} ms wall "
          f"(G forward {statistics.median(g_ms):.1f} ms), median of {len(walls)}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del model, batch

    # one training step at the full-width training defaults, after warm-up
    topt = TrainOptions().parse(targv, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.set_input(batch)
    walls, peaks = [], []
    for i in range(7):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 2:
            reset_counts()
        t0 = time.perf_counter()
        model.optimize_parameters(1)
        model.get_current_losses()
        torch.cuda.synchronize()
        if i == 2:
            step_launches = read_counts()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"[time step] one {CANVAS}² training step (batch 1, ngf {NGF}, ndf 8, K {K_TRAIN} "
          f"+ 32): {statistics.median(walls):.1f} ms wall, median of {len(walls)} "
          f"({', '.join(f'{w:.1f}' for w in walls)}); {1e3 / statistics.median(walls):.3f} "
          f"samples/s; peak memory {max(peaks):.2f} GiB; launches per step {step_launches}")
    check(step_launches == PER_STEP, f"a training step launched {step_launches}, the "
                                     f"timed shapes stand for {PER_STEP}")
    del model, batch

    sources = {"conv3x3_bias_relu": ("vts_torch/csrc/conv3x3.cu",
                                     "vts_tpu/ops/pallas_conv.py:42"),
               "conv3x3_dx": ("vts_torch/csrc/conv3x3.cu", "vts_tpu/ops/pallas_conv.py:119"),
               "gather_patches": ("vts_torch/csrc/gather_patches.cu",
                                  "vts_tpu/ops/pallas_gather.py:34"),
               "scatter_patches": ("vts_torch/csrc/scatter_patches.cu",
                                   "vts_tpu/ops/patch.py:41 (XLA transpose of the gather; "
                                   "no Pallas kernel)")}
    kernels = []
    for (kname, path), acc in rows.items():
        launches = (test_launches if path == "eval" else step_launches)[kname]
        check(launches == acc["per"], f"{kname} ({path}): {launches} launches, timed {acc['per']}")
        b_ms, b_by = bound_ms(acc["flops"], acc["bytes"])
        src, repl = sources[kname]
        print(f"[time {kname} {path}] per {'test sample' if path == 'eval' else 'training step'}: "
              f"{launches} launches, kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, "
              f"library {acc['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        kernels.append(dict(name=f"{kname}@{path}", route="cuda", source=src, replaces=repl,
                            launches=launches, max_abs_err=acc["err"], ms=acc["ms"],
                            plain_ms=acc["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                            library_ms=acc["library_ms"], path=path,
                            launches_in_run=(test_launches if path == "eval"
                                             else train_launches)[kname]))
    print(f"[shapes] {json.dumps(shape_rows)}")
    print(f"[done] chip_smoke took {time.time() - t_start:.1f} s")
    tmp_dir.cleanup()

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
