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
     1e-4·max|ref| + 1e-5; K2 forward bit-exact at the eval shape, from
     offsets and from coords (.5 ties included), and at each of the training
     step's three launch groups (1 to 4 sources of 1, 2 and 3 channels,
     K = 64 and 32, N = 1 and 2); K2 backward (the tile-owner scatter-add)
     bit-exact against index_put_(accumulate=True) run serially on the CPU,
     from offsets and from coords, and the same bits in two card runs — both
     modes, the batched form, overlapping and out-of-bounds windows;
  3. the test slice end to end: a seeded ngf-10 generator written as
     best_net_G.msgpack, then ``vts_torch.test.test`` on a 1800² synthetic
     garment (1536² canvas, K = 100 test patches) with --device cuda; all 8
     metrics finite, the forward kernels' launch counts > 0 in that run, and
     no patch_offsets call on the host (K2 decodes the coords);
     then ``vts_torch.test`` at 256² on cuda and on cpu (plain versions)
     agree;
  4. the training slice end to end: ``vts_torch.train`` on the same garment
     at the full-width training defaults (1536² crop, ngf 10, ndf 8, K = 64
     patches + 32 "more fake T", batch_size_G2_val 128) for the 2 steps of
     one epoch and its validation pass; every loss finite, the launch
     counts of K1 fwd, K1 dx, K2 fwd and K2 bwd all > 0 in that run, the G,
     D and D2 checkpoints with their Adam files written, and the best G
     then loading into ``vts_torch.test``; then one 256² training step on
     cuda (cuDNN's deterministic algorithms; a second CUDA step shows
     whether the step repeats bit for bit) and on cpu from the same weights
     and draws: losses within rtol
     1e-4, Adam first moments (the gradients) within 1e-4 of each leaf's
     max |g| (see :func:`grad_tol` for the two named sets of leaves held to
     a round-off floor);
  5. times (CUDA events, warm-up, median of >= 10 runs): each kernel and its
     plain version and library call at each path shape, the bound from the
     shapes, and for K2 and K2 bwd the device-only time of the kernel from
     torch.profiler; the wall time of one test sample, and of one 1536²
     training step (median of >= 5 after warm-up) with its peak memory and
     launches (and no patch_offsets call on the host).

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
# K2 on the training path, one launch per group and step: (group, the
# channels of its sources, K, windows).  A: fake_T for D2, S and the two
# augmented I at the batch's coords; B: fake_I, fake_T and S at the K = 32
# "more fake T" offsets; C: fake_T for G's losses at the batch's coords,
# the one gather with a gradient (K2 bwd).
K2_TRAIN = [("A", (2, 1, 3, 3), 64, "coords"), ("B", (3, 2, 1), 32, "offsets"),
            ("C", (2,), 64, "coords")]
CANVAS, PADDED, NGF, K_PATCH, K_TRAIN = 1536, 1800, 10, 100, 64
KERNELS = ("conv3x3_bias_relu", "conv3x3_dx", "gather_patches", "scatter_patches")
# launches of one test sample and of one training step, as the tables above give them
PER_SAMPLE = {"conv3x3_bias_relu": sum(r[-1] for r in K1_SHAPES), "conv3x3_dx": 0,
              "gather_patches": 1, "scatter_patches": 0}
PER_STEP = {"conv3x3_bias_relu": sum(r[5] for r in K1_TRAIN),
            "conv3x3_dx": sum(r[6] for r in K1_TRAIN),
            "gather_patches": len(K2_TRAIN), "scatter_patches": 1}
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


def device_ms(fn, name, reps=50):
    """Device-only time of one call of fn in ms, from torch.profiler: the CUDA
    time of the kernels whose name holds ``name`` (every kernel if ``name``
    is empty) over ``reps`` calls, divided by ``reps``; None if the trace
    shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(us) / reps / 1e3 if us else None


def host_ms(fn, reps=200):
    """Host time of one call of fn in ms: the calls enqueued back to back on
    the host clock (the card keeps up with kernels this small), then one
    synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.5f} ms"


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


def gather_bytes(ox, oy, chans, window_bytes, cut=32):
    """Bytes one grouped gather from one image must move: each canvas pixel
    the (K,) windows touch read once from every source, the patches written
    once, the windows (offsets or coords) read once."""
    ar = torch.arange(cut, device=ox.device)
    iy = (oy.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, :, None].expand(-1, -1, cut)
    ix = (ox.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, None, :].expand(-1, cut, -1)
    touched = torch.zeros(CANVAS, CANVAS, dtype=torch.bool, device=ox.device)
    touched[iy, ix] = True
    return (int(touched.sum().item()) + ox.numel() * cut * cut) * sum(chans) * 4 + window_bytes


def serial_scatter(grad, ox, oy, shape, mode):
    """scatter_patches_plain on CPU copies, with deterministic algorithms on,
    so that index_put_(accumulate=True) adds serially in the order of its
    index tensor (window, row, column), the order K2 bwd sums in.  Without
    that, PyTorch's CPU index_put_ adds with atomics in parallel above its
    grain (32768 elements), in an order that varies."""
    from vts_torch.ops import patch as k2
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return k2.scatter_patches_plain(grad.cpu(), ox.cpu(), oy.cpu(), shape, mode)
    finally:
        torch.use_deterministic_algorithms(was)


class CountPatchOffsets:
    """Counts the host's patch_offsets calls while it is entered: on the
    card the main path decodes the coords in K2 and calls it no time."""

    def __enter__(self):
        from vts_torch.ops import patch as k2
        self.k2, self.real, self.calls = k2, k2.patch_offsets, 0

        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)
        k2.patch_offsets = counted
        return self

    def __exit__(self, *exc):
        self.k2.patch_offsets = self.real


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
    ties = coords.clone()                      # crop offsets on .5: round half to even
    ties[..., 0], ties[..., 1] = ox.cpu().float(), oy.cpu().float()
    ties[..., 6] = torch.tensor([0.5, -0.5, 1.5, 2.5]).repeat(K_PATCH // 4)
    ties[..., 7] = torch.tensor([-1.5, 0.5, 2.5, -2.5, 1.0]).repeat(K_PATCH // 5)
    ties[:, 40:42] = 0.0                       # padded patches: 0/0 offsets, decoded as 0
    coords, ties = coords.to(dev), ties.to(dev)
    for cc in (coords, ties):
        for mode in ("gather", "slice"):
            got = k2.gather_patches_from_coords(img2, cc, mode=mode)
            ref = k2.gather_patches_plain(img2, *k2.patch_offsets(cc)[:2], 32, mode=mode)
            torch.cuda.synchronize()
            check(torch.equal(got, ref) and got.shape == (2 * K_PATCH, 32, 32, 2),
                  f"K2 from (N, K, 8) coords differs from its plain version ({mode})")
    print("[K2 check] gather/slice, single and batched, from offsets and from coords (.5 "
          "ties, padded patches), OOB + overlapping: bit-exact")
    k2_train = []
    for (group, chans, kk, windows) in K2_TRAIN:
        for n_img in (2, 1):
            ims = [torch.randn(n_img, CANVAS, CANVAS, c, generator=gen).to(dev) for c in chans]
            if windows == "coords":
                kw = dict(coords=ties[:n_img, :kk].contiguous())
                rx, ry = k2.patch_offsets(kw["coords"])[:2]
            else:
                kw = dict(offset_x=ox[:n_img, :kk].contiguous(),
                          offset_y=oy[:n_img, :kk].contiguous())
                rx, ry = kw["offset_x"], kw["offset_y"]
            for mode in ("gather", "slice"):
                outs = k2.gather_patches_group(ims, cutout=32, mode=mode, **kw)
                for im, out in zip(ims, outs):
                    ref = k2.gather_patches_plain(im, rx, ry, 32, mode=mode)
                    torch.cuda.synchronize()
                    check(torch.equal(out, ref), f"K2 group {group} differs from its plain "
                                                 f"version ({mode}, N = {n_img}, "
                                                 f"{im.shape[-1]} channels, K = {kk})")
            del outs, ref
        k2_train.append(dict(group=group, chans=chans, k=kk, windows=windows, images=ims,
                             kw=kw, offsets=(rx[0], ry[0])))
    print("[K2 check] training groups A (2,1,3,3 ch), B (3,2,1 ch) at K 64|32, C, "
          "N 1|2, gather/slice: bit-exact per source")

    oxt, oyt = ox[:, :K_TRAIN].contiguous(), oy[:, :K_TRAIN].contiguous()
    gpatch = torch.randn(2 * K_TRAIN, 32, 32, 2, generator=gen).to(dev)
    k2b_err = 0.0
    for mode in ("gather", "slice"):
        for n_img in (1, 2):
            g_in = gpatch[:n_img * K_TRAIN]
            shape = (n_img, CANVAS, CANVAS, 2)
            runs = [k2.scatter_patches(g_in, oxt[:n_img], oyt[:n_img], shape, mode=mode)
                    for _ in range(2)]
            tc = ties[:n_img, :K_TRAIN].contiguous()
            runs.append(k2.scatter_patches(g_in, None, None, shape, mode=mode, coords=tc))
            ref = serial_scatter(g_in, oxt[:n_img], oyt[:n_img], shape, mode)
            ref_c = serial_scatter(g_in, *k2.patch_offsets(tc)[:2], shape, mode)
            torch.cuda.synchronize()
            err = max((runs[0].cpu() - ref).abs().max().item(),
                      (runs[2].cpu() - ref_c).abs().max().item())
            k2b_err = max(k2b_err, err)
            print(f"[K2 bwd check] {mode} {shape} K={K_TRAIN}: max|d| {err:.3e} against the "
                  f"serial CPU index_put_ (offsets and coords); two card runs equal: "
                  f"{torch.equal(runs[0], runs[1])}")
            check(torch.equal(runs[0], runs[1]), f"K2 backward is not deterministic ({mode}, "
                                                 f"{shape})")
            check(torch.equal(runs[0].cpu(), ref) and torch.equal(runs[2].cpu(), ref_c),
                  f"K2 backward differs from the serial index_put_ ({mode}, {shape})")
    del runs, ref, ref_c

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
    with CountPatchOffsets() as host_offsets:
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
    check(host_offsets.calls == 0, f"the test run called patch_offsets {host_offsets.calls} "
                                   f"times on the host")

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
    # cuDNN picks its conv algorithms anew in each run, and some add in a
    # varying order: its deterministic choice makes the CUDA step the same
    # from run to run (the port's own kernels are), so that the comparison
    # below does not move between runs of this script.
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pair = {}
    for key, d in (("cpu", "cpu"), ("cuda", "cuda"), ("cuda again", "cuda")):
        o = TrainOptions().parse(strain + ["--device", d], quiet=True)
        pair[key] = create_model(o)
        pair[key].setup()
    sbatch = next(iter(create_dataset(o)))
    draws = pair["cpu"].draw(1)
    for m in pair.values():
        m.set_input(sbatch)
        m.optimize_parameters(1, draws=draws)
    torch.backends.cudnn.deterministic = cudnn_det
    same = all(torch.equal(pair["cuda"].adam[net].mu[k], pair["cuda again"].adam[net].mu[k])
               for net in ("G", "D", "D2") for k in pair["cuda"].adam[net].mu)
    print(f"[train ref] two 256² CUDA steps from the same weights and draws give the same "
          f"gradients bit for bit: {same}")
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
                                                  flops=0.0, bytes=0.0, err=0.0, per=0,
                                                  dev=[]))
        for k_, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                      ("flops", flops), ("bytes", nbytes)):
            acc[k_] += per * v
        acc["err"] = max(acc["err"], err)
        acc["per"] += per
        bound, by = bound_ms(flops, nbytes)
        shape_rows.append(dict(kernel=kname, path=path, shape=shape, launches=per, ms=ms,
                               plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                               tflops=flops / ms / 1e9, max_abs_err=err, device_ms=None))
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

    def indexing(img1, ox1, oy1):
        """The library call: advanced indexing on window indices already made."""
        ar = torch.arange(32, device=dev)
        iy = (oy1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, :, None]
        ix = (ox1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, None, :]
        return lambda: img1[iy, ix]

    # Device-only times come from torch.profiler, run after the step timing
    # below: a profiler session slows the host's later calls.  ``deferred``
    # holds what those runs need: (row key, launches, shape row, kernel
    # call, kernel name, library call, line to print).
    deferred = []

    def time_gather(path, per, ims, kw, offsets, what):
        """One K2 launch on (1, 1536², C) images at K windows, as the main path
        calls it; the library time sums indexing over the group's sources."""
        call = lambda: k2.gather_patches_group(ims, cutout=32, **kw)
        if "coords" in kw:
            plain = lambda: [k2.gather_patches_plain(
                im, *k2.patch_offsets(kw["coords"])[:2], 32) for im in ims]
        else:
            plain = lambda: [k2.gather_patches_plain(im, *offsets, 32) for im in ims]
        ms = cuda_ms(call, reps=50)
        host = host_ms(call)
        plain_ms = cuda_ms(plain, reps=50)
        libs = [indexing(im[0], *offsets) for im in ims]
        lib = sum(cuda_ms(f, reps=50) for f in libs)
        chans = [im.shape[-1] for im in ims]
        kk = offsets[0].numel()
        wbytes = kk * 8 * 4 if "coords" in kw else 2 * kk * 4
        bound, _ = add("gather_patches", path, per, ms, plain_ms, lib, 0.0,
                       gather_bytes(*offsets, chans, wbytes), 0.0,
                       [1, CANVAS, CANVAS, chans, kk, 32])
        line = (f"[time K2 {path}] {what}: (1,{CANVAS},{CANVAS},{chans}) K={kk} cut 32 from "
                f"{'coords' if 'coords' in kw else 'offsets'}: kernel {ms:.4f} ms (host only "
                f"{host:.4f} ms, device only {{dev}}), plain {plain_ms:.4f} ms, indexing "
                f"{lib:.4f} ms (device only {{lib_dev}}), bound {bound:.5f} ms (bytes), "
                f"{per} per {'sample' if path == 'eval' else 'step'}")
        deferred.append((("gather_patches", path), per, len(shape_rows) - 1, call,
                         "gather_group_kernel", lambda: [f() for f in libs], line))

    # eval: fake_T (1, 1536², 2) at the K = 100 test patches' coords
    time_gather("eval", PER_SAMPLE["gather_patches"], (img2[:1],),
                dict(coords=coords[:1].contiguous()), k2.patch_offsets(coords[0])[:2],
                "fake_T at the test patches")
    for row in k2_train:
        time_gather("train", 1, row["images"], row["kw"], row["offsets"],
                    f"group {row['group']}")
        del row["images"]

    # K2 bwd at the check's windows (out-of-bounds ones and 10 on one spot,
    # as PR 2 timed it), and beside it at in-bounds windows, as the data
    # pipeline cuts them
    tc1 = ties[:1, :K_TRAIN].contiguous()
    inb = tc1.clone()
    inb[..., :2] = torch.randint(0, CANVAS - 32, (1, K_TRAIN, 2), generator=gen).float()
    inb[..., 5], inb[..., 6:] = 1.0, 0.0
    gp1 = gpatch[:K_TRAIN].contiguous()
    shape1 = (1, CANVAS, CANVAS, 2)
    for label, wc in (("", tc1), (" in-bounds windows", inb)):
        oxt1, oyt1 = k2.patch_offsets(wc[0])[:2]
        call = lambda wc=wc: k2.scatter_patches(gp1, None, None, shape1, coords=wc)
        ms = cuda_ms(call, reps=50)
        host = host_ms(call)
        plain = cuda_ms(lambda: k2.scatter_patches_plain(
            gp1, *k2.patch_offsets(wc)[:2], shape1), reps=50)
        ar = torch.arange(32, device=dev)
        iy = (oyt1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, :, None]
        ix = (oxt1.long()[:, None] + ar).clamp(0, CANVAS - 1)[:, None, :]
        flat = (iy * CANVAS + ix).reshape(-1)                       # (K·32·32,) pixel index
        gflat = gp1.reshape(-1, 2)
        index_add = lambda flat=flat: torch.zeros(CANVAS * CANVAS, 2,
                                                  device=dev).index_add_(0, flat, gflat)
        lib = cuda_ms(index_add, reps=50)
        nbytes = CANVAS * CANVAS * 2 * 4 + K_TRAIN * 32 * 32 * 2 * 4 + K_TRAIN * 8 * 4
        if label:
            bound = bound_ms(0.0, nbytes)[0]
            key, idx = None, None
        else:
            bound, _ = add("scatter_patches", "train", PER_STEP["scatter_patches"], ms, plain,
                           lib, 0.0, nbytes, k2b_err, [1, CANVAS, CANVAS, 2, K_TRAIN, 32])
            key, idx = ("scatter_patches", "train"), len(shape_rows) - 1
        line = (f"[time K2 bwd{label}] (1,{CANVAS},{CANVAS},2) K={K_TRAIN} cut 32 from coords: "
                f"kernel {ms:.4f} ms (host only {host:.4f} ms, device only {{dev}}), plain "
                f"(index_put_) {plain:.4f} ms, zeros + index_add_ {lib:.4f} ms (device only "
                f"{{lib_dev}}), bound {bound:.5f} ms (bytes: the canvas write, "
                f"{CANVAS * CANVAS * 8 / 1e6:.1f} MB, dominates)")
        deferred.append((key, PER_STEP["scatter_patches"], idx, call, "scatter_tile_kernel",
                         index_add, line))
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
    with CountPatchOffsets() as host_offsets:
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
    check(host_offsets.calls == 0, f"7 training steps called patch_offsets "
                                   f"{host_offsets.calls} times on the host")
    del model, batch

    # device-only times of K2 and K2 bwd, and of their library calls
    for key, per, idx, call, kname_, lib_fn, line in deferred:
        dev_t, lib_t = device_ms(call, kname_), device_ms(lib_fn, "")
        if key is not None:
            shape_rows[idx]["device_ms"] = dev_t
            rows[key]["dev"].append(None if dev_t is None else per * dev_t)
        print(line.format(dev=fmt_ms(dev_t), lib_dev=fmt_ms(lib_t)))

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
        dev_t = sum(acc["dev"]) if acc["dev"] and None not in acc["dev"] else None
        src, repl = sources[kname]
        print(f"[time {kname} {path}] per {'test sample' if path == 'eval' else 'training step'}: "
              f"{launches} launches, kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, "
              f"library {acc['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), device only "
              f"{fmt_ms(dev_t)}")
        kernels.append(dict(name=f"{kname}@{path}", route="cuda", source=src, replaces=repl,
                            launches=launches, max_abs_err=acc["err"], ms=acc["ms"],
                            plain_ms=acc["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                            library_ms=acc["library_ms"], device_ms=dev_t, path=path,
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
