#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (vts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device: name, compute capability (must be 9.0), nvidia-smi name and
     power limit; builds every kernel from vts_torch/csrc (one nvcc per
     source, all started together);
  2. kernels against their plain PyTorch versions on the card, at the shapes
     the eval path gives them, TF32 off: K1 within 1e-4·max|ref| + 1e-5,
     K2 bit-exact (both modes, the batched form, overlapping and
     out-of-bounds windows);
  3. the slice end to end: a seeded ngf-10 generator written as
     best_net_G.msgpack, then ``vts_torch.test.test`` on a 1800² synthetic
     garment (1536² canvas, K = 100 test patches) with --device cuda; all 8
     metrics finite, and every kernel's launch count > 0 in that run; then
     ``vts_torch.test`` at 256² on cuda and on cpu (plain versions) agree;
  4. times (CUDA events, warm-up, median of >= 10 runs): each kernel and its
     plain version and library call at each path shape, the bound from the
     shapes, and the wall time of one test sample.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Nothing is printed as a result unless
every phase passed.  No JAX and nothing of vts_tpu is imported.
"""

from __future__ import annotations

import json
import math
import os
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
CANVAS, PADDED, NGF, K_PATCH = 1536, 1800, 10, 100


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from vts_torch.config import TestOptions
    from vts_torch.kernels import build
    from vts_torch.models import create_model
    from vts_torch.ops import conv3x3 as k1
    from vts_torch.ops import patch as k2
    from vts_torch.test import test as run_test

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

    img2 = torch.randn(2, CANVAS, CANVAS, 2, generator=gen).to(dev)
    ox = torch.randint(-40, CANVAS + 8, (2, K_PATCH), generator=gen)
    oy = torch.randint(-40, CANVAS + 8, (2, K_PATCH), generator=gen)
    ox[:, :10], oy[:, :10] = 500, 600            # overlapping windows
    ox, oy = ox.to(dev, torch.int32), oy.to(dev, torch.int32)   # as patch_offsets gives
    k2_err = 0.0
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

    # ---------------------------------------------------------------- 3 ---
    tmp_dir = tempfile.TemporaryDirectory(prefix="vts_torch_smoke_")
    tmp = tmp_dir.name
    argv = ["--model", "sinskit", "--epoch", "best", "--name", "smoke",
            "--dataroot", f"synthetic://smoke?size={PADDED}", "--device", "cuda",
            "--ngf", str(NGF), "--crop_size", str(CANVAS),
            "--batch_size_G2", str(K_PATCH),
            "--checkpoints_dir", os.path.join(tmp, "ckpt"),
            "--results_dir", os.path.join(tmp, "res")]
    opt = TestOptions().parse(argv, quiet=True)
    model = create_model(opt)
    model.setup()
    model.save_networks("best")
    del model
    torch.cuda.synchronize()
    k1.conv3x3_bias_relu.launches = 0
    k2.gather_patches.launches = 0
    t0 = time.time()
    metrics = run_test(argv)[0]
    t_slice = time.time() - t0
    launches = {"conv3x3_bias_relu": k1.conv3x3_bias_relu.launches,
                "gather_patches": k2.gather_patches.launches}
    print(f"[slice] {len(metrics)} metrics in {t_slice:.2f} s (first run, incl. data "
          f"and model set-up): " + " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
    print(f"[slice] launches during the run: {launches}")
    check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
          f"expected 8 finite metrics, got {metrics}")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")

    small = ["--model", "sinskit", "--epoch", "best", "--name", "small",
             "--dataroot", "synthetic://small?size=320&center_w=192&center_h=128"
                           "&patches=6&val_patches=3",
             "--crop_size", "256", "--center_w", "192", "--center_h", "128",
             "--ngf", "4", "--batch_size_G2", "4", "--init_gain", "0.5",
             "--checkpoints_dir", os.path.join(tmp, "ckpt"),
             "--results_dir", os.path.join(tmp, "res")]
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
    kernels = []
    shape_rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
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
        bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        m = row["per_sample"]
        for k_, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                      ("flops", flops), ("bytes", nbytes)):
            tot[k_] += m * v
        shape_rows.append(dict(kernel="conv3x3_bias_relu", shape=row["shape"],
                               per_sample=m, ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bound, tflops=flops / ms / 1e9,
                               max_abs_err=row["err"]))
        print(f"[time K1] {(n, h, w, c)}->{co}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"F.conv2d+relu {lib:.4f} ms, bound {bound:.4f} ms (operations), "
              f"{flops / ms / 1e9:.2f} TFLOP/s")
    k1_bound = max(tot["flops"] / PEAK_FP32_FLOPS, tot["bytes"] / PEAK_HBM_BYTES) * 1e3
    kernels.append(dict(
        name="conv3x3_bias_relu", route="cuda", source="vts_torch/csrc/conv3x3.cu",
        replaces="vts_tpu/ops/pallas_conv.py:42", launches=launches["conv3x3_bias_relu"],
        max_abs_err=max(r["err"] for r in k1_rows), ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=k1_bound,
        bound_by="operations" if tot["flops"] / PEAK_FP32_FLOPS >= tot["bytes"] / PEAK_HBM_BYTES
        else "bytes",
        library_ms=tot["library_ms"]))

    img1, ox1, oy1 = img2[0], ox[0], oy[0]
    ms = cuda_ms(lambda: k2.gather_patches(img1, ox1, oy1, 32), reps=50)
    plain = cuda_ms(lambda: k2.gather_patches_plain(img1, ox1, oy1, 32), reps=50)
    ar = torch.arange(32, device=dev)
    iy = (oy1.long()[:, None] + ar).clamp(0, CANVAS - 1)
    ix = (ox1.long()[:, None] + ar).clamp(0, CANVAS - 1)
    iy, ix = iy[:, :, None], ix[:, None, :]
    lib = cuda_ms(lambda: img1[iy, ix], reps=50)
    touched = torch.zeros(CANVAS, CANVAS, dtype=torch.bool, device=dev)
    touched[iy.expand(-1, -1, 32), ix.expand(-1, 32, -1)] = True
    out_bytes = K_PATCH * 32 * 32 * 2 * 4
    nbytes = int(touched.sum().item()) * 2 * 4 + out_bytes + 2 * K_PATCH * 4
    bound = nbytes / PEAK_HBM_BYTES * 1e3
    shape_rows.append(dict(kernel="gather_patches", shape=[1, CANVAS, CANVAS, 2, K_PATCH, 32],
                           per_sample=1, ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bound, max_abs_err=0.0))
    print(f"[time K2] (1,{CANVAS},{CANVAS},2) K={K_PATCH} cut 32: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, indexing {lib:.4f} ms, bound {bound:.5f} ms (bytes)")
    kernels.append(dict(
        name="gather_patches", route="cuda", source="vts_torch/csrc/gather_patches.cu",
        replaces="vts_tpu/ops/pallas_gather.py:34", launches=launches["gather_patches"],
        max_abs_err=k2_err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
        library_ms=lib))

    # one test sample: G forward + the 8 metrics, after a warm-up
    topt = TestOptions().parse(argv, quiet=True)
    from vts_torch.data import create_dataset
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
