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
     1e-4·max|ref| + 1e-5; K1 and K1 dx at two path shapes against an
     fp64 reference, within 0.05 of that limit and with a relative bias
     under 1e-6 (the kernel's 3xTF32 sums keep fp32 accuracy); K2 forward
     bit-exact at the eval shape, from offsets and from coords (.5 ties
     included), and at each of the training
     step's three launch groups (1 to 4 sources of 1, 2 and 3 channels,
     K = 64 and 32, N = 1 and 2); K2 backward (the tile-owner scatter-add)
     bit-exact against index_put_(accumulate=True) run serially on the CPU,
     from offsets and from coords, and the same bits in two card runs — both
     modes, the batched form, overlapping and out-of-bounds windows;
  3. the test slice end to end: a seeded ngf-10 generator written as
     best_net_G.msgpack, then ``vts_torch.test.test`` on a 1800² synthetic
     garment (1536² canvas, K = 100 test patches) with --device cuda; all 8
     metrics finite, the forward kernels' launch counts > 0 in that run, and
     no patch_offsets call on the host (K2 decodes the coords); its HTML
     gallery (PNGs, raw gx/gy npz, patch-coords JSON, index.html) written,
     the gallery's time and K2 launch on a line of their own and outside the
     sample's counts; then ``vts_torch.test`` at 256² on cuda and on cpu
     (plain versions) agree;
  4. the training slice end to end: ``vts_torch.train`` on the same garment
     at the full-width training defaults (1536² crop, ngf 10, ndf 8, K = 64
     patches + 32 "more fake T", batch_size_G2_val 128, the full CLIP
     ViT-B/32 for D3) for 2 epochs of 2 steps with D3 switched on at epoch
     2 and the gallery written once (after the last step); every loss
     finite, G_D3 and D3_loss among epoch 2's, the launch counts of K1 fwd,
     K1 dx, K2 fwd and K2 bwd all > 0 in that run, the gallery and the G, D
     and D2 checkpoints with their Adam files written, one more D3-active
     step launching each kernel as often as ``PER_STEP`` says, and the best
     G then loading into ``vts_torch.test``; then 256² training steps on
     cuda (cuDNN's deterministic algorithms; a second CUDA step shows
     whether the step repeats bit for bit) and on cpu from the same weights
     and draws, before D3's warmup and with D3 active: losses within rtol
     1e-4, Adam first moments (the gradients) within 1e-4 of each leaf's
     max |g| (see :func:`grad_tol` for the two named sets of leaves held to
     a round-off floor);
  4b. the production lane (the round-5 ``sched_anneal`` arm, cut in length
     only): ``vts_torch.train`` on the same garment with ``--dtype bfloat16
     --batch_size 4 --lpips_crop 768 --cache_data_device``, D3 from epoch 2
     and ``--anneal_epoch 3 --anneal_set "lpips_crop=0,batch_size=2,
     remat_g=on,lpips_remat=off"``, 3 epochs of 4 samples: every loss
     finite, the ``[anneal]`` switch seen, every kernel launched, one more
     step launching as ``PER_STEP_BF16`` says; the best G through
     ``vts_torch.test --dtype bfloat16 --batch_size 2``, which runs at batch
     1; then a 256² bf16 training step (--lpips_crop 128, batch 2) on cuda
     and on cpu from the same weights and draws, held to the bf16 bound of
     ``tests/test_torch_port_lanes.py`` with the cpu fp32 step as the
     reference.  Before it (phase 2b), the kernels in bf16 at the lane's
     shapes, before and after the anneal: K1 and K1 dx against their plain
     versions in bf16 within one bf16 rounding of each output on top of the
     fp32 limit (2^-7·|ref| + 1e-4·max|ref| + 1e-5), and at two of those
     shapes against fp64 (within the same limit, with a relative bias against
     the fp64 result rounded once to bf16 under 1e-6); one bf16 call of each
     traced by torch.profiler shows the conv kernel and no copy kernel; K2
     bit-exact, K2 bwd with a bf16 cotangent bit-exact against the serial
     CPU index_put_ rounded once to bf16;
  2c. the kernels at the tactile super-resolution shapes, TF32 off: K1 and
     K1 dx at the x2 (64² patches) and x4 (128²) touch-patch LPIPS shapes
     within the fp32 limit; K2 bit-exact at cut 64 on a 3072² touch canvas
     with x2 coords and at cut 128 on 6144² with x4 coords, from coords and
     from offsets (edge and out-of-bounds windows included); K2 bwd there
     bit-exact against the serial CPU index_put_, the same bits twice;
  4c. the x2 path (--T_resolution_multiplier 2) at the full-width training
     defaults on a x2 garment: ``vts_torch.train`` for 2 epochs of 2 steps
     with D3 from epoch 2 and the gallery once, every loss finite, every
     kernel launched, one D3-active step launching as ``PER_STEP_TMULT2``
     says (5 K2 launches), no patch_offsets call on the host; its best G
     through ``vts_torch.test`` (8 finite metrics); a 256² x2 step on cuda
     and on cpu from the same weights and draws, as in phase 4 except that
     G's per-leaf limit is 4x and G is also held to 1e-4 in the 2-norm (see
     :func:`compare_steps`);
  4d. one full-width x4 step (6144² touch canvas, D3 active) with its wall
     and peak memory; a 256² step with --gan_mode wgangp --normD instance
     --diffaugment bscton --netD patch --netD2 pixel (learning rates 0, see
     ``SURFACE_ARGS``) on cuda and on cpu (the penalty's double backward on
     the card), as in phase 4 with the round-off leaves found from the CPU
     gradient;
  4e. skitG (--model skit), the multi-garment model with the CLIP style code,
     at the full-width training defaults on two synthetic garments (synthA,
     synthB; style code tile/concat at one level, so up7 takes 8·ngf + 512
     channels): ``vts_torch.train`` for 2 epochs of one sample of each, D3
     from epoch 2, the gallery once, every loss finite, every kernel
     launched, one D3-active step launching as ``PER_STEP`` says; its best G
     through ``vts_torch.test`` on both garments under --eval_mode batched
     and legacy, 8 finite metrics a sample and both garments in
     eval_metrics_per_material.pkl (printed); garment A's fake_I with B's
     style image differs from it with A's (beyond A's twice); K1 at the
     legacy evaluation's shapes for garment A's valid patches (T_LPIPS in
     chunks of 16 pairs: (32, 224², ·) and the remainder) within the fp32
     limit; a 256² skitG step on cuda and on cpu from the same weights,
     style code (encoded on the cpu) and draws, held as the x2 step of 4c is;
  4f. the edit → render workflow (:func:`edit_render_workflow`): two on-disk
     garments written from the synthetic one at 1800² and their edited
     twins (sketch and mask mirrored, no visual image, no touch records);
     ``vts_torch.launch ours launch --mode process`` trains both at once on
     the card at the full-width defaults, cut in length only (1 epoch of 2
     samples, D3 off), then each alone; ``launch ours test`` (8 finite
     metrics each), ``launch ours_edit test`` on the edited sketches (the
     gallery and the raw touch map at the canvas size, ``{}`` metrics, no
     per-material roll-up; fake_I moved by the edit beyond run-to-run
     noise); every child reports running on cuda; the metric roll-up with
     its MEAN row, ``launch ours compare``, the postprocess of each raw touch
     map in all five modes (1280×800 maps in [0, 1]; which CLAHE branch
     ran); a short 256² training run with ``--display_id 1 --display_port 0``
     whose ``/data.json`` is read over 127.0.0.1 while it trains (the loss
     history grows; the server is closed at the end);
  5. times (CUDA events, warm-up, median of >= 10 runs): each kernel and its
     plain version and library call at each path shape, the bound from the
     shapes (K1 and K1 dx against the TF32 tensor cores at three passes,
     their fp32 CUDA-core bound beside it; a row's bound is the sum over its
     shapes of launches × that shape's bound), and the device-only time of
     every kernel from one torch.profiler session, beside CUDA events in that
     session (medians over the runs); the D3 part of a step (both CLIP
     passes, the backward, resize_mm) by events; the device-only times of
     the library calls and the D3 part from a second session, in a process
     of its own that maps these tensors; the wall time of one test sample,
     and of one 1536²
     training step before D3's warmup and with D3 active (median of 5
     after 2 warm-ups each) with its peak memory and launches (and no
     patch_offsets call on the host); the bf16 lane's kernels the same way
     (bound at the bf16 tensor-core rate and bf16 bytes, library calls in
     bf16, the route K1's bf16 instance replaced — widened to the fp32
     kernel and rounded back — beside it), and the lane's untraced step with
     D3 active before and after the anneal (median of 5 after 2 warm-ups,
     samples/s, peak memory); the x2 path's kernels at one step's shapes,
     its untraced D3-active step (median of 5 after 2 warm-ups, samples/s,
     peak memory) and one x2 test sample; K1 and K2 at the legacy
     evaluation's shapes; one skitG test sample (garment A) under each
     evaluation, with its launches, the style encode, and the untraced
     skitG D3-active step (median of 5 after 2 warm-ups, samples/s, peak
     memory, launches); phase 4f's edit test sample (median of 3 after 1),
     its launcher walls (two processes at once, and one after the other)
     and the postprocess's host time per map in each mode.

The second-to-last line is ``{"kernels": [...]}``, one row per kernel and
path: an ``eval`` row covers one test sample (its launches are the test
run's, which holds one sample, less the gallery's), a ``train`` row one
training step (its launches are those of a timed D3-active step, counted
from 0), a ``train_bf16`` row one step of the production lane before its
anneal (likewise), a ``train_tmult2`` row one D3-active x2 step and an
``eval_legacy`` row one skitG test sample under --eval_mode legacy (its
launches counted in that sample); ``ms``, ``plain_ms``,
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
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores,
# TF32 on the tensor cores and HBM3 bandwidth.  Stated against the card's
# power limit, printed below.  K1 runs fp32 as three TF32 passes (3xTF32), so
# its operations bound is 3·FLOPs at the TF32 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
K1_PEAK = PEAK_TF32_FLOPS / 3
PEAK_HBM_BYTES = 3.35e12
# dense bf16 on the tensor cores: the bound of the bf16 lane's rows
PEAK_BF16_FLOPS = 989e12

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
# The round-5 production lane (scripts/round5_queue.sh:50-53, r5_anneal.sh:29-35):
# bf16, batch 4, the canvas LPIPS on one 768² window; after the anneal batch 2
# on the full canvas.  K1 before the anneal, (N, H, W, C, Co, forward launches
# per step, dx launches per step): the canvas LPIPS runs x and y on the four
# images' 768² windows, the patch LPIPS gx and gy of 4·64 fake_T patches as
# one 2·4·64 batch; dx for x only.  After the anneal (checked, not timed):
# the canvas at batch 2 and 2·2·64 patches.
LANE_ARGS = ["--dtype", "bfloat16", "--batch_size", "4", "--lpips_crop", "768",
             "--cache_data_device", "--remat_g", "off", "--lpips_remat", "off"]
LANE_ANNEAL = "lpips_crop=0,batch_size=2,remat_g=on,lpips_remat=off"
K1_BF16 = [
    (4, 768, 768, 64, 64, 2, 1),
    (4, 384, 384, 64, 128, 2, 1),
    (4, 384, 384, 128, 128, 2, 1),
    (512, 32, 32, 64, 64, 2, 1),
    (512, 16, 16, 64, 128, 2, 1),
    (512, 16, 16, 128, 128, 2, 1),
]
K1_BF16_ANNEALED = [(2, 1536, 1536, 64, 64), (2, 768, 768, 64, 128), (2, 768, 768, 128, 128),
                    (256, 32, 32, 64, 64)]
PER_STEP_BF16 = {"conv3x3_bias_relu": sum(r[5] for r in K1_BF16),
                 "conv3x3_dx": sum(r[6] for r in K1_BF16),
                 "gather_patches": len(K2_TRAIN), "scatter_patches": 1}
# The x2 tactile super-resolution path (--T_resolution_multiplier 2): a
# 3072² touch canvas and 64² touch patches.  K1 at the canvas as in K1_TRAIN
# and at the patches (the patch LPIPS on 2·64 64² patches, x and y, dx for x).
# K2 in five groups a step, one launch each: (group, canvas side, channels, K,
# windows, cut, scale multiplier of the coords).  A_T: fake_T for D2 at the
# batch's coords; A_SI: S and the two augmented I there at 32²; B_T: fake_T
# at the "more fake T" offsets on the touch canvas; B_SI: fake_I and S at
# those offsets // 2; C: fake_T for G's losses (the gather with K2 bwd).
TMULT = 2
TOUCH2, TOUCH4 = CANVAS * 2, CANVAS * 4
K1_TMULT2 = K1_TRAIN[:3] + [(128, 64, 64, 64, 64, 2, 1), (128, 32, 32, 64, 128, 2, 1),
                            (128, 32, 32, 128, 128, 2, 1)]
K1_TMULT4 = [(128, 128, 128, 64, 64), (128, 64, 64, 64, 128), (128, 64, 64, 128, 128)]
K2_TMULT2 = [("A_T", TOUCH2, (2,), 64, "coords", 64, 2),
             ("A_SI", CANVAS, (1, 3, 3), 64, "coords", 32, 1),
             ("B_T", TOUCH2, (2,), 32, "offsets", 64, 1),
             ("B_SI", CANVAS, (3, 1), 32, "offsets", 32, 1),
             ("C", TOUCH2, (2,), 64, "coords", 64, 2)]
PER_STEP_TMULT2 = {"conv3x3_bias_relu": sum(r[5] for r in K1_TMULT2),
                   "conv3x3_dx": sum(r[6] for r in K1_TMULT2),
                   "gather_patches": len(K2_TMULT2), "scatter_patches": 1}
X2_DATA = f"synthetic://smoke?size={PADDED}&mult=2"
# the rest of the sinskit training surface, in one 256² step (the patch D2
# cannot run: its per-tile losses do not line up with the patches' mask, in
# the reference too, so the patch D is D1's).  The learning rates are 0, so
# that G's GAN losses read the same Ds on both sides: Adam's first step moves
# every element by ±lr by the sign of its gradient, and under a WGAN loss a
# logit head's bias has an exactly-zero gradient whose round-off takes
# either sign (at the default rates G_GAN read -0.0186 on cuda and -0.0242
# on cpu from the same weights and draws, on an H100).
SURFACE_ARGS = ["--gan_mode", "wgangp", "--normD", "instance", "--diffaugment", "bscton",
                "--netD", "patch", "--netD2", "pixel", "--lr", "0", "--lr_G2", "0"]


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


def device_times(calls):
    """Device-only time of one call of each fn in ms, from one torch.profiler
    session, beside its time by CUDA events in the same session: a list of
    (device ms, events ms, first run's device ms).  ``calls`` holds (fn,
    name, reps): each fn runs twice to warm up, then reps times between two
    markers (spin kernels, ``torch.cuda._sleep``) of its span, with an
    event pair around each run.  A run's device time is the time in which
    at least one of its kernels whose name holds ``name`` (every kernel if
    ``name`` is empty) runs (some cuDNN calls run kernels side by side);
    both times are the median over the runs.  Nones where the span shows no
    such kernel, or one a number of times that is not a multiple of reps
    (the trace lost launches); all Nones if the spans cannot be told apart
    (a marker lost in each of three sessions: a session that loses one, as
    one of 68 calls' did on an H100 after the lead run of spins, is run
    again).  One session: a session per call lost launches after some dozens
    of sessions on the H100, and a second session in a process recorded only
    part of its spans (:func:`library_device_times` runs one in a process of
    its own)."""
    for fn, _, _ in calls:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        out = _device_times_session(calls)
        if out is not None:
            return out
    return [(None, None, None)] * len(calls)


def _device_times_session(calls):
    """One profiler session of :func:`device_times`; None if it lost a marker."""
    from torch.profiler import ProfilerActivity, profile

    def marker():
        # two spin kernels; a run of spins is one marker
        torch.cuda._sleep(1000)
        torch.cuda._sleep(1000)
    evs = [[(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(reps)] for _, _, reps in calls]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the session's first device events go missing on an H100 now and
        # then (58 markers for 58 calls): a run of spins to lose first, which
        # merges with the first call's marker
        for _ in range(8):
            marker()
        torch.cuda.synchronize()
        time.sleep(0.05)
        for (fn, _, _), pairs in zip(calls, evs):
            # two warm-ups right before the runs, as cuda_ms does, in a span
            # of their own
            marker()
            fn()
            fn()
            marker()
            for st, en in pairs:
                st.record()
                fn()
                en.record()
        marker()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    spans, in_marker = [], False
    for e in events:
        if "spin" in e.name:
            if not in_marker:
                spans.append([])
            in_marker = True
        else:
            in_marker = False
            if spans:
                spans[-1].append(e)
    if len(spans) != 2 * len(calls) + 1:
        print(f"[device-only] the session shows {len(spans)} markers for {len(calls)} calls "
              f"({len(events)} device events)")
        return None
    out = []
    for (_, name, reps), span, pairs in zip(calls, spans[1::2], evs):
        mine = [e for e in span if name in e.name]
        if not mine or len(mine) % reps:
            out.append((None, None, None))
            continue
        k = len(mine) // reps
        per_run = [busy_us(mine[i * k:(i + 1) * k]) / 1e3 for i in range(reps)]
        out.append((statistics.median(per_run),
                    statistics.median(st.elapsed_time(en) for st, en in pairs), per_run[0]))
    return out


def busy_us(events):
    """The µs in which at least one of ``events`` (sorted by start) runs."""
    total, end = 0.0, float("-inf")
    for e in events:
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            total += e.time_range.end - start
            end = e.time_range.end
    return total


def d3_part(clip, heads, real_I, fake_I):
    """The D3 part of a step: CLIP of the real I without a gradient, CLIP of
    fake_I with one, the backward to fake_I (through the 12 blocks and
    resize_mm)."""
    from vts_torch.losses.vision_aided import d3_logits, softplus

    def run():
        with torch.no_grad():
            d3_logits(clip, heads, real_I)
        f = fake_I.detach().requires_grad_(True)
        loss = sum(torch.mean(softplus(-lg)) for lg in d3_logits(clip, heads, f))
        return torch.autograd.grad(loss, f)[0]
    return run


def library_call(spec):
    """The library call that a timed row is set beside, from its spec
    (kind, tensors...): ``conv_relu`` cuDNN's conv + ReLU; ``conv_dx``
    cuDNN's input gradient of the masked cotangent; ``indexing`` advanced
    indexing at each (image, row index, column index); ``index_add`` zeros +
    index_add_; ``d3`` the D3 part of a step on the seeded CLIP tower and
    heads the model builds; ``resize`` resize_mm to 224²."""
    import torch.nn.functional as F
    kind, args = spec[0], spec[1:]
    if kind == "conv_relu":
        x, w, b = args
        return lambda: F.relu(F.conv2d(x, w, b, padding=1))
    if kind == "conv_dx":
        shape, w, gy, y = args
        return lambda: torch.nn.grad.conv2d_input(shape, w, gy * (y > 0), padding=1)
    if kind == "indexing":
        return lambda: [img[iy, ix] for img, iy, ix in args[0]]
    if kind == "index_add":
        numel, flat, g = args
        return lambda: torch.zeros(numel, 2, device=g.device, dtype=g.dtype).index_add_(
            0, flat, g)
    if kind == "d3":
        from vts_torch.losses.vision_aided import D3Heads, init_d3_head_params
        from vts_torch.networks.clip_vit import CLIPViT, init_clip_params
        real_I, fake_I = args
        clip = CLIPViT(init_clip_params(0)).to(real_I.device)
        heads = D3Heads(init_d3_head_params(0)).to(real_I.device)
        return d3_part(clip, heads, real_I, fake_I)
    if kind == "resize":
        from vts_torch.ops.resize_mm import resize_mm
        return lambda: resize_mm(args[0], (224, 224))
    raise ValueError(kind)


def backend_flags():
    """The backend settings a timed library call depends on (TF32 off in
    cuDNN and cuBLAS, cuDNN's algorithm choice), to carry into a child."""
    b = torch.backends
    return dict(cudnn_tf32=b.cudnn.allow_tf32, matmul_tf32=b.cuda.matmul.allow_tf32,
                deterministic=b.cudnn.deterministic, benchmark=b.cudnn.benchmark)


def _library_device_times(conn):
    """Child process of :func:`library_device_times`: takes the parent's
    backend flags and the specs from ``conn``, sends the times back after
    dropping every tensor it mapped."""
    import gc
    flags, specs = conn.recv()
    b = torch.backends
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = flags["cudnn_tf32"], flags["matmul_tf32"]
    b.cudnn.deterministic, b.cudnn.benchmark = flags["deterministic"], flags["benchmark"]
    try:
        if backend_flags() != flags:
            raise RuntimeError(f"backend flags {backend_flags()} differ from the parent's {flags}")
        calls = [(library_call(spec), "", reps) for spec, reps in specs]
        out = device_times(calls)
    except Exception as e:                      # noqa: BLE001 (sent back and printed)
        out = f"{type(e).__name__}: {e}"
    calls = specs = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    conn.send(out)
    conn.close()


def library_device_times(specs, timeout=600):
    """:func:`device_times` of the library calls of ``specs`` ((spec, reps)
    pairs, see :func:`library_call`) in a profiler session of a process of
    its own, which maps this process's tensors (CUDA IPC): with our kernels
    in one session the library calls and the D3 part (65k-108k device
    events) lost span markers on an H100.  The child runs under this
    process's backend flags: a fresh process has cuDNN's TF32 on."""
    ctx = torch.multiprocessing.get_context("spawn")
    here, there = ctx.Pipe()
    proc = ctx.Process(target=_library_device_times, args=(there,))
    proc.start()
    there.close()
    try:
        here.send((backend_flags(), specs))
        out = here.recv() if here.poll(timeout) else f"no answer in {timeout} s"
    except (EOFError, OSError):
        out = f"the process ended with code {proc.exitcode}"
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if isinstance(out, str):
        print(f"[device-only] library calls: {out}; not measured")
        return [(None, None, None)] * len(specs)
    return out


def card_state():
    """The card's SM clock, power draw and temperature, as nvidia-smi reads
    them now."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


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


def fmt_dev(times):
    """A (device ms, events ms, first run's device ms) of
    :func:`device_times` as printed."""
    dev, ev, first = times
    return "not measured" if dev is None else (f"{dev:.5f} ms, first run {first:.5f} ms; "
                                               f"events in its session {ev:.5f} ms")


def bf16_tol(ref):
    """Elementwise limit of a bf16 kernel output against its plain version:
    both sum in fp32 (the fp32 limit) and round once to bf16 (2^-8 of the
    value each)."""
    r = ref.float().abs()
    return 2 ** -7 * r + 1e-4 * r.max() + 1e-5


class Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def rel_norm(a, b, ref):
    """‖a − b‖ / ‖ref‖ over the leaves of three dicts of tensors."""
    d = sum(((a[k].double().cpu() - b[k].double().cpu()) ** 2).sum().item() for k in ref)
    r = sum((ref[k].double().cpu() ** 2).sum().item() for k in ref)
    return math.sqrt(d / r) if r else 0.0


def bound_ms(flops, nbytes, peak=PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
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
ZERO_GRAD = re.compile(r"(down[1-6]|up[1-7](_T)?|up0_T_extra\d|Conv4x4_[123])\W.*bias")
CANCELLING = re.compile(r"Conv4x4_4\W.*bias")


def grad_tol(name, g, net_max):
    """|Δg| bound of one gradient leaf: 1e-4 of the leaf's max |g|; 1e-5 of
    the network's max |g| for a :data:`ZERO_GRAD` leaf, and that floor on
    top for a :data:`CANCELLING` one."""
    if ZERO_GRAD.search(name):
        return 1e-5 * net_max
    return 1e-4 * g.abs().max().item() + (1e-5 * net_max if CANCELLING.search(name) else 0.0)


def gather_bytes(ox, oy, chans, window_bytes, cut=32, esize=4, side=CANVAS):
    """Bytes one grouped gather must move: each canvas pixel that an image's
    windows ((N, K) or (K,) offsets) touch read once from every source, the
    patches written once, the windows (offsets or coords) read once."""
    ar = torch.arange(cut, device=ox.device)
    pixels = ox.numel() * cut * cut
    for oxi, oyi in zip(ox.reshape(-1, ox.shape[-1]), oy.reshape(-1, oy.shape[-1])):
        iy = (oyi.long()[:, None] + ar).clamp(0, side - 1)[:, :, None].expand(-1, -1, cut)
        ix = (oxi.long()[:, None] + ar).clamp(0, side - 1)[:, None, :].expand(-1, cut, -1)
        touched = torch.zeros(side, side, dtype=torch.bool, device=ox.device)
        touched[iy, ix] = True
        pixels += int(touched.sum().item())
    return pixels * sum(chans) * esize + window_bytes


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


def compare_steps(label, cpu, cuda, g_scale=1.0, named=True):
    """Losses within rtol 1e-4 (+1e-7) and each network's gradient (Adam's
    first moment after one step, β1 = 0) per leaf within :func:`grad_tol`
    of a CUDA step against the CPU step from the same weights and draws.
    ``named``: the leaves at round-off (≤ 1e-5 of the network's max) must be
    exactly :data:`ZERO_GRAD`'s; otherwise (other nets and losses, whose
    round-off leaves the names do not cover) every such leaf is held to that
    round-off floor.  ``g_scale`` multiplies G's per-leaf limit, and G is
    then also held to 1e-4 in the 2-norm over the network (the x2 touch
    LPIPS on 64² patches: fp32 max-pool near-ties and ReLU near-zeros flip
    differently in any two fp32 implementations; tests/test_torch_port_
    tmult.py measures it against float64)."""
    lc, lg = cpu.get_current_losses(), cuda.get_current_losses()
    check(set(lc) == set(lg), f"{label}: unexpected losses {sorted(lc)} / {sorted(lg)}")
    worst = max((abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-7), k) for k in lc)
    print(f"[train ref] {label}, cuda vs cpu: worst loss rel {worst[0]:.2e} ({worst[1]})" + (
        f" (G_D3 cuda {lg['G_D3']:.7g} cpu {lc['G_D3']:.7g}, D3_loss cuda "
        f"{lg['D3_loss']:.7g} cpu {lc['D3_loss']:.7g})" if "G_D3" in lc else ""))
    for k in lc:
        check(abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) + 1e-7,
              f"{label}: training loss {k} on cuda {lg[k]} disagrees with cpu {lc[k]}")
    for net in cpu.adam:
        mu_c, mu_g = cpu.adam[net].mu, cuda.adam[net].mu
        net_max = max(v.abs().max().item() for v in mu_c.values())
        at_roundoff = {k for k, v in mu_c.items() if v.abs().max().item() <= 1e-5 * net_max}
        if named:
            check(at_roundoff == {k for k in mu_c if ZERO_GRAD.search(k)},
                  f"{label}, {net}: the leaves at round-off are not the named ones: "
                  f"{sorted(at_roundoff)}")
        scale = g_scale if net == "G" else 1.0

        def tol(k, v):
            if not named and k in at_roundoff:
                return 1e-5 * net_max
            return grad_tol(k, v, net_max) * (1.0 if ZERO_GRAD.search(k) else scale)
        ratio = {k: (mu_g[k].cpu() - v).abs().max().item() / tol(k, v) for k, v in mu_c.items()}
        worst = max(ratio, key=ratio.get)
        norm = rel_norm(mu_g, mu_c, mu_c)
        print(f"[train ref] {label}, {net} grads cuda vs cpu: worst per-leaf |d|/tolerance "
              f"{ratio[worst]:.2e} at {worst} (network max |g| {net_max:.3e}, "
              f"{len(at_roundoff)} leaves at round-off; limit x{scale:g}); |d|/|g| over the "
              f"network {norm:.2e}")
        check(ratio[worst] <= 1.0, f"{label}: {net} gradient {worst} on cuda disagrees with cpu")
        if scale != 1.0:
            check(norm <= 1e-4, f"{label}: {net} gradient on cuda disagrees with cpu in norm")


class Gallery:
    """While entered: the launches and the time of the model's
    ``get_current_visuals`` and the time of the gallery's file writes (the
    test driver's ``save_images``, the training driver's
    ``display_current_results``), kept apart from the run they happen in."""

    def __enter__(self):
        from vts_torch import test as test_mod
        from vts_torch.models.sinskit import SinSKITModel
        from vts_torch.utils.visualizer import Visualizer
        self.launches = dict.fromkeys(KERNELS, 0)
        self.visuals_ms, self.write_ms, self.passes = 0.0, 0.0, 0
        self.patched = [(SinSKITModel, "get_current_visuals"), (test_mod, "save_images"),
                        (Visualizer, "display_current_results")]
        self.real = [getattr(o, a) for o, a in self.patched]
        outer = self

        def visuals(model):
            torch.cuda.synchronize()
            before, t0 = read_counts(), time.perf_counter()
            out = outer.real[0](model)
            torch.cuda.synchronize()
            outer.visuals_ms += (time.perf_counter() - t0) * 1e3
            outer.passes += 1
            for k, v in read_counts().items():
                outer.launches[k] += v - before[k]
            return out

        def timed(real):
            def write(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return real(*a, **kw)
                finally:
                    outer.write_ms += (time.perf_counter() - t0) * 1e3
            return write
        for (o, a), fn in zip(self.patched, [visuals, timed(self.real[1]), timed(self.real[2])]):
            setattr(o, a, fn)
        return self

    def __exit__(self, *exc):
        for (o, a), real in zip(self.patched, self.real):
            setattr(o, a, real)

    def line(self, what):
        return (f"[gallery] {what}: {self.passes} visuals pass(es) {self.visuals_ms:.1f} ms, "
                f"file writes {self.write_ms:.1f} ms; launches {self.launches} (outside the "
                f"path's counts)")


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


# ------------------------------------------------------------------ 4f ---
# the edit → render workflow: two on-disk garments and their edited sketches
ROOT = os.path.dirname(os.path.abspath(__file__))
EDIT_MATERIALS = ("synthA", "synthB")
# what vts_torch.train and vts_torch.test report: the run, its phase, its device
DEVICE_LINE = re.compile(r"\[device\] (\S+) (trains|tests) on (cpu|cuda:\d+ \([^)]*\))")
# the launcher's children at the full-width training defaults, cut in length
# only: 1 epoch of 2 samples, D3 off, no gallery
WORKFLOW_TRAIN = ["--data_len", "2", "--n_epochs", "1", "--n_epochs_decay", "0",
                  "--use_vision_aided_loss", "false", "--no_html"]
# the dashboard's short 256² run: 6 epochs of 4 steps, a loss line each step
DASH_TRAIN = ["--dataroot", SMALL_DATA, "--crop_size", "256", "--center_w", "192",
              "--center_h", "128", "--ngf", "4", "--ndf", "4", "--batch_size_G2", "4",
              "--batch_size_G2_val", "3", "--add_fake_T_sample_size", "3", "--data_len", "4",
              "--n_epochs", "6", "--n_epochs_decay", "0", "--use_vision_aided_loss", "false",
              "--no_html", "--val_for_each_epoch", "false", "--print_freq", "1",
              "--display_id", "1", "--display_port", "0"]


def stop(proc):
    """Kill whatever still runs of ``proc``'s session: ``proc`` and the
    children it started."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:          # the session has ended
        pass
    proc.wait()


def launcher(argv, log, device, n_children, timeout=900):
    """``python -m vts_torch.launch <argv>`` from the repo root, its output in
    ``log``; checks exit code 0 and that each of the ``n_children`` children
    reported running on ``device``.  Its wall time in s."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "vts_torch.launch", *argv], cwd=ROOT,
                                stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            stop(proc)
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    check(rc == 0, f"launch {' '.join(argv[:2])} exited {rc}:\n{text[-6000:]}")
    # the children share the log, so a line of one can follow another's
    # unfinished line: match the reports, not whole lines
    devices = DEVICE_LINE.findall(text)
    check(len(devices) == n_children and all(d.startswith(device) for _, _, d in devices),
          f"launch {' '.join(argv[:2])}: the children report {devices}, not {n_children} on "
          f"{device}")
    print(f"[workflow] launch {' '.join(argv[:2])} ({n_children} children): {wall:.1f} s")
    for name, verb, dev in devices:
        print(f"[workflow] {name} {verb} on {dev}")
    return wall


def watch_dashboard(argv, device, timeout=600):
    """``vts_torch.train <argv>`` with the dashboard on: polls its /data.json
    over 127.0.0.1 while it trains; checks that the loss history grew, that
    the run reported ``device``, exited 0 and closed the server.  The
    history's lengths as read."""
    import threading
    import urllib.request
    proc = subprocess.Popen([sys.executable, "-m", "vts_torch.train", *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines, url = [], []

    def read():
        for ln in proc.stdout:
            lines.append(ln)
            if ln.startswith("[visualizer] live dashboard at ") and not url:
                url.append(ln.split(" at ", 1)[1].strip())
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    sizes = []
    deadline = time.time() + timeout
    try:
        while proc.poll() is None and time.time() < deadline:
            if url:
                try:
                    with urllib.request.urlopen(url[0] + "data.json", timeout=5) as r:
                        sizes.append(len(json.load(r)["losses"]))
                except OSError:                 # the run closing its server
                    pass
            time.sleep(0.01)
        rc = proc.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        stop(proc)
    reader.join(timeout=30)
    text = "".join(lines)
    check(rc == 0, f"the dashboard run exited {rc}:\n{text[-6000:]}")
    check(url and f"[visualizer] live dashboard at {url[0]} closed" in text,
          f"the dashboard was not started and closed: {text[-3000:]}")
    check([d for _, _, d in DEVICE_LINE.findall(text) if d.startswith(device)],
          f"the dashboard run did not report {device}")
    grew = sorted(set(sizes))
    check(len(grew) >= 3 and sizes == sorted(sizes),
          f"the dashboard's loss history did not grow while training: {len(sizes)} reads, "
          f"lengths {grew}")
    return sizes


def edit_render_workflow(tmp, device, size=PADDED, query="", flags=(), train_flags=WORKFLOW_TRAIN,
                         dash_flags=DASH_TRAIN):
    """The paper's edit → render workflow through the port's entry points:
    two on-disk garments (synthA, synthB: S, I, M, touch records) and their
    edited twins (the sketch and mask mirrored, nothing else) written from
    the synthetic garment; ``launch ours launch --mode process`` (both
    garments at once on the device), each again alone; ``launch ours test``
    (8 finite metrics each); ``launch ours_edit test`` on the edited
    sketches (a gallery and the raw touch map at the canvas size, ``{}``
    metrics, no per-material roll-up; fake_I moved by the edit beyond
    run-to-run noise); the metric roll-up with its MEAN row; ``launch ours
    compare``; ``postprocess`` on each raw touch map in every mode; a short
    training run whose dashboard is read while it trains.  ``flags`` go to
    every child, ``train_flags`` to the training ones.  Its times."""
    import pickle

    import numpy as np
    from PIL import Image

    from vts_torch import postprocess
    from vts_torch.config import TestOptions
    from vts_torch.data import create_dataset
    from vts_torch.data.synthetic import materialize_synthetic, save_garment
    from vts_torch.launch import main as launch_main
    from vts_torch.models import create_model
    from vts_torch.utils import compile_metrics

    data, logs = os.path.join(tmp, "wf_data"), os.path.join(tmp, "wf_logs")
    os.makedirs(logs, exist_ok=True)

    def root(m, edit=False):
        return os.path.join(data, f"singleskit_{m}{'_edit' if edit else ''}_padded_{size}_x1")
    for m in EDIT_MATERIALS:
        g = materialize_synthetic(f"synthetic://{m}?size={size}{query}")
        save_garment(g, data)
        for sub, kind, arr in (("testS", "sketch", g.sketch), ("testM", "mask", g.mask)):
            os.makedirs(os.path.join(root(m, edit=True), sub))
            Image.fromarray(arr[:, ::-1].copy()).save(
                os.path.join(root(m, edit=True), sub, f"{m}_{kind}.png"))
    mats = ",".join(EDIT_MATERIALS)
    ckpt, res, res_edit = (os.path.join(tmp, d) for d in ("wf_ckpt", "wf_res", "wf_res_edit"))

    def launch(phase, method, materials, log, ckpt=ckpt, res=res, edit=False, extra=()):
        return launcher([method, phase, "--mode", "process", "--materials", materials,
                         "--dataroot-template", root("{material}", edit),
                         "--checkpoints_dir", ckpt, "--results_dir", res, "--", *flags, *extra],
                        os.path.join(logs, log), device, materials.count(",") + 1)

    out = {"two_s": launch("launch", "ours", mats, "launch.log", extra=train_flags),
           "one_by_one_s": [launch("launch", "ours", m, f"launch_{m}.log", extra=train_flags,
                                   ckpt=ckpt + "_seq", res=res + "_seq")
                            for m in EDIT_MATERIALS]}
    names = [f"{m}_sinskitG_baseline_ours" for m in EDIT_MATERIALS]
    for name in names:
        check(os.path.exists(os.path.join(ckpt, name, "best_net_G.msgpack")),
              f"{name}: no best_net_G.msgpack")
    launch("test", "ours", mats, "test.log")
    for name in names:
        with open(os.path.join(res, name, "test_best", "eval_metrics.pkl"), "rb") as f:
            metrics = pickle.load(f)
        print(f"[workflow] {name} test: " + " ".join(f"{k}={v:.6g}"
                                                    for k, v in sorted(metrics.items())))
        check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
              f"{name}: expected 8 finite metrics, got {metrics}")
    launch("test", "ours_edit", mats, "test_edit.log", res=res_edit, edit=True)
    topt = TestOptions().parse(["--name", names[0], "--epoch", "best", "--dataroot",
                                root("synthA"), "--checkpoints_dir", ckpt, "--results_dir", res,
                                *flags], quiet=True)
    raws = []
    for m, name in zip(EDIT_MATERIALS, names):
        web = os.path.join(res_edit, name, "test_best")
        with open(os.path.join(web, "eval_metrics.pkl"), "rb") as f:
            metrics = pickle.load(f)
        files = sorted(os.listdir(os.path.join(web, "images")))
        raw = os.path.join(web, "images", f"{m}_sketch_0_fake_gxgy_raw.npz")
        with np.load(raw) as z:
            shapes = (z["gx"].shape, z["gy"].shape)
        print(f"[workflow] {name} edit test: metrics {metrics}, {len(files)} gallery files, "
              f"raw touch map {shapes}")
        check(metrics == {} and not os.path.exists(
            os.path.join(web, "eval_metrics_per_material.pkl")),
              f"{name}: the edit test wrote metrics {metrics}")
        check(shapes == ((topt.crop_size, topt.crop_size),) * 2
              and f"{m}_sketch_0_fake_I.png" in files
              and os.path.exists(os.path.join(web, "index.html")),
              f"{name}: the edit gallery is incomplete: {files}, {shapes}")
        raws.append(raw)
    # the edit moves fake_I beyond run-to-run noise; one edit sample's wall
    batch = next(iter(create_dataset(topt)))
    topt.dataroot = root("synthA", edit=True)
    edit_batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.load_networks("best")
    fakes = []
    for b in (batch, batch, edit_batch):
        model.set_input(b)
        model.test()
        fakes.append(model._outputs["fake_I"].float())
    d_same, d_edit = ((fakes[0] - f).abs().max().item() for f in fakes[1:])
    print(f"[workflow] synthA's fake_I, edited sketch vs its own: max|d| {d_edit:.4g} (its own "
          f"twice: {d_same:.4g})")
    check(d_edit > max(10 * d_same, 1e-5), "the edited sketch gives the garment's own fake_I")
    walls = []
    for i in range(4):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.set_input(edit_batch)
        model.test()
        got = model.compute_metrics(phase="test")
        model._outputs["fake_T"].sum().item()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    check(got == {}, f"an edit sample computed metrics {got}")
    out["edit_sample_ms"] = walls
    del model, fakes
    # the roll-up, the comparison pages, the friction maps
    table = compile_metrics.main(["--results_dir", res, "--materials", mats])
    check(list(table) == [*EDIT_MATERIALS, "MEAN"] and len(table["MEAN"]) == 8,
          f"the roll-up: {table}")
    check(launch_main(["ours", "compare", "--materials", mats, "--results_dir", res]) == 0
          and all(os.path.exists(os.path.join(res, f"comparison_{m}", "index.html"))
                  for m in EDIT_MATERIALS), "launch ours compare wrote no page")
    try:
        import cv2  # noqa: F401
        out["clahe"] = "cv2 (OpenCV CLAHE)"
    except ImportError:
        out["clahe"] = "the histogram fallback (no cv2)"
    print(f"[workflow] postprocess: the equalize mode's CLAHE runs through {out['clahe']}")
    out["pp_ms"] = {}
    with np.load(raws[0]) as z:
        gx, gy = z["gx"], z["gy"]
    for mode in postprocess.MODES:
        for raw in raws:
            png = postprocess.main(["--input", raw, "--mode", mode])
            check(np.asarray(Image.open(png)).shape == (800, 1280), f"{png}: not 1280×800")
        fmap = postprocess.postprocess_gz(gx, gy, mode)
        check(fmap.shape == (800, 1280) and 0 <= fmap.min() and fmap.max() <= 1
              and fmap.max() > 0, f"postprocess {mode}: {fmap.shape} in "
                                  f"[{fmap.min()}, {fmap.max()}]")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            postprocess.postprocess_gz(gx, gy, mode)
            times.append((time.perf_counter() - t0) * 1e3)
        out["pp_ms"][mode] = statistics.median(times)
    # the dashboard of a short training run, read while it trains
    sizes = watch_dashboard([*dash_flags, "--name", "dash", "--device", device,
                             "--checkpoints_dir", ckpt, "--results_dir", res], device)
    print(f"[workflow] the dashboard's loss history as read while training: {len(sizes)} reads, "
          f"{len(set(sizes))} lengths, {sizes[0]} → {sizes[-1]} points")
    return out


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
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for kname, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[ptxas {kname}] {line.strip()}")
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                                  text=True, timeout=120).stdout
            print(f"[sass {kname}] {sass.count('HGMMA')} HGMMA instructions")

    # ---------------------------------------------------------------- 2 ---
    print(f"[phase] phase 2 (kernel checks) from {time.time() - t_start:.1f} s")
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

    # K1 and K1 dx against an fp64 reference: max |Δ| over the limit, and the
    # bias mean(Δ·sign(ref)) / mean|ref|.  The tensor cores round their sums
    # toward zero; the kernel adds each 8-channel chunk's sum in fp32
    # registers so that this bias stays far below the limit (summed over K
    # in the tensor cores it shrank the outputs by a few 1e-6, and the 256²
    # step's gradients failed).
    def acc_line(got, ref):
        d = got.double() - ref
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        bias = (d * torch.sign(ref)).mean().item() / ref.abs().mean().item()
        return d.abs().max().item() / tol, bias

    for (n, h, w, c, co) in ((1, 768, 768, 128, 128), (128, 32, 32, 64, 64)):
        x = torch.relu(torch.randn(n, h, w, c, generator=gen)).to(dev)
        wt = (torch.randn(3, 3, c, co, generator=gen) * math.sqrt(2.0 / (9 * c))).to(dev)
        b = (torch.randn(co, generator=gen) * 0.1).to(dev)
        gy = torch.randn(n, h, w, co, generator=gen).to(dev)
        w64 = wt.double().permute(3, 2, 0, 1)
        y64 = torch.relu(F.conv2d(x.double().permute(0, 3, 1, 2), w64, b.double(), padding=1)
                         ).permute(0, 2, 3, 1)
        y = y64.float()
        g64 = torch.where(y > 0, gy, torch.zeros_like(gy)).double().permute(0, 3, 1, 2)
        dx64 = F.conv_transpose2d(g64, w64, padding=1).permute(0, 2, 3, 1)
        for what, got, plain, ref in (
                ("K1", k1.conv3x3_bias_relu(x, wt, b), k1.conv3x3_bias_relu_plain(x, wt, b), y64),
                ("K1 dx", k1.conv3x3_dx(gy, y, wt), k1.conv3x3_dx_plain(gy, y, wt), dx64)):
            (e_k, b_k), (e_p, b_p) = acc_line(got, ref), acc_line(plain, ref)
            print(f"[{what} vs fp64] {(n, h, w, c)}->{co}: kernel max|d|/limit {e_k:.4f} bias "
                  f"{b_k:+.2e}; plain max|d|/limit {e_p:.4f} bias {b_p:+.2e}")
            check(e_k <= 0.05 and abs(b_k) < 1e-6, f"{what} strays from fp64 at {(n, h, w, c, co)}")
        del x, y, y64, g64, dx64, gy

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

    # --------------------------------------------------------------- 2b ---
    print(f"[phase] phase 2b (bf16 kernel checks at the production lane's shapes) from "
          f"{time.time() - t_start:.1f} s")
    bf = torch.bfloat16
    gdev = torch.Generator(device=dev).manual_seed(2)
    lane_rows = []
    for shape in K1_BF16 + [s_ + (0, 0) for s_ in K1_BF16_ANNEALED]:
        n, h, w, c, co, fwd_per_step, dx_per_step = shape
        x = torch.relu(torch.randn(n, h, w, c, generator=gdev, device=dev)).to(bf)
        wt = (torch.randn(3, 3, c, co, generator=gdev, device=dev)
              * math.sqrt(2.0 / (9 * c))).to(bf)
        b = (torch.randn(co, generator=gdev, device=dev) * 0.1).to(bf)
        gy = torch.randn(n, h, w, co, generator=gdev, device=dev).to(bf)
        y = k1.conv3x3_bias_relu(x, wt, b)
        ref = k1.conv3x3_bias_relu_plain(x, wt, b)
        torch.cuda.synchronize()
        check(y.dtype == bf and bool(((y.float() - ref.float()).abs() <= bf16_tol(ref)).all()),
              f"K1 in bf16 disagrees with its plain version at {shape[:5]}")
        f_err = (y.float() - ref.float()).abs().max().item()
        dx = k1.conv3x3_dx(gy, y, wt)
        ref = k1.conv3x3_dx_plain(gy, y, wt)
        torch.cuda.synchronize()
        check(dx.dtype == bf and bool(((dx.float() - ref.float()).abs() <= bf16_tol(ref)).all()),
              f"K1 dx in bf16 disagrees with its plain version at {shape[:5]}")
        err = (dx.float() - ref.float()).abs().max().item()
        print(f"[K1 bf16 check] {(n, h, w, c)}->{co}: fwd max|d| {f_err:.3e}, dx max|d| "
              f"{err:.3e} (limit 2^-7·|ref| + 1e-4·max|ref| + 1e-5 elementwise)"
              + ("" if fwd_per_step else " (after the anneal)"))
        if fwd_per_step:
            lane_rows.append(dict(shape=[n, h, w, c, co], fwd=fwd_per_step, dx=dx_per_step,
                                  f_err=f_err, err=err, tensors=(x, wt, b, y, gy)))
        del dx, ref
    # K1 and K1 dx in bf16 against fp64 at two lane shapes (C 128 and 64: two
    # 64-channel chunks and one): max |Δ| over the bf16 limit, and the bias
    # mean(Δ·sign(ref)) / mean|ref| against the fp64 result rounded once to
    # bf16, what an exact sum would store; the plain version (fp32 sums that
    # round to nearest) beside it.
    def bf16_acc_line(got, ref64):
        d = got.double() - ref64.to(bf).double()
        bias = (d * torch.sign(ref64)).mean().item() / ref64.abs().mean().item()
        err = ((got.double() - ref64).abs() / bf16_tol(ref64)).max().item()
        return err, bias

    for (n, h, w, c, co) in ((4, 384, 384, 128, 128), (512, 32, 32, 64, 64)):
        x = torch.relu(torch.randn(n, h, w, c, generator=gdev, device=dev)).to(bf)
        wt = (torch.randn(3, 3, c, co, generator=gdev, device=dev)
              * math.sqrt(2.0 / (9 * c))).to(bf)
        b = (torch.randn(co, generator=gdev, device=dev) * 0.1).to(bf)
        gy = torch.randn(n, h, w, co, generator=gdev, device=dev).to(bf)
        w64 = wt.double().permute(3, 2, 0, 1)
        y = k1.conv3x3_bias_relu(x, wt, b)
        y64 = torch.relu(F.conv2d(x.double().permute(0, 3, 1, 2), w64, b.double(), padding=1)
                         ).permute(0, 2, 3, 1)
        g64 = torch.where(y > 0, gy, torch.zeros_like(gy)).double().permute(0, 3, 1, 2)
        dx64 = F.conv_transpose2d(g64, w64, padding=1).permute(0, 2, 3, 1)
        del g64
        for what, got, plain, ref in (
                ("K1 bf16", y, k1.conv3x3_bias_relu_plain(x, wt, b), y64),
                ("K1 dx bf16", k1.conv3x3_dx(gy, y, wt), k1.conv3x3_dx_plain(gy, y, wt), dx64)):
            (e_k, b_k), (e_p, b_p) = bf16_acc_line(got, ref), bf16_acc_line(plain, ref)
            print(f"[{what} vs fp64] {(n, h, w, c)}->{co}: kernel max|d|/limit {e_k:.4f} bias "
                  f"{b_k:+.2e}; plain max|d|/limit {e_p:.4f} bias {b_p:+.2e}")
            check(e_k <= 1.0 and abs(b_k) < 1e-6, f"{what} strays from fp64 at {(n, h, w, c, co)}")
        del x, y, y64, dx64, gy, got, plain

    # a bf16 call launches its kernel and nothing else: no cast or copy
    from torch.profiler import ProfilerActivity, profile
    x, wt, b, y, gy = lane_rows[0]["tensors"]
    for what, fn in (("K1 bf16", lambda: k1.conv3x3_bias_relu(x, wt, b)),
                     ("K1 dx bf16", lambda: k1.conv3x3_dx(gy, y, wt))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        print(f"[{what} trace] one call's device kernels: {names}")
        check(any("conv3x3_bf16" in nm for nm in names)
              and not any("copy" in nm.lower() for nm in names),
              f"{what}: a call's trace shows {names}, not the conv kernel alone")

    # K2 and K2 bwd on bf16 sources and cotangents, N = 4 (and 2 after the anneal)
    ties4 = torch.cat([ties, ties.roll(7, dims=1)]).contiguous()
    ox4 = torch.cat([ox, ox.roll(5, dims=1)]).contiguous()
    oy4 = torch.cat([oy, oy.roll(5, dims=1)]).contiguous()
    k2_lane = []
    for (group, chans, kk, windows) in K2_TRAIN:
        for n_img in (4, 2):
            ims = [torch.randn(n_img, CANVAS, CANVAS, c, generator=gdev, device=dev).to(bf)
                   for c in chans]
            if windows == "coords":
                kw = dict(coords=ties4[:n_img, :kk].contiguous())
                rx, ry = k2.patch_offsets(kw["coords"])[:2]
            else:
                kw = dict(offset_x=ox4[:n_img, :kk].contiguous(),
                          offset_y=oy4[:n_img, :kk].contiguous())
                rx, ry = kw["offset_x"], kw["offset_y"]
            for mode in ("gather", "slice"):
                outs = k2.gather_patches_group(ims, cutout=32, mode=mode, **kw)
                for im, out in zip(ims, outs):
                    check(out.dtype == bf and torch.equal(
                        out, k2.gather_patches_plain(im, rx, ry, 32, mode=mode)),
                        f"K2 group {group} in bf16 differs from its plain version ({mode}, "
                        f"N = {n_img})")
            if n_img == 4:
                k2_lane.append(dict(group=group, images=ims, kw=kw, offsets=(rx, ry)))
    for n_img in (4, 2):
        g_in = torch.randn(n_img * K_TRAIN, 32, 32, 2, generator=gdev, device=dev).to(bf)
        tc = ties4[:n_img, :K_TRAIN].contiguous()
        shape = (n_img, CANVAS, CANVAS, 2)
        runs = [k2.scatter_patches(g_in, None, None, shape, coords=tc) for _ in range(2)]
        ref = serial_scatter(g_in, *k2.patch_offsets(tc)[:2], shape, "gather")
        torch.cuda.synchronize()
        check(runs[0].dtype == bf and torch.equal(runs[0], runs[1])
              and torch.equal(runs[0].cpu(), ref),
              f"K2 bwd in bf16 differs from the serial index_put_ rounded to bf16 ({shape})")
        print(f"[K2 bwd bf16 check] {shape} K={K_TRAIN} from coords: bit-exact against the "
              f"serial CPU index_put_ (fp32 sums, one rounding); two card runs equal")
        if n_img == 4:
            lane_scatter = dict(grad=g_in, coords=tc)
    print("[K2 bf16 check] groups A, B, C on bf16 sources, N 4|2, gather/slice: bit-exact")
    del runs, ref

    # --------------------------------------------------------------- 2c ---
    print(f"[phase] phase 2c (kernels at the x2 and x4 tactile shapes) from "
          f"{time.time() - t_start:.1f} s")
    # K1 and K1 dx at the touch-patch LPIPS shapes, fp32 limit; the x2 ones
    # (with the canvas shapes a x2 step also runs) kept for phase 5
    x2_rows = []
    for shape in K1_TMULT2 + [s_ + (0, 0) for s_ in K1_TMULT4]:
        n, h, w, c, co, fwd_per_step, dx_per_step = shape
        x = torch.relu(torch.randn(n, h, w, c, generator=gdev, device=dev))
        wt = torch.randn(3, 3, c, co, generator=gdev, device=dev) * math.sqrt(2.0 / (9 * c))
        b = torch.randn(co, generator=gdev, device=dev) * 0.1
        gy = torch.randn(n, h, w, co, generator=gdev, device=dev)
        y = k1.conv3x3_bias_relu(x, wt, b)
        ref = k1.conv3x3_bias_relu_plain(x, wt, b)
        torch.cuda.synchronize()
        f_err = (y - ref).abs().max().item()
        f_tol = 1e-4 * ref.abs().max().item() + 1e-5
        dx = k1.conv3x3_dx(gy, y, wt)
        ref = k1.conv3x3_dx_plain(gy, y, wt)
        torch.cuda.synchronize()
        err = (dx - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        print(f"[K1 x{2 if fwd_per_step else 4} check] {(n, h, w, c)}->{co}: fwd max|d| "
              f"{f_err:.3e} (tol {f_tol:.3e}), dx max|d| {err:.3e} (tol {tol:.3e})")
        check(f_err <= f_tol and err <= tol, f"K1 or K1 dx disagrees with its plain version at "
                                            f"{(n, h, w, c, co)}")
        if fwd_per_step:
            x2_rows.append(dict(shape=[n, h, w, c, co], fwd=fwd_per_step, dx=dx_per_step,
                                f_err=f_err, err=err, tensors=(x, wt, b, y, gy)))
        del dx, ref
    # K2 and K2 bwd on the touch canvases: cut 64 with x2 coords on 3072²,
    # cut 128 with x4 coords on 6144², windows from the coords (.5 ties,
    # padded patches, out-of-bounds and overlapping windows) and from offsets
    tmult_k2 = {}
    for mult, side in ((2, TOUCH2), (4, TOUCH4)):
        cut = 32 * mult
        img = torch.randn(1, side, side, 2, generator=gdev, device=dev)
        tc = ties[:1, :K_TRAIN].contiguous()
        rx, ry = k2.patch_offsets(tc, mult)[:2]
        oxm = (ox[:1, :32] * mult).contiguous()
        oym = (oy[:1, :32] * mult).contiguous()
        for mode in ("gather", "slice"):
            got = k2.gather_patches_from_coords(img, tc, 32, mult, mode=mode)
            ref = k2.gather_patches_plain(img, rx, ry, cut, mode=mode)
            got_o = k2.gather_patches(img, oxm, oym, cut, mode=mode)
            ref_o = k2.gather_patches_plain(img, oxm, oym, cut, mode=mode)
            torch.cuda.synchronize()
            check(torch.equal(got, ref) and got.shape == (K_TRAIN, cut, cut, 2)
                  and torch.equal(got_o, ref_o),
                  f"K2 at cut {cut} on {side}² differs from its plain version ({mode})")
        g_in = torch.randn(K_TRAIN, cut, cut, 2, generator=gdev, device=dev)
        shape = (1, side, side, 2)
        for mode in ("gather", "slice"):
            runs = [k2.scatter_patches(g_in, None, None, shape, mode=mode, coords=tc,
                                       scale_multiplier=mult) for _ in range(2)]
            runs.append(k2.scatter_patches(g_in, rx, ry, shape, mode=mode))
            ref = serial_scatter(g_in, rx, ry, shape, mode)
            torch.cuda.synchronize()
            check(torch.equal(runs[0], runs[1]), f"K2 bwd at cut {cut} is not deterministic")
            check(all(torch.equal(r.cpu(), ref) for r in (runs[0], runs[2])),
                  f"K2 bwd at cut {cut} on {side}² differs from the serial index_put_ ({mode})")
        print(f"[K2 x{mult} check] cut {cut} on (1, {side}², 2) from x{mult} coords and from "
              f"offsets, gather/slice: bit-exact; K2 bwd bit-exact against the serial CPU "
              f"index_put_, two card runs equal")
        if mult == TMULT:
            tmult_k2 = dict(image=img, coords=tc, grad=g_in)
        del img, runs, ref, got, ref_o, got_o

    # ---------------------------------------------------------------- 3 ---
    print(f"[phase] phase 3 (test slice) from {time.time() - t_start:.1f} s")
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
    with CountPatchOffsets() as host_offsets, Gallery() as gallery:
        metrics = run_test(argv)[0]
    t_slice = time.time() - t0
    run_launches = read_counts()
    test_launches = {k: v - gallery.launches[k] for k, v in run_launches.items()}
    print(f"[slice] {len(metrics)} metrics in {t_slice:.2f} s (first run, incl. data "
          f"and model set-up and the gallery): "
          + " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
    print(f"[slice] launches during the test run: {run_launches}; the sample's, without "
          f"the gallery: {test_launches}")
    print(gallery.line(f"test gallery, one {CANVAS}² sample"))
    web = os.path.join(tmp, "res", "smoke", "test_best")
    written = os.listdir(os.path.join(web, "images")) if os.path.isdir(web) else []
    check(os.path.exists(os.path.join(web, "index.html"))
          and any(f.endswith("_fake_gxgy_raw.npz") for f in written)
          and any(f.endswith("_patch_coords.json") for f in written)
          and sum(f.endswith(".png") for f in written) == 11,
          f"the test gallery is incomplete: {sorted(written)}")
    check(gallery.passes == 1 and gallery.launches["gather_patches"] == 1,
          f"the test gallery made {gallery.passes} visuals passes, {gallery.launches}")
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
    print(f"[phase] phase 4 (training slice) from {time.time() - t_start:.1f} s")
    # 2 epochs of 2 steps, D3 from epoch 2, the gallery after step 4 (the
    # shipped defaults switch D3 on at epoch 100 and draw every 100 samples)
    targv = ["--model", "sinskit", "--name", "train_smoke",
             "--dataroot", f"synthetic://smoke?size={PADDED}", "--device", "cuda",
             "--data_len", "2", "--n_epochs", "2", "--n_epochs_decay", "0",
             "--vision_aided_warmup_epoch", "2", "--display_freq", "4"] + dirs
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with Gallery() as gallery:
        tmodel = run_train(targv)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    train_launches = read_counts()
    losses = tmodel.get_current_losses()
    print(f"[train] 4 steps (D3 active in the last 2) + 2 validations + the gallery in "
          f"{t_train:.2f} s (first run, incl. data and model set-up); epoch 2's last losses: "
          + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[train] launches during the training run: {train_launches}")
    print(gallery.line(f"training gallery at {CANVAS}² (with the full-canvas D2 pass)"))
    check(len(losses) >= 15 and {"G_D3", "D3_loss"} <= set(losses)
          and all(math.isfinite(v) for v in losses.values()),
          f"an epoch-2 training loss is missing or not finite: {losses}")
    check(all(train_launches[k] > 0 for k in KERNELS),
          f"a kernel was not launched by the training run: {train_launches}")
    ck = os.path.join(tmp, "ckpt", "train_smoke")
    missing = [f"best_{kind}_{net}.msgpack" for net in ("G", "D", "D2") for kind in ("net", "opt")
               if not os.path.exists(os.path.join(ck, f"best_{kind}_{net}.msgpack"))]
    check(not missing, f"checkpoints not written: {missing}")
    pngs = [f for f in os.listdir(os.path.join(ck, "web", "images")) if f.startswith("epoch002_")]
    check(gallery.passes == 1 and len(pngs) == 19
          and os.path.exists(os.path.join(ck, "web", "index.html")),
          f"the training gallery is incomplete: {gallery.passes} passes, {sorted(pngs)}")
    torch.cuda.synchronize()
    reset_counts()
    tmodel.optimize_parameters(2)
    torch.cuda.synchronize()
    d3_launches = read_counts()
    print(f"[train] launches of one more D3-active step: {d3_launches}")
    check(d3_launches == PER_STEP, f"a D3-active step launched {d3_launches}, not {PER_STEP}")
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
    for label, extra, keys in (
            ("256² step", ["--use_vision_aided_loss", "false"], ("cpu", "cuda", "cuda again")),
            ("256² D3-active step", ["--vision_aided_warmup_epoch", "1"], ("cpu", "cuda"))):
        pair = {}
        for key in keys:
            o = TrainOptions().parse(strain + extra + ["--device", key.split()[0]], quiet=True)
            pair[key] = create_model(o)
            pair[key].setup()
        sbatch = next(iter(create_dataset(o)))
        draws = pair["cpu"].draw(1)
        for m in pair.values():
            m.set_input(sbatch)
            m.optimize_parameters(1, draws=draws)
        if "cuda again" in pair:
            same = all(torch.equal(pair["cuda"].adam[net].mu[k],
                                   pair["cuda again"].adam[net].mu[k])
                       for net in ("G", "D", "D2") for k in pair["cuda"].adam[net].mu)
            print(f"[train ref] two {label}s on CUDA from the same weights and draws give "
                  f"the same gradients bit for bit: {same}")
        lc = pair["cpu"].get_current_losses()
        check(("G_D3" in lc) == ("D3" in label), f"{label}: unexpected losses {sorted(lc)}")
        compare_steps(label, pair["cpu"], pair["cuda"])
        del pair
    torch.backends.cudnn.deterministic = cudnn_det

    # --------------------------------------------------------------- 4b ---
    print(f"[phase] phase 4b (production lane) from {time.time() - t_start:.1f} s")
    # the sched_anneal arm cut in length: 3 epochs of 4 samples (2 steps of 4,
    # then after the anneal 2 of 2), D3 from epoch 2, the production logging
    largv = ["--model", "sinskit", "--name", "lane",
             "--dataroot", f"synthetic://smoke?size={PADDED}", "--device", "cuda",
             "--data_len", "4", "--n_epochs", "3", "--n_epochs_decay", "0",
             "--vision_aided_warmup_epoch", "2", "--anneal_epoch", "3",
             "--anneal_set", LANE_ANNEAL, "--print_freq", "1000", "--display_freq", "5000",
             "--save_latest_freq", "5000"] + LANE_ARGS + dirs
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    tee = Tee(sys.stdout)
    real_stdout, sys.stdout = sys.stdout, tee
    try:
        lmodel = run_train(largv)
    finally:
        sys.stdout = real_stdout
    torch.cuda.synchronize()
    t_lane = time.time() - t0
    lane_run_launches = read_counts()
    losses = lmodel.get_current_losses()
    anneal_lines = [ln for ln in tee.text().splitlines() if ln.startswith("[anneal]")]
    print(f"[lane] 3 epochs (bf16, batch 4, LPIPS crop 768, D3 from epoch 2, anneal at epoch "
          f"3) in {t_lane:.2f} s (first run, incl. data and model set-up); the last losses: "
          + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[lane] {anneal_lines}; launches during the run: {lane_run_launches}")
    check(anneal_lines == ["[anneal] epoch 3: applied {'lpips_crop': 0, 'batch_size': 2, "
                           "'remat_g': 'on', 'lpips_remat': 'off'}"],
          f"the anneal did not switch once at epoch 3: {anneal_lines}")
    check(lmodel.opt.batch_size == 2 and lmodel.opt.lpips_crop == 0,
          "the lane did not end at batch 2 on the full canvas")
    check(len(losses) >= 15 and {"G_D3", "D3_loss"} <= set(losses)
          and all(math.isfinite(v) for v in losses.values()),
          f"a lane loss is missing or not finite: {losses}")
    check(all(lane_run_launches[k] > 0 for k in KERNELS),
          f"a kernel was not launched by the lane: {lane_run_launches}")
    reset_counts()
    lmodel.optimize_parameters(3)
    torch.cuda.synchronize()
    check(read_counts() == PER_STEP_BF16, f"a lane step launched {read_counts()}, not "
                                          f"{PER_STEP_BF16}")
    check(lmodel._outputs["fake_I"].dtype == torch.bfloat16, "the lane's step is not bf16")
    del lmodel
    lt = run_test(["--model", "sinskit", "--epoch", "best", "--name", "lane",
                   "--dataroot", f"synthetic://smoke?size={PADDED}", "--device", "cuda",
                   "--dtype", "bfloat16", "--batch_size", "2", "--data_len", "2",
                   "--num_test", "2", "--batch_size_G2", str(K_PATCH)] + dirs)
    check(len(lt) == 2 and all(len(m) == 8 and all(math.isfinite(v) for v in m.values())
                               for m in lt),
          f"the lane's best G did not evaluate sample by sample: {lt}")
    print("[lane] best G through vts_torch.test --dtype bfloat16 --batch_size 2, run at "
          "batch 1, 2 samples: " + " ".join(f"{k}={v:.6g}" for k, v in sorted(lt[0].items())))

    # a 256² bf16 step on cuda and on cpu, the cpu fp32 step as the reference
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    lane_small = strain + ["--use_vision_aided_loss", "false", "--batch_size", "2",
                           "--lpips_crop", "128"]
    trio = {}
    for key, dt, device in (("cpu32", "float32", "cpu"), ("cpu16", "bfloat16", "cpu"),
                            ("cuda16", "bfloat16", "cuda")):
        o = TrainOptions().parse(lane_small + ["--dtype", dt, "--device", device], quiet=True)
        trio[key] = create_model(o)
        trio[key].setup()
    sbatch = next(iter(create_dataset(o)))
    draws = trio["cpu16"].draw(2, (256, 256))
    for m in trio.values():
        m.set_input(sbatch)
        m.optimize_parameters(1, draws=draws)
    l32, l16, lg = (trio[k].get_current_losses() for k in ("cpu32", "cpu16", "cuda16"))
    worst = 0.0
    for k in l32:
        gap = abs(l16[k] - l32[k])
        worst = max(worst, abs(lg[k] - l16[k]) / (2 * gap + 1e-3 * abs(l32[k]) + 1e-30))
        check(abs(lg[k] - l16[k]) <= 2 * gap + 1e-3 * abs(l32[k]),
              f"256² bf16 step: loss {k} on cuda {lg[k]} vs cpu {l16[k]} (fp32 {l32[k]})")
    print(f"[lane ref] 256² bf16 step (batch 2, LPIPS crop 128), cuda vs cpu: worst loss "
          f"|cuda16 - cpu16| / (2·|cpu16 - cpu32| + 1e-3·|cpu32|) {worst:.3f}")
    for net in ("G", "D", "D2"):
        mu32, mu16, mug = (trio[k].adam[net].mu for k in ("cpu32", "cpu16", "cuda16"))
        d_dev, d_bf = rel_norm(mug, mu16, mu32), rel_norm(mu16, mu32, mu32)
        print(f"[lane ref] 256² bf16 step, {net} grads: |cuda16 - cpu16|/|cpu32| {d_dev:.3e}, "
              f"|cpu16 - cpu32|/|cpu32| {d_bf:.3e}")
        check(d_dev <= 2 * d_bf + 1e-3, f"256² bf16 step: {net} gradient on cuda disagrees "
                                        f"with cpu beyond the bf16 bound")
    del trio
    torch.backends.cudnn.deterministic = cudnn_det

    # --------------------------------------------------------------- 4c ---
    print(f"[phase] phase 4c (x2 tactile super-resolution) from {time.time() - t_start:.1f} s")
    # the shipped training defaults with --T_resolution_multiplier 2 on a x2
    # garment: 2 epochs of 2 steps, D3 from epoch 2, the gallery once
    x2argv = ["--model", "sinskit", "--name", "tmult2", "--dataroot", X2_DATA,
              "--device", "cuda", "--T_resolution_multiplier", str(TMULT),
              "--data_len", "2", "--n_epochs", "2", "--n_epochs_decay", "0",
              "--vision_aided_warmup_epoch", "2", "--display_freq", "4"] + dirs
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with CountPatchOffsets() as host_offsets, Gallery() as gallery:
        x2model = run_train(x2argv)
    torch.cuda.synchronize()
    x2_run_launches = read_counts()
    losses = x2model.get_current_losses()
    print(f"[x2] 4 steps (D3 active in the last 2) + 2 validations + the gallery in "
          f"{time.time() - t0:.2f} s (first run, incl. data and model set-up); epoch 2's last "
          f"losses: " + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[x2] launches during the run: {x2_run_launches}")
    print(gallery.line(f"x2 training gallery ({TOUCH2}² touch canvas)"))
    check(x2model._outputs["fake_T"].shape == (1, TOUCH2, TOUCH2, 2),
          f"the x2 fake_T is {tuple(x2model._outputs['fake_T'].shape)}")
    check(len(losses) >= 15 and {"G_D3", "D3_loss"} <= set(losses)
          and all(math.isfinite(v) for v in losses.values()),
          f"a x2 training loss is missing or not finite: {losses}")
    check(all(x2_run_launches[k] > 0 for k in KERNELS),
          f"a kernel was not launched by the x2 run: {x2_run_launches}")
    check(host_offsets.calls == 0, f"the x2 run called patch_offsets {host_offsets.calls} times")
    check(gallery.passes == 1, f"the x2 gallery made {gallery.passes} visuals passes")
    reset_counts()
    x2model.optimize_parameters(2)
    torch.cuda.synchronize()
    check(read_counts() == PER_STEP_TMULT2, f"a x2 D3-active step launched {read_counts()}, "
                                            f"not {PER_STEP_TMULT2}")
    del x2model
    x2test = ["--model", "sinskit", "--epoch", "best", "--name", "tmult2", "--dataroot",
              X2_DATA, "--device", "cuda", "--T_resolution_multiplier", str(TMULT),
              "--batch_size_G2", str(K_PATCH)] + dirs
    reset_counts()
    with CountPatchOffsets() as host_offsets:
        tm = run_test(x2test)[0]
    check(len(tm) == 8 and all(math.isfinite(v) for v in tm.values()),
          f"the x2 best G does not evaluate: {tm}")
    check(read_counts()["gather_patches"] > 0 and host_offsets.calls == 0,
          f"the x2 test run: launches {read_counts()}, {host_offsets.calls} patch_offsets calls")
    print("[x2] best G through vts_torch.test --T_resolution_multiplier 2: " +
          " ".join(f"{k}={v:.6g}" for k, v in sorted(tm.items())))
    # a 256² x2 step on cuda and on cpu from the same weights and draws
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    small_x2 = strain + ["--dataroot", SMALL_DATA.replace("small?", "smallx2?") + "&mult=2",
                         "--T_resolution_multiplier", str(TMULT),
                         "--use_vision_aided_loss", "false"]
    pair = {}
    for key in ("cpu", "cuda"):
        o = TrainOptions().parse(small_x2 + ["--device", key], quiet=True)
        pair[key] = create_model(o)
        pair[key].setup()
    sbatch = next(iter(create_dataset(o)))
    draws = pair["cpu"].draw(1)
    for m in pair.values():
        m.set_input(sbatch)
        m.optimize_parameters(1, draws=draws)
    compare_steps("256² x2 step", pair["cpu"], pair["cuda"], g_scale=4.0)
    del pair

    # --------------------------------------------------------------- 4d ---
    print(f"[phase] phase 4d (x4 and the training surface) from {time.time() - t_start:.1f} s")
    x4opt = TrainOptions().parse(
        ["--model", "sinskit", "--name", "tmult4", "--dataroot",
         f"synthetic://smoke?size={PADDED}&mult=4", "--device", "cuda",
         "--T_resolution_multiplier", "4", "--data_len", "1", "--vision_aided_warmup_epoch", "1",
         "--no_html"] + dirs, quiet=True)
    x4batch = next(iter(create_dataset(x4opt)))
    x4model = create_model(x4opt)
    x4model.setup()
    x4model.set_input(x4batch)
    x4model.optimize_parameters(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    x4model.optimize_parameters(1)
    losses = x4model.get_current_losses()
    torch.cuda.synchronize()
    x4_ms = (time.perf_counter() - t0) * 1e3
    x4_launches = read_counts()
    print(f"[x4] one {TOUCH4}² touch-canvas training step (D3 active, 128² touch patches): "
          f"{x4_ms:.1f} ms wall (second step), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {x4_launches}; "
          + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    check(x4model._outputs["fake_T"].shape == (1, TOUCH4, TOUCH4, 2)
          and all(math.isfinite(v) for v in losses.values())
          and x4_launches == PER_STEP_TMULT2, f"the x4 step: {x4_launches}, {losses}")
    del x4model, x4batch
    torch.cuda.empty_cache()
    # WGAN-GP (the penalty's double backward on the card), instance-norm Ds,
    # the patch D1 and the pixel D2, every DiffAugment letter
    pair = {}
    for key in ("cpu", "cuda"):
        o = TrainOptions().parse(strain + SURFACE_ARGS + ["--use_vision_aided_loss", "false",
                                                          "--device", key], quiet=True)
        pair[key] = create_model(o)
        pair[key].setup()
    sbatch = next(iter(create_dataset(o)))
    draws = pair["cpu"].draw(1, (256, 256))
    for m in pair.values():
        m.set_input(sbatch)
        m.optimize_parameters(1, draws=draws)
    lc = pair["cpu"].get_current_losses()
    check(lc["D_I_grad_penalty"] > 0 and lc["D_T_grad_penalty"] > 0,
          f"the surface step has no gradient penalty: {lc}")
    compare_steps("256² wgangp/instance/bscton/patch-pixel step", pair["cpu"], pair["cuda"],
                  named=False)
    del pair
    torch.backends.cudnn.deterministic = cudnn_det

    # --------------------------------------------------------------- 4e ---
    print(f"[phase] phase 4e (skitG) from {time.time() - t_start:.1f} s")
    # the multi-garment model with the CLIP style code, at the full-width
    # training defaults on two synthetic garments (synthA, synthB): 2 epochs
    # of one sample of each, D3 from epoch 2, the gallery once
    sargv = ["--model", "skit", "--name", "skit", "--dataroot", f"synthetic://smoke?size={PADDED}",
             "--device", "cuda", "--data_len", "1", "--n_epochs", "2", "--n_epochs_decay", "0",
             "--vision_aided_warmup_epoch", "2", "--display_freq", "4"] + dirs
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with Gallery() as gallery:
        smodel = run_train(sargv)
    torch.cuda.synchronize()
    skit_run_launches = read_counts()
    losses = smodel.get_current_losses()
    print(f"[skit] 4 steps over 2 garments (D3 active in the last 2) + 2 validations + the "
          f"gallery in {time.time() - t0:.2f} s (first run, incl. data and model set-up); epoch "
          f"2's last losses: " + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[skit] launches during the run: {skit_run_launches}")
    print(gallery.line("skitG training gallery"))
    up7_in = smodel.netG.up["up7"].convt.weight.shape[0]
    check(up7_in == 8 * NGF + 512 and smodel._input["style_code"].shape == (1, 512),
          f"skitG's G takes {up7_in} channels at up7, code {smodel._input.get('style_code')}")
    check(len(losses) >= 15 and {"G_D3", "D3_loss"} <= set(losses)
          and all(math.isfinite(v) for v in losses.values()),
          f"a skitG training loss is missing or not finite: {losses}")
    check(all(skit_run_launches[k] > 0 for k in KERNELS),
          f"a kernel was not launched by the skitG run: {skit_run_launches}")
    check(gallery.passes == 1, f"the skitG gallery made {gallery.passes} visuals passes")
    reset_counts()
    smodel.optimize_parameters(2)
    torch.cuda.synchronize()
    check(read_counts() == PER_STEP, f"a skitG D3-active step launched {read_counts()}, not "
                                     f"{PER_STEP}")
    del smodel
    # its best G through the test driver on both garments, batched and legacy
    stest = ["--model", "skit", "--epoch", "best", "--name", "skit", "--dataroot",
             f"synthetic://smoke?size={PADDED}", "--device", "cuda", "--data_len", "1",
             "--num_test", "2", "--batch_size_G2", str(K_PATCH)] + dirs
    import pickle
    skit_tests = {}
    for mode in ("batched", "legacy"):
        reset_counts()
        with Gallery() as gallery:
            got = run_test(stest + ["--eval_mode", mode, "--results_dir",
                                    os.path.join(tmp, f"res_{mode}")])
        torch.cuda.synchronize()
        skit_tests[mode] = read_counts()
        with open(os.path.join(tmp, f"res_{mode}", "skit", "test_best",
                               "eval_metrics_per_material.pkl"), "rb") as f:
            per_mat = pickle.load(f)
        check(len(got) == 2 and all(len(m) == 8 and all(math.isfinite(v) for v in m.values())
                                    for m in got), f"skitG test ({mode}): {got}")
        check(sorted(per_mat) == ["synthA", "synthB"]
              and all(math.isfinite(v) for m in per_mat.values() for v in m.values()),
              f"skitG test ({mode}): per-material metrics {per_mat}")
        for mat, m in sorted(per_mat.items()):
            print(f"[skit test {mode}] material {mat}: "
                  + " ".join(f"{k}={v:.6g}" for k, v in sorted(m.items())))
        print(f"[skit test {mode}] launches during the 2-sample run: {skit_tests[mode]} "
              f"(the gallery's: {gallery.launches})")
    legacy_run_launches = skit_tests["legacy"]
    # two style images give two images: garment A's sketch with A's style
    # image, then with B's
    topt = TestOptions().parse(stest, quiet=True)
    sbatches = list(create_dataset(topt))
    smodel = create_model(topt)
    smodel.setup()
    smodel.load_networks("best")
    fakes = []
    for style in (sbatches[0]["style_image"], sbatches[0]["style_image"],
                  sbatches[1]["style_image"]):
        smodel.set_input({**sbatches[0], "style_image": style})
        smodel.test()
        fakes.append(smodel._outputs["fake_I"])
    d_same, d_style = ((fakes[0] - f).abs().max().item() for f in fakes[1:])
    print(f"[skit] garment A's fake_I with A's style image vs B's: max|d| {d_style:.4g} (A's "
          f"twice: {d_same:.4g})")
    check(d_style > max(10 * d_same, 1e-5), "two style images give the same fake_I")
    del smodel, fakes
    # K1 at the legacy evaluation's shapes for garment A's valid test
    # patches: T_LPIPS on gx and on gy in chunks of 16 pairs, each chunk's
    # VGG on (2·pairs, 224², ·); I_LPIPS at the canvas as the batched eval
    kv = int((sbatches[0]["T_valid"] > 0).sum())
    chunks = [16] * (kv // 16) + ([kv % 16] if kv % 16 else [])
    k1_legacy = [(2, CANVAS, CANVAS, 64, 64, 1), (2, CANVAS // 2, CANVAS // 2, 64, 128, 1),
                 (2, CANVAS // 2, CANVAS // 2, 128, 128, 1)]
    for pairs in sorted(set(chunks), reverse=True):
        per = 2 * chunks.count(pairs)
        k1_legacy += [(2 * pairs, 224, 224, 64, 64, per), (2 * pairs, 112, 112, 64, 128, per),
                      (2 * pairs, 112, 112, 128, 128, per)]
    legacy_rows = []
    for (n, h, w, c, co, per) in k1_legacy:
        x = torch.relu(torch.randn(n, h, w, c, generator=gdev, device=dev))
        wt = torch.randn(3, 3, c, co, generator=gdev, device=dev) * math.sqrt(2.0 / (9 * c))
        b = torch.randn(co, generator=gdev, device=dev) * 0.1
        got = k1.conv3x3_bias_relu(x, wt, b)
        ref = k1.conv3x3_bias_relu_plain(x, wt, b)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        print(f"[K1 legacy check] {(n, h, w, c)}->{co}: max|d| {err:.3e} (tol {tol:.3e}), "
              f"{per} per garment-A sample")
        check(err <= tol, f"K1 disagrees with its plain version at {(n, h, w, c, co)}")
        legacy_rows.append(dict(shape=[n, h, w, c, co], per_sample=per, err=err,
                                tensors=(x, wt, b)))
        del got, ref
    print(f"[skit] garment A: {kv} valid test patches, T_LPIPS chunks {chunks}")
    # a 256² skitG step on cuda and on cpu from the same weights, style code
    # (encoded once, on the cpu) and draws
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    small_skit = strain + ["--model", "skit", "--use_vision_aided_loss", "false"]
    pair = {}
    for key in ("cpu", "cuda"):
        o = TrainOptions().parse(small_skit + ["--device", key], quiet=True)
        pair[key] = create_model(o)
        pair[key].setup()
    sbatch = next(iter(create_dataset(o)))
    sbatch["style_code"] = pair["cpu"].encode_style(
        torch.from_numpy(sbatch["style_image"])).numpy()
    draws = pair["cpu"].draw(1)
    for m in pair.values():
        m.set_input(sbatch)
        m.optimize_parameters(1, draws=draws)
    compare_steps("256² skitG step", pair["cpu"], pair["cuda"], g_scale=4.0)
    del pair
    torch.backends.cudnn.deterministic = cudnn_det

    # --------------------------------------------------------------- 4f ---
    print(f"[phase] phase 4f (the edit → render workflow) from {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    workflow = edit_render_workflow(tmp, "cuda")
    workflow_s = time.time() - t0
    print(f"[workflow] took {workflow_s:.1f} s")

    # ---------------------------------------------------------------- 5 ---
    print(f"[phase] phase 5 (times) from {time.time() - t_start:.1f} s; the card: {card_state()} "
          f"(SM clock, power, temperature)")
    edit_ms, seq_s = workflow["edit_sample_ms"], workflow["one_by_one_s"]
    print(f"[time workflow] {smi}: one {CANVAS}² edit test sample (set_input, G forward, no "
          f"metrics): {statistics.median(edit_ms):.1f} ms wall, median of {len(edit_ms)} "
          f"({', '.join(f'{w:.1f}' for w in edit_ms)})")
    print(f"[time workflow] {smi}: two garments trained through the launcher (1 epoch of 2 "
          f"samples each at {CANVAS}², D3 off; process start, data, set-up, validation and "
          f"checkpoints included) in two processes on the card at once: "
          f"{workflow['two_s']:.1f} s wall; one after the other: {seq_s[0]:.1f} + {seq_s[1]:.1f} "
          f"= {sum(seq_s):.1f} s")
    print(f"[time workflow] {smi}: postprocess_gz {CANVAS}² -> 1280x800 on the host, ms per map "
          f"(median of 3): " + ", ".join(f"{m} {v:.1f}" for m, v in workflow["pp_ms"].items())
          + f" (equalize through {workflow['clahe']})")
    rows = {}                     # (kernel, path) -> per-sample or per-step sums
    shape_rows = []

    def add(kname, path, per, ms, plain, lib, flops, nbytes, err, shape, peak=PEAK_FP32_FLOPS):
        acc = rows.setdefault((kname, path), dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                                  flops=0.0, bytes=0.0, err=0.0, per=0,
                                                  dev=[], lib_dev=[], peak=peak, bound=0.0,
                                                  by=dict(operations=0.0, bytes=0.0)))
        bound, by = bound_ms(flops, nbytes, peak)
        for k_, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                      ("flops", flops), ("bytes", nbytes), ("bound", bound)):
            acc[k_] += per * v
        acc["by"][by] += per * bound
        acc["err"] = max(acc["err"], err)
        acc["per"] += per
        shape_rows.append(dict(kernel=kname, path=path, shape=shape, launches=per, ms=ms,
                               plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                               bound_fp32_ms=bound_ms(flops, nbytes)[0],
                               tflops=flops / ms / 1e9, max_abs_err=err, device_ms=None))
        return bound, by

    # Device-only times come from torch.profiler, run after the step timing
    # below: a profiler session slows the host's later calls.  ``deferred``
    # holds what those runs need: (row key, launches, shape row, kernel
    # call, kernel name, library call, line to print).
    deferred = []

    def k1_line(what, ms, plain, lib_name, lib, bound, flops, note):
        return (f"{what}: kernel {ms:.4f} ms (device only {{dev}}), plain {plain:.4f} ms, "
                f"{lib_name} {lib:.4f} ms (device only {{lib_dev}}), bound {bound:.4f} ms "
                f"({note}), {flops / ms / 1e9:.2f} TFLOP/s")

    def tf32_note(flops, nbytes):
        return f"operations, 3xTF32; fp32 CUDA cores {bound_ms(flops, nbytes)[0]:.4f}"

    def time_k1_eval(rows, path):
        """K1 at each eval shape of ``rows`` (fp32), per test sample."""
        for row in rows:
            n, h, w, c, co = row["shape"]
            x, wt, b = row["tensors"]
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            x_nchw = x.permute(0, 3, 1, 2)
            call = lambda x=x, wt=wt, b=b: k1.conv3x3_bias_relu(x, wt, b)
            lib_spec = ("conv_relu", x_nchw, w_oihw, b)
            lib_fn = library_call(lib_spec)
            ms = cuda_ms(call)
            plain = cuda_ms(lambda: k1.conv3x3_bias_relu_plain(x, wt, b))
            lib = cuda_ms(lib_fn)
            flops = 2.0 * 9 * n * h * w * c * co
            nbytes = 4.0 * (n * h * w * c + 9 * c * co + co + n * h * w * co)
            bound, _ = add("conv3x3_bias_relu", path, row["per_sample"], ms, plain, lib, flops,
                           nbytes, row["err"], row["shape"], K1_PEAK)
            line = k1_line(f"[time K1 {path}] {(n, h, w, c)}->{co}", ms, plain, "F.conv2d+relu",
                           lib, bound, flops, tf32_note(flops, nbytes))
            deferred.append((("conv3x3_bias_relu", path), row["per_sample"], len(shape_rows) - 1,
                             call, "conv3x3", lib_spec, line))
            del row["tensors"]

    time_k1_eval(k1_rows, "eval")
    # the legacy evaluation of garment A's skitG test sample (--eval_mode legacy)
    time_k1_eval(legacy_rows, "eval_legacy")

    def time_k1_train(rows, path, peak, tag):
        """K1 and K1 dx at each training shape of ``rows``, in the rows'
        dtype: bytes at its element size, the bound at ``peak``, the library
        calls (cuDNN) in that dtype."""
        for row in rows:
            n, h, w, c, co = row["shape"]
            x, wt, b, y, gy = row["tensors"]
            es = x.element_size()
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            x_nchw, y_nchw, gy_nchw = (t.permute(0, 3, 1, 2) for t in (x, y, gy))
            flops = 2.0 * 9 * n * h * w * c * co
            f_call = lambda x=x, wt=wt, b=b: k1.conv3x3_bias_relu(x, wt, b)
            f_spec = ("conv_relu", x_nchw, w_oihw, b)
            f_lib_fn = library_call(f_spec)
            f_ms, f_lib = cuda_ms(f_call), cuda_ms(f_lib_fn)
            f_plain = cuda_ms(lambda: k1.conv3x3_bias_relu_plain(x, wt, b))
            f_bytes = es * (n * h * w * c + 9 * c * co + co + n * h * w * co)
            d_call = lambda gy=gy, y=y, wt=wt: k1.conv3x3_dx(gy, y, wt)
            d_spec = ("conv_dx", (n, c, h, w), w_oihw, gy_nchw, y_nchw)
            d_lib_fn = library_call(d_spec)
            ms, lib = cuda_ms(d_call), cuda_ms(d_lib_fn)
            plain = cuda_ms(lambda: k1.conv3x3_dx_plain(gy, y, wt))
            if x.dtype == torch.bfloat16:
                # the route before the bf16 instance: widen to fp32, run the
                # 3xTF32 kernel, round once (timed here, used nowhere)
                dt = x.dtype
                wide_f = cuda_ms(lambda: k1.conv3x3_bias_relu(x.float(), wt.float(),
                                                              b.float()).to(dt))
                wide_d = cuda_ms(lambda: k1.conv3x3_dx(gy.float(), y.float(),
                                                       wt.float()).to(dt))
                print(f"[time K1 {tag} widened] {(n, h, w, c)}->{co}: fwd {wide_f:.4f} ms, dx "
                      f"{wide_d:.4f} ms (bf16 widened to the fp32 kernel and rounded back)")
            nbytes = es * (2 * n * h * w * co + 9 * c * co + n * h * w * c)
            fb, _ = add("conv3x3_bias_relu", path, row["fwd"], f_ms, f_plain, f_lib, flops,
                        f_bytes, row["f_err"], row["shape"], peak)
            f_note = tf32_note(flops, f_bytes) if peak == K1_PEAK else "bf16 tensor cores"
            deferred.append((("conv3x3_bias_relu", path), row["fwd"], len(shape_rows) - 1,
                             f_call, "conv3x3", f_spec,
                             k1_line(f"[time K1 {tag}] {(n, h, w, c)}->{co}", f_ms, f_plain,
                                     f"F.conv2d+relu {x.dtype}", f_lib, fb, flops, f_note)))
            bb, _ = add("conv3x3_dx", path, row["dx"], ms, plain, lib, flops, nbytes,
                        row["err"], row["shape"], peak)
            d_note = tf32_note(flops, nbytes) if peak == K1_PEAK else "bf16 tensor cores"
            deferred.append((("conv3x3_dx", path), row["dx"], len(shape_rows) - 1, d_call,
                             "conv3x3", d_spec,
                             k1_line(f"[time K1 dx {tag}] gy {(n, h, w, co)} -> dx {c}", ms,
                                     plain, f"conv2d_input+mask {x.dtype}", lib, bb, flops,
                                     d_note)))
            print(f"[time K1 {tag}] {(n, h, w, c)}->{co}: fwd {f_ms:.4f} ms (plain "
                  f"{f_plain:.4f}, F.conv2d+relu {f_lib:.4f}, bound {fb:.4f}); dx {ms:.4f} ms "
                  f"(plain {plain:.4f}, conv2d_input+mask {lib:.4f}, bound {bb:.4f}), dx "
                  f"{flops / ms / 1e9:.2f} TFLOP/s")
            del row["tensors"]

    time_k1_train(dx_rows, "train", K1_PEAK, "train")

    def indexing(img1, ox1, oy1, cut=32):
        """The library call's operands: the image and its window indices,
        made beforehand."""
        side = img1.shape[0]
        ar = torch.arange(cut, device=dev)
        iy = (oy1.long()[:, None] + ar).clamp(0, side - 1)[:, :, None]
        ix = (ox1.long()[:, None] + ar).clamp(0, side - 1)[:, None, :]
        return img1, iy, ix

    def time_gather(path, per, ims, kw, offsets, what, cut=32):
        """One K2 launch on (N, side², C) images at K windows each ((N, K) or,
        for N = 1, (K,) offsets), cut² each, as the main path calls it; the
        library time sums indexing over the group's sources and images."""
        call = lambda: k2.gather_patches_group(ims, cutout=cut, **kw)
        n, side = ims[0].shape[0], ims[0].shape[1]
        mult = kw.get("scale_multiplier", 1)
        ox2, oy2 = (t.reshape(n, -1) for t in offsets)
        if "coords" in kw:
            plain = lambda: [k2.gather_patches_plain(
                im, *k2.patch_offsets(kw["coords"], mult)[:2], cut) for im in ims]
        else:
            plain = lambda: [k2.gather_patches_plain(im, *offsets, cut) for im in ims]
        ms = cuda_ms(call, reps=50)
        host = host_ms(call)
        plain_ms = cuda_ms(plain, reps=50)
        wins = [indexing(im[i], ox2[i], oy2[i], cut) for im in ims for i in range(n)]
        lib = sum(cuda_ms(library_call(("indexing", [w])), reps=50) for w in wins)
        chans = [im.shape[-1] for im in ims]
        kk = ox2.shape[1]
        wbytes = n * kk * (8 * 4 if "coords" in kw else 2 * 4)
        bound, _ = add("gather_patches", path, per, ms, plain_ms, lib, 0.0,
                       gather_bytes(ox2, oy2, chans, wbytes, cut, ims[0].element_size(), side),
                       0.0, [n, side, side, chans, kk, cut])
        line = (f"[time K2 {path}] {what}: ({n},{side},{side},{chans}) "
                f"{str(ims[0].dtype)[6:]} K={kk} cut {cut} from "
                f"{'coords' if 'coords' in kw else 'offsets'}: kernel {ms:.4f} ms (host only "
                f"{host:.4f} ms, device only {{dev}}), plain {plain_ms:.4f} ms, indexing "
                f"{lib:.4f} ms (device only {{lib_dev}}), bound {bound:.5f} ms (bytes), "
                f"{per} per {'sample' if path.startswith('eval') else 'step'}")
        deferred.append((("gather_patches", path), per, len(shape_rows) - 1, call,
                         "gather_group_kernel", ("indexing", wins), line))

    # eval: fake_T (1, 1536², 2) at the K = 100 test patches' coords
    time_gather("eval", PER_SAMPLE["gather_patches"], (img2[:1],),
                dict(coords=coords[:1].contiguous()), k2.patch_offsets(coords[0])[:2],
                "fake_T at the test patches")
    # the legacy evaluation cuts the same stack, one launch per sample
    time_gather("eval_legacy", 1, (img2[:1],), dict(coords=coords[:1].contiguous()),
                k2.patch_offsets(coords[0])[:2], "fake_T at the test patches")
    for row in k2_train:
        time_gather("train", 1, row["images"], row["kw"], row["offsets"],
                    f"group {row['group']}")
        del row["images"]

    def time_scatter(path, per, grad, wc, err, label="", mult=1):
        """One K2 bwd launch of ``grad`` at the (N, K, 8) coords ``wc`` (scaled
        by ``mult``) into an (N, 1536·mult², 2) canvas of grad's dtype, as the
        main path calls it; the library call is zeros + index_add_ in that
        dtype.  A labelled call is timed beside the path's and adds no row."""
        n, side, cut = wc.shape[0], CANVAS * mult, grad.shape[1]
        shape = (n, side, side, 2)
        oxn, oyn = (t.reshape(n, -1) for t in k2.patch_offsets(wc, mult)[:2])
        call = lambda: k2.scatter_patches(grad, None, None, shape, coords=wc,
                                          scale_multiplier=mult)
        ms, host = cuda_ms(call, reps=50), host_ms(call)
        plain = cuda_ms(lambda: k2.scatter_patches_plain(grad, *k2.patch_offsets(wc, mult)[:2],
                                                         shape), reps=50)
        ar = torch.arange(cut, device=dev)
        iy = (oyn.long()[:, :, None] + ar).clamp(0, side - 1)[:, :, :, None]
        ix = (oxn.long()[:, :, None] + ar).clamp(0, side - 1)[:, :, None, :]
        flat = ((torch.arange(n, device=dev)[:, None, None, None] * side + iy) * side
                + ix).reshape(-1)                             # (N·K·cut·cut,) pixel index
        lib_spec = ("index_add", n * side * side, flat, grad.reshape(-1, 2))
        lib = cuda_ms(library_call(lib_spec), reps=50)
        kk, es = oxn.shape[1], grad.element_size()
        canvas_bytes = n * side * side * 2 * es
        nbytes = canvas_bytes + n * kk * cut * cut * 2 * es + n * kk * 8 * 4
        if label:
            bound, key, idx = bound_ms(0.0, nbytes)[0], None, None
        else:
            bound, _ = add("scatter_patches", path, per, ms, plain, lib, 0.0, nbytes, err,
                           [n, side, side, 2, kk, cut])
            key, idx = ("scatter_patches", path), len(shape_rows) - 1
        line = (f"[time K2 bwd {path}{label}] {shape} {grad.dtype} K={kk} cut {cut} from coords: "
                f"kernel {ms:.4f} ms (host only {host:.4f} ms, device only {{dev}}), plain "
                f"(index_put_) {plain:.4f} ms, zeros + index_add_ {lib:.4f} ms (device only "
                f"{{lib_dev}}), bound {bound:.5f} ms (bytes: the canvas write, "
                f"{canvas_bytes / 1e6:.1f} MB, dominates)")
        deferred.append((key, per, idx, call, "scatter_tile_kernel", lib_spec, line))

    # K2 bwd at the check's windows (out-of-bounds ones and 10 on one spot,
    # as PR 2 timed it), and beside it at in-bounds windows, as the data
    # pipeline cuts them
    tc1 = ties[:1, :K_TRAIN].contiguous()
    inb = tc1.clone()
    inb[..., :2] = torch.randint(0, CANVAS - 32, (1, K_TRAIN, 2), generator=gen).float()
    inb[..., 5], inb[..., 6:] = 1.0, 0.0
    gp1 = gpatch[:K_TRAIN].contiguous()
    time_scatter("train", PER_STEP["scatter_patches"], gp1, tc1, k2b_err)
    time_scatter("train", PER_STEP["scatter_patches"], gp1, inb, k2b_err, ", in-bounds windows")
    del img2, gpatch

    # the production lane's kernels in bf16, at one step's shapes before the
    # anneal: the bound at the bf16 tensor-core rate and bf16 bytes, the
    # library calls in bf16
    time_k1_train(lane_rows, "train_bf16", PEAK_BF16_FLOPS, "bf16")
    for row in k2_lane:
        time_gather("train_bf16", 1, row["images"], row["kw"], row["offsets"],
                    f"group {row['group']}")
        del row["images"]
    time_scatter("train_bf16", PER_STEP_BF16["scatter_patches"], lane_scatter["grad"],
                 lane_scatter["coords"], 0.0)

    # the x2 path's kernels at one step's shapes: K1 and K1 dx at the canvas
    # and at the 64² touch patches; K2 in its five groups (the touch canvas
    # 3072², cut 64 for fake_T; the canvas 1536², cut 32 for S and I); K2 bwd
    # at cut 64 into the touch canvas
    time_k1_train(x2_rows, "train_tmult2", K1_PEAK, "tmult2")
    x2_coords = ties[:1, :K_TRAIN].contiguous()
    x2_off = (ox[:1, :32].contiguous(), oy[:1, :32].contiguous())     # "more fake T" offsets
    for (group, side, chans, kk, windows, cut, mult) in K2_TMULT2:
        ims = [tmult_k2["image"][..., :c] if side == TOUCH2 else
               torch.randn(1, side, side, c, generator=gdev, device=dev) for c in chans]
        if windows == "coords":
            kw = dict(coords=x2_coords[:, :kk], scale_multiplier=mult)
            offs = k2.patch_offsets(kw["coords"], mult)[:2]
        else:
            offs = tuple((t * TMULT if side == TOUCH2 else t)[:, :kk].contiguous() for t in x2_off)
            kw = dict(offset_x=offs[0], offset_y=offs[1])
        time_gather("train_tmult2", 1, ims, kw, offs, f"group {group}", cut)
        del ims
    time_scatter("train_tmult2", PER_STEP_TMULT2["scatter_patches"], tmult_k2["grad"],
                 tmult_k2["coords"], 0.0, mult=TMULT)
    del tmult_k2

    # one test sample: G forward + the 8 metrics, after a warm-up
    print(f"[phase] sample wall from {time.time() - t_start:.1f} s")
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
    print(f"[phase] step wall from {time.time() - t_start:.1f} s")
    # the same model steps at epoch 1 (before D3's warmup) and at epoch 2 (D3
    # active, as every step from epoch 100 at the shipped defaults)
    topt = TrainOptions().parse(targv, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.set_input(batch)
    step_wall = {}
    with CountPatchOffsets() as host_offsets:
        for key, label, epoch in (("warmup", "before D3's warmup", 1), ("d3", "D3 active", 2)):
            walls, peaks = [], []
            for i in range(7):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if i == 2:
                    reset_counts()
                t0 = time.perf_counter()
                model.optimize_parameters(epoch)
                model.get_current_losses()
                torch.cuda.synchronize()
                if i == 2:
                    step_launches = read_counts()
                if i >= 2:
                    walls.append((time.perf_counter() - t0) * 1e3)
                    peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            step_wall[key] = statistics.median(walls)
            print(f"[time step] one {CANVAS}² training step, {label} (batch 1, ngf {NGF}, "
                  f"ndf 8, K {K_TRAIN} + 32): {step_wall[key]:.1f} ms wall, median of "
                  f"{len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); "
                  f"{1e3 / step_wall[key]:.3f} samples/s; peak memory {max(peaks):.2f} GiB; "
                  f"launches per step {step_launches}")
            check(step_launches == PER_STEP, f"a training step ({label}) launched "
                                             f"{step_launches}, the timed shapes stand for "
                                             f"{PER_STEP}")
    check(host_offsets.calls == 0, f"14 training steps called patch_offsets "
                                   f"{host_offsets.calls} times on the host")
    print(f"[time step] D3 adds {step_wall['d3'] - step_wall['warmup']:.1f} ms to the step wall")

    # the D3 part of a step on its own, at the step's tensors: CLIP of the
    # real I without a gradient, CLIP of fake_I with one, the backward to
    # fake_I (through the 12 blocks and resize_mm); and resize_mm alone
    real_I, fake_I = model._input["I"], model._outputs["fake_I"]
    d3_call = d3_part(model.clip, model.d3_heads, real_I, fake_I)
    d3_specs = [(("d3", real_I, fake_I), 3), (("resize", real_I), 20)]
    d3_ms, resize_ms = cuda_ms(d3_call, reps=5), cuda_ms(library_call(d3_specs[1][0]), reps=20)
    d3_host = host_ms(d3_call, reps=5)
    del model, batch

    # the production lane's step, untraced, D3 active: before the anneal
    # (bf16, batch 4, the LPIPS window 768²) and after it (batch 2, the canvas)
    print(f"[phase] lane step wall from {time.time() - t_start:.1f} s")
    lopt = TrainOptions().parse(largv, quiet=True)
    lbatch = next(iter(create_dataset(lopt)))
    lmodel = create_model(lopt)
    lmodel.setup()
    lane_wall = {}
    for key, label, nb, crop in (("before", "before the anneal", 4, 768),
                                 ("after", "after the anneal", 2, 0)):
        lmodel.opt.lpips_crop = crop
        lmodel.set_input({k: v[:nb] for k, v in lbatch.items()})
        walls, peaks = [], []
        for i in range(7):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if i == 2:
                reset_counts()
            t0 = time.perf_counter()
            lmodel.optimize_parameters(2)
            lmodel.get_current_losses()
            torch.cuda.synchronize()
            if i == 2:
                counts = read_counts()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        check(counts == PER_STEP_BF16, f"a lane step ({label}) launched {counts}, not "
                                       f"{PER_STEP_BF16}")
        if key == "before":
            lane_step_launches = counts
        lane_wall[key] = statistics.median(walls)
        print(f"[time lane step] one {CANVAS}² production-lane step, {label} (bf16, batch {nb}, "
              f"LPIPS {'window ' + str(crop) + '²' if crop else 'on the canvas'}, D3 active, "
              f"ngf {NGF}, ndf 8, K {K_TRAIN} + 32): {lane_wall[key]:.1f} ms wall, median of "
              f"{len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); "
              f"{nb * 1e3 / lane_wall[key]:.3f} samples/s; peak memory {max(peaks):.2f} GiB; "
              f"launches per step {counts}")
    del lmodel, lbatch
    torch.cuda.empty_cache()

    # the x2 path untraced: one training step with D3 active (median of 5
    # after 2 warm-ups) and one test sample (median of 3 after 1)
    print(f"[phase] x2 step wall from {time.time() - t_start:.1f} s")
    x2opt = TrainOptions().parse(x2argv, quiet=True)
    x2batch = next(iter(create_dataset(x2opt)))
    x2model = create_model(x2opt)
    x2model.setup()
    x2model.set_input(x2batch)
    walls, peaks = [], []
    with CountPatchOffsets() as host_offsets:
        for i in range(7):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if i == 2:
                reset_counts()
            t0 = time.perf_counter()
            x2model.optimize_parameters(2)
            x2model.get_current_losses()
            torch.cuda.synchronize()
            if i == 2:
                x2_step_launches = read_counts()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    x2_wall = statistics.median(walls)
    print(f"[time x2 step] one {CANVAS}² training step with a {TOUCH2}² touch canvas, D3 "
          f"active (batch 1, ngf {NGF}, ndf 8, K {K_TRAIN} + 32 at 64²): {x2_wall:.1f} ms "
          f"wall, median of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); "
          f"{1e3 / x2_wall:.3f} samples/s; peak memory {max(peaks):.2f} GiB; launches per "
          f"step {x2_step_launches}")
    check(x2_step_launches == PER_STEP_TMULT2 and host_offsets.calls == 0,
          f"a timed x2 step launched {x2_step_launches} ({host_offsets.calls} patch_offsets "
          f"calls), the timed shapes stand for {PER_STEP_TMULT2}")
    del x2model, x2batch
    topt = TestOptions().parse(x2test, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.load_networks("best")
    model.set_input(batch)
    walls = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.test()
        model.compute_metrics()
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[time x2 sample] one x2 test sample ({TOUCH2}² touch canvas, K {K_PATCH}): "
          f"{statistics.median(walls):.1f} ms wall, median of {len(walls)}")
    del model, batch
    torch.cuda.empty_cache()

    # skitG untraced: garment A's test sample under the batched and the
    # legacy evaluation (median of 3 after 1, the launches of one), the style
    # encode, and one training step with D3 active (median of 5 after 2)
    print(f"[phase] skitG walls from {time.time() - t_start:.1f} s")
    legacy_per_sample = {"conv3x3_bias_relu": sum(r[5] for r in k1_legacy), "conv3x3_dx": 0,
                         "gather_patches": 1, "scatter_patches": 0}
    skit_sample = {}
    for mode, want in (("batched", PER_SAMPLE), ("legacy", legacy_per_sample)):
        topt = TestOptions().parse(stest + ["--eval_mode", mode], quiet=True)
        batch = next(iter(create_dataset(topt)))
        model = create_model(topt)
        model.setup()
        model.load_networks("best")
        walls = []
        for i in range(4):
            torch.cuda.synchronize()
            if i == 1:
                reset_counts()
            t0 = time.perf_counter()
            model.set_input(batch)
            model.test()
            model.compute_metrics()
            torch.cuda.synchronize()
            if i == 1:
                skit_sample[mode] = read_counts()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[time skit sample {mode}] one {CANVAS}² skitG test sample (garment A, style "
              f"encode included, K {K_PATCH}): {statistics.median(walls):.1f} ms wall, median "
              f"of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); launches "
              f"{skit_sample[mode]}")
        check(skit_sample[mode] == want, f"a {mode} skitG test sample launched "
                                         f"{skit_sample[mode]}, not {want}")
        if mode == "legacy":
            style = model._input["style_image"]
            enc_ms = cuda_ms(lambda: model.encode_style(style), reps=20)
            enc_full = cuda_ms(lambda: model.encode_style(model._input["I"]), reps=20)
            print(f"[time skit encode] the style code of one sample: {enc_ms:.3f} ms from the "
                  f"224² style image, {enc_full:.3f} ms from the {CANVAS}² visual image "
                  f"(CLIP ViT-B/32, resize_mm inside)")
        del model, batch
    sopt = TrainOptions().parse(sargv, quiet=True)
    batch = next(iter(create_dataset(sopt)))
    model = create_model(sopt)
    model.setup()
    model.set_input(batch)
    walls, peaks = [], []
    for i in range(7):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 2:
            reset_counts()
        t0 = time.perf_counter()
        model.optimize_parameters(2)
        model.get_current_losses()
        torch.cuda.synchronize()
        if i == 2:
            skit_step_launches = read_counts()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    skit_wall = statistics.median(walls)
    print(f"[time skit step] one {CANVAS}² skitG training step, D3 active (batch 1, ngf {NGF}, "
          f"ndf 8, K {K_TRAIN} + 32, style code at 1 level): {skit_wall:.1f} ms wall, median of "
          f"{len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); {1e3 / skit_wall:.3f} "
          f"samples/s; peak memory {max(peaks):.2f} GiB; launches per step {skit_step_launches}")
    check(skit_step_launches == PER_STEP, f"a timed skitG step launched {skit_step_launches}, "
                                          f"not {PER_STEP}")
    del model, batch
    torch.cuda.empty_cache()
    # device-only times of every kernel, and of their library calls
    print(f"[phase] device-only times from {time.time() - t_start:.1f} s")
    print(f"[device-only] the card: {card_state()} (SM clock, power, temperature)")
    # our kernels here; the library calls and the D3 part in a process of
    # their own (see library_device_times)
    times = device_times([(call, kname_, 20 if kname_ == "conv3x3" else 50)
                          for _, _, _, call, kname_, _, _ in deferred])
    lib_times = library_device_times([(spec, 10) for *_, spec, _ in deferred] + d3_specs)
    d3_dev, resize_dev = lib_times[-2:]
    print(f"[time D3] the D3 part of a {CANVAS}² step (CLIP ViT-B/32 of real I, no grad; of "
          f"fake_I with grad; backward to fake_I): {d3_ms:.2f} ms (host only {d3_host:.2f} ms, "
          f"device only {fmt_dev(d3_dev)}); resize_mm {CANVAS}² -> 224² forward "
          f"{resize_ms:.4f} ms (device only {fmt_dev(resize_dev)})")
    over = [f"library of {what}" for what, (d, e, _) in zip(
        [line[1:line.index(":")] for *_, line in deferred] + ["D3", "resize_mm"], lib_times)
        if d is not None and d > e]
    for (key, per, idx, _, _, _, line), dev_t, lib_t in zip(deferred, times, lib_times):
        if key is not None:
            shape_rows[idx]["device_ms"] = dev_t[0]
            shape_rows[idx]["library_device_ms"] = lib_t[0]
            rows[key]["dev"].append(None if dev_t[0] is None else per * dev_t[0])
            rows[key]["lib_dev"].append(None if lib_t[0] is None else per * lib_t[0])
            if dev_t[0] is not None and dev_t[0] > dev_t[1]:
                over.append(f"{key[0]}@{key[1]} {shape_rows[idx]['shape']}")
        print(line.format(dev=fmt_dev(dev_t), lib_dev=fmt_dev(lib_t)))
    print(f"[device-only] {len(over)} calls whose kernels' device time exceeds their events' "
          f"in the same session: {over}")

    sources = {"conv3x3_bias_relu": ("vts_torch/csrc/conv3x3.cu",
                                     "vts_tpu/ops/pallas_conv.py:42"),
               "conv3x3_dx": ("vts_torch/csrc/conv3x3.cu", "vts_tpu/ops/pallas_conv.py:119"),
               "gather_patches": ("vts_torch/csrc/gather_patches.cu",
                                  "vts_tpu/ops/pallas_gather.py:34"),
               "scatter_patches": ("vts_torch/csrc/scatter_patches.cu",
                                   "vts_tpu/ops/patch.py:41 (XLA transpose of the gather; "
                                   "no Pallas kernel)")}
    kernels = []
    per_path = {"eval": test_launches, "train": step_launches, "train_bf16": lane_step_launches,
                "train_tmult2": x2_step_launches, "eval_legacy": skit_sample["legacy"]}
    in_run = {"eval": run_launches, "train": train_launches, "train_bf16": lane_run_launches,
              "train_tmult2": x2_run_launches, "eval_legacy": legacy_run_launches}
    for (kname, path), acc in rows.items():
        launches = per_path[path][kname]
        check(launches == acc["per"], f"{kname} ({path}): {launches} launches, timed {acc['per']}")
        # the least time of the row's launches: each shape's own bound (bytes
        # or operations, whichever is larger there) times its launches, summed;
        # bound_by names the kind that makes up most of it
        b_ms, b_by = acc["bound"], max(acc["by"], key=acc["by"].get)
        dev_t = sum(acc["dev"]) if acc["dev"] and None not in acc["dev"] else None
        lib_dev = sum(acc["lib_dev"]) if acc["lib_dev"] and None not in acc["lib_dev"] else None
        src, repl = sources[kname]
        per_what = "test sample" if path.startswith("eval") else "training step"
        print(f"[time {kname} {path}] per {per_what}: "
              f"{launches} launches, kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, "
              f"library {acc['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}"
              f"{', 3xTF32' if acc['peak'] == K1_PEAK else ''}; fp32 CUDA cores "
              f"{bound_ms(acc['flops'], acc['bytes'])[0]:.4f}), device only {fmt_ms(dev_t)}, "
              f"library device only {fmt_ms(lib_dev)}")
        kernels.append(dict(name=f"{kname}@{path}", route="cuda", source=src, replaces=repl,
                            launches=launches, max_abs_err=acc["err"], ms=acc["ms"],
                            plain_ms=acc["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                            library_ms=acc["library_ms"], device_ms=dev_t,
                            library_device_ms=lib_dev, path=path,
                            bound_fp32_ms=bound_ms(acc["flops"], acc["bytes"])[0],
                            launches_in_run=in_run[path][kname]))
    print(f"[shapes] {json.dumps(shape_rows)}")
    print(f"[done] chip_smoke took {time.time() - t_start:.1f} s (phase 4f: {workflow_s:.1f} s)")
    tmp_dir.cleanup()

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
