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
     and on garment A under legacy, 8 finite metrics a sample and the
     garments in eval_metrics_per_material.pkl (printed); garment A's fake_I with B's
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
     samples, D3 off); ``launch ours test`` (8 finite
     metrics each), ``launch ours_edit test`` on the edited sketches (the
     gallery and the raw touch map at the canvas size, ``{}`` metrics, no
     per-material roll-up; fake_I moved by the edit beyond run-to-run
     noise); every child reports running on cuda; the metric roll-up with
     its MEAN row, ``launch ours compare``, the postprocess of each raw touch
     map in all five modes (1280×800 maps in [0, 1]; which CLAHE branch
     ran); a short 256² training run with ``--display_id 1 --display_port 0``
     whose ``/data.json`` is read over 127.0.0.1 while it trains (the loss
     history grows; the server is closed at the end);
  4g. the pix2pix baseline (:func:`pix2pix_baseline`): ``vts_torch.train
     --model pix2pix --dataset_mode patchskit`` on the 1800² garment at the
     shipped training defaults (ngf/ndf 64, resnet_9blocks, batch-norm G and
     basic Ds, batch 32 of 32² patches from the 1536² view, vanilla GAN and
     L1·100), cut in length only: 5 epochs of the view's 64 touch squares
     (10 steps), the full-image validation after each epoch, the gallery at
     sample 320; every loss finite, no ``pred_fake_T_full`` panel, the G, D
     and D2 checkpoints with their Adam files (``best`` and ``latest``), K1
     and K2 launched by the validations and K1 dx and K2 bwd not at all;
     its best G through ``vts_torch.test --model pix2pix`` on the 1536²
     canvas (K = 64 test patches): 8 finite metrics, K1 and K2 launched as
     ``PER_SAMPLE`` says, no patch_offsets call on the host, the gallery and
     the raw gx/gy npz; K1 at that sample's shapes within the fp32 limit; a
     32² step at batch 4 with ngf/ndf 8 on cuda and on cpu from the same
     weights and patches, held as in phase 4, the running statistics of G,
     D and D2 within 1e-5, and G's 256² eval forward within 1e-4 of its max;
     the launcher's ``pix2pix launch --mode process`` child on phase 4f's
     on-disk garment (1 epoch of 32 patches, no validation) on the card;
  4h. the pix2pixHD baseline (:func:`pix2pixhd_baseline`): ``vts_torch.train
     --model pix2pixHD --dataset_mode patchskit`` on the 1800² garment at the
     shipped training defaults (the instance-norm global G with ngf 64, 4
     downsamplings and 9 blocks; two 2-scale multiscale Ds with intermediate
     features, ndf 64; lsgan, GAN-feat·10, VGG19·10; batch 32 of 32²
     patches), cut in length only: 1 epoch of the view's 64 touch squares
     (2 steps), the full-image validation after it; every loss finite,
     G_GAN_Feat 0 (the reference's term), G_VGG finite and > 0, the G, D
     and D2 checkpoints with their Adam files, K1 and K2 launched by the
     validations and K1 dx and K2 bwd not at all; its best G through
     ``vts_torch.test --model pix2pixHD`` on the 1536² canvas (K = 64): 8
     finite metrics, K1 and K2 launched as ``PER_SAMPLE`` says, no
     patch_offsets call on the host, the gallery and the raw gx/gy npz, and
     the shapes K1 and K2 launched at against a pix2pix test sample's (the
     same: phase 5 reuses pix2pix's rows; else these shapes are checked
     against the plain version here and timed in phase 5); a 32² step at
     batch 4 (ngf/ndf 8, 2 downsamplings, 2 blocks, the VGG loss,
     ``--correct_gan_feat true``, a pool of 2 with fixed draws) on cuda and
     on cpu from the same weights, held as the x2 step of 4c is (G meets the
     VGG19 loss's fp32 max-pool near-ties) with the round-off leaves found
     from the CPU gradient, and the pool within 1e-5; G's 256²
     eval forward from the same weights within 1e-4 of its max; the same
     step under ``--dtype bfloat16`` on cuda and on cpu, held by phase
     4b's bf16 rule with the cpu fp32 step as the reference; the launcher's ``pix2pixhd launch
     --mode process`` child on phase 4f's on-disk garment (1 epoch of 32
     patches, no validation, ngf/ndf 8) on the
     card;
  4i. the SPADE baseline (:func:`spade_baseline`): ``vts_torch.train --model
     spade --dataset_mode patchskit`` on the 1800² garment at the shipped
     training defaults (the spade G with ngf 64, 3 upsamplings, spectral
     convs and the param-free sync batch norm; two 2-scale multiscale
     spectral-instance Ds with intermediate features, ndf 64; hinge,
     GAN-feat·10, VGG19·10, TTUR; batch 16 of 32² patches), cut in length
     only: 1 epoch of 2 steps (``--max_dataset_size 32``), the full-image
     validation after it; every loss finite, G_GAN_Feat and G_VGG > 0,
     the G, D and D2 checkpoints with their Adam files and each with ``u``
     in its stats, K1 and K2 launched by the validations and K1 dx and K2
     bwd not at all; its best G through ``vts_torch.test --model spade`` on
     the 1536² canvas (K = 64): 8 finite metrics, K1 and K2 launched as
     ``PER_SAMPLE`` says, no patch_offsets call on the host, the gallery and
     the raw gx/gy npz, the run's peak memory, and the kernels' shapes
     against a pix2pix test sample's (as in 4h); 32² steps at batch 4
     (ngf/ndf 8, a pool of 2 with fixed draws) on cuda and on cpu from the
     same weights and ``u``: without the VGG loss held as in phase 4 (the
     round-off leaves found from the cpu gradient), every ``u`` and running
     statistic of G, D and D2 within 1e-5, the pool within 1e-5; with it,
     the losses and D's and D2's gradients the same way and G's in the
     2-norm within what a 1e-6 relative change of the sketch does to it on
     the cpu (at least 1e-4: VGG19's near-ties on an untrained G's
     near-constant outputs); G's 256² eval forward from the same weights
     within 1e-4 of its max; the VGG-less step under ``--dtype bfloat16``
     on cuda and on cpu, held by phase 4b's bf16 rule; the launcher's
     ``spade launch --mode process``
     child on phase 4f's on-disk garment (1 epoch of 32 patches, no
     validation, ngf/ndf 8) on the card;
 4j. the garment fleet: ``vts_torch.launch ours launch`` in its default
     mode (one process) on two synthetic 1800² garments at the full-width
     training defaults, 2 epochs of 2 steps with D3 from epoch 2: finite
     ``[fleet]`` losses, ``G_D3`` and ``D3_loss`` at epoch 2, each garment's
     ``latest`` G, D and D2 with their Adam files, and each G through
     ``vts_torch.test --epoch latest`` (8 finite metrics); one D3-active
     fleet step of the two at full width against each garment's single
     step (``--seed g``, same batch and draws) under cuDNN's deterministic
     algorithms: losses, parameters, running statistics and Adam moments
     bit for bit, garment 0's update the same bits with garment 1's batch
     changed, each kernel launched 2 × ``PER_STEP`` times, the LPIPS and
     CLIP weights at one address in both garments' steps; the 20
     ``DEFAULT_MATERIALS`` at full width, one step each before D3: the
     fleet's peak memory within 1 GiB of one garment's step's, both walls;
     a 256² two-garment fleet step on cuda against cpu under phase 4's rule
     (G in the 2-norm within the largest jump that weights moved by 1e-6 of
     themselves make to it on the cpu, where that exceeds 1e-5: a max-pool
     or ReLU near-tie flipping); a ``pack=2`` ngf-10 generator at 1536²
     against each garment's ``pack=1`` forward within 1e-4·max|ref| + 1e-5;
 4k. the rest of the network zoo (:func:`zoo_phase`): ``vts_torch.train
     --model sinskit --netG unet_256 --netD stylegan2 --netD2 stylegan2`` at
     the shipped defaults (1536², ngf 10 / ndf 8, batch 1, full-canvas
     LPIPS), 3 steps of one epoch before D3, finite losses, then
     ``vts_torch.test --epoch latest`` on it (8 finite metrics); one more
     step launching as ``PER_STEP`` says, K1 and K2 at the ``train`` row's
     shapes (recorded in phase 4's D3-active step), so that row stands for
     it; ``vts_torch.train --model pix2pix`` at its defaults (32² patches,
     ngf 64, batch 32, no validation, 2 steps) with ``--netG visgel``,
     ``resnet_cat`` and ``stylegan2 --crop_size 1024`` (the largest crop
     its width table takes), no kernel launched in training, each latest G
     on one test sample through ``vts_torch.test`` (8 finite metrics,
     ``PER_SAMPLE`` launches; at 1536² K1 and K2 at the ``eval_pix2pix``
     row's shapes, at 1024² an ``eval_stylegan2`` row, K1 checked against
     its plain version there); each new network (the plain U-Nets, VisGel
     ×1 and ×2, GResnet with and without z, both StyleGAN2 Gs with the
     noise injected, both Ds) on cuda against cpu at a small size: forward,
     input and parameter gradients, running statistics; each step's wall
     (median of 5 after 2), peak memory and launches, each test sample's
     wall and G forward (median of 3 after 1).  The sinskit run trains
     with the repeated-letter policy ``--diffaugment btbt``: its next
     step's draws on the card equal a cpu replay from the same generator
     state at every position, each repeated letter's two positions differ,
     and that step's augmentation of the real canvas is the cpu's bit for
     bit;
 4l. the library's last modules (:func:`cut_phase`): the LPIPS VGG16 taps
     of a random 1536² image (K1 forward on the card), ``PatchSampleF`` with
     its MLP on 256 locations of each tap, ``patch_nce_loss`` against the
     real image's taps and ``texture_loss``, backward to the image (K1 dx)
     and the head: K1 and K1 dx 3 launches each, the losses within 1e-4
     and the gradients within 1e-4 in the 2-norm of the plain path of the
     same code on the card (K1's plain version under autograd), each limit
     raised to twice the plain path's own move under a 1e-6 relative move
     of the image where that is larger (ReLU slopes flipping near 0, and
     the texture loss a small difference of two grams), both timed;
     the four normal-loss modes on the normals of two random 1536² gx/gy
     maps on cuda against the cpu (values within 1e-5, gradients within
     1e-5 of their max, each widened by acos' conditioning near ±1; a
     pixel within 2^-20 of a mask bound of AL or TAL left out of the
     gradient's check, since the loss jumps there); one
     batch of each legacy dataset (single, unaligned, singleimage,
     template) through the port's ``DataLoader`` onto the card, the same
     bits back;
 4m. several ranks (:func:`several_ranks`): two ranks that share the card
     over gloo (``vts_torch.platform.spawn_ranks``, devices [cuda:0,
     cuda:0]; the kernels built before): (a) one D3-active full-width
     sinskit step of batch 2 under ``--mesh data:2``, one sample a rank,
     against the serial batch-2 step on the card from the same seeded
     weights, batch and draws: losses and Adam's first moments by phase
     4's rule (the leaves at round-off held to its floor, a zero gradient's
     leaf to its floor plus the serial step's |g| and twice what 1e-6
     relative moves of the weights change there; G in the
     2-norm within twice the largest move that 1e-6 relative moves of the
     weights make to the serial step's G gradient, where that exceeds
     1e-5: the touch LPIPS's near-ties), D1's and D2's running statistics
     within 1e-6 + 1e-4·|ref|; the two ranks' networks and moments bit for
     bit the same; each rank's K1, K1 dx, K2 and K2 bwd launches
     ``PER_STEP`` at the ``train`` row's shapes; the walls of 3 more steps
     on each rank and of the serial step, the collectives a step makes and
     the bytes each rank sends (not a speed figure: the ranks contend for
     one card); (b) phase 4j's two garments, one a rank
     (``FleetTrainer`` on its block), each bit for bit its single step
     under cuDNN's deterministic algorithms, the loss means gathered over
     the ranks the same on both; (c) with two cards or more, over NCCL:
     ``vts_torch.train --mesh data:2`` (two ``[dist]`` lines naming nccl)
     and ``vts_torch.launch ours launch`` on two garments, one a card;
     with one, ``[dist] nccl: 1 card visible, not run``;
  5. times (CUDA events, warm-up, median of >= 10 runs): each kernel and its
     plain version and library call at each path shape, the bound from the
     shapes (K1 and K1 dx against the TF32 tensor cores at three passes,
     their fp32 CUDA-core bound beside it; a row's bound is the sum over its
     shapes of launches × that shape's bound) (no device-only profiler
     session: cut for time); the D3 part of a step (both CLIP passes, the
     backward, resize_mm) by events; the wall time of one test sample,
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
     its launcher wall (two processes at once)
     and the postprocess's host time per map in each mode; the untraced
     full-width pix2pix step (median of 5 after 2 warm-ups, samples/s, peak
     memory), one full-canvas pix2pix test sample (median of 3 after 1, its
     G forward and launches) and one traced pix2pix step in a process of its
     own (``vts_torch.utils.profiler``'s ``profile_train_step``: the idle
     share; the three baselines' traced steps share that process); the
     same three for pix2pixHD, the traced step's process also profiling
     the step's VGG19 loss alone (its device time); the same three for
     SPADE, with the test sample's G forward and peak memory, the traced
     step's launches, and its process also profiling the step's VGG19 loss
     and its spectral norms alone (their device time and launches).

The second-to-last line is ``{"kernels": [...]}``, one row per kernel and
path: an ``eval`` row covers one test sample (its launches are the test
run's, which holds one sample, less the gallery's), a ``train`` row one
training step (its launches are those of a timed D3-active step, counted
from 0), a ``train_bf16`` row one step of the production lane before its
anneal (likewise), a ``train_tmult2`` row one D3-active x2 step, an
``eval_legacy`` row one skitG test sample under --eval_mode legacy (its
launches counted in that sample), an ``eval_pix2pix`` row one pix2pix
test sample (K = 64 test patches; the test run's launches less the
gallery's) and an ``eval_pix2pixhd`` row one pix2pixHD test sample
(likewise; its times are the ``eval_pix2pix`` row's when phase 4h found the
same shapes) and an ``eval_spade`` row one SPADE test sample (the same
with phase 4i), and an ``eval_stylegan2`` row one 1024² pix2pix test
sample with the StyleGAN2 G (phase 4k); ``ms``, ``plain_ms``,
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


def compare_steps(label, cpu, cuda, g_scale=1.0, named=True, g_norm=None, vs="cuda vs cpu",
                  extra_tol=None):
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
    tmult.py measures it against float64).  ``g_norm``: G is held in the
    2-norm over the network to that bound alone (its per-leaf ratios
    printed): a step whose G gradient is ill-conditioned, its bound
    measured beside it (SPADE's VGG-on step).  ``extra_tol``: net → leaf →
    a bound added to that leaf's."""
    lc, lg = cpu.get_current_losses(), cuda.get_current_losses()
    check(set(lc) == set(lg), f"{label}: unexpected losses {sorted(lc)} / {sorted(lg)}")
    worst = max((abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-7), k) for k in lc)
    print(f"[train ref] {label}, {vs}: worst loss rel {worst[0]:.2e} ({worst[1]})" + (
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
            extra = (extra_tol or {}).get(net, {}).get(k, 0.0)
            return grad_tol(k, v, net_max) * (1.0 if ZERO_GRAD.search(k) else scale) + extra
        ratio = {k: (mu_g[k].cpu() - v).abs().max().item() / tol(k, v) for k, v in mu_c.items()}
        worst = max(ratio, key=ratio.get)
        norm = rel_norm(mu_g, mu_c, mu_c)
        print(f"[train ref] {label}, {net} grads {vs}: worst per-leaf |d|/tolerance "
              f"{ratio[worst]:.2e} at {worst} (network max |g| {net_max:.3e}, "
              f"{len(at_roundoff)} leaves at round-off; limit x{scale:g}); |d|/|g| over the "
              f"network {norm:.2e}" + (f" (limit {g_norm:.2e}, the 2-norm alone)"
                                       if net == "G" and g_norm else ""))
        if net == "G" and g_norm:
            check(norm <= g_norm, f"{label}: G gradient on cuda disagrees with cpu in norm")
            continue
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


class RecordShapes:
    """While entered: the shapes K1 launches at, (N, H, W, C, Co), and those
    K2 launches at, (the images' shapes, N, K, cut), each sorted: two runs
    whose lists are equal launched the kernels at the same shapes."""

    def __enter__(self):
        from vts_torch.ops import conv3x3 as k1
        from vts_torch.ops import patch as k2
        self.mods = ((k1, "_forward"), (k2, "_gather_group"))
        self.real = [getattr(m, a) for m, a in self.mods]
        self.k1, self.k2 = [], []
        fwd, group = self.real

        def k1_fwd(x, w, b, relu):
            if x.is_cuda:
                self.k1.append(tuple(x.shape) + (w.shape[-1],))
            return fwd(x, w, b, relu)

        def k2_group(images, win, cutout, mode):
            if images[0].is_cuda:
                self.k2.append((tuple(tuple(im.shape) for im in images), win.n, win.k, cutout))
            return group(images, win, cutout, mode)
        k1._forward, k2._gather_group = k1_fwd, k2_group
        return self

    def __exit__(self, *exc):
        for (m, a), real in zip(self.mods, self.real):
            setattr(m, a, real)

    def shapes(self):
        return sorted(self.k1), sorted(self.k2)


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
# the dashboard's short 256² run: 3 epochs of 4 steps, a loss line each step
DASH_TRAIN = ["--dataroot", SMALL_DATA, "--crop_size", "256", "--center_w", "192",
              "--center_h", "128", "--ngf", "4", "--ndf", "4", "--batch_size_G2", "4",
              "--batch_size_G2_val", "3", "--add_fake_T_sample_size", "3", "--data_len", "4",
              "--n_epochs", "3", "--n_epochs_decay", "0", "--use_vision_aided_loss", "false",
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

    # both garments at once only: the one-after-the-other runs once timed
    # beside it (17.5 s at once against 36.1 s on an H100) were cut for time
    out = {"data": data,
           "two_s": launch("launch", "ours", mats, "launch.log", extra=train_flags)}
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


# ------------------------------------------------------------------ 4g ---
# pix2pix at its shipped training defaults (ngf/ndf 64, resnet_9blocks, the
# batch-norm G and basic Ds, batch 32 of 32² patches cut from the 1536²
# view, the vanilla GAN and L1·100), cut in length only: an epoch holds the
# view's 64 touch squares (two steps), so 5 epochs make 10 steps, with the
# full-image validation after each and the gallery at sample 320 (the tenth
# step, as --display_freq says by default)
P2P_DATA = f"synthetic://smoke?size={PADDED}"
P2P_TRAIN = ["--model", "pix2pix", "--dataset_mode", "patchskit", "--name", "p2p",
             "--dataroot", P2P_DATA, "--device", "cuda", "--n_epochs", "5",
             "--n_epochs_decay", "0", "--val_for_each_epoch", "true"]
P2P_TEST = ["--model", "pix2pix", "--name", "p2p", "--epoch", "best", "--dataroot", P2P_DATA,
            "--device", "cuda"]
P2P_LOSSES = {"D_fake", "D_real", "D2_fake", "D2_real", "G_GAN_I", "G_GAN_T", "G_L1", "G_total"}
# K1 at a pix2pix test sample, whose test parser cuts K = 64 test patches:
# the canvas LPIPS on [real, fake], the patch LPIPS on 2·64 224² patches,
# once for gx and once for gy
K_P2P = 64
K1_P2P = K1_SHAPES[:3] + [(2 * K_P2P, 224, 224, 64, 64, 2), (2 * K_P2P, 112, 112, 64, 128, 2),
                          (2 * K_P2P, 112, 112, 128, 128, 2)]


def patch_batch(b, seed=0):
    """Random 32² pix2pix patches (S, I, M, T_images, I_masks) at batch b."""
    import numpy as np
    r = np.random.default_rng(seed)
    return {"S": r.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32),
            "I": r.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
            "M": np.ones((b, 32, 32, 1), np.float32),
            "T_images": r.uniform(-1, 1, (b, 1, 32, 32, 2)).astype(np.float32),
            "I_masks": np.ones((b, 1, 32, 32, 1), np.float32)}


def k1_eval_rows(spec, what, seed):
    """K1 against its plain version at each (N, H, W, C, Co, per sample) of
    ``spec``, within 1e-4·max|ref| + 1e-5: the rows phase 5 times."""
    from vts_torch.ops import conv3x3 as k1
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = []
    for (n, h, w, c, co, per) in spec:
        x = torch.relu(torch.randn(n, h, w, c, generator=gen)).cuda()
        wt = (torch.randn(3, 3, c, co, generator=gen) * math.sqrt(2.0 / (9 * c))).cuda()
        b = (torch.randn(co, generator=gen) * 0.1).cuda()
        got, ref = k1.conv3x3_bias_relu(x, wt, b), k1.conv3x3_bias_relu_plain(x, wt, b)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        print(f"[K1 {what} check] {(n, h, w, c)}->{co}: max|d| {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"K1 disagrees with its plain version at {(n, h, w, c, co)}")
        rows.append(dict(shape=[n, h, w, c, co], per_sample=per, err=err, tensors=(x, wt, b)))
        del got, ref
    return rows


def pix2pix_baseline(tmp, dirs, wf_data, run_train, run_test):
    """Phase 4g: ``vts_torch.train --model pix2pix`` at the full-width
    defaults (:data:`P2P_TRAIN`), its best G through ``vts_torch.test`` on
    the 1536² canvas, a 32² step (batch 4, ngf/ndf 8) and a 256² eval
    forward on cuda against cpu, and the launcher's pix2pix child on the
    on-disk garment of phase 4f.  What phase 5 needs of it."""
    import numpy as np

    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_torch.ops import conv3x3 as k1

    out = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with Gallery() as gallery:
        model = run_train(P2P_TRAIN + dirs)
    torch.cuda.synchronize()
    run = read_counts()
    losses = model.get_current_losses()
    steps = model.adam["G"].count
    print(f"[pix2pix] {steps} steps of batch 32 over 5 epochs + 5 full-image validations + the "
          f"gallery in {time.time() - t0:.2f} s (first run, incl. data and model set-up); G "
          f"{sum(p.numel() for p in model.netG.parameters()) / 1e6:.3f} M params; last losses: "
          + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[pix2pix] launches during the training run: {run}")
    print(gallery.line("pix2pix training gallery (32² patches)"))
    check(set(losses) == P2P_LOSSES and all(math.isfinite(v) for v in losses.values()),
          f"a pix2pix training loss is missing or not finite: {losses}")
    check(steps == 10, f"the pix2pix run took {steps} steps, not 10")
    check(run["conv3x3_bias_relu"] > 0 and run["gather_patches"] > 0
          and run["conv3x3_dx"] == 0 and run["scatter_patches"] == 0,
          f"the pix2pix run (GAN + L1, the metrics in its validations) launched {run}")
    ck = os.path.join(tmp, "ckpt", "p2p")
    missing = [f"{tag}_{kind}_{net}.msgpack" for tag in ("best", "latest")
               for net in ("G", "D", "D2") for kind in ("net", "opt")
               if not os.path.exists(os.path.join(ck, f"{tag}_{kind}_{net}.msgpack"))]
    check(not missing, f"pix2pix checkpoints not written: {missing}")
    pngs = os.listdir(os.path.join(ck, "web", "images"))
    check(gallery.passes == 1 and any(f.endswith("_fake_I.png") for f in pngs)
          and not any("pred_fake_T_full" in f for f in pngs),
          f"the pix2pix gallery: {gallery.passes} passes, {sorted(pngs)}")
    out["train_model"] = model

    # its best G on the full canvas through the test driver
    reset_counts()
    with CountPatchOffsets() as host_offsets, Gallery() as gallery, RecordShapes() as shapes:
        metrics = run_test(P2P_TEST + dirs)[0]
    torch.cuda.synchronize()
    out["shapes"] = shapes.shapes()
    out["run_launches"] = read_counts()
    out["sample_launches"] = {k: v - gallery.launches[k] for k, v in out["run_launches"].items()}
    print(f"[pix2pix test] {CANVAS}² canvas, K {K_P2P}: " +
          " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
    print(f"[pix2pix test] launches during the test run: {out['run_launches']}; the sample's, "
          f"without the gallery: {out['sample_launches']}")
    check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
          f"pix2pix test: expected 8 finite metrics, got {metrics}")
    check(out["sample_launches"] == PER_SAMPLE,
          f"a pix2pix test sample launched {out['sample_launches']}, not {PER_SAMPLE}")
    check(host_offsets.calls == 0, f"the pix2pix test called patch_offsets "
                                   f"{host_offsets.calls} times on the host")
    web = os.path.join(tmp, "res", "p2p", "test_best")
    written = os.listdir(os.path.join(web, "images"))
    check(os.path.exists(os.path.join(web, "index.html"))
          and any(f.endswith("_fake_gxgy_raw.npz") for f in written)
          and not any("pred_fake_T_full" in f for f in written),
          f"the pix2pix test gallery: {sorted(written)}")

    # K1 at the pix2pix eval shapes against its plain version
    check(out["shapes"][0] == sorted(tuple(r[:5]) for r in K1_P2P for _ in range(r[5])),
          f"a pix2pix test sample launched K1 at {out['shapes'][0]}, not at K1_P2P's shapes")
    out["k1_rows"] = k1_eval_rows(K1_P2P, "pix2pix", seed=12)

    # a 32² step (batch 4, ngf/ndf 8) on cuda and on cpu from the same weights
    small = ["--model", "pix2pix", "--name", "p2p_small", "--dataroot", SMALL_DATA,
             "--crop_size", "256", "--center_w", "192", "--center_h", "128", "--ngf", "8",
             "--ndf", "8", "--batch_size", "4", "--no_html"] + dirs
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pair = {}
    for key in ("cpu", "cuda"):
        pair[key] = create_model(TrainOptions().parse(small + ["--device", key], quiet=True))
        pair[key].setup()
        pair[key].set_input(patch_batch(4))
        pair[key].optimize_parameters(1)
    compare_steps("32² pix2pix step", pair["cpu"], pair["cuda"])
    worst = 0.0
    for net in ("G", "D", "D2"):
        for k, v in getattr(pair["cpu"], f"net{net}").state_dict().items():
            if k.endswith((".mean", ".var")):
                d = (getattr(pair["cuda"], f"net{net}").state_dict()[k].cpu() - v).abs().max()
                worst = max(worst, d.item())
    print(f"[pix2pix ref] 32² step, running statistics of G, D and D2 cuda vs cpu: max|d| "
          f"{worst:.3e}")
    check(worst <= 1e-5, "pix2pix running statistics on cuda disagree with cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 256, 256, 1))
                         .astype(np.float32))
    with torch.no_grad():
        ref, got = (pair[k]._forward_eval(x.to(pair[k].device), torch.ones_like(x[..., :1])
                                          .to(pair[k].device)) for k in ("cpu", "cuda"))
    err = max((g.cpu() - r).abs().max().item() / r.abs().max().item() for g, r in zip(got, ref))
    print(f"[pix2pix ref] 256² eval forward (running statistics) cuda vs cpu: max|d|/max|ref| "
          f"{err:.3e}")
    check(err <= 1e-4, "the pix2pix eval forward on cuda disagrees with cpu")
    torch.backends.cudnn.deterministic = cudnn_det
    del pair

    # the launcher's pix2pix child on the on-disk garment of phase 4f, 1 epoch
    root = os.path.join(wf_data, f"singleskit_{{material}}_padded_{PADDED}_x1")
    out["launch_s"] = launcher(
        ["pix2pix", "launch", "--mode", "process", "--materials", "synthA",
         "--dataroot-template", root, "--checkpoints_dir", os.path.join(tmp, "p2p_ckpt"),
         "--results_dir", os.path.join(tmp, "p2p_res"), "--", "--n_epochs", "1",
         "--n_epochs_decay", "0", "--no_html", "--max_dataset_size", "32",
         "--val_for_each_epoch", "false"],
        os.path.join(tmp, "wf_logs", "launch_pix2pix.log"), "cuda", 1)
    check(os.path.exists(os.path.join(tmp, "p2p_ckpt", "synthA_pix2pix_baseline",
                                      "latest_net_G.msgpack")),
          "the launcher's pix2pix child wrote no checkpoint")
    return out


# ------------------------------------------------------------------ 4h ---
# pix2pixHD at its shipped training defaults (the instance-norm global G:
# ngf 64, 4 downsamplings, 9 blocks; two 2-scale multiscale Ds with
# intermediate features, ndf 64; lsgan, GAN-feat·10 and VGG19·10; batch 32
# of 32² patches from the 1536² view), cut in length only: 1 epoch of the
# view's 64 touch squares (2 steps), the full-image validation after it
HD_TRAIN = ["--model", "pix2pixHD", "--dataset_mode", "patchskit", "--name", "p2phd",
            "--dataroot", P2P_DATA, "--device", "cuda", "--n_epochs", "1",
            "--n_epochs_decay", "0", "--val_for_each_epoch", "true"]
HD_TEST = ["--model", "pix2pixHD", "--name", "p2phd", "--epoch", "best", "--dataroot", P2P_DATA,
           "--device", "cuda"]
HD_LOSSES = {"D_fake", "D_real", "D2_fake", "D2_real", "G_GAN", "G_GAN_Feat", "G_VGG",
             "G_total"}


def pix2pixhd_baseline(tmp, dirs, wf_data, run_train, run_test, p2p_shapes):
    """Phase 4h: ``vts_torch.train --model pix2pixHD`` at the full-width
    defaults (:data:`HD_TRAIN`), its best G through ``vts_torch.test`` on the
    1536² canvas (the kernels' shapes there against pix2pix's test sample's,
    ``p2p_shapes``), a 32² step (batch 4, ngf/ndf 8, 2 downsamplings, 2
    blocks, the VGG loss, the corrected GAN-feat term, a pool of 2 with
    fixed draws) and a 256² eval forward on cuda against cpu, and the
    launcher's pix2pixhd child on the on-disk garment of phase 4f.  What
    phase 5 needs of it."""
    import numpy as np

    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model

    out = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    model = run_train(HD_TRAIN + dirs)
    torch.cuda.synchronize()
    run = read_counts()
    losses = model.get_current_losses()
    steps = model.adam["G"].count
    print(f"[pix2pixhd] {steps} steps of batch 32 in 1 epoch + 1 full-image validation in "
          f"{time.time() - t0:.2f} s (first run, incl. data and model set-up); G "
          f"{sum(p.numel() for p in model.netG.parameters()) / 1e6:.3f} M params, D "
          f"{sum(p.numel() for p in model.netD.parameters()) / 1e6:.3f} M; last losses: "
          + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[pix2pixhd] launches during the training run: {run}")
    check(set(losses) == HD_LOSSES and all(math.isfinite(v) for v in losses.values()),
          f"a pix2pixHD training loss is missing or not finite: {losses}")
    check(losses["G_GAN_Feat"] == 0.0 and losses["G_VGG"] > 0,
          f"pix2pixHD: G_GAN_Feat {losses['G_GAN_Feat']} (the reference's term is 0), G_VGG "
          f"{losses['G_VGG']} (> 0)")
    check(steps == 2, f"the pix2pixHD run took {steps} steps, not 2")
    check(run["conv3x3_bias_relu"] > 0 and run["gather_patches"] > 0
          and run["conv3x3_dx"] == 0 and run["scatter_patches"] == 0,
          f"the pix2pixHD run (GAN, GAN-feat and VGG19 on cuDNN; the metrics in its "
          f"validations) launched {run}")
    ck = os.path.join(tmp, "ckpt", "p2phd")
    missing = [f"{tag}_{kind}_{net}.msgpack" for tag in ("best", "latest")
               for net in ("G", "D", "D2") for kind in ("net", "opt")
               if not os.path.exists(os.path.join(ck, f"{tag}_{kind}_{net}.msgpack"))]
    check(not missing, f"pix2pixHD checkpoints not written: {missing}")
    out["train_model"] = model

    # its best G on the full canvas through the test driver
    reset_counts()
    with CountPatchOffsets() as host_offsets, Gallery() as gallery, RecordShapes() as shapes:
        metrics = run_test(HD_TEST + dirs)[0]
    torch.cuda.synchronize()
    out["run_launches"] = read_counts()
    out["sample_launches"] = {k: v - gallery.launches[k] for k, v in out["run_launches"].items()}
    print(f"[pix2pixhd test] {CANVAS}² canvas, K {K_P2P}: " +
          " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
    print(f"[pix2pixhd test] launches during the test run: {out['run_launches']}; the "
          f"sample's, without the gallery: {out['sample_launches']}")
    check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
          f"pix2pixHD test: expected 8 finite metrics, got {metrics}")
    check(out["sample_launches"] == PER_SAMPLE,
          f"a pix2pixHD test sample launched {out['sample_launches']}, not {PER_SAMPLE}")
    check(host_offsets.calls == 0, f"the pix2pixHD test called patch_offsets "
                                   f"{host_offsets.calls} times on the host")
    web = os.path.join(tmp, "res", "p2phd", "test_best")
    written = os.listdir(os.path.join(web, "images"))
    check(os.path.exists(os.path.join(web, "index.html"))
          and any(f.endswith("_fake_gxgy_raw.npz") for f in written),
          f"the pix2pixHD test gallery: {sorted(written)}")
    # the kernels' shapes: pix2pix's rows are reused when they are the same,
    # else these are checked here and timed in phase 5
    k1_shapes, k2_shapes = shapes.shapes()
    out["same_shapes"] = (k1_shapes, k2_shapes) == p2p_shapes
    print(f"[pix2pixhd test] K1 and K2 at the shapes of a pix2pix test sample: "
          f"{out['same_shapes']} (K1 {sorted(set(k1_shapes))}, K2 {k2_shapes})")
    out["k1_rows"] = [] if out["same_shapes"] else k1_eval_rows(
        [r + (k1_shapes.count(r),) for r in sorted(set(k1_shapes))], "pix2pixhd", seed=13)
    out["k2_k"] = max(k for _, _, k, _ in k2_shapes)      # the sample's (the gallery cuts 10)

    # a 32² step (batch 4, ngf/ndf 8) on cuda and on cpu from the same weights
    small = ["--model", "pix2pixHD", "--name", "p2phd_small", "--dataroot", SMALL_DATA,
             "--crop_size", "256", "--center_w", "192", "--center_h", "128", "--ngf", "8",
             "--ndf", "8", "--batch_size", "4", "--n_downsample_global", "2",
             "--n_blocks_global", "2", "--correct_gan_feat", "true", "--pool_size", "2",
             "--no_html"] + dirs
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pair = {}
    for key in ("cpu", "cuda"):
        pair[key] = create_model(TrainOptions().parse(small + ["--device", key], quiet=True))
        pair[key].setup()
    draws = pair["cpu"].draw(4)
    for key in ("cpu", "cuda"):
        pair[key].set_input(patch_batch(4))
        pair[key].optimize_parameters(1, draws=draws)
    # G meets the VGG19 loss, whose fp32 max-pool, ReLU and |·| near-ties
    # settle differently on cuda and cpu: the x2 rule (see compare_steps)
    compare_steps("32² pix2pixHD step (VGG, corrected GAN-feat, pool)", pair["cpu"],
                  pair["cuda"], g_scale=4.0, named=False)
    (buf_c, n_c), (buf_g, n_g) = pair["cpu"]._pool, pair["cuda"]._pool
    err = (buf_g.cpu() - buf_c).abs().max().item() / buf_c.abs().max().item()
    print(f"[pix2pixhd ref] 32² step, the pool (count {n_g} / {n_c}) cuda vs cpu: "
          f"max|d|/max|ref| {err:.3e}")
    check(n_c == n_g == 2 and err <= 1e-5, "the pix2pixHD pool on cuda disagrees with cpu")
    # the eval forward from the same weights: after the step they differ where
    # Adam's first step, lr·g/(|g| + 1e-8), turned a near-zero gradient's
    # round-off into a ±lr move, which the instance norms of an ngf-8 G
    # carry to ~1e-2 of its output (measured on an H100)
    pair["cuda"].netG.load_state_dict(pair["cpu"].netG.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 256, 256, 1))
                         .astype(np.float32))
    with torch.no_grad():
        ref, got = (pair[k]._forward_eval(x.to(pair[k].device), torch.ones_like(x[..., :1])
                                          .to(pair[k].device)) for k in ("cpu", "cuda"))
    err = max((g.cpu() - r).abs().max().item() / r.abs().max().item() for g, r in zip(got, ref))
    print(f"[pix2pixhd ref] 256² eval forward cuda vs cpu from the same weights: max|d|/max|ref| "
          f"{err:.3e}")
    check(err <= 1e-4, "the pix2pixHD eval forward on cuda disagrees with cpu")
    del pair
    # the same step under --dtype bfloat16 on cuda and on cpu, cpu fp32 the reference
    out["bf16"] = bf16_trio("32² pix2pixHD bf16 step (VGG, corrected GAN-feat, pool)", small,
                            patch_batch(4), 4)
    torch.backends.cudnn.deterministic = cudnn_det

    # the launcher's pix2pixhd child on the on-disk garment of phase 4f, 1 epoch,
    # ngf/ndf 8 (cut for time: the full-width G's seeded init on the host
    # took most of the child's 31-43 s; the full width trains above)
    root = os.path.join(wf_data, f"singleskit_{{material}}_padded_{PADDED}_x1")
    out["launch_s"] = launcher(
        ["pix2pixhd", "launch", "--mode", "process", "--materials", "synthA",
         "--dataroot-template", root, "--checkpoints_dir", os.path.join(tmp, "hd_ckpt"),
         "--results_dir", os.path.join(tmp, "hd_res"), "--", "--n_epochs", "1",
         "--n_epochs_decay", "0", "--no_html", "--max_dataset_size", "32",
         "--val_for_each_epoch", "false", "--ngf", "8", "--ndf", "8"],
        os.path.join(tmp, "wf_logs", "launch_pix2pixhd.log"), "cuda", 1)
    check(os.path.exists(os.path.join(tmp, "hd_ckpt", "synthA_pix2pixHD_baseline",
                                      "latest_net_G.msgpack")),
          "the launcher's pix2pixhd child wrote no checkpoint")
    return out


def traced_baseline_steps(dirs):
    """One traced full-width training step each of pix2pix, pix2pixHD and
    SPADE (``vts_torch.utils.profiler.profile_train_step``, as ``python -m
    vts_torch.utils.profiler --phase train`` runs it), in one process of
    their own started once for the three: {"pix2pix", "pix2pixhd",
    "spade"} → the profiler's record."""
    code = ("import json, sys\n"
            "from vts_torch.utils.profiler import profile_train_step\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    print(json.dumps(profile_train_step(argv)), flush=True)\n")
    argvs = [P2P_TRAIN + dirs, HD_TRAIN + dirs, SP_TRAIN + dirs]
    t0 = time.time()
    prof = subprocess.run([sys.executable, "-c", code, json.dumps(argvs)], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    check(prof.returncode == 0, f"the traced baseline steps failed:\n{prof.stderr[-3000:]}")
    # the models' set-up prints lines of their own between the records
    recs = [json.loads(line) for line in prof.stdout.splitlines() if line.startswith("{")]
    check(len(recs) == 3, f"the traced baseline steps printed {len(recs)} records, not 3")
    print(f"[time traced baselines] the three traced steps' process took {time.time() - t0:.1f} s")
    return dict(zip(("pix2pix", "pix2pixhd", "spade"), recs))


def pix2pixhd_times(hd, dirs, smi, rec):
    """Phase 5's pix2pixHD times: one untraced full-width training step
    (median of 5 after 2 warm-ups, samples/s, peak memory), one full-canvas
    test sample (median of 3 after 1, its G forward and launches), and one
    traced step in a process of its own (the idle share) with the step's
    VGG19 loss profiled alone on its outputs (its device time)."""
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model

    model = hd.pop("train_model")
    batch = next(iter(create_dataset(TrainOptions().parse(HD_TRAIN + dirs, quiet=True))))
    model.set_input(batch)
    walls, peaks = [], []
    held = torch.cuda.memory_allocated() / 2 ** 30
    for i in range(7):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.optimize_parameters(1)
        model.get_current_losses()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    hd_wall = statistics.median(walls)
    print(f"[time pix2pixhd step] {smi}: one full-width pix2pixHD training step (batch 32 of "
          f"32² patches, ngf/ndf 64, the instance-norm global G with 4 downsamplings and 9 "
          f"blocks, two 2-scale Ds, lsgan + GAN-feat + VGG19): {hd_wall:.1f} ms wall, median "
          f"of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); {32e3 / hd_wall:.1f} "
          f"samples/s; peak memory {max(peaks):.2f} GiB, of which {held:.2f} GiB was held by "
          f"this process before the step")
    del model, batch
    torch.cuda.empty_cache()
    topt = TestOptions().parse(HD_TEST + dirs, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.load_networks("best")
    model.set_input(batch)
    walls, g_ms = [], []
    for i in range(4):
        torch.cuda.synchronize()
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        model.test()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.compute_metrics()
        torch.cuda.synchronize()
        if i == 1:
            hd_one = read_counts()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
            g_ms.append((t1 - t0) * 1e3)
    print(f"[time pix2pixhd sample] {smi}: one {CANVAS}² pix2pixHD test sample (K {K_P2P}): "
          f"{statistics.median(walls):.1f} ms wall (G forward {statistics.median(g_ms):.1f} "
          f"ms), median of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); G forward "
          f"alone {', '.join(f'{w:.1f}' for w in g_ms)} ms; launches {hd_one}")
    check(hd_one == PER_SAMPLE, f"a pix2pixHD test sample launched {hd_one}, not {PER_SAMPLE}")
    del model, batch
    torch.cuda.empty_cache()
    vgg = rec["vgg19"]
    print(f"[time pix2pixhd traced] {smi}: one traced full-width pix2pixHD step in a process "
          f"of its own (vts_torch.utils.profiler --phase train): wall {rec['wall_ms']:.1f} ms, "
          f"device busy {rec['device_busy_ms']:.1f} ms, idle share "
          f"{rec['device_idle_share']:.3f}, peak memory {rec['peak_memory_gib']:.2f} GiB; top "
          f"kernels: " + "; ".join(f"{k['name'][:60]} {k['ms']:.2f} ms"
                                   for k in rec["kernels_ms"][:8]))
    print(f"[time pix2pixhd vgg19] {smi}: the step's VGG19 loss alone on its outputs (fake_I, "
          f"gx and gy tiled to 3 channels, one pass of 96 32² images each for x and y, the "
          f"backward to the inputs; profiled after the step): wall {vgg['wall_ms']:.2f} ms, "
          f"device busy {vgg['device_busy_ms']:.2f} ms "
          f"({vgg['device_busy_ms'] / rec['device_busy_ms']:.3f} of the step's); top kernels: "
          + "; ".join(
              f"{k['name'][:60]} {k['ms']:.3f} ms" for k in vgg["kernels_ms"][:6]))


# ------------------------------------------------------------------ 4i ---
# SPADE at its shipped training defaults (the spade G with ngf 64, 3
# upsamplings, spectral convs and the param-free sync batch norm; two 2-scale
# multiscale spectral-instance Ds with intermediate features, ndf 64; hinge,
# GAN-feat·10 and VGG19·10; TTUR; batch 16 of 32² patches from the 1536²
# view), cut in length only: 1 epoch of 2 steps (--max_dataset_size 32),
# the full-image validation after it
SP_TRAIN = ["--model", "spade", "--dataset_mode", "patchskit", "--name", "spade",
            "--dataroot", P2P_DATA, "--device", "cuda", "--n_epochs", "1",
            "--n_epochs_decay", "0", "--val_for_each_epoch", "true", "--max_dataset_size", "32"]
SP_TEST = ["--model", "spade", "--name", "spade", "--epoch", "best", "--dataroot", P2P_DATA,
           "--device", "cuda"]
SP_LOSSES = HD_LOSSES


def spectral_state(model):
    """Every ``u`` and running statistic of G, D and D2, on the host."""
    return {f"{net}.{k}": v.detach().float().cpu()
            for net in ("G", "D", "D2") for k, v in getattr(model, f"net{net}").state_dict().items()
            if k.endswith((".u", ".mean", ".var"))}


def spade_baseline(tmp, dirs, wf_data, run_train, run_test, p2p_shapes):
    """Phase 4i: ``vts_torch.train --model spade`` at the full-width defaults
    (:data:`SP_TRAIN`), its best G through ``vts_torch.test`` on the 1536²
    canvas (the kernels' shapes there against pix2pix's test sample's,
    ``p2p_shapes``; the sample's peak memory), 32² steps (batch 4, ngf/ndf
    8, a pool of 2 with fixed draws; without and with the VGG loss) and a
    256² eval forward on cuda against cpu, and the launcher's spade child on
    the on-disk garment of phase 4f.  What phase 5 needs of it."""
    import numpy as np

    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_torch.utils.msgpack import msgpack_restore

    out = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    model = run_train(SP_TRAIN + dirs)
    torch.cuda.synchronize()
    run = read_counts()
    losses = model.get_current_losses()
    steps = model.adam["G"].count
    print(f"[spade] {steps} steps of batch 16 in 1 epoch + 1 full-image validation in "
          f"{time.time() - t0:.2f} s (first run, incl. data and model set-up); G "
          f"{sum(p.numel() for p in model.netG.parameters()) / 1e6:.3f} M params, D "
          f"{sum(p.numel() for p in model.netD.parameters()) / 1e6:.3f} M; last losses: "
          + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[spade] launches during the training run: {run}")
    check(set(losses) == SP_LOSSES and all(math.isfinite(v) for v in losses.values()),
          f"a SPADE training loss is missing or not finite: {losses}")
    check(losses["G_GAN_Feat"] > 0 and losses["G_VGG"] > 0,
          f"SPADE: G_GAN_Feat {losses['G_GAN_Feat']} and G_VGG {losses['G_VGG']} must be > 0")
    check(steps == 2, f"the SPADE run took {steps} steps, not 2")
    check(run["conv3x3_bias_relu"] > 0 and run["gather_patches"] > 0
          and run["conv3x3_dx"] == 0 and run["scatter_patches"] == 0,
          f"the SPADE run (hinge, GAN-feat and VGG19 on cuDNN; the metrics in its "
          f"validations) launched {run}")
    ck = os.path.join(tmp, "ckpt", "spade")
    missing = [f"{tag}_{kind}_{net}.msgpack" for tag in ("best", "latest")
               for net in ("G", "D", "D2") for kind in ("net", "opt")
               if not os.path.exists(os.path.join(ck, f"{tag}_{kind}_{net}.msgpack"))]
    check(not missing, f"SPADE checkpoints not written: {missing}")
    def has_u(tree):
        return any(k == "u" or (isinstance(v, dict) and has_u(v)) for k, v in tree.items())
    for net in ("G", "D", "D2"):
        with open(os.path.join(ck, f"latest_net_{net}.msgpack"), "rb") as f:
            check(has_u(msgpack_restore(f.read())["stats"]),
                  f"the SPADE {net} checkpoint holds no spectral u in its stats")
    out["train_model"] = model

    # its best G on the full canvas through the test driver
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    with CountPatchOffsets() as host_offsets, Gallery() as gallery, RecordShapes() as shapes:
        metrics = run_test(SP_TEST + dirs)[0]
    torch.cuda.synchronize()
    out["test_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["run_launches"] = read_counts()
    out["sample_launches"] = {k: v - gallery.launches[k] for k, v in out["run_launches"].items()}
    print(f"[spade test] {CANVAS}² canvas, K {K_P2P}: " +
          " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
    print(f"[spade test] launches during the test run: {out['run_launches']}; the sample's, "
          f"without the gallery: {out['sample_launches']}; peak memory of the run "
          f"{out['test_peak_gib']:.2f} GiB ({held:.2f} GiB held before it)")
    check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
          f"SPADE test: expected 8 finite metrics, got {metrics}")
    check(out["sample_launches"] == PER_SAMPLE,
          f"a SPADE test sample launched {out['sample_launches']}, not {PER_SAMPLE}")
    check(host_offsets.calls == 0, f"the SPADE test called patch_offsets "
                                   f"{host_offsets.calls} times on the host")
    web = os.path.join(tmp, "res", "spade", "test_best")
    written = os.listdir(os.path.join(web, "images"))
    check(os.path.exists(os.path.join(web, "index.html"))
          and any(f.endswith("_fake_gxgy_raw.npz") for f in written),
          f"the SPADE test gallery: {sorted(written)}")
    k1_shapes, k2_shapes = shapes.shapes()
    out["same_shapes"] = (k1_shapes, k2_shapes) == p2p_shapes
    print(f"[spade test] K1 and K2 at the shapes of a pix2pix test sample: "
          f"{out['same_shapes']} (K1 {sorted(set(k1_shapes))}, K2 {k2_shapes})")
    out["k1_rows"] = [] if out["same_shapes"] else k1_eval_rows(
        [r + (k1_shapes.count(r),) for r in sorted(set(k1_shapes))], "spade", seed=14)
    out["k2_k"] = max(k for _, _, k, _ in k2_shapes)

    # 32² steps (batch 4, ngf/ndf 8, a pool of 2) on cuda and on cpu from the
    # same weights, u and draws: without the VGG loss under the plain rule,
    # with it as below
    small = ["--model", "spade", "--name", "spade_small", "--dataroot", SMALL_DATA,
             "--crop_size", "256", "--center_w", "192", "--center_h", "128", "--ngf", "8",
             "--ndf", "8", "--batch_size", "4", "--pool_size", "2", "--no_html"] + dirs
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def pair_step(extra, keys=("cpu", "cuda"), batch=None):
        pair = {}
        for key in keys:
            pair[key] = create_model(TrainOptions().parse(small + extra + ["--device", key],
                                                          quiet=True))
            pair[key].setup()
        draws = pair[keys[0]].draw(4)
        for key in keys:
            pair[key].set_input(batch or patch_batch(4))
            pair[key].optimize_parameters(1, draws=draws)
        return pair

    pair = pair_step(["--no_vgg_loss"])
    compare_steps("32² SPADE step (hinge, TTUR, pool; no VGG)", pair["cpu"], pair["cuda"],
                  named=False)
    st_c, st_g = spectral_state(pair["cpu"]), spectral_state(pair["cuda"])
    fresh = create_model(TrainOptions().parse(small + ["--device", "cpu"], quiet=True))
    fresh.setup()
    init = spectral_state(fresh)
    moved = sum(1 for k, v in st_c.items() if k.endswith(".u") and not torch.equal(v, init[k]))
    worst = max(((st_g[k] - v).abs().max().item(), k) for k, v in st_c.items())
    print(f"[spade ref] 32² step, every u and running statistic of G, D and D2 "
          f"({len(st_c)} buffers, {moved} u moved by the step) cuda vs cpu: max|d| "
          f"{worst[0]:.3e} at {worst[1]}")
    check(worst[0] <= 1e-5 and moved > 0,
          "SPADE u or running statistics on cuda disagree with cpu (or no u moved)")
    (buf_c, n_c), (buf_g, n_g) = pair["cpu"]._pool, pair["cuda"]._pool
    err = (buf_g.cpu() - buf_c).abs().max().item() / buf_c.abs().max().item()
    print(f"[spade ref] 32² step, the pool (count {n_g} / {n_c}) cuda vs cpu: max|d|/max|ref| "
          f"{err:.3e}")
    check(n_c == n_g == 2 and err <= 1e-5, "the SPADE pool on cuda disagrees with cpu")
    # with the VGG loss: an untrained SPADE G's outputs are near-constant (std
    # ~0.02), so VGG19's fp32 max-pool and ReLU near-ties make G's gradient
    # ill-conditioned; it is held in the 2-norm to what a 1e-6 relative
    # change of the sketch does to it on the cpu (measured here), at least the
    # x2 rule's 1e-4, and D's and D2's per leaf as above
    pair = pair_step([])
    b = patch_batch(4)
    b["S"] = (b["S"] * (1 + 1e-6 * np.random.default_rng(3).standard_normal(b["S"].shape))
              ).astype(np.float32)
    moved = pair_step([], ("cpu",), b)["cpu"]
    sens = rel_norm(moved.adam["G"].mu, pair["cpu"].adam["G"].mu, pair["cpu"].adam["G"].mu)
    print(f"[spade ref] 32² VGG-on step on the cpu: a 1e-6 relative change of the sketch moves "
          f"G's gradient by {sens:.2e} in the 2-norm")
    compare_steps("32² SPADE step (hinge, TTUR, pool, VGG)", pair["cpu"], pair["cuda"],
                  named=False, g_norm=max(1e-4, sens))
    # the eval forward (running statistics, σ from the stored u) from the same weights
    pair["cuda"].netG.load_state_dict(pair["cpu"].netG.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 256, 256, 1))
                         .astype(np.float32))
    with torch.no_grad():
        ref, got = (pair[k]._forward_eval(x.to(pair[k].device), torch.ones_like(x[..., :1])
                                          .to(pair[k].device)) for k in ("cpu", "cuda"))
    err = max((g.cpu() - r).abs().max().item() / r.abs().max().item() for g, r in zip(got, ref))
    print(f"[spade ref] 256² eval forward cuda vs cpu from the same weights: max|d|/max|ref| "
          f"{err:.3e}")
    check(err <= 1e-4, "the SPADE eval forward on cuda disagrees with cpu")
    del pair
    # the VGG-less step under --dtype bfloat16 on cuda and on cpu, cpu fp32 the reference
    out["bf16"] = bf16_trio("32² SPADE bf16 step (hinge, TTUR, pool; no VGG)",
                            small + ["--no_vgg_loss"], patch_batch(4), 4)
    torch.backends.cudnn.deterministic = cudnn_det

    # the launcher's spade child on the on-disk garment of phase 4f, 1 epoch,
    # ngf/ndf 8 (cut for time: the full-width G's seeded init on the host
    # took most of the child's 31-43 s; the full width trains above)
    root = os.path.join(wf_data, f"singleskit_{{material}}_padded_{PADDED}_x1")
    out["launch_s"] = launcher(
        ["spade", "launch", "--mode", "process", "--materials", "synthA",
         "--dataroot-template", root, "--checkpoints_dir", os.path.join(tmp, "sp_ckpt"),
         "--results_dir", os.path.join(tmp, "sp_res"), "--", "--n_epochs", "1",
         "--n_epochs_decay", "0", "--no_html", "--max_dataset_size", "32",
         "--val_for_each_epoch", "false", "--ngf", "8", "--ndf", "8"],
        os.path.join(tmp, "wf_logs", "launch_spade.log"), "cuda", 1)
    check(os.path.exists(os.path.join(tmp, "sp_ckpt", "synthA_spade_baseline",
                                      "latest_net_G.msgpack")),
          "the launcher's spade child wrote no checkpoint")
    return out


def spade_times(sp, dirs, smi, rec):
    """Phase 5's SPADE times: one untraced full-width training step (median
    of 5 after 2 warm-ups, samples/s, peak memory), one full-canvas test
    sample (median of 3 after 1, its G forward, launches and peak memory),
    and one traced step in a process of its own (the idle share) with the
    step's VGG19 loss and its spectral norms profiled alone (their device
    time, and the norms' launches)."""
    from vts_torch.config import TestOptions, TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model

    model = sp.pop("train_model")
    batch = next(iter(create_dataset(TrainOptions().parse(SP_TRAIN + dirs, quiet=True))))
    model.set_input(batch)
    walls, peaks = [], []
    held = torch.cuda.memory_allocated() / 2 ** 30
    for i in range(7):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.optimize_parameters(1)
        model.get_current_losses()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    sp_wall = statistics.median(walls)
    print(f"[time spade step] {smi}: one full-width SPADE training step (batch 16 of 32² "
          f"patches, ngf/ndf 64, the spade G with 3 upsamplings, spectral convs and sync batch "
          f"norm, two 2-scale spectral-instance Ds, hinge + GAN-feat + VGG19, TTUR): "
          f"{sp_wall:.1f} ms wall, median of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}"
          f"); {16e3 / sp_wall:.1f} samples/s; peak memory {max(peaks):.2f} GiB, of which "
          f"{held:.2f} GiB was held by this process before the step")
    del model, batch
    torch.cuda.empty_cache()
    topt = TestOptions().parse(SP_TEST + dirs, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.load_networks("best")
    model.set_input(batch)
    walls, g_ms, peaks = [], [], []
    held = torch.cuda.memory_allocated() / 2 ** 30
    for i in range(4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        model.test()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        model.compute_metrics()
        torch.cuda.synchronize()
        if i == 1:
            sp_one = read_counts()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
            g_ms.append((t1 - t0) * 1e3)
            peaks.append((g_peak, torch.cuda.max_memory_allocated() / 2 ** 30))
    print(f"[time spade sample] {smi}: one {CANVAS}² SPADE test sample (K {K_P2P}): "
          f"{statistics.median(walls):.1f} ms wall (G forward {statistics.median(g_ms):.1f} "
          f"ms), median of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); G forward "
          f"alone {', '.join(f'{w:.1f}' for w in g_ms)} ms; peak memory of the G forward "
          f"{max(p[0] for p in peaks):.2f} GiB, of the sample {max(p[1] for p in peaks):.2f} "
          f"GiB ({held:.2f} GiB held before); launches {sp_one}")
    check(sp_one == PER_SAMPLE, f"a SPADE test sample launched {sp_one}, not {PER_SAMPLE}")
    del model, batch
    torch.cuda.empty_cache()
    vgg, sn = rec["vgg19"], rec["spectral_norm"]
    print(f"[time spade traced] {smi}: one traced full-width SPADE step in a process of "
          f"its own (vts_torch.utils.profiler --phase train): wall {rec['wall_ms']:.1f} ms, device busy "
          f"{rec['device_busy_ms']:.1f} ms, idle share {rec['device_idle_share']:.3f}, "
          f"{rec['kernel_launches']} kernel launches, peak memory {rec['peak_memory_gib']:.2f} "
          f"GiB; top kernels: " + "; ".join(f"{k['name'][:60]} {k['ms']:.2f} ms"
                                           for k in rec["kernels_ms"][:8]))
    print(f"[time spade vgg19] {smi}: the step's VGG19 loss alone on its outputs (fake_I, gx "
          f"and gy tiled to 3 channels, one pass of 48 32² images each for x and y, the "
          f"backward to the inputs): wall {vgg['wall_ms']:.2f} ms, device busy "
          f"{vgg['device_busy_ms']:.2f} ms ({vgg['device_busy_ms'] / rec['device_busy_ms']:.3f} "
          f"of the step's)")
    print(f"[time spade spectral] {smi}: the step's spectral norms alone ({sn['convs']} convs, "
          f"{sn['passes']} power iterations and kernel / σ: G's once, D's and D2's three times): "
          f"wall {sn['wall_ms']:.2f} ms, device busy {sn['device_busy_ms']:.3f} ms "
          f"({sn['device_busy_ms'] / rec['device_busy_ms']:.3f} of the step's), "
          f"{sn['kernel_launches']} kernel launches ({sn['kernel_launches'] / rec['kernel_launches']:.3f} "
          f"of the step's); top kernels: " + "; ".join(
              f"{k['name'][:50]} {k['ms']:.3f} ms" for k in sn["kernels_ms"][:5]))


# ------------------------------------------------------------------ 4j ---
# the garment fleet: ``vts_torch.launch ours launch`` in its default mode at
# the shipped training defaults, on two synthetic 1800² garments, cut in
# length only: 2 epochs of 2 steps, D3 from epoch 2
FLEET_MATERIALS = ("fleetA", "fleetB")
FLEET_TEMPLATE = f"synthetic://{{material}}?size={PADDED}"
FLEET_TRAIN = ["--data_len", "2", "--n_epochs", "2", "--n_epochs_decay", "0",
               "--vision_aided_warmup_epoch", "2"]
FLEET_LINE = re.compile(r"^\[fleet\] epoch (\d+)/(\d+) \(\d+s\)((?: \S+:\S+)+)$", re.M)
FLEET_SMALL = "synthetic://{material}?size=320&center_w=192&center_h=128&patches=6&val_patches=3"


def garment_states(model):
    """Every tensor a garment's step moves, cloned: its networks' state dicts
    (parameters and running statistics) and Adam moments."""
    out = {}
    for name, net in model.nets().items():
        out.update({f"{name}.{k}": v.detach().clone() for k, v in net.state_dict().items()})
        for m in ("mu", "nu"):
            out.update({f"{name}.{m}.{k}": v.clone()
                        for k, v in getattr(model.adam[name], m).items()})
    return out


def garment_fleet(tmp, dirs, run_test, smi):
    """Phase 4j: (a) ``vts_torch.launch ours launch`` (the default mode, the
    fleet) on two 1800² garments at the full-width training defaults, each
    garment's ``latest`` G through ``vts_torch.test --epoch latest``; (b) one
    D3-active fleet step of the two against each garment's single step from
    the same weights, batch and draws, under cuDNN's deterministic
    algorithms: bit for bit, garment 0 unmoved by garment 1's batch, the
    kernels launched 2 × ``PER_STEP`` times, one copy of the frozen towers;
    (c) the 20 ``DEFAULT_MATERIALS`` at full width, one step each (before
    D3): peak memory and step walls against one garment's; (d) a 256²
    two-garment fleet step on cuda against cpu (phase 4's rule); (e) a
    ``pack=2`` ngf-10 generator at 1536² against each garment's ``pack=1``
    forward.  What phase 5 and the records need of it."""
    import concurrent.futures
    import functools

    import vts_torch.models.sinskit as sinskit
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.launch import DEFAULT_MATERIALS
    from vts_torch.models import create_model
    from vts_torch.networks.unet_custom import CustomUNet
    from vts_torch.parallel.fleet import FleetTrainer, stack_states
    from vts_torch.parallel.packing import pack_images, pack_tree, unpack_images

    out = {}
    ck, res = os.path.join(tmp, "fleet_ckpt"), os.path.join(tmp, "fleet_res")
    # (a) the launcher's default mode, then the test driver on each garment
    log = os.path.join(tmp, "fleet_launch.log")
    out["launch_s"] = launcher(["ours", "launch", "--materials", ",".join(FLEET_MATERIALS),
                                "--dataroot-template", FLEET_TEMPLATE, "--checkpoints_dir", ck,
                                "--results_dir", res, "--", *FLEET_TRAIN], log, "cuda", 1)
    with open(log) as f:
        text = f.read()
    for ln in text.splitlines():
        if ln.startswith("[fleet]"):
            print(ln)
    lines = FLEET_LINE.findall(text)
    losses = {int(ep): {k: float(v) for k, v in (kv.split(":") for kv in body.split())}
              for ep, _, body in lines}
    check(sorted(losses) == [1, 2] and "[fleet] 2 garments over 1 devices" in text
          and "[fleet] trained 2 garments in " in text, f"the fleet's lines: {lines}")
    check(all(math.isfinite(v) for ep in losses.values() for v in ep.values())
          and {"G_D3", "D3_loss"} <= set(losses[2]) and "G_D3" not in losses[1]
          and len(losses[2]) >= 15, f"the fleet's losses: {losses}")
    for m in FLEET_MATERIALS:
        gd = os.path.join(ck, f"{m}_sinskitG_baseline_ours")
        missing = [f for f in (f"latest_{kind}_{net}.msgpack" for net in ("G", "D", "D2")
                               for kind in ("net", "opt")) if not os.path.exists(
                                   os.path.join(gd, f))]
        check(not missing, f"the fleet wrote no {missing} for {m}")
        tm = run_test(["--model", "sinskit", "--epoch", "latest",
                       "--name", f"{m}_sinskitG_baseline_ours",
                       "--dataroot", FLEET_TEMPLATE.format(material=m), "--device", "cuda",
                       "--batch_size_G2", str(K_PATCH), "--checkpoints_dir", ck,
                       "--results_dir", res])[0]
        check(len(tm) == 8 and all(math.isfinite(v) for v in tm.values()),
              f"the fleet's {m} G does not evaluate: {tm}")
        print(f"[fleet] {m}'s latest G through vts_torch.test: "
              + " ".join(f"{k}={v:.6g}" for k, v in sorted(tm.items())))

    # (b) one D3-active fleet step against the single steps, at full width
    full = ["--model", "sinskit", "--name", "fleet_full", "--device", "cuda", "--data_len", "1",
            "--vision_aided_warmup_epoch", "1", "--no_html"] + dirs

    def opt_for(m, *extra):
        return TrainOptions().parse(full + ["--dataroot", FLEET_TEMPLATE.format(material=m),
                                            *extra], quiet=True)

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    real_clip, real_d3 = sinskit.init_clip_params, sinskit.d3_logits
    # the seeded CLIP tower's numpy draws once for the phase's several models
    sinskit.init_clip_params = functools.lru_cache(real_clip)
    towers = {"lpips": [], "clip": []}

    def first_ptr(module):
        return next(iter(module.state_dict().values())).data_ptr()

    def d3_spy(clip, heads, images):
        towers["clip"].append(first_ptr(clip))
        return real_d3(clip, heads, images)
    try:
        batches = [next(iter(create_dataset(opt_for(m)))) for m in FLEET_MATERIALS]
        trainer = FleetTrainer(create_model(opt_for(FLEET_MATERIALS[0])), 2)
        trainer.init_states()
        hook = trainer.model.lpips_net.register_forward_pre_hook(
            lambda mod, args: towers["lpips"].append(first_ptr(mod)))
        sinskit.d3_logits = d3_spy
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer.step(batches, 1)
        torch.cuda.synchronize()
        out["pair_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = read_counts()
        sinskit.d3_logits = real_d3
        hook.remove()
        fleet = []
        for g in range(2):
            trainer.select(g)
            fleet.append((dict(trainer.model._losses), garment_states(trainer.model)))
        want = {k: 2 * v for k, v in PER_STEP.items()}
        print(f"[fleet] a D3-active full-width fleet step of 2 garments: {out['pair_ms']:.1f} ms "
              f"(the first); launches {out['launches']} (2 x PER_STEP = {want}); LPIPS weights "
              f"at {sorted(set(towers['lpips']))} in {len(towers['lpips'])} calls, CLIP at "
              f"{sorted(set(towers['clip']))} in {len(towers['clip'])} calls")
        check(out["launches"] == want, f"a 2-garment fleet step launched {out['launches']}, "
                                       f"not {want}")
        check(len(set(towers["lpips"])) == 1 and len(set(towers["clip"])) == 1
              and len(towers["lpips"]) >= 4 and len(towers["clip"]) >= 4,
              f"the frozen towers are not one copy across the garments: {towers}")
        del trainer
        varied = []
        for g in range(2):
            single = create_model(opt_for(FLEET_MATERIALS[g], "--seed", str(g)))
            single.setup()
            single.set_input(batches[g])
            single.optimize_parameters(1)
            lf, sf = fleet[g]
            same_l = all(torch.equal(torch.as_tensor(lf[k]), torch.as_tensor(v))
                         for k, v in single._losses.items()) and lf.keys() == single._losses.keys()
            ss = garment_states(single)
            diff = [k for k in ss if not torch.equal(ss[k], sf[k])]
            print(f"[fleet] garment {g}: the fleet step against its single step (--seed {g}, "
                  f"same batch, same draws): losses bit-identical {same_l}; {len(ss) - len(diff)} "
                  f"of {len(ss)} parameter, statistic and Adam tensors bit-identical"
                  + (f"; differing: {diff[:8]}" if diff else ""))
            if not (same_l and not diff):
                varied.append(g)
            del single
        check(not varied, f"the fleet step differs from the single steps for garments {varied}")
        # phase 4m holds the fleet over ranks to these, the single steps' bits
        out["batches"] = batches
        out["steps"] = [({k: torch.as_tensor(v).cpu() for k, v in lf.items()},
                         {k: v.cpu() for k, v in sf.items()}) for lf, sf in fleet]
        b1x = {k: v + 0.25 if k in ("S", "I") else v for k, v in batches[1].items()}
        trainer = FleetTrainer(create_model(opt_for(FLEET_MATERIALS[0])), 2)
        trainer.init_states()
        trainer.step([batches[0], b1x], 1)
        trainer.select(0)
        s0 = garment_states(trainer.model)
        same = all(torch.equal(s0[k], fleet[0][1][k]) for k in s0) and all(
            torch.equal(torch.as_tensor(trainer.losses[0][k]), torch.as_tensor(v))
            for k, v in fleet[0][0].items())
        moved = float(trainer.losses[1]["G_L1"]) != float(fleet[1][0]["G_L1"])
        print(f"[fleet] garment 1's sketch and image shifted by 0.25: garment 0's update "
              f"bit-identical {same} (garment 1's G_L1 moved: {moved})")
        check(same and moved, "garment 0's update depends on garment 1's batch")
        del trainer, fleet

        # (c) the 20 garments, one step each before D3, timed with cuDNN's
        # own choice of algorithms, as a training run makes it
        torch.backends.cudnn.deterministic = cudnn_det
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()      # what the script held before the fleet
        t0 = time.time()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:   # numpy and PIL release the GIL
            b20 = list(pool.map(lambda m: next(iter(create_dataset(opt_for(m)))),
                                DEFAULT_MATERIALS))
        out["data20_s"] = time.time() - t0
        trainer = FleetTrainer(create_model(opt_for(DEFAULT_MATERIALS[0],
                                                    "--vision_aided_warmup_epoch", "100")),
                               len(DEFAULT_MATERIALS))
        t0 = time.time()
        trainer.init_states()
        out["init20_s"] = time.time() - t0
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        slot_bytes = sum(t.numel() * t.element_size() for net in trainer.slots[0].nets.values()
                         for t in net.state_dict().values()) + sum(
            t.numel() * t.element_size() for a in trainer.slots[0].adam.values()
            for t in (*a.mu.values(), *a.nu.values()))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        l20 = trainer.step(b20, 1)
        torch.cuda.synchronize()
        out["fleet20_ms"] = (time.perf_counter() - t0) * 1e3
        out["peak20"] = torch.cuda.max_memory_allocated()
        finite = all(math.isfinite(float(v)) for ls in l20 for v in ls.values())
        check(finite and all("G_D3" not in ls for ls in l20),
              "a loss of the 20-garment fleet step is not finite (or D3 ran)")
        torch.cuda.reset_peak_memory_stats()
        model, walls = trainer.model, []
        trainer.select(0)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.set_input(b20[0])
            model.optimize_parameters(1)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["peak1"] = torch.cuda.max_memory_allocated()
        out["single_ms"] = statistics.median(walls)
        out["resident"], out["slot_bytes"], out["held"] = resident, slot_bytes, held
        gib = 2 ** 30
        print(f"[time fleet] {smi}: 20 garments ({DEFAULT_MATERIALS[0]} .. "
              f"{DEFAULT_MATERIALS[-1]}) at {CANVAS}², one step each before D3: "
              f"{out['fleet20_ms']:.1f} ms, {out['fleet20_ms'] / 20:.1f} ms a garment; one "
              f"garment's step alone on the same model: {out['single_ms']:.1f} ms (median of 3: "
              f"{', '.join(f'{w:.1f}' for w in walls)}); over the {held / gib:.2f} GiB the "
              f"script held before the fleet: peak memory of the fleet step "
              f"{(out['peak20'] - held) / gib:.2f} GiB, of one garment's step "
              f"{(out['peak1'] - held) / gib:.2f} GiB, resident before the step "
              f"{(resident - held) / gib:.2f} GiB (the towers and 20 garments' states, "
              f"{slot_bytes / 2 ** 20:.2f} MiB each); data for 20 garments "
              f"{out['data20_s']:.1f} s, their set-up {out['init20_s']:.1f} s")
        check(out["peak20"] <= out["peak1"] + gib,
              f"the 20-garment fleet's peak {out['peak20']} is not one step's "
              f"{out['peak1']}")
        del trainer, model, b20, l20
        torch.cuda.empty_cache()

        # (d) a 256² two-garment fleet step, cuda against cpu
        torch.backends.cudnn.deterministic = True
        small = ["--model", "sinskit", "--name", "fleet_small", "--crop_size", "256",
                 "--center_w", "192", "--center_h", "128", "--ngf", "4", "--ndf", "4",
                 "--batch_size_G2", "6", "--batch_size_G2_val", "4",
                 "--add_fake_T_sample_size", "4", "--data_len", "1", "--init_gain", "0.5",
                 "--use_vision_aided_loss", "false", "--no_html"] + dirs
        sb = [next(iter(create_dataset(TrainOptions().parse(
            small + ["--dataroot", FLEET_SMALL.format(material=m), "--device", "cpu"],
            quiet=True)))) for m in FLEET_MATERIALS]
        pair = {}
        for key in ("cpu", "cuda"):
            pair[key] = FleetTrainer(create_model(TrainOptions().parse(
                small + ["--dataroot", FLEET_SMALL.format(material="fleetA"), "--device", key],
                quiet=True)), 2)
            pair[key].init_states()
            pair[key].step(sb, 1)
        for g in range(2):
            for tr in pair.values():
                tr.select(g)
            # how far G's gradient moves on the cpu when every weight moves by
            # ~1e-6 of itself (three random directions): a step whose G
            # gradient jumps there (a max-pool or ReLU near-tie flipping) is
            # held in the 2-norm to that jump, as SPADE's VGG-on step is
            ref = {k: v.clone() for k, v in pair["cpu"].model.adam["G"].mu.items()}
            jumps = []
            for d in range(3):
                m = create_model(TrainOptions().parse(
                    small + ["--dataroot", FLEET_SMALL.format(material="fleetA"),
                             "--device", "cpu", "--seed", str(g)], quiet=True))
                m.setup()
                gen = torch.Generator().manual_seed(100 + d)
                with torch.no_grad():
                    for net in m.nets().values():
                        for prm in net.parameters():
                            prm.mul_(1 + 1e-6 * torch.randn(prm.shape, generator=gen))
                m.set_input(sb[g])
                m.optimize_parameters(1)
                jumps.append(rel_norm(m.adam["G"].mu, ref, ref))
                del m
            jump = max(jumps)
            print(f"[fleet] 256² garment {g}: on the cpu, weights moved by 1e-6 of themselves "
                  f"move G's gradient by {', '.join(f'{j:.2e}' for j in jumps)} in the 2-norm"
                  + ("; G held to the largest, in the 2-norm" if jump > 1e-5 else
                     "; phase 4's rule"))
            compare_steps(f"256² fleet step, garment {g}", pair["cpu"].model, pair["cuda"].model,
                          g_norm=jump if jump > 1e-5 else None)
        del pair
    finally:
        sinskit.init_clip_params, sinskit.d3_logits = real_clip, real_d3
        torch.backends.cudnn.deterministic = cudnn_det

    # (e) the packed generator: two garments' seeded ngf-10 G on grouped convs
    in_nc = 1 + 2 * 4                      # the sketch and its positional encoding
    nets = []
    for g in range(2):
        net = CustomUNet(in_nc, ngf=NGF)
        net.reset_parameters(torch.Generator().manual_seed(g))
        nets.append(net.cuda().eval())
    packed = CustomUNet(in_nc, ngf=NGF, pack=2).cuda().eval()
    packed.load_state_dict(pack_tree(stack_states([n.state_dict() for n in nets])))
    gdev = torch.Generator(device="cuda").manual_seed(4)
    xs = [torch.rand(1, CANVAS, CANVAS, in_nc, generator=gdev, device="cuda") * 2 - 1
          for _ in range(2)]
    with torch.no_grad():
        got = unpack_images(packed(pack_images(xs)), 2)
        refs = [torch.cat(n(x), -1) for n, x in zip(nets, xs)]
        out["packed_ms"] = cuda_ms(lambda: packed(pack_images(xs)), reps=5, warmup=1)
        out["unpacked_ms"] = cuda_ms(lambda: [n(x) for n, x in zip(nets, xs)], reps=5, warmup=1)
    errs = []
    for g in range(2):
        tol = 1e-4 * refs[g].abs().max().item() + 1e-5
        errs.append(((got[g] - refs[g]).abs().max().item(), tol))
    print(f"[fleet] pack=2 ngf-{NGF} generator at {CANVAS}² on cuda against each garment's "
          f"pack=1 forward: max|d| {', '.join(f'{e:.3e} (tol {t:.3e})' for e, t in errs)}; "
          f"forward {out['packed_ms']:.2f} ms packed, {out['unpacked_ms']:.2f} ms for the two "
          f"pack=1 nets ({smi})")
    check(all(e <= t for e, t in errs), "the packed generator disagrees with the per-garment ones")
    del nets, packed, xs, got, refs
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ 4k ---
# the rest of the network zoo: (a) sinskit with the plain U-Net and the
# StyleGAN2 D and D2 at the shipped defaults (1536², ngf 10 / ndf 8, batch 1,
# the full-canvas LPIPS), 3 steps of one epoch before D3, then its latest G
# through the test driver; (b) pix2pix at its defaults (32² patches, ngf 64,
# batch 32) with the VisGel G, MUNIT's resnet_cat, and the StyleGAN2 G at
# --crop_size 1024 (the largest crop its width table takes), one epoch (two
# steps) and its latest G on one test sample (the StyleGAN2 G on a garment
# whose center fits its crop); (c) each new network on cuda
# against cpu at a small size from the same weights
ZOO_DATA = f"synthetic://smoke?size={PADDED}"
# a repeated-letter DiffAugment policy rides on this run: each position draws
# its own numbers (diffaug_replay checks them against a cpu replay)
ZOO_POLICY = "btbt"
ZOO_TRAIN = ["--model", "sinskit", "--name", "zoo", "--netG", "unet_256", "--netD", "stylegan2",
             "--netD2", "stylegan2", "--dataroot", ZOO_DATA, "--device", "cuda", "--data_len", "3",
             "--n_epochs", "1", "--n_epochs_decay", "0", "--no_html",
             "--diffaugment", ZOO_POLICY]
ZOO_TEST = ["--model", "sinskit", "--name", "zoo", "--netG", "unet_256", "--epoch", "latest",
            "--dataroot", ZOO_DATA, "--device", "cuda", "--batch_size_G2", str(K_PATCH)]
# the StyleGAN2 G's garment fits its 1024² crop: a 1024 × 768 center (the
# crop must cover the center region, and the patches lie inside it)
SG2_DATA = f"synthetic://zoo1024?size={PADDED}&center_w=1024&center_h=768"
ZOO_P2P = {"visgel": ["--dataroot", P2P_DATA], "resnet_cat": ["--dataroot", P2P_DATA],
           "stylegan2": ["--dataroot", SG2_DATA, "--crop_size", "1024", "--center_w", "1024",
                         "--center_h", "768"]}
# K1 at a 1024² pix2pix test sample: the canvas LPIPS at 1024², the patch
# LPIPS as at 1536² (K = 64 224² patches, gx and gy)
SG2_CANVAS = 1024
K1_SG2 = [(2, SG2_CANVAS, SG2_CANVAS, 64, 64, 1), (2, SG2_CANVAS // 2, SG2_CANVAS // 2, 64, 128, 1),
          (2, SG2_CANVAS // 2, SG2_CANVAS // 2, 128, 128, 1)] + K1_P2P[3:]


def zoo_step_walls(model, label, want=None):
    """Seven steps on the model's current input: the launches of the third
    and K1's and K2's shapes there, the median wall of the last five and
    their peak memory over what the script held before each.  ``want``: the
    launches a step must make."""
    walls, peaks = [], []
    for i in range(7):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        if i == 2:
            reset_counts()
            rec = RecordShapes().__enter__()
        t0 = time.perf_counter()
        model.optimize_parameters(1)
        model.get_current_losses()
        torch.cuda.synchronize()
        if i == 2:
            rec.__exit__()
            launches, shapes = read_counts(), rec.shapes()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
            peaks.append((torch.cuda.max_memory_allocated() - held) / 2 ** 30)
    wall = statistics.median(walls)
    print(f"[time zoo step] {label}: {wall:.1f} ms wall, median of {len(walls)} "
          f"({', '.join(f'{w:.1f}' for w in walls)}); peak memory {max(peaks):.2f} GiB over "
          f"the {held / 2 ** 30:.2f} GiB held before the step; launches per step {launches}")
    if want is not None:
        check(launches == want, f"{label}: a step launched {launches}, not {want}")
    return dict(wall_ms=wall, peak_gib=max(peaks), launches=launches, shapes=shapes)


def zoo_sample_walls(argv, label):
    """One test sample of the latest G (set_input, G forward, the 8 metrics):
    its launches (the second pass), the median wall of three after one, the
    G forward's; the model and its input."""
    from vts_torch.config import TestOptions
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model
    topt = TestOptions().parse(argv, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.load_networks("latest")
    walls, g_ms = [], []
    for i in range(4):
        torch.cuda.synchronize()
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        model.set_input(batch)
        model.test()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.compute_metrics()
        torch.cuda.synchronize()
        if i == 1:
            launches = read_counts()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
            g_ms.append((t1 - t0) * 1e3)
    print(f"[time zoo sample] {label}: {statistics.median(walls):.1f} ms wall (set_input and G "
          f"forward {statistics.median(g_ms):.1f} ms), median of {len(walls)}; launches "
          f"{launches}")
    check(launches == PER_SAMPLE, f"{label}: a test sample launched {launches}, not {PER_SAMPLE}")
    return model, dict(wall_ms=statistics.median(walls), g_ms=statistics.median(g_ms),
                       launches=launches)


def zoo_nets():
    """(label, build function, input shapes) of each new network at a small
    size."""
    from vts_torch.networks.munit import GResnet
    from vts_torch.networks.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
    from vts_torch.networks.unet_plain import UnetGenerator
    from vts_torch.networks.visgel import VisGelGenerator
    return [
        # ngf 4: at ngf 8 this seeded unet_256's fp32 gradient is
        # ill-conditioned on any device (on the cpu alone, weights moved by
        # 1e-6 of themselves move its input gradient by 1.5%)
        ("unet_256 (batch norm)", lambda: UnetGenerator(3, ngf=4, out_nc=5, num_downs=8,
                                                        init_gain=0.5), [(2, 256, 256, 3)]),
        ("unet_128 (batch norm)", lambda: UnetGenerator(3, ngf=8, out_nc=5, num_downs=7,
                                                        init_gain=0.5), [(2, 128, 128, 3)]),
        ("visgel x1", lambda: VisGelGenerator(1, out_nc=5, t_resolution_multiplier=1),
         [(4, 32, 32, 1)]),
        ("visgel x2", lambda: VisGelGenerator(1, out_nc=5, t_resolution_multiplier=2),
         [(4, 32, 32, 1)]),
        ("resnet_cat", lambda: GResnet(3, ngf=8, out_nc=5, init_gain=0.5), [(2, 64, 64, 3)]),
        ("resnet_cat with a width-0 z", lambda: GResnet(3, ngf=8, out_nc=5, init_gain=0.5),
         [(2, 64, 64, 3), (2, 0)]),
        ("stylegan2 G (noise injected)", lambda: StyleGAN2Generator(3, ngf=8, out_nc=5,
                                                                    crop_size=64),
         [(2, 64, 64, 3)]),
        ("smallstylegan2 G", lambda: StyleGAN2Generator(3, ngf=8, out_nc=5, n_blocks=2,
                                                        crop_size=64), [(2, 64, 64, 3)]),
        ("stylegan2 D", lambda: StyleGAN2Discriminator(7, ndf=8, input_size=(32, 32)),
         [(8, 32, 32, 7)]),
        ("tilestylegan2 D", lambda: StyleGAN2Discriminator(4, ndf=8, tile=True, crop_size=64,
                                                           input_size=(64, 64)),
         [(2, 64, 64, 4)]),
    ]


def zoo_grads(net, ins, device):
    """Forward, input gradient and parameter gradients of ``net`` on
    ``ins`` (a random cotangent, seed 3) and its running statistics, on the
    host."""
    xs = [t.to(device).requires_grad_(i == 0) for i, t in enumerate(ins)]
    out = net(*xs)
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(device)
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(out, [xs[0]] + list(net.parameters()), ct)
    return (out.detach().cpu(), grads[0].cpu(), {k: g.cpu() for k, g in zip(names, grads[1:])},
            {k: v.cpu() for k, v in net.state_dict().items() if k.endswith((".mean", ".var"))})


def zoo_cuda_vs_cpu():
    """Each new network's forward, input gradient and parameter gradients (a
    random cotangent) and running statistics on cuda against cpu, from the
    same seeded weights and inputs, under phase 4's rule: the forward and the
    input gradient within 1e-4 of their max, each parameter leaf within 1e-4
    of its max (a round-off leaf, a conv bias that an instance norm follows,
    within 1e-5 of the network's max), or else, as phase 4's x2 and skitG
    steps are held, the parameters within 1e-4 in the 2-norm over the
    network; the running statistics within 1e-5.  Where the net's fp32
    gradient is ill-conditioned (a ReLU or leaky ReLU input near 0 flips its
    slope; VisGel's 15 instance norms over shrinking maps), each of the
    three limits is raised to twice the largest jump that moving the weights
    by 1e-6 of themselves makes on the cpu (five draws; phase 4j holds the
    fleet's G to one such jump: twice, because five draws sample the flips
    that the card's other rounding makes, and its StyleGAN2 G read 1.08×
    the largest of them in the 2-norm).  The jumps are drawn only for a net
    that a plain limit fails."""
    import copy
    worst = {}
    for label, build, shapes in zoo_nets():
        net = build()
        net.reset_parameters(torch.Generator().manual_seed(len(label)))
        gen = torch.Generator().manual_seed(7)
        ins = [torch.rand(s, generator=gen) * 2 - 1 for s in shapes]
        if hasattr(net, "styled_convs"):
            with torch.no_grad():
                for m in net.styled_convs():
                    if m.noise_strength is not None:
                        m.noise_strength.fill_(0.3)
                        m.noise[(2, 64, 64)] = torch.randn((2, 64, 64, 1), generator=gen)
        on_card = copy.deepcopy(net).cuda().train()
        o_c, x_c, g_c, s_c = zoo_grads(net.train(), ins, "cpu")
        o_g, x_g, g_g, s_g = zoo_grads(on_card, ins, "cuda")
        f_err = (o_g - o_c).abs().max().item() / o_c.abs().max().item()
        x_err = (x_g - x_c).abs().max().item() / x_c.abs().max().item()
        net_max = max(v.abs().max().item() for v in g_c.values())

        def tol(v):
            leaf = v.abs().max().item()
            return 1e-5 * net_max if leaf <= 1e-5 * net_max else 1e-4 * leaf
        ratio = {k: (g_g[k] - v).abs().max().item() / tol(v) for k, v in g_c.items()}
        k_worst = max(ratio, key=ratio.get)
        norm = rel_norm(g_g, g_c, g_c)
        s_err = max([(s_g[k] - v).abs().max().item() for k, v in s_c.items()] or [0.0])
        per_leaf = ratio[k_worst] <= 1.0
        # the jumps only raise the limits: drawn where a plain limit fails
        jump = [0.0, 0.0, 0.0]
        if f_err > 1e-4 or x_err > 1e-4 or not (per_leaf or norm <= 1e-4):
            jumps = []
            for _ in range(5):
                moved = copy.deepcopy(net)
                with torch.no_grad():
                    for p in moved.parameters():
                        p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
                o_m, x_m, g_m, _ = zoo_grads(moved, ins, "cpu")
                jumps.append(((o_m - o_c).abs().max().item() / o_c.abs().max().item(),
                              (x_m - x_c).abs().max().item() / x_c.abs().max().item(),
                              rel_norm(g_m, g_c, g_c)))
            jump = [max(j[i] for j in jumps) for i in range(3)]
        print(f"[zoo ref] {label}, cuda vs cpu: forward max|d|/max|ref| {f_err:.2e}, input "
              f"gradient {x_err:.2e}, worst parameter leaf |d|/tolerance {ratio[k_worst]:.2e} "
              f"at {k_worst}, |d|/|g| over the network {norm:.2e}, running statistics max|d| "
              f"{s_err:.2e} ({len(s_c)} buffers); a 1e-6 move of the weights on the cpu (0: "
              f"not drawn, the plain limits hold): forward {jump[0]:.2e}, input gradient "
              f"{jump[1]:.2e}, parameters {jump[2]:.2e}; "
              + ("the per-leaf rule holds" if per_leaf else
                 f"held in the 2-norm to {max(1e-4, 2 * jump[2]):.2e}"))
        ok = (f_err <= max(1e-4, 2 * jump[0]) and x_err <= max(1e-4, 2 * jump[1])
              and (per_leaf or norm <= max(1e-4, 2 * jump[2])))
        check(ok and s_err <= 1e-5, f"{label} on cuda disagrees with cpu")
        worst[label] = dict(forward=f_err, input_grad=x_err, param_norm=norm, jump=jump)
    return worst


def zoo_phase(tmp, dirs, run_train, run_test, train_shapes, p2p_shapes):
    """Phase 4k (see above); what phase 5 needs of it."""
    from vts_torch.networks.stylegan2 import StyleGAN2Discriminator
    from vts_torch.networks.unet_plain import UnetGenerator

    out = {}
    # (a) sinskit at full width with the zoo's U-Net and StyleGAN2 Ds
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    model = run_train(ZOO_TRAIN + dirs)
    torch.cuda.synchronize()
    run = read_counts()
    losses = model.get_current_losses()
    steps = model.adam["G"].count
    print(f"[zoo sinskit] {steps} steps of unet_256 + StyleGAN2 D and D2 at {CANVAS}² (ngf "
          f"{NGF}, ndf 8, batch 1, D3 off before its warmup) + a validation in "
          f"{time.time() - t0:.2f} s (first run, incl. data and model set-up); G "
          f"{sum(p.numel() for p in model.netG.parameters()) / 1e6:.3f} M, D "
          f"{sum(p.numel() for p in model.netD.parameters()) / 1e6:.3f} M, D2 "
          f"{sum(p.numel() for p in model.netD2.parameters()) / 1e6:.3f} M params; last "
          f"losses: " + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
    print(f"[zoo sinskit] launches during the training run: {run}")
    out["diffaug"] = diffaug_replay(model)
    check(isinstance(model.netG, UnetGenerator)
          and isinstance(model.netD, StyleGAN2Discriminator)
          and isinstance(model.netD2, StyleGAN2Discriminator), "phase 4k built other networks")
    check(steps == 3 and {"D_fake_I", "D_real_T_concat", "G_GAN", "G2_GAN", "G_lpips"}
          <= set(losses) and all(math.isfinite(v) for v in losses.values()),
          f"a zoo sinskit loss is missing or not finite ({steps} steps): {losses}")
    out["sinskit_step"] = zoo_step_walls(model, f"{CANVAS}² sinskit step, unet_256 + StyleGAN2 "
                                                f"D and D2 (D3 off)", PER_STEP)
    check(out["sinskit_step"]["shapes"] == train_shapes,
          f"the zoo sinskit step launched K1/K2 at {out['sinskit_step']['shapes']}, not at the "
          f"train row's {train_shapes}")
    print("[zoo sinskit] one step launches K1, K1 dx, K2 and K2 bwd as the train row counts "
          "them, K1 and K2 at its shapes: the train row stands for it")
    del model
    torch.cuda.empty_cache()
    reset_counts()
    metrics = run_test(ZOO_TEST + dirs)[0]
    print("[zoo sinskit test] latest G: " + " ".join(f"{k}={v:.6g}"
                                                    for k, v in sorted(metrics.items())))
    check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
          f"the zoo sinskit test: expected 8 finite metrics, got {metrics}")
    model, out["sinskit_sample"] = zoo_sample_walls(ZOO_TEST + dirs,
                                                    f"one {CANVAS}² sinskit test sample, unet_256")
    del model
    torch.cuda.empty_cache()

    # (b) pix2pix with the VisGel, resnet_cat and StyleGAN2 Gs
    out["p2p"] = {}
    for g, extra in ZOO_P2P.items():
        name = f"zoo_{g}"
        train = ["--model", "pix2pix", "--name", name, "--netG", g, "--device", "cuda",
                 "--n_epochs", "1", "--n_epochs_decay", "0", "--val_for_each_epoch", "false",
                 "--no_html"] + extra + dirs
        test = ["--model", "pix2pix", "--name", name, "--netG", g, "--epoch", "latest",
                "--device", "cuda"] + extra + dirs
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        model = run_train(train)
        torch.cuda.synchronize()
        run = read_counts()
        losses = model.get_current_losses()
        steps = model.adam["G"].count
        print(f"[zoo pix2pix {g}] {steps} steps of batch 32 in {time.time() - t0:.2f} s (first "
              f"run, incl. data and model set-up); G "
              f"{sum(p.numel() for p in model.netG.parameters()) / 1e6:.3f} M params; last "
              f"losses: " + " ".join(f"{k}={v:.6g}" for k, v in losses.items()))
        check(steps >= 1 and set(losses) == P2P_LOSSES
              and all(math.isfinite(v) for v in losses.values()),
              f"pix2pix {g}: a loss is missing or not finite ({steps} steps): {losses}")
        check(run == dict.fromkeys(KERNELS, 0),
              f"pix2pix {g}: its GAN + L1 training run launched {run}")
        res = {"step": zoo_step_walls(model, f"32² pix2pix step, {g} G (batch 32, ngf 64)",
                                      dict.fromkeys(KERNELS, 0))}
        del model
        torch.cuda.empty_cache()
        reset_counts()
        with Gallery() as gallery, RecordShapes() as shapes:
            metrics = run_test(test)[0]
        torch.cuda.synchronize()
        res["run_launches"] = read_counts()
        res["sample_launches"] = {k: v - gallery.launches[k]
                                  for k, v in res["run_launches"].items()}
        print(f"[zoo pix2pix {g} test] " + " ".join(f"{k}={v:.6g}"
                                                    for k, v in sorted(metrics.items())))
        check(len(metrics) == 8 and all(math.isfinite(v) for v in metrics.values()),
              f"pix2pix {g} test: expected 8 finite metrics, got {metrics}")
        check(res["sample_launches"] == PER_SAMPLE,
              f"a pix2pix {g} test sample launched {res['sample_launches']}, not {PER_SAMPLE}")
        side = SG2_CANVAS if g == "stylegan2" else CANVAS
        model, res["sample"] = zoo_sample_walls(test, f"one {side}² pix2pix test sample, {g} G")
        if side == CANVAS:
            check(shapes.shapes() == p2p_shapes,
                  f"a pix2pix {g} test sample launched K1/K2 at {shapes.shapes()}, not at the "
                  f"eval_pix2pix row's")
            print(f"[zoo pix2pix {g} test] K1 and K2 at the eval_pix2pix row's shapes")
        else:
            want = sorted(tuple(r[:5]) for r in K1_SG2 for _ in range(r[5]))
            check(shapes.shapes()[0] == want,
                  f"a {side}² pix2pix test sample launched K1 at {shapes.shapes()[0]}")
            out["sg2_k1_rows"] = k1_eval_rows(K1_SG2, "stylegan2", seed=16)
            out["sg2_k2"] = (model._outputs["fake_T"][:1].contiguous(),
                             model._input["T_coords"].reshape(1, -1, 8).contiguous())
            check(tuple(out["sg2_k2"][0].shape) == (1, side, side, 2),
                  f"the {side}² sample's fake_T is {tuple(out['sg2_k2'][0].shape)}")
            out["sg2_sample_launches"] = res["sample_launches"]
            out["sg2_run_launches"] = res["run_launches"]
        out["p2p"][g] = res
        del model
        torch.cuda.empty_cache()

    # (c) each new network on cuda against cpu
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out["nets"] = zoo_cuda_vs_cpu()
    torch.backends.cudnn.deterministic = cudnn_det
    return out


def diffaug_replay(model):
    """The zoo run's repeated-letter policy (``ZOO_POLICY``): the draws of
    its next step, taken on the card model, against a cpu replay from the
    same generator state (``SinSKITModel.draw`` on a stand-in with a copy of
    the generator): every position's numbers equal, the repeated letters'
    two positions different, and that step's augmentation of the real
    canvas on the card the cpu's bit for bit."""
    import types

    from vts_torch.models.sinskit import SinSKITModel
    from vts_torch.ops import diffaug
    policy = model.opt.diffaugment
    check(policy == ZOO_POLICY, f"the zoo run trained with --diffaugment {policy!r}")
    size = tuple(model._input["I"].shape[1:3])
    gen = torch.Generator()
    gen.set_state(model.generator.get_state())
    replay = types.SimpleNamespace(opt=model.opt, generator=gen,
                                   _crop_active=model._crop_active)
    want = SinSKITModel.draw(replay, 1, size)
    got = model.draw(1, size)
    for side in ("aug_real", "aug_fake"):
        check(len(got[side]) == len(want[side]) == len(policy)
              and all(torch.equal(a, b) for a, b in zip(got[side], want[side])),
              f"{side}: the card model's per-position draws differ from the cpu replay")
        for i, letter in enumerate(policy):
            j = policy.index(letter)
            check(j == i or not torch.equal(got[side][i], got[side][j]),
                  f"{side}: positions {j} and {i} ({letter!r}) drew the same numbers")
    t0 = time.time()
    real = model._input["I"]
    on_card = diffaug.diff_augment(real, policy, draws=got["aug_real"])
    torch.cuda.synchronize()
    on_cpu = diffaug.diff_augment(real.cpu(), policy, draws=want["aug_real"])
    same = torch.equal(on_card.cpu(), on_cpu)
    print(f"[zoo diffaug] --diffaugment {policy} at {size[0]}²: the next step's draws on the card "
          f"equal a cpu replay at every position ({', '.join(policy)}; each repeated letter's "
          f"two positions differ: b {got['aug_real'][0].tolist()} and "
          f"{got['aug_real'][2].tolist()}, t {got['aug_real'][1].tolist()} and "
          f"{got['aug_real'][3].tolist()}); the augmented real canvas on the card equals the "
          f"cpu's bit for bit: {same} ({time.time() - t0:.2f} s)")
    check(same, "the repeated-letter augmentation on the card differs from the cpu's")
    model.optimize_parameters(1, draws=got)
    return {"policy": policy, "same": same}


def bf16_trio(label, argv, batch, n, size=None):
    """One bf16 step on cuda and on cpu from the same weights, batch and
    draws, the cpu fp32 step as the reference (phase 4b's rule): per loss
    |cuda16 − cpu16| ≤ 2·|cpu16 − cpu32| + 1e-3·|cpu32|, per network
    ‖cuda16 − cpu16‖/‖cpu32‖ ≤ 2·‖cpu16 − cpu32‖/‖cpu32‖ + 1e-3 over the
    gradient (Adam's first moment).  ``batch``: the batch, or None for the
    options' dataset's first."""
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model
    trio = {}
    for key, dt, device in (("cpu32", "float32", "cpu"), ("cpu16", "bfloat16", "cpu"),
                            ("cuda16", "bfloat16", "cuda")):
        o = TrainOptions().parse(argv + ["--dtype", dt, "--device", device], quiet=True)
        trio[key] = create_model(o)
        trio[key].setup()
    batch = batch if batch is not None else next(iter(create_dataset(o)))
    draws = trio["cpu16"].draw(n, size) if size else trio["cpu16"].draw(n)
    for m in trio.values():
        m.set_input(batch)
        m.optimize_parameters(1, draws=draws)
    l32, l16, lg = (trio[k].get_current_losses() for k in ("cpu32", "cpu16", "cuda16"))
    worst = 0.0
    for k in l32:
        gap = abs(l16[k] - l32[k])
        worst = max(worst, abs(lg[k] - l16[k]) / (2 * gap + 1e-3 * abs(l32[k]) + 1e-30))
        check(abs(lg[k] - l16[k]) <= 2 * gap + 1e-3 * abs(l32[k]),
              f"{label}: loss {k} on cuda {lg[k]} vs cpu {l16[k]} (fp32 {l32[k]})")
    print(f"[bf16 ref] {label}, cuda vs cpu: worst loss |cuda16 - cpu16| / (2·|cpu16 - cpu32| "
          f"+ 1e-3·|cpu32|) {worst:.3f}")
    out = {"loss": worst}
    for net in trio["cpu32"].adam:
        mu32, mu16, mug = (trio[k].adam[net].mu for k in ("cpu32", "cpu16", "cuda16"))
        d_dev, d_bf = rel_norm(mug, mu16, mu32), rel_norm(mu16, mu32, mu32)
        print(f"[bf16 ref] {label}, {net} grads: |cuda16 - cpu16|/|cpu32| {d_dev:.3e}, "
              f"|cpu16 - cpu32|/|cpu32| {d_bf:.3e}")
        check(d_dev <= 2 * d_bf + 1e-3, f"{label}: {net} gradient on cuda disagrees with cpu "
                                        f"beyond the bf16 bound")
        out[net] = (d_dev, d_bf)
    return out


class PlainK1:
    """Within it, the LPIPS VGG16 runs K1's plain version (and autograd's
    backward of it) in place of K1 and K1 dx: the plain path of the same code."""

    def __enter__(self):
        from vts_torch.losses import lpips as lpips_mod
        from vts_torch.ops import conv3x3 as k1
        self.mod, self.kernel = lpips_mod, lpips_mod.conv3x3_bias_relu
        lpips_mod.conv3x3_bias_relu = k1.conv3x3_bias_relu_plain
        return self

    def __exit__(self, *exc):
        self.mod.conv3x3_bias_relu = self.kernel
        return False


def cut_phase(tmp):
    """Phase 4l (see above): the CUT heads and the texture loss on the LPIPS
    VGG16 taps of the canvas, the normal-loss modes, the legacy datasets."""
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.losses.lpips import LPIPS, init_lpips_params
    from vts_torch.losses.normal import cosine_similarity, surface_normal_angle_error
    from vts_torch.networks import cut_heads
    import numpy as np
    from PIL import Image

    from vts_torch.ops.normal import compute_normal

    dev = torch.device("cuda")
    out = {}
    gen = torch.Generator().manual_seed(17)
    lp = LPIPS(init_lpips_params(0)).to(dev)
    fake0 = (torch.rand(1, CANVAS, CANVAS, 3, generator=gen) * 2 - 1).to(dev)
    real0 = (torch.rand(1, CANVAS, CANVAS, 3, generator=gen) * 2 - 1).to(dev)
    with torch.no_grad():
        real_taps = lp.vgg16_taps(real0)
    chans = [t.shape[-1] for t in real_taps]
    head = cut_heads.PatchSampleF(use_mlp=True, nc=256, num_patches=256, in_channels=chans,
                                  generator=torch.Generator().manual_seed(18)).to(dev)
    ids = [torch.randperm(t.shape[1] * t.shape[2], generator=gen)[:256].to(dev)
           for t in real_taps]
    params = list(head.parameters())

    def run(image=fake0):
        """PatchNCE (the MLP head on 256 locations of each tap, the real
        image's as keys) + the texture loss of the five taps, and the
        gradients to the image and the head."""
        fake = image.clone().requires_grad_(True)
        taps = lp.vgg16_taps(fake)
        q, _ = head(taps, patch_ids=ids)
        k, _ = head(real_taps, patch_ids=ids)
        nce = sum(torch.mean(cut_heads.patch_nce_loss(a, b)) for a, b in zip(q, k))
        tex = cut_heads.texture_loss(taps, real_taps)
        grads = torch.autograd.grad(nce + tex, [fake] + params)
        return nce.detach(), tex.detach(), grads

    torch.cuda.synchronize()
    reset_counts()
    nce, tex, grads = run()
    torch.cuda.synchronize()
    launches = read_counts()
    with PlainK1():
        nce_p, tex_p, grads_p = run()
        # the plain path's own jump under a 1e-6 relative move of the image
        nce_m, tex_m, grads_m = run(fake0 * (1 + 1e-6 * torch.randn(
            fake0.shape, generator=torch.Generator().manual_seed(19)).to(dev)))
        plain_ms = cuda_ms(run, reps=5, warmup=1)
    kernel_ms = cuda_ms(run, reps=5, warmup=1)

    def diffs(a, b):
        """(nce, texture, image gradient, head gradient): relative
        differences, the gradients' in the 2-norm."""
        head = math.sqrt(sum(((x - y).double() ** 2).sum().item()
                             for x, y in zip(a[2][1:], b[2][1:]))
                         / sum((y.double() ** 2).sum().item() for y in b[2][1:]))
        return (abs(a[0].item() - b[0].item()) / abs(b[0].item()),
                abs(a[1].item() - b[1].item()) / abs(b[1].item()),
                ((a[2][0] - b[2][0]).double().norm() / b[2][0].double().norm()).item(), head)
    got = diffs((nce, tex, grads), (nce_p, tex_p, grads_p))
    jump = diffs((nce_m, tex_m, grads_m), (nce_p, tex_p, grads_p))
    lim = [max(1e-4, 2 * j) for j in jump]
    names = ("PatchNCE", "texture loss", "image gradient", "head gradient")
    print(f"[cut] PatchNCE (PatchSampleF with its MLP, 256 locations of each of the 5 VGG16 "
          f"taps of a {CANVAS}² image, the real image's as keys) {nce.item():.6g}, texture loss "
          f"{tex.item():.6g}, backward to the image and the head: launches {launches}; against "
          f"the plain path on the card (relative; the gradients in the 2-norm; the plain path's "
          f"own move under a 1e-6 relative move of the image beside): "
          + ", ".join(f"{n} {g:.2e} (jump {j:.2e})" for n, g, j in zip(names, got, jump))
          + f"; forward + backward {kernel_ms:.2f} ms with K1 and K1 dx, {plain_ms:.2f} ms plain "
          f"(median of 5 after 1, CUDA events)")
    check(launches["conv3x3_bias_relu"] == 3 and launches["conv3x3_dx"] == 3
          and launches["gather_patches"] == launches["scatter_patches"] == 0,
          f"the CUT/texture pass launched {launches}, not K1 and K1 dx 3 times each")
    bad = [n for n, g, m in zip(names, got, lim) if g > m]
    check(not bad, f"with K1 the CUT/texture {bad} disagree with the plain path")
    out.update(cut_ms=kernel_ms, cut_plain_ms=plain_ms, cut_launches=launches, cut_err=got,
               cut_jump=jump)

    # the normal-loss modes on the card against the same code on the cpu, on
    # the normals of two random canvas-sized gx/gy maps: each value within 1e-5 of
    # itself (the angles also within what a cosine 2^-22 away moves them
    # by), the gradients within 1e-5 of their max plus, per pixel, what a
    # cosine 2^-22 away moves acos' slope by
    tg = [torch.rand(1, CANVAS, CANVAS, 2, generator=gen) * 2 - 1 for _ in range(2)]
    real_n, pred_n = (compute_normal(t, scale_nz=1.0) for t in tg[::-1])
    cos = cosine_similarity(pred_n, real_n).double()
    amp = cos.abs() * 2.0 ** -22 / (1 - cos * cos).clamp_min(1e-30)
    worst = {}
    BOUNDS = {"train_L2_loss": (), "train_AL_loss": (-0.999, 0.999),
              "train_TAL_loss": (0.0, 0.9999)}
    for mode in ("evaluate", "train_L2_loss", "train_AL_loss", "train_TAL_loss"):
        res = {}
        for device in ("cpu", "cuda"):
            p = tg[0].to(device).requires_grad_(True)
            r = compute_normal(tg[1].to(device), scale_nz=1.0)
            val = surface_normal_angle_error(r, compute_normal(p, scale_nz=1.0), mode)
            g = torch.autograd.grad(val, p)[0] if mode != "evaluate" else None
            res[device] = (val.detach().cpu().double(), None if g is None else g.cpu().double())
        (v_c, g_c), (v_g, g_g) = res["cpu"], res["cuda"]
        if mode == "evaluate":
            # degrees; acos moves by 2^-22/sin(angle) for a cosine 2^-22 away
            lim = 1e-5 * v_c.abs() + 1e-6 + torch.rad2deg(
                2.0 ** -22 / torch.sin(torch.deg2rad(v_c)).clamp_min(1e-12))
        else:
            lim = 1e-5 * v_c.abs() + 1e-7
        err = ((v_g - v_c).abs() / lim).max().item()
        check(err <= 1.0, f"normal {mode}: value {err:.2f} of its limit on cuda vs cpu")
        g_err, edge = 0.0, 0
        if g_c is not None:
            # a pixel whose cosine lies within 2^-20 of one of the mode's mask
            # bounds may fall on the other side of it on the other device:
            # the loss jumps there, so its gradient is left out (counted)
            near = torch.zeros_like(cos, dtype=torch.bool)
            for bound in BOUNDS[mode]:
                near |= (cos - bound).abs() <= 2.0 ** -20
            edge = int(near.sum())
            tol = 1e-5 * g_c.abs().max() + g_c.abs() * amp[..., None]
            g_err = ((g_g - g_c).abs() / tol)[~near.expand_as(g_c[..., 0])].max().item()
            check(g_err <= 1.0, f"normal {mode}: gradient {g_err:.2f} of its limit")
        worst[mode] = (err, g_err, edge)
    print(f"[normal] the four modes on a {CANVAS}² normal map, cuda vs cpu: " + ", ".join(
        f"{m} value {e:.2f}" + (f" and gradient {g:.2f} of its limit ({n} pixels at a mask "
                                f"bound left out)" if m != "evaluate" else " of its limit")
        for m, (e, g, n) in worst.items()))
    out["normal"] = worst

    # the legacy datasets: a batch of each through the port's DataLoader onto the card
    root = os.path.join(tmp, "legacy")
    rng = np.random.default_rng(5)

    def write(path, w, h):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    for i in range(4):
        write(os.path.join(root, "single", f"im{i}.png"), 300 + 7 * i, 260 + 5 * i)
        write(os.path.join(root, "template", f"im{i}.png"), 290, 270)
        write(os.path.join(root, "unaligned", "trainA", f"a{i}.png"), 310, 280)
        write(os.path.join(root, "unaligned", "trainB", f"b{i}.png"), 280, 310)
    write(os.path.join(root, "singleimage", "trainA", "a.png"), 333, 301)
    write(os.path.join(root, "singleimage", "trainB", "b.png"), 301, 333)
    for mode in ("single", "unaligned", "singleimage", "template"):
        t0 = time.time()
        o = TrainOptions().parse(["--dataset_mode", mode, "--dataroot", os.path.join(root, mode),
                                  "--name", f"legacy_{mode}", "--checkpoints_dir",
                                  os.path.join(tmp, "ckpt"), "--preprocess", "resize_and_crop",
                                  "--load_size", "286", "--crop_size", "256", "--no_flip",
                                  "false", "--batch_size", "2", "--data_len", "4",
                                  "--device", "cuda"], quiet=True)
        batch = next(iter(create_dataset(o)))
        on_card = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(on_card[k].cpu(), torch.from_numpy(v)) for k, v in batch.items())
        print(f"[legacy {mode}] a batch through the port's DataLoader onto the card in "
              f"{time.time() - t0:.2f} s: " + ", ".join(
                  f"{k} {tuple(v.shape)} {v.dtype}" for k, v in sorted(on_card.items()))
              + f"; the same bits back: {same}")
        images = [v for k, v in on_card.items() if v.dim() == 4]
        check(same and images and all(v.shape == (2, 256, 256, 3)
                                      and v.abs().max().item() <= 1.0 for v in images),
              f"the legacy {mode} batch on the card: {[(k, v.shape) for k, v in on_card.items()]}")
    return out


# ------------------------------------------------------------------ 4m ---
# several ranks: one data-parallel step over two ranks against the serial
# step, and the fleet over ranks; on one card, two ranks share it over gloo
DP_TRAIN = ["--model", "sinskit", "--name", "dp", "--device", "cuda",
            "--dataroot", f"synthetic://smoke?size={PADDED}", "--batch_size", "2",
            "--data_len", "2", "--vision_aided_warmup_epoch", "1", "--no_html"]
DP_TIMED = 3
FLEET_FULL = ["--model", "sinskit", "--name", "fleet_full", "--device", "cuda", "--data_len", "1",
              "--vision_aided_warmup_epoch", "1", "--no_html"]


class Recorded:
    """A finished step's losses and Adam moments, as :func:`compare_steps`
    reads a model's."""

    def __init__(self, rec):
        import types
        self.rec = rec
        self.adam = {net: types.SimpleNamespace(mu=mu) for net, mu in rec["mu"].items()}

    def get_current_losses(self):
        return self.rec["losses"]


def step_record(model):
    """A step's losses, Adam first moments and networks' state dicts (the
    parameters and running statistics), on the host."""
    return {"losses": model.get_current_losses(),
            "mu": {net: {k: v.cpu() for k, v in a.mu.items()} for net, a in model.adam.items()},
            "state": {f"{name}.{k}": v.detach().cpu() for name, net in model.nets().items()
                      for k, v in net.state_dict().items()}}


def timed_steps(model, draws, n=DP_TIMED):
    """The walls (ms) of n more steps on the model's input, each synchronized."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.optimize_parameters(1, draws=draws)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def ranks_rank(dirs, batch, draws, fleet_batches):
    """One rank of phase 4m: (a) the data-parallel step on its half of the
    batch, with its launches, their shapes, its collectives and the walls of
    more steps; (b) its garment of the fleet, one step under cuDNN's
    deterministic algorithms, the loss table gathered over the ranks."""
    import functools

    import vts_torch.models.sinskit as sinskit
    from vts_torch.config import TrainOptions
    from vts_torch.models import create_model
    from vts_torch.parallel.dist import TRAFFIC, reset_traffic
    from vts_torch.parallel.fleet import FleetTrainer
    from vts_torch.platform import world

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sinskit.init_clip_params = functools.lru_cache(sinskit.init_clip_params)
    rank = world().rank
    model = create_model(TrainOptions().parse(DP_TRAIN + ["--mesh", "data:2"] + dirs,
                                              quiet=True))
    model.setup()
    model.set_input(batch)
    torch.cuda.synchronize()
    reset_counts()
    reset_traffic()
    with RecordShapes() as rec:
        model.optimize_parameters(1, draws=draws)
        torch.cuda.synchronize()
    out = {"launches": read_counts(), "shapes": rec.shapes(), "traffic": dict(TRAFFIC),
           **step_record(model)}
    reset_traffic()
    out["walls"] = timed_steps(model, draws)
    out["timed_traffic"] = dict(TRAFFIC)
    del model
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    m = FLEET_MATERIALS[rank]
    trainer = FleetTrainer(create_model(TrainOptions().parse(
        FLEET_FULL + dirs + ["--dataroot", FLEET_TEMPLATE.format(material=m)], quiet=True)),
        1, first=rank)
    trainer.init_states()
    trainer.step([fleet_batches[rank]], 1)
    out["fleet"] = ({k: torch.as_tensor(v).cpu() for k, v in trainer.losses[0].items()},
                    {k: v.cpu() for k, v in garment_states(trainer.model).items()})
    out["fleet_means"] = trainer.mean_losses(2)
    return out


def several_ranks(dirs, train_shapes, fleet, smi, devices=("cuda:0", "cuda:0")):
    """Phase 4m: (a) a D3-active full-width sinskit step of batch 2 in two
    ranks that share the card over gloo (1 + 1, ``--mesh data:2``), against
    the serial batch-2 step from the same weights, batch and draws on the
    card by phase 4's rule; the ranks' networks bit for bit the same; each
    rank's kernel launches and their shapes the ``train`` row's; the walls
    of more steps, the collectives and their bytes; (b) phase 4j's two
    garments, one per rank, each bit for bit its single step; (c) over
    NCCL, the training CLI and the launcher's fleet on two cards, where
    there are two.  ``devices``: the two ranks' (two cards: (a) and (b)
    over NCCL)."""
    import functools

    import vts_torch.models.sinskit as sinskit
    from vts_torch.config import TrainOptions
    from vts_torch.data import create_dataset
    from vts_torch.models import create_model
    from vts_torch.platform import spawn_ranks

    out = {}
    opt = TrainOptions().parse(DP_TRAIN + dirs, quiet=True)
    real_clip = sinskit.init_clip_params
    sinskit.init_clip_params = functools.lru_cache(real_clip)
    try:
        serial = create_model(opt)
        serial.setup()
        batch = next(iter(create_dataset(opt)))
        draws = serial.draw(2)
        serial.set_input(batch)
        serial.optimize_parameters(1, draws=draws)
        want = step_record(serial)
        out["serial_walls"] = timed_steps(serial, draws)
        del serial
        # how far the serial step's gradients move when every weight moves by
        # ~1e-6 of itself (two random directions): where a max-pool or ReLU
        # near-tie of the touch LPIPS flips, the ranks' G (whose convs see
        # batch 1, not 2) is held in the 2-norm to twice the larger jump; a
        # zero gradient's leaf moves by its round-off
        jumps, moved = [], []
        for d in range(2):
            m = create_model(opt)
            m.setup()
            gen = torch.Generator().manual_seed(100 + d)
            with torch.no_grad():
                for net in m.nets().values():
                    for prm in net.parameters():
                        prm.mul_(1 + 1e-6 * torch.randn(prm.shape, generator=gen).to(prm.device))
            m.set_input(batch)
            m.optimize_parameters(1, draws=draws)
            moved.append({net: {k: v.cpu() for k, v in a.mu.items()} for net, a in m.adam.items()})
            ref = want["mu"]["G"]
            jumps.append(rel_norm(moved[-1]["G"], ref, ref))
            del m
    finally:
        sinskit.init_clip_params = real_clip
    torch.cuda.empty_cache()
    jump = max(jumps)
    print(f"[ranks] the serial batch-2 step's G gradient moves by "
          f"{', '.join(f'{j:.2e}' for j in jumps)} in the 2-norm when the weights move by 1e-6 "
          f"of themselves" + ("; G held to twice the larger, in the 2-norm" if jump > 1e-5
                              else "; phase 4's rule"))

    t0 = time.time()
    res = spawn_ranks(ranks_rank, (dirs, batch, draws, fleet["batches"]), devices)
    out["ranks_s"] = time.time() - t0
    print(f"[ranks] two ranks on {', '.join(devices)}, (a) and (b) in {out['ranks_s']:.1f} s "
          f"(process start, set-up and CLIP included)")
    # (a) the data-parallel step against the serial one
    # named=False: at batch 2 the G leaves at round-off are not ZERO_GRAD's
    # batch-1 set, so every leaf at round-off is held to the floor.  A
    # ZERO_GRAD leaf's exact gradient is zero, so both steps hold round-off
    # there: its bound adds the serial |g| and twice the most the 1e-6 weight
    # moves changed it (that round-off's measured size)
    extra = {net: {k: want["mu"][net][k].abs().max().item()
                   + 2 * max((mv[net][k] - want["mu"][net][k]).abs().max().item()
                             for mv in moved)
                   for k in want["mu"][net] if ZERO_GRAD.search(k)} for net in want["mu"]}
    compare_steps("dp2 step (2 ranks x batch 1) against the serial batch-2 step",
                  Recorded(want), Recorded(res[0]), named=False, vs="ranks vs serial",
                  g_norm=2 * jump if jump > 1e-5 else None, extra_tol=extra)
    zero = max(((res[0]["mu"][net][k] - want["mu"][net][k]).abs().max().item()
                / max(extra[net][k], 1e-30), net, k, want["mu"][net][k].abs().max().item(), extra[net][k])
               for net in ("D", "D2") for k in extra[net])
    print(f"[ranks] D's and D2's zero-gradient leaves: the worst |d| is {zero[0]:.2f} of the "
          f"serial round-off bound at {zero[1]} {zero[2]} (serial |g| {zero[3]:.3e}, bound "
          f"{zero[4]:.3e}, the floor 1e-5 of the network's max |g| besides)")
    stats = [k for k in want["state"] if k.startswith(("D.", "D2.")) and
             k.endswith((".mean", ".var"))]
    worst = max(((res[0]["state"][k] - want["state"][k]).abs()
                 / (1e-6 + 1e-4 * want["state"][k].abs())).max().item() for k in stats)
    print(f"[ranks] D1/D2 running statistics ({len(stats)} buffers) against the serial step: "
          f"worst |d| / (1e-6 + 1e-4 |ref|) {worst:.3f}")
    check(stats and worst <= 1.0, "the ranks' running statistics disagree with the serial step's")
    same = [all(torch.equal(res[0]["state"][k], res[1]["state"][k]) for k in want["state"]),
            all(torch.equal(res[0]["mu"][n][k], res[1]["mu"][n][k])
                for n in want["mu"] for k in want["mu"][n])]
    print(f"[ranks] the two ranks' networks after the step bit for bit the same: {same[0]}; "
          f"their Adam moments: {same[1]}")
    check(all(same), "the ranks' networks differ after the step")
    for r, got in enumerate(res):
        print(f"[ranks] rank {r}: launches {got['launches']} (PER_STEP {PER_STEP}); shapes "
              f"those of the train row: {got['shapes'] == train_shapes}")
        check(got["launches"] == PER_STEP and got["shapes"] == train_shapes,
              f"rank {r}'s kernel launches are not the train row's: {got['launches']}")
    t = res[0]["timed_traffic"]
    out["collectives"], out["bytes"] = t["collectives"] / DP_TIMED, t["bytes"] / DP_TIMED
    out["rank_walls"] = [got["walls"] for got in res]
    walls = "; ".join(f"rank {r} median {statistics.median(w):.1f} ms "
                      f"({', '.join(f'{v:.1f}' for v in w)})"
                      for r, w in enumerate(out["rank_walls"]))
    shared = len(set(devices)) == 1
    print(f"[time ranks] {smi}: a D3-active {CANVAS}² dp2 step, 2 ranks on "
          + ("one card over gloo (not a speed figure: the ranks contend for the card)" if shared
             else f"{', '.join(devices)} over nccl") + f": {walls}; the serial "
          f"batch-2 step {statistics.median(out['serial_walls']):.1f} ms "
          f"({', '.join(f'{v:.1f}' for v in out['serial_walls'])}); per step "
          f"{out['collectives']:.0f} collectives moving {out['bytes'] / 2 ** 20:.3f} MiB from "
          f"each rank (the first step: {res[0]['traffic']['collectives']})")
    # (b) the fleet over ranks against the single steps
    for g, got in enumerate(res):
        lw, sw = fleet["steps"][g]
        lf, sf = got["fleet"]
        same_l = lf.keys() == lw.keys() and all(torch.equal(lf[k], lw[k]) for k in lw)
        diff = [k for k in sw if not torch.equal(sf[k], sw[k])]
        print(f"[ranks] fleet garment {g} on rank {g}: against its single step losses "
              f"bit-identical {same_l}; {len(sw) - len(diff)} of {len(sw)} parameter, statistic "
              f"and Adam tensors bit-identical" + (f"; differing: {diff[:8]}" if diff else ""))
        check(same_l and not diff, f"the fleet over ranks differs for garment {g}")
    check(res[0]["fleet_means"] == res[1]["fleet_means"],
          "the ranks' gathered fleet losses differ")
    # (c) NCCL, one card per rank
    if torch.cuda.device_count() < 2:
        print(f"[dist] nccl: {torch.cuda.device_count()} card visible, not run")
        return out
    log = os.path.join(dirs[1], "dp_nccl.log")
    with open(log, "w") as f:
        subprocess.run([sys.executable, "-m", "vts_torch.train", *DP_TRAIN, "--mesh", "data:2",
                        "--n_epochs", "1", "--n_epochs_decay", "0", *dirs], cwd=ROOT, stdout=f,
                       stderr=subprocess.STDOUT, timeout=900, check=True)
    with open(log) as f:
        text = f.read()
    print("\n".join(ln for ln in text.splitlines() if ln.startswith(("[dist]", "(epoch"))))
    check(text.count("(backend nccl)") == 2, "the training CLI's ranks did not use nccl")
    launcher(["ours", "launch", "--materials", ",".join(FLEET_MATERIALS), "--dataroot-template",
              FLEET_TEMPLATE, "--checkpoints_dir", dirs[1], "--results_dir", dirs[3], "--",
              "--data_len", "1", "--n_epochs", "1", "--n_epochs_decay", "0"],
             os.path.join(dirs[1], "fleet_nccl.log"), "cuda", 2)
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
    with RecordShapes() as rec:
        tmodel.optimize_parameters(2)
        torch.cuda.synchronize()
    train_shapes = rec.shapes()
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
    bf16_trio("256² bf16 step (batch 2, LPIPS crop 128)",
              strain + ["--use_vision_aided_loss", "false", "--batch_size", "2",
                        "--lpips_crop", "128"], None, 2, (256, 256))
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
        # the legacy evaluation on garment A alone (cut for time: ~5 s a sample)
        n_test = 2 if mode == "batched" else 1
        reset_counts()
        with Gallery() as gallery:
            got = run_test(stest + ["--eval_mode", mode, "--num_test", str(n_test),
                                    "--results_dir", os.path.join(tmp, f"res_{mode}")])
        torch.cuda.synchronize()
        skit_tests[mode] = read_counts()
        with open(os.path.join(tmp, f"res_{mode}", "skit", "test_best",
                               "eval_metrics_per_material.pkl"), "rb") as f:
            per_mat = pickle.load(f)
        check(len(got) == n_test and all(len(m) == 8 and all(math.isfinite(v)
                                                             for v in m.values())
                                         for m in got), f"skitG test ({mode}): {got}")
        check(sorted(per_mat) == ["synthA", "synthB"][:n_test]
              and all(math.isfinite(v) for m in per_mat.values() for v in m.values()),
              f"skitG test ({mode}): per-material metrics {per_mat}")
        for mat, m in sorted(per_mat.items()):
            print(f"[skit test {mode}] material {mat}: "
                  + " ".join(f"{k}={v:.6g}" for k, v in sorted(m.items())))
        print(f"[skit test {mode}] launches during the {n_test}-sample run: {skit_tests[mode]} "
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

    # --------------------------------------------------------------- 4g ---
    print(f"[phase] phase 4g (the pix2pix baseline) from {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    p2p = pix2pix_baseline(tmp, dirs, workflow["data"], run_train, run_test)
    p2p_s = time.time() - t0
    print(f"[pix2pix] phase 4g took {p2p_s:.1f} s")

    # --------------------------------------------------------------- 4h ---
    print(f"[phase] phase 4h (the pix2pixHD baseline) from {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    hd = pix2pixhd_baseline(tmp, dirs, workflow["data"], run_train, run_test, p2p["shapes"])
    hd_s = time.time() - t0
    print(f"[pix2pixhd] phase 4h took {hd_s:.1f} s")

    # --------------------------------------------------------------- 4i ---
    print(f"[phase] phase 4i (the SPADE baseline) from {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    sp = spade_baseline(tmp, dirs, workflow["data"], run_train, run_test, p2p["shapes"])
    sp_s = time.time() - t0
    print(f"[spade] phase 4i took {sp_s:.1f} s")

    # --------------------------------------------------------------- 4j ---
    print(f"[phase] phase 4j (the garment fleet) from {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    fl = garment_fleet(tmp, dirs, run_test, smi)
    fl_s = time.time() - t0
    print(f"[fleet] phase 4j took {fl_s:.1f} s (the launcher's fleet {fl['launch_s']:.1f} s)")

    # --------------------------------------------------------------- 4k ---
    print(f"[phase] phase 4k (the zoo) from {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    zoo = zoo_phase(tmp, dirs, run_train, run_test, train_shapes, p2p["shapes"])
    zoo_s = time.time() - t0
    print(f"[zoo] phase 4k took {zoo_s:.1f} s")

    # --------------------------------------------------------------- 4l ---
    print(f"[phase] phase 4l (the CUT heads, the normal modes, the legacy datasets) from "
          f"{time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    cut = cut_phase(tmp)
    cut_s = time.time() - t0
    print(f"[cut] phase 4l took {cut_s:.1f} s")

    # --------------------------------------------------------------- 4m ---
    print(f"[phase] phase 4m (several ranks) from {time.time() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    several_ranks(dirs, train_shapes, fl, smi)
    ranks_s = time.time() - t0
    print(f"[ranks] phase 4m took {ranks_s:.1f} s")

    # ---------------------------------------------------------------- 5 ---
    print(f"[phase] phase 5 (times) from {time.time() - t_start:.1f} s; the card: {card_state()} "
          f"(SM clock, power, temperature)")
    edit_ms = workflow["edit_sample_ms"]
    print(f"[time workflow] {smi}: one {CANVAS}² edit test sample (set_input, G forward, no "
          f"metrics): {statistics.median(edit_ms):.1f} ms wall, median of {len(edit_ms)} "
          f"({', '.join(f'{w:.1f}' for w in edit_ms)})")
    print(f"[time workflow] {smi}: two garments trained through the launcher (1 epoch of 2 "
          f"samples each at {CANVAS}², D3 off; process start, data, set-up, validation and "
          f"checkpoints included) in two processes on the card at once: "
          f"{workflow['two_s']:.1f} s wall")
    print(f"[time workflow] {smi}: postprocess_gz {CANVAS}² -> 1280x800 on the host, ms per map "
          f"(median of 3): " + ", ".join(f"{m} {v:.1f}" for m, v in workflow["pp_ms"].items())
          + f" (equalize through {workflow['clahe']})")
    rows = {}                     # (kernel, path) -> per-sample or per-step sums
    shape_rows = []

    def add(kname, path, per, ms, plain, lib, flops, nbytes, err, shape, peak=PEAK_FP32_FLOPS):
        acc = rows.setdefault((kname, path), dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                                  flops=0.0, bytes=0.0, err=0.0, per=0,
                                                  peak=peak, bound=0.0,
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
                               tflops=flops / ms / 1e9, max_abs_err=err))
        return bound, by

    # ``deferred``: (row key, launches, shape row, kernel call, kernel name,
    # library call, line to print); the lines are printed after the step
    # timing, their device-only fields "not measured" (no profiler session)
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
    # a pix2pix test sample (K = 64 test patches); a pix2pixHD one's rows are
    # pix2pix's where its shapes are the same (phase 4h checks), else its own
    time_k1_eval(p2p["k1_rows"], "eval_pix2pix")
    time_k1_eval(hd["k1_rows"], "eval_pix2pixhd")
    time_k1_eval(sp["k1_rows"], "eval_spade")
    # a 1024² pix2pix test sample with the StyleGAN2 G
    time_k1_eval(zoo["sg2_k1_rows"], "eval_stylegan2")

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
    time_gather("eval_pix2pix", PER_SAMPLE["gather_patches"], (img2[:1],),
                dict(coords=coords[:1, :K_P2P].contiguous()),
                k2.patch_offsets(coords[0, :K_P2P])[:2],
                f"fake_T at pix2pix's {K_P2P} test patches")
    if not hd["same_shapes"]:
        time_gather("eval_pix2pixhd", PER_SAMPLE["gather_patches"], (img2[:1],),
                    dict(coords=coords[:1, :hd["k2_k"]].contiguous()),
                    k2.patch_offsets(coords[0, :hd["k2_k"]])[:2],
                    f"fake_T at pix2pixHD's {hd['k2_k']} test patches")
    if not sp["same_shapes"]:
        time_gather("eval_spade", PER_SAMPLE["gather_patches"], (img2[:1],),
                    dict(coords=coords[:1, :sp["k2_k"]].contiguous()),
                    k2.patch_offsets(coords[0, :sp["k2_k"]])[:2],
                    f"fake_T at SPADE's {sp['k2_k']} test patches")
    sg2_T, sg2_coords = zoo.pop("sg2_k2")
    time_gather("eval_stylegan2", PER_SAMPLE["gather_patches"], (sg2_T,),
                dict(coords=sg2_coords), k2.patch_offsets(sg2_coords[0])[:2],
                f"fake_T at the StyleGAN2 G's {sg2_coords.shape[1]} test patches on its "
                f"{SG2_CANVAS}² canvas")
    del sg2_T
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
        # the legacy sample once after its warm-up (cut for time), the batched
        # one three times
        for i in range(4 if mode == "batched" else 2):
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

    # pix2pix untraced: one full-width training step (median of 5 after 2
    # warm-ups), one full-canvas test sample (median of 3 after 1, the
    # launches of one); then one traced step in a process of its own
    print(f"[phase] pix2pix walls from {time.time() - t_start:.1f} s")
    traced = traced_baseline_steps(dirs)
    model = p2p.pop("train_model")
    batch = next(iter(create_dataset(TrainOptions().parse(P2P_TRAIN + dirs, quiet=True))))
    model.set_input(batch)
    walls, peaks = [], []
    held = torch.cuda.memory_allocated() / 2 ** 30
    for i in range(7):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.optimize_parameters(1)
        model.get_current_losses()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    p2p_wall = statistics.median(walls)
    print(f"[time pix2pix step] {smi}: one full-width pix2pix training step (batch 32 of 32² "
          f"patches, ngf/ndf 64, resnet_9blocks, batch-norm G and Ds): {p2p_wall:.1f} ms wall, "
          f"median of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); "
          f"{32e3 / p2p_wall:.1f} samples/s; peak memory {max(peaks):.2f} GiB, of which "
          f"{held:.2f} GiB was held by this process before the step")
    del model, batch
    topt = TestOptions().parse(P2P_TEST + dirs, quiet=True)
    batch = next(iter(create_dataset(topt)))
    model = create_model(topt)
    model.setup()
    model.load_networks("best")
    model.set_input(batch)
    walls, g_ms = [], []
    for i in range(4):
        torch.cuda.synchronize()
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        model.test()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.compute_metrics()
        torch.cuda.synchronize()
        if i == 1:
            p2p_one = read_counts()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
            g_ms.append((t1 - t0) * 1e3)
    print(f"[time pix2pix sample] {smi}: one {CANVAS}² pix2pix test sample (K {K_P2P}): "
          f"{statistics.median(walls):.1f} ms wall (G forward {statistics.median(g_ms):.1f} ms), "
          f"median of {len(walls)} ({', '.join(f'{w:.1f}' for w in walls)}); launches "
          f"{p2p_one}")
    check(p2p_one == PER_SAMPLE, f"a pix2pix test sample launched {p2p_one}, not {PER_SAMPLE}")
    del model, batch
    torch.cuda.empty_cache()
    rec = traced["pix2pix"]
    print(f"[time pix2pix traced] {smi}: one traced full-width pix2pix step in a process of "
          f"its own (vts_torch.utils.profiler --phase train): wall {rec['wall_ms']:.1f} ms, device busy "
          f"{rec['device_busy_ms']:.1f} ms, idle share {rec['device_idle_share']:.3f}, peak "
          f"memory {rec['peak_memory_gib']:.2f} GiB; top kernels: "
          + "; ".join(f"{k['name'][:60]} {k['ms']:.2f} ms" for k in rec["kernels_ms"][:6]))
    print(f"[phase] pix2pixhd walls from {time.time() - t_start:.1f} s")
    pix2pixhd_times(hd, dirs, smi, traced["pix2pixhd"])
    print(f"[phase] spade walls from {time.time() - t_start:.1f} s")
    spade_times(sp, dirs, smi, traced["spade"])
    # no device-only profiler session: cut for time (the kernels' session
    # lost its span markers in every run)
    print(f"[time D3] the D3 part of a {CANVAS}² step (CLIP ViT-B/32 of real I, no grad; of "
          f"fake_I with grad; backward to fake_I): {d3_ms:.2f} ms (host only {d3_host:.2f} ms, "
          f"device only not measured); resize_mm {CANVAS}² -> 224² forward "
          f"{resize_ms:.4f} ms")
    for *_, line in deferred:
        print(line.format(dev="not measured", lib_dev="not measured"))
    if hd["same_shapes"]:
        # a pix2pixHD test sample launches K1 and K2 at a pix2pix one's shapes
        for kname in ("conv3x3_bias_relu", "gather_patches"):
            rows[(kname, "eval_pix2pixhd")] = dict(rows[(kname, "eval_pix2pix")])
    if sp["same_shapes"]:
        # a SPADE test sample launches K1 and K2 at a pix2pix one's shapes
        for kname in ("conv3x3_bias_relu", "gather_patches"):
            rows[(kname, "eval_spade")] = dict(rows[(kname, "eval_pix2pix")])

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
                "train_tmult2": x2_step_launches, "eval_legacy": skit_sample["legacy"],
                "eval_pix2pix": p2p["sample_launches"],
                "eval_pix2pixhd": hd["sample_launches"], "eval_spade": sp["sample_launches"],
                "eval_stylegan2": zoo["sg2_sample_launches"]}
    in_run = {"eval": run_launches, "train": train_launches, "train_bf16": lane_run_launches,
              "train_tmult2": x2_run_launches, "eval_legacy": legacy_run_launches,
              "eval_pix2pix": p2p["run_launches"], "eval_pix2pixhd": hd["run_launches"],
              "eval_spade": sp["run_launches"], "eval_stylegan2": zoo["sg2_run_launches"]}
    for (kname, path), acc in rows.items():
        launches = per_path[path][kname]
        check(launches == acc["per"], f"{kname} ({path}): {launches} launches, timed {acc['per']}")
        # the least time of the row's launches: each shape's own bound (bytes
        # or operations, whichever is larger there) times its launches, summed;
        # bound_by names the kind that makes up most of it
        b_ms, b_by = acc["bound"], max(acc["by"], key=acc["by"].get)
        src, repl = sources[kname]
        per_what = "test sample" if path.startswith("eval") else "training step"
        print(f"[time {kname} {path}] per {per_what}: "
              f"{launches} launches, kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, "
              f"library {acc['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}"
              f"{', 3xTF32' if acc['peak'] == K1_PEAK else ''}; fp32 CUDA cores "
              f"{bound_ms(acc['flops'], acc['bytes'])[0]:.4f})")
        kernels.append(dict(name=f"{kname}@{path}", route="cuda", source=src, replaces=repl,
                            launches=launches, max_abs_err=acc["err"], ms=acc["ms"],
                            plain_ms=acc["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                            library_ms=acc["library_ms"], path=path,
                            bound_fp32_ms=bound_ms(acc["flops"], acc["bytes"])[0],
                            launches_in_run=in_run[path][kname]))
    print(f"[shapes] {json.dumps(shape_rows)}")
    print(f"[done] chip_smoke took {time.time() - t_start:.1f} s (phase 4f: {workflow_s:.1f} s, "
          f"phase 4g: {p2p_s:.1f} s, phase 4h: {hd_s:.1f} s, phase 4i: {sp_s:.1f} s, "
          f"phase 4j: {fl_s:.1f} s, phase 4k: {zoo_s:.1f} s, phase 4l: {cut_s:.1f} s, "
          f"phase 4m: {ranks_s:.1f} s)")
    tmp_dir.cleanup()

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
