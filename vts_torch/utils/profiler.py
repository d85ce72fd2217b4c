"""Where one test sample's, or one training step's, time goes, on the card.

    python -m vts_torch.utils.profiler [vts_torch.test flags] [--trace out.json]
    python -m vts_torch.utils.profiler --phase train [vts_torch.train flags] [--trace out.json]

Test phase (the default): builds the model and the first sample from the
same flags as ``vts_torch.test`` (a checkpoint is loaded when one exists,
else the seeded init stays), runs one warm-up sample, then one sample under
``torch.profiler`` (CPU + CUDA activities).  ``--phase train``: builds the
training model and the first batch from the ``vts_torch.train`` flags, runs
two warm-up steps, then one training step (losses fetched to the host)
under the profiler, at ``--vision_aided_warmup_epoch`` (D3 active, as in
every epoch from there on) when the run's epochs reach it and the model
has D3 (``--use_vision_aided_loss``; pix2pix has none), else at
``--epoch_count``; the training
flags pass through as given, so the production lane's ``--dtype bfloat16
--batch_size 4 --lpips_crop 768`` profiles that lane's step.  Prints, as
one JSON line: the wall time, the device-busy time (the union of the CUDA
kernel intervals) and the idle share, the peak device memory of the
profiled run, the host time spent in the Fréchet ``sqrtm`` calls (test
phase), the epoch stepped, whether D3 was active, the batch, dtype and LPIPS
crop (train phase), and the
device time per kernel name (top 25) and the count of kernel launches.
For a model with a VGG19 loss (``--model pix2pixhd``, ``spade``) the train
phase also profiles that loss alone on the profiled step's outputs,
forward and backward to them (``vgg19``: its wall, device busy time and
kernels), the measure of its share of the step; for a model with
spectral-norm convs (``--model spade``) it profiles, alone, the spectral
norms one step computes (``spectral_norm``): each conv's power iteration
and kernel / σ, once for each of G's convs and three times for each of
D's and D2's (the fake, the real and the G-loss pass), with their launches;
for a model with StyleGAN2 nets (``--netG stylegan2``, ``--netD
stylegan2``, ...) it records every call the step makes to them and replays
those alone, forward and backward (``stylegan2``: on cuDNN, their FIR
blurs, equalized and modulated convs), the measure of their share.
``--trace`` also writes the chrome trace.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..config import TestOptions, TrainOptions
from ..data import create_dataset
from ..device import resolve_device
from ..metrics import evaluate_batch
from ..models import create_model
from ..networks.spade_nets import SpectralConv
from ..networks.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator


def _busy_ms(events) -> float:
    """Union of the device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3          # µs → ms


def profile_test_sample(argv, trace_path: str = None) -> dict:
    opt = TestOptions().parse(argv, quiet=True)
    device = resolve_device(opt.device)
    if device.type != "cuda":
        raise RuntimeError("the profiler measures the card; run it with --device cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = next(iter(create_dataset(opt)))
    model = create_model(opt)
    model.setup()
    model.load_networks(opt.epoch)
    model.set_input(batch)

    host_frechet = [0.0]
    frechet = evaluate_batch.frechet_distance

    def timed_frechet(*a, **k):
        t = time.perf_counter()
        try:
            return frechet(*a, **k)
        finally:
            host_frechet[0] += time.perf_counter() - t

    def one_sample():
        model.test()
        model.compute_metrics()
        torch.cuda.synchronize()

    one_sample()                                   # warm-up
    evaluate_batch.frechet_distance = timed_frechet
    try:
        out = _profile(one_sample, trace_path)
    finally:
        evaluate_batch.frechet_distance = frechet
    out["host_frechet_ms"] = host_frechet[0] * 1e3
    return out


def profile_train_step(argv, trace_path: str = None) -> dict:
    opt = TrainOptions().parse(argv, quiet=True)
    device = resolve_device(opt.device)
    if device.type != "cuda":
        raise RuntimeError("the profiler measures the card; run it with --device cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = next(iter(create_dataset(opt)))
    model = create_model(opt)
    model.setup()
    model.set_input(batch)

    epoch = opt.epoch_count
    d3 = model.use_d3 and opt.vision_aided_warmup_epoch <= opt.n_epochs + opt.n_epochs_decay
    if d3:
        epoch = max(epoch, opt.vision_aided_warmup_epoch)

    def one_step():
        model.optimize_parameters(epoch)
        model.get_current_losses()
        torch.cuda.synchronize()

    for _ in range(2):                             # warm-up
        one_step()
    out = dict(_profile(one_step, trace_path), epoch=epoch, d3_active=bool(d3),
               batch=opt.batch_size, dtype=opt.dtype, lpips_crop=opt.lpips_crop)
    if getattr(model, "vgg", None) is not None:
        fake_I, fake_T = (model._outputs[k].detach().requires_grad_(True)
                          for k in ("fake_I", "fake_T"))

        def vgg_part():
            loss = model.vgg_term(fake_I, fake_T, model._input["I"], model._input["T_images"])
            torch.autograd.grad(loss, (fake_I, fake_T))
            torch.cuda.synchronize()

        vgg_part()                                 # warm-up
        out["vgg19"] = _profile(vgg_part)
    passes = [(m, 1 if name == "G" else 3) for name in model.model_names
              for m in getattr(model, f"net{name}").modules() if isinstance(m, SpectralConv)]
    if passes:
        def spectral_part():
            for m, n in passes:
                for _ in range(n):
                    _ = m.weight.detach() / m.power_iteration()[1]
            torch.cuda.synchronize()

        spectral_part()                            # warm-up
        out["spectral_norm"] = dict(_profile(spectral_part), convs=len(passes),
                                    passes=sum(n for _, n in passes))
    zoo = [getattr(model, f"net{name}") for name in model.model_names]
    zoo = [m for m in zoo if isinstance(m, (StyleGAN2Generator, StyleGAN2Discriminator))]
    if zoo:
        # every call the step makes to a StyleGAN2 net, recorded in one more
        # step, replayed alone: forward, and backward to its parameters and
        # to its input where the step's input took a gradient
        calls = []
        hooks = [m.register_forward_hook(lambda mod, inp, o: calls.append(
            (mod, inp[0].detach().clone(), inp[0].requires_grad))) for m in zoo]
        one_step()
        for h in hooks:
            h.remove()

        def stylegan2_part():
            for mod, x, needs in calls:
                x = x.requires_grad_(needs)
                torch.autograd.grad(mod(x).sum(), list(mod.parameters()) + ([x] if needs else []))
            torch.cuda.synchronize()

        stylegan2_part()                           # warm-up
        out["stylegan2"] = dict(_profile(stylegan2_part), calls=len(calls))
    return out


def _profile(fn, trace_path: str = None) -> dict:
    """Run ``fn`` once under torch.profiler; wall, device busy, idle share,
    peak memory and the device time per kernel name."""
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = _busy_ms(events)
    per_kernel = {}
    launches = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (e.time_range.end
                                                                 - e.time_range.start) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return {"device": torch.cuda.get_device_name(0), "wall_ms": wall,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "kernel_launches": launches,
            "kernels_ms": [{"name": n[:120], "ms": ms} for n, ms in top]}


if __name__ == "__main__":
    args = sys.argv[1:]
    trace = None
    if "--trace" in args:
        i = args.index("--trace")
        trace = args[i + 1]
        del args[i:i + 2]
    train = "--phase" in args and args[args.index("--phase") + 1] == "train"
    print(json.dumps((profile_train_step if train else profile_test_sample)(args, trace)))
