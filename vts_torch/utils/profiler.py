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
every epoch from there on) when the run's epochs reach it and
``--use_vision_aided_loss`` is on, else at ``--epoch_count``.  Prints, as
one JSON line: the wall time, the device-busy time (the union of the CUDA
kernel intervals) and the idle share, the peak device memory of the
profiled run, the host time spent in the Fréchet ``sqrtm`` calls (test
phase), the epoch stepped and whether D3 was active (train phase), and the
device time per kernel name (top 25).  ``--trace`` also writes the chrome
trace.
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
    d3 = opt.use_vision_aided_loss and opt.vision_aided_warmup_epoch <= \
        opt.n_epochs + opt.n_epochs_decay
    if d3:
        epoch = max(epoch, opt.vision_aided_warmup_epoch)

    def one_step():
        model.optimize_parameters(epoch)
        model.get_current_losses()
        torch.cuda.synchronize()

    for _ in range(2):                             # warm-up
        one_step()
    return dict(_profile(one_step, trace_path), epoch=epoch, d3_active=bool(d3))


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
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (e.time_range.end
                                                                 - e.time_range.start) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return {"device": torch.cuda.get_device_name(0), "wall_ms": wall,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
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
