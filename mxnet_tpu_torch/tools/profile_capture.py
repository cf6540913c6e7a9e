"""The captured training step against the eager one, on one CUDA card.

    python3 -m mxnet_tpu_torch.tools.profile_capture [cell ...]

For each cell of ``chip_smoke.py``'s training phases (``train``: the LM's
bf16 fused step at ``TRAIN``'s batch through ``make_train_step``;
``resnet``: ResNet-50's bf16 ``Module.fit_step`` at batch 32;
``image_zoo``: Inception-BN's, the same way (``tools/image_zoo.py``);
``ssd``: ssd-vgg16's bf16 ``fit_step`` at batch 32 on one host batch
(``tools/ssd.py``), whose step copies the batch from pageable memory, and
``ssd_prefetch``: the same step fed through ``DevicePrefetchIter`` (its
pinned copy on a stream of its own, the step's copy device to device),
with the device time of the copies by direction (``copy HtoD``, ``copy
DtoD``); ``lstm`` /
``custom``: the LSTM LM's ``fit_step`` at batch 128 with the
``SoftmaxOutput`` / ``rtc_softmax`` head), first with the step captured
as a CUDA graph, then eager (``MXNET_CUDA_GRAPH=0``),
each from its own set-up: warm-up steps (the captured one's two warm-up
calls and its capture among them), then the host-clock ms of
``steps`` synchronized steps (median), and a ``torch.profiler`` window
over ``window`` steps: the device's busy ms (its kernels' device time,
replayed kernels included) by kind (each cell's own profile tool's
kinds) and idle share of the window, and the heaviest kernels. The step
is the fused step alone, without the metric. Prints one JSON line per cell
and path; exits non-zero without a card.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from . import profile_generate, profile_lstm, profile_module

CELLS = ("train", "resnet", "image_zoo", "ssd", "ssd_prefetch", "lstm",
         "custom")


def _copy_kind(name):
    """The batch copies by direction, the rest as ``profile_module``."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "copy " + ("HtoD" if "htod" in low else "DtoD" if "dtod"
                          in low else "other")
    return profile_module._kind(name)


# each cell's kernel kinds: those of its own profile tool
KIND = {"train": profile_generate._kind, "resnet": profile_module._kind,
        "image_zoo": profile_module._kind, "ssd": _copy_kind,
        "ssd_prefetch": _copy_kind, "lstm": profile_lstm._kind,
        "custom": profile_lstm._kind}


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _setup(cell):
    """(one training step, its stats) of ``cell``, warmed up."""
    from . import image_zoo, lm, lstm_lm, resnet, rtc_softmax, ssd

    if cell == "train":
        exe, names = lm.lm_train_setup(lm.LM, lm.TRAIN)
        run, step = lm.lm_train_step(
            exe, names, lm.lm_updater("sgd", lm.TRAIN, names))
        for _ in range(3):      # warm-up, warm-up, capture
            run()
        return run, step.stats
    if cell == "resnet":
        cfg = resnet.RESNET
        mod, it, init = resnet.resnet_setup(
            cfg, cfg["batch"], 4, compute_dtype=cfg["dtype"])
        kwargs = resnet.fit_args(cfg, init)
    elif cell == "image_zoo":
        cfg = image_zoo.IMAGE_ZOO["main"]
        mod, it, init = image_zoo.zoo_setup(
            cfg["model"], cfg, cfg["batch"], 4, compute_dtype=cfg["dtype"])
        kwargs = resnet.fit_args(cfg, init)
    elif cell in ("ssd", "ssd_prefetch"):
        from .. import io

        cfg = ssd.SSD
        mod, it, init = ssd.ssd_setup(cfg, cfg["batch"], 4,
                                      compute_dtype=cfg["dtype"])
        mod.fit(it, **ssd.fit_args(cfg, init))
        it.reset()
        if cell == "ssd":
            batch = next(iter(it))
            return (lambda: mod.fit_step(batch)), mod.fit_step_stats
        # an endless epoch: each step takes the next prefetched batch
        pre = io.DevicePrefetchIter(io.ResizeIter(it, 1 << 30))
        return (lambda: mod.fit_step(pre.next())), mod.fit_step_stats
    else:
        cfg = lstm_lm.LSTM_LM
        sym = rtc_softmax.lstm_rtc_symbol(cfg) if cell == "custom" else None
        mod, it, init = lstm_lm.lstm_setup(cfg, cfg["batch"], 4,
                                           symbol=sym)
        kwargs = lstm_lm.fit_args(cfg, init)
    mod.fit(it, **kwargs)       # 4 batches: warm-up, capture, a replay
    it.reset()
    batch = next(iter(it))
    return (lambda: mod.fit_step(batch)), mod.fit_step_stats


def profile(cell, capture, steps=10, window=3):
    """The record of one cell and path."""
    from .lm import cuda_graph

    with cuda_graph(capture):
        try:
            torch.cuda.reset_peak_memory_stats()
            run, stats = _setup(cell)
            run()
            times = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(window):
                    run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            by_kind = {}
            for e in kernels:
                k = KIND[cell](e.key)
                by_kind[k] = (by_kind.get(k, 0.0)
                              + e.self_device_time_total / 1e3)
            busy = sum(by_kind.values())
            top = sorted(kernels,
                         key=lambda e: -e.self_device_time_total)[:8]
            return {"cell": cell, "path": stats()["path"], "stats": stats(),
                    "step_ms": times,
                    "median_step_ms": float(np.median(times)),
                    "window_steps": window, "window_wall_ms": wall_ms,
                    "device_busy_ms": busy if busy > 0 else None,
                    "device_idle_share": (1.0 - busy / wall_ms) if busy > 0
                    else None,
                    "device_ms_by_kind": by_kind,
                    "top_kernels": [{"name": e.key[:80], "count": e.count,
                                     "ms": e.self_device_time_total / 1e3}
                                    for e in top],
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
        finally:
            gc.collect()
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_capture: no CUDA device available", file=sys.stderr)
        return 2
    from .lm import nvidia_smi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells = (argv if argv is not None else sys.argv[1:]) or CELLS
    for cell in cells:
        for capture in (True, False):
            _emit(dict(profile(cell, capture), gpu=nvidia_smi()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
