"""Where the time goes in one ResNet-50 ``Module.fit`` step, on one CUDA
card.

    python3 -m mxnet_tpu_torch.tools.profile_module      # from the repo root

Sets up the run of ``chip_smoke.py``'s resnet phase
(``tools/resnet.py:resnet_setup``: ResNet-50, 1000 classes, 3 x 224 x 224,
batch 32, f32, no TF32, Xavier from the seed, SGD momentum), warms two
steps, then measures on the card:

- host-clock time of the step's stages — forward (is_train), backward,
  the 157 parameter updates, the metric update — each ending in
  ``torch.cuda.synchronize()``, median of 3 steps;
- a ``torch.profiler`` window over one whole step: device kernel time and
  launches by kind (conv forward, conv dgrad, the port's conv_wgrad, the
  1x1 / 7x7 weight gradients, batch norm / ReLU / other elementwise and
  reduction kernels, sgd_mom, matrix products, everything else), the
  device's busy and idle share of the window, and the heaviest kernels.

Kinds come from kernel names; the heaviest kernels are printed so the
split can be read. Prints one JSON line per measurement; exits non-zero
without a card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# (kind, substrings of the lower-cased kernel name), first match wins
KINDS = (
    ("conv_wgrad", ("conv_wgrad",)),
    ("sgd_mom", ("sgd_mom",)),
    ("wgrad 1x1/7x7 (cuDNN)", ("wgrad",)),
    ("conv dgrad", ("dgrad",)),
    ("conv forward", ("fprop", "convolve", "conv2d", "implicit_gemm",
                      "nchwtonhwc", "nhwctonchw", "cudnn")),
    ("matmul", ("gemm", "gemv", "cublas", "cutlass", "xmma", "nvjet")),
    ("bn/relu/elementwise", ("elementwise", "reduce", "relu", "threshold",
                             "clamp", "rsqrt", "batch_norm", "sum",
                             "mean")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_module: no CUDA device available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.tools import lm, resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.RESNET
    mod, it, init = resnet.resnet_setup(cfg, cfg["batch"], 1)
    args = resnet.fit_args(cfg, init)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(init)
    mod.init_optimizer(optimizer=args["optimizer"],
                       optimizer_params=args["optimizer_params"])
    batch = next(iter(it))
    acc = metric.create(args["eval_metric"])

    stages = (("forward", lambda: mod.forward(batch, is_train=True)),
              ("backward", mod.backward), ("update", mod.update),
              ("metric", lambda: mod.update_metric(acc, batch.label)))
    for _ in range(2):                               # warm
        for _name, fn in stages:
            fn()
    times = {name: [] for name, _ in stages}
    for _ in range(3):
        for name, fn in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    _emit({"measure": "host_ms", "batch": cfg["batch"],
           "stage_ms": {k: float(np.median(v)) for k, v in times.items()},
           "gpu": lm.nvidia_smi()})

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _name, fn in stages:
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind, launches = {}, {}
    for e in kernels:
        k = _kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
        launches[k] = launches.get(k, 0) + e.count
    busy = sum(by_kind.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    _emit({"measure": "profile", "window": "fit_step", "wall_ms": wall_ms,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
           "device_ms_by_kind": by_kind, "kernel_launches": launches,
           "top_kernels": [{"name": e.key[:100], "kind": _kind(e.key),
                            "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
