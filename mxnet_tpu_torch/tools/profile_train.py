"""Where the time goes in one training step of the LM, on one CUDA card.

    python3 -m mxnet_tpu_torch.tools.profile_train        # from the repo root

Sets up the train run that ``chip_smoke.py`` drives
(``tools/lm.py:lm_train_setup``: the full-width LM at ``TRAIN``'s batch
32 x 2048 in its compute type (bf16 over f32 weights), no TF32,
Xavier-initialized from the seed, one fixed batch), warms two
SGD-momentum steps, then measures on the card, stage by stage (the
captured fused step is ``tools/profile_capture.py``'s):

- host-clock time of the step's three stages — forward (is_train),
  backward, the 53 parameter updates — each ending in
  ``torch.cuda.synchronize()``, median of 3 steps;
- a ``torch.profiler`` window over one whole step: device kernel time by
  kind (each of the port's kernels, matrix products, everything else),
  the device's busy and idle share of the window, and the heaviest
  kernels.

Prints one JSON line per measurement; exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .profile_generate import _kind


def _emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.tools import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train = lm.TRAIN
    exe, names = lm.lm_train_setup(lm.LM, train)
    updater = lm.lm_updater("sgd", train, names)

    def update():
        lm.lm_update(exe, names, updater)

    stages = (("forward", lambda: exe.forward(is_train=True)),
              ("backward", exe.backward), ("update", update))
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
    _emit({"measure": "host_ms", "batch": train["batch"],
           "seq": train["seq"],
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    _emit({"measure": "profile", "window": "train_step", "wall_ms": wall_ms,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
           "device_ms_by_kind": by_kind, "kernel_launches": launches,
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
